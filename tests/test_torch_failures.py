"""The port's failure handling (glimpseprune_torch/utils/failures.py)
against the JAX package's (glimpseprune_tpu/utils/failures.py): the same
calls, warnings and results on the same scripted exception sequences, one
process (no process group: every rank is this one). A CUDA OOM
(``torch.cuda.OutOfMemoryError``) counts as an OOM in the port."""

import warnings

import numpy as np
import pytest

from glimpseprune_tpu.utils import failures as jax_failures

OOM = "RESOURCE_EXHAUSTED: out of memory while trying to allocate"


def _run(failures, case):
    """(calls, warning messages, result or the exception's type name)."""
    import torch

    calls = []

    def oom(port):
        if port and case.endswith("torch"):
            return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return RuntimeError(OOM)

    port = failures.__name__.startswith("glimpseprune_torch")
    if case.startswith("fallback"):
        def fn(size=4):
            calls.append(size)
            if case.startswith("fallback_non_oom"):
                raise ValueError("boom")
            if case.startswith("fallback_exhausted") or size > 1:
                raise oom(port)
            return size

        fn = failures.with_oom_fallback([{"size": 2}, {"size": 1}],
                                        on_fallback=lambda i, e: calls.append(f"fb{i}"))(fn)
    else:
        def fn():
            calls.append("step")
            if case.startswith("step_oom"):
                raise oom(port)
            if case == "step_non_oom":
                raise ValueError("boom")
            return "result"

        fn = failures.oom_resilient_step(skip_value="skipped")(fn)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn()
        except Exception as e:  # the exception's kind is the result
            out = type(e).__name__ if not isinstance(e, RuntimeError) else "RuntimeError"
    return calls, [str(w.message) for w in caught], out


@pytest.mark.parametrize("case", ["fallback_then_success", "fallback_then_success_torch",
                                  "fallback_non_oom", "fallback_exhausted",
                                  "fallback_exhausted_torch", "step_ok", "step_oom",
                                  "step_oom_torch", "step_non_oom"])
def test_failures_match_jax(case):
    from glimpseprune_torch.utils import failures

    got = _run(failures, case)
    want = _run(jax_failures, case)
    if case.endswith("torch"):  # the port's OOM is a CUDA error JAX never sees
        got = (got[0], [m.split(" (")[0] for m in got[1]], got[2])
        want = (want[0], [m.split(" (")[0] for m in want[1]], want[2])
    assert got == want
    if case == "fallback_then_success":
        assert got[0] == [4, "fb0", 2, "fb1", 1] and got[2] == 1 and len(got[1]) == 2


def test_is_oom_and_finite_and_nan_checks():
    import torch

    from glimpseprune_torch.utils import failures

    for e in (RuntimeError(OOM), RuntimeError("Out of memory"),
              torch.cuda.OutOfMemoryError("CUDA out of memory")):
        assert failures.is_oom_error(e)
    assert failures.is_oom_error(RuntimeError(OOM)) == jax_failures.is_oom_error(
        RuntimeError(OOM))
    assert not failures.is_oom_error(RuntimeError("other"))
    failures.assert_finite({"a": np.ones(3), "b": [torch.ones(2)]}, "ok")
    with pytest.raises(FloatingPointError, match="bad:a"):
        failures.assert_finite({"a": np.array([1.0, np.nan])}, "bad")
    with pytest.raises(FloatingPointError, match="bad:b/0"):
        failures.assert_finite({"b": [torch.tensor([np.inf])]}, "bad")
    assert failures.all_hosts_agree_ok(True) and not failures.all_hosts_agree_ok(False)
    failures.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        failures.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
