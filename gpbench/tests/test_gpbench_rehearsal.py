"""One run of a tiny cell on the CPU, through the program and the
reference, with the look for a card skipped; then the same run with the
timed path broken underneath, which the check has to call not correct.
The cells run on one card, so no fault of an exchange between cards
applies."""

import pytest

from gpbench import faults
from gpbench.tests.common import TINY, tiny_root, tiny_run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("gpbench"))


@pytest.fixture(scope="module")
def line(root):
    return tiny_run(root)


@pytest.mark.parametrize("name", [TINY, "tiny_glob.tiny_vqa"])
def test_the_tiny_cell_is_correct(root, line, name):
    out = line if name == TINY else tiny_run(root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 4
    assert all(d["kept"] > 1 for d in out["judged"])  # the cap decides, not the floor
    assert out["checks"]["keep_policy_flips"] == {"value": 0, "limit": 0}


def test_the_last_line_has_its_keys(line):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for m in ("gen_tok_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s"):
        assert line["metrics"][m]["value"] > 0 and line["metrics"][m]["unit"]
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_a_traced_run_prints_its_per_layer_metrics(root):
    out = tiny_run(root, traced=True)
    assert out["correct"]
    for m in ("prefill.ms", "decode.step_ms", "serve.occupancy_pct"):
        assert out["metrics"][m]["value"] > 0
    assert "gen_tok_s" not in out["metrics"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    faults.plant(fault, monkeypatch.setattr)
    out = tiny_run(root)
    assert not out["correct"], out["checks"]


def test_a_keep_set_off_the_policy_fails_the_exact_check(root, monkeypatch):
    """Half the image left out of the keep decision: the program's keep set
    is not the policy's on its own keep logits."""
    faults.plant("half_the_image", monkeypatch.setattr)
    out = tiny_run(root)
    assert out["checks"]["keep_policy_flips"]["value"] > 0


def test_the_control_tier_is_not_correct(root):
    """The program one precision down (int8 weights, W8A8, int8 KV) reads
    past the tiny cell's float32 limits."""
    control = {"weights": "int8", "knobs": {"act_quant": "prefill"}, "kv_cache": "int8"}
    out = tiny_run(root, tier=control)
    assert not out["correct"], out["checks"]
