"""Failure handling: OOM fallback and numerics checks.

Counterpart of glimpseprune_tpu/utils/failures.py (``is_oom_error`` :17,
``with_oom_fallback`` :21, ``all_hosts_agree_ok`` :59, ``oom_resilient_step``
:74, ``enable_nan_checks`` :101, ``assert_finite`` :108). The reference
guards its RL forward with decorators that catch a CUDA OOM and skip the
step on every rank together (warppers.py:443-494); ``with_oom_fallback``
retries a callable with smaller kwargs (an image side, max_pixels) on OOM,
warning at every step down, so a caller always learns which kwargs ran.

On the card an OOM is ``torch.cuda.OutOfMemoryError``; the JAX package's
strings (``RESOURCE_EXHAUSTED``, ``Out of memory``) count too. Before a
retry on a CUDA device the caching allocator's free blocks go back to the
card (``torch.cuda.empty_cache``), once the failed call's frames have
let go of their tensors. The cross-rank agreement goes through
``torch.distributed`` when a process group is initialised and is the
identity otherwise.
"""

from __future__ import annotations

import functools
import traceback
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch


def is_oom_error(e: BaseException) -> bool:
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(e) or "Out of memory" in str(e))


def release_oom(e: BaseException) -> None:
    """Drop what a failed call still holds: its frames' locals (the
    exception's traceback keeps them, and with them the call's tensors),
    then, on a CUDA device, the allocator's free blocks."""
    traceback.clear_frames(e.__traceback__)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def with_oom_fallback(
    fallback_kwargs: Sequence[Dict[str, Any]],
    on_fallback: Optional[Callable[[int, BaseException], None]] = None,
):
    """Decorator: retry fn with each kwargs override in turn on OOM.

    Example:
        @with_oom_fallback([{"max_pixels": 512 * 28 * 28},
                            {"max_pixels": 256 * 28 * 28}])
        def run(sample, max_pixels=None): ...
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if not is_oom_error(e):
                    raise
                last = e
                release_oom(e)
                for i, override in enumerate(fallback_kwargs):
                    warnings.warn(
                        f"{fn.__name__}: OOM, retrying with {override} "
                        f"(fallback {i + 1}/{len(fallback_kwargs)})"
                    )
                    if on_fallback:
                        on_fallback(i, e)
                    try:
                        return fn(*args, **{**kwargs, **override})
                    except Exception as e2:
                        if not is_oom_error(e2):
                            raise
                        last = e2
                        release_oom(e2)
                raise last

        return wrapper

    return decorator


def all_hosts_agree_ok(ok: bool) -> bool:
    """True iff every rank succeeded, through ``utils.multihost.gather_objects``
    (JAX failures.py:71-73). Every rank must call this each step (success
    or failure), or the next collective deadlocks; without an initialised
    process group it returns ``ok``."""
    from glimpseprune_torch.utils.multihost import gather_objects

    return all(gather_objects(bool(ok), max_bytes=64))


def oom_resilient_step(skip_value: Any = None):
    """Decorator (reference ``oom_resilient``, warppers.py:443-494): catch an
    OOM in a per-step callable and skip the step on every rank together: if
    any rank runs out of memory, every rank returns ``skip_value``."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            ok, result, err = True, None, None
            try:
                result = fn(*args, **kwargs)
            except Exception as e:
                if not is_oom_error(e):
                    raise
                ok, err = False, e
                release_oom(e)
            if all_hosts_agree_ok(ok):
                return result
            if err is not None:
                warnings.warn(f"{fn.__name__}: OOM — all hosts skip this step ({err})")
            else:
                warnings.warn(f"{fn.__name__}: another host OOMed — skipping in sync")
            return skip_value

        return wrapper

    return decorator


def enable_nan_checks(enabled: bool = True):
    """Turn autograd's anomaly detection on or off: a backward that makes a
    NaN raises where it was made (JAX: ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enabled)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def assert_finite(tree, name: str = "tree"):
    """Host-side finiteness check over nested dicts / lists of tensors or
    arrays (a state dict, a metrics dict)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(f"non-finite values in {name}:{'/'.join(path)}")
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise FloatingPointError(f"non-finite values in {name}:{'/'.join(path)}")
