"""Profiling decorators: time and peak-memory stats of hot calls.

Counterpart of glimpseprune_tpu/utils/profiling.py (reference
warppers.py:190-300 ``time_logger``, :306-438 ``memory_logger``): a global
stats registry keyed by qualified name, thread-local on/off context
managers, and a dump for the eval's info.json. On the card a timed call is
fenced by ``torch.cuda.synchronize`` before and after, so the time holds
the call's device work and nothing queued earlier; peak memory is
``torch.cuda.max_memory_allocated``. An inactive logger calls the function
and nothing else: no synchronize and no host read, so decorated methods
run unchanged inside sync-checked or captured regions.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

_STATE = threading.local()


def _flag(name: str, default: bool = False) -> bool:
    return getattr(_STATE, name, default)


class LoggerControl:
    """Context manager to toggle time/memory logging on the current thread."""

    def __init__(self, time_active: bool = None, memory_active: bool = None):
        self._time = time_active
        self._memory = memory_active
        self._prev = {}

    def __enter__(self):
        if self._time is not None:
            self._prev["time_active"] = _flag("time_active")
            _STATE.time_active = self._time
        if self._memory is not None:
            self._prev["memory_active"] = _flag("memory_active")
            _STATE.memory_active = self._memory
        return self

    def __exit__(self, *exc):
        for k, v in self._prev.items():
            setattr(_STATE, k, v)
        return False


def time_logger_set_active(active: bool = True) -> LoggerControl:
    return LoggerControl(time_active=active)


def memory_logger_set_active(active: bool = True) -> LoggerControl:
    return LoggerControl(memory_active=active)


class _Stats:
    __slots__ = ("count", "total", "peak")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.peak = 0.0

    def add(self, value: float):
        self.count += 1
        self.total += value
        self.peak = max(self.peak, value)

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


_TIME_STATS: Dict[str, _Stats] = defaultdict(_Stats)
_MEM_STATS: Dict[str, _Stats] = defaultdict(_Stats)
_STATS_LOCK = threading.Lock()


def get_logger_stats() -> Dict[str, Any]:
    """Dump running stats for *_info.json artifacts
    (reference viscot_eval/infer_cot.py:424-438)."""
    with _STATS_LOCK:
        return {
            "time_ms": {
                k: {"avg": s.avg * 1e3, "count": s.count, "total": s.total * 1e3}
                for k, s in _TIME_STATS.items()
            },
            "peak_memory_bytes": {
                k: {"peak": s.peak, "count": s.count} for k, s in _MEM_STATS.items()
            },
        }


def reset_logger_stats():
    with _STATS_LOCK:
        _TIME_STATS.clear()
        _MEM_STATS.clear()


def _cuda_device(args, kwargs) -> Optional[torch.device]:
    """The CUDA device a call works on: that of its first CUDA tensor
    argument, or of an argument's ``device`` (a runner's, a model's
    parameters'); None on the CPU."""
    for a in list(args) + list(kwargs.values()):
        dev = a.device if isinstance(a, torch.Tensor) else getattr(a, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return dev
    return None


def _device_peak_bytes() -> float:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0.0
    return float(sum(torch.cuda.max_memory_allocated(i)
                     for i in range(torch.cuda.device_count())))


def time_logger(fn):
    """Time a call, its device work included."""

    name = getattr(fn, "__qualname__", getattr(fn, "__name__", str(fn)))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _flag("time_active"):
            return fn(*args, **kwargs)
        dev = _cuda_device(args, kwargs)
        if dev is not None:
            torch.cuda.synchronize(dev)
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev is not None:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - start
        with _STATS_LOCK:
            _TIME_STATS[name].add(elapsed)
        return out

    return wrapper


def memory_logger(fn):
    """Record the device's peak memory observed after the call."""

    name = getattr(fn, "__qualname__", getattr(fn, "__name__", str(fn)))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _flag("memory_active"):
            return fn(*args, **kwargs)
        out = fn(*args, **kwargs)
        dev = _cuda_device(args, kwargs)
        if dev is not None:
            torch.cuda.synchronize(dev)
        with _STATS_LOCK:
            _MEM_STATS[name].add(_device_peak_bytes())
        return out

    return wrapper


def debug_calls(every_n: Optional[int] = None, prefix: str = ""):
    """Print every Nth call's args summary, gated by env DEBUG_CALLS_N
    (reference warppers.py:15-114 `@debug_calls`; used there for RL sample
    logging). N resolves at call time: decorator arg > env var > off."""

    def deco(fn):
        counter = {"n": 0}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            n = every_n or int(os.environ.get("DEBUG_CALLS_N", "0") or 0)
            if n > 0:
                counter["n"] += 1
                if counter["n"] % n == 0:
                    parts = [
                        f"{type(a).__name__}{getattr(a, 'shape', '')}" for a in args
                    ]
                    print(
                        f"[debug_calls]{prefix} {fn.__qualname__} "
                        f"#{counter['n']} ({', '.join(parts[:6])})"
                    )
            return fn(*args, **kwargs)

        return wrapper

    return deco


class profiler_trace:
    """Context manager writing a torch.profiler Chrome trace
    (``<log_dir>/trace.json``, CPU and, where there is a card, CUDA
    activity) when ``log_dir`` is truthy; no-op otherwise."""

    TRACE_FILE = "trace.json"

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        if self.log_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.log_dir, self.TRACE_FILE))
            self._prof = None
        return False
