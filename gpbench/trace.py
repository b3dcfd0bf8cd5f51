"""Reading a torch.profiler trace: the device's busy time, kernel time by
name between two marker kernels, and the breakdown of the traced window.

Frozen copies of the program's trace arithmetic: ``busy_us`` is the union
of device intervals of ``chip_smoke.idle_share``; ``between_markers`` is
the marker-bounded sums of ``tools/kernel_ab.device_ms_by_kernel`` (a
trace can lose its first and last records and hold records of an earlier
trace, so only what lies between the last two markers counts). The
functions take plain (name, start_us, end_us) tuples, so that they can be
tested on synthetic intervals.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

Span = Tuple[str, float, float]  # (name, start us, end us)

MARK = "spin_kernel"          # the kernel torch.cuda._sleep launches
MARK_CYCLES = 20000           # its length in cycles (~10 us)


def busy_us(spans: Sequence[Span]) -> float:
    """Microseconds in which at least one of the spans runs."""
    busy, end = 0.0, None
    for _, start, stop in sorted(spans, key=lambda s: s[1]):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def between_markers(device: Sequence[Span], mark: str = MARK):
    """(the device spans strictly between the last two markers, (start,
    end) of that window in us), or None where the trace holds fewer than
    two markers."""
    spans = sorted(device, key=lambda s: s[1])
    marks = [i for i, s in enumerate(spans) if mark in s[0]][-2:]
    if len(marks) < 2:
        return None
    a, b = marks
    return spans[a + 1:b], (spans[a][2], spans[b][1])


def sums_by_name(spans: Sequence[Span]) -> Dict[str, Tuple[float, int]]:
    """{name: (total us, count)}."""
    total, count = Counter(), Counter()
    for name, start, stop in spans:
        total[name] += stop - start
        count[name] += 1
    return {k: (total[k], count[k]) for k in total}


def gaps(spans: Sequence[Span], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The idle intervals of the device inside the window."""
    out, at = [], window[0]
    for _, start, stop in sorted(spans, key=lambda s: s[1]):
        if start > at:
            out.append((at, min(start, window[1])))
        at = max(at, stop)
    if at < window[1]:
        out.append((at, window[1]))
    return [g for g in out if g[1] > g[0]]


def host_at(host: Sequence[Span], points: Sequence[float]) -> List[Optional[str]]:
    """For each time point, the innermost (shortest) host span that holds
    it, or None."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    spans = sorted(host, key=lambda s: s[1])
    out: List[Optional[str]] = [None] * len(points)
    active: List[Span] = []
    j = 0
    for i in order:
        t = points[i]
        while j < len(spans) and spans[j][1] <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[2] >= t]
        if active:
            out[i] = min(active, key=lambda s: s[2] - s[1])[0]
    return out


def breakdown(device: Sequence[Span], host: Sequence[Span], window: Tuple[float, float],
              top: int = 10) -> Dict[str, list]:
    """{"device_ops": [[name, seconds]], "idle_gaps": [[host activity,
    seconds]]}: the device operations that took most time, and the idle
    time of the device summed by what the host was doing at each gap's
    middle, each list the ``top`` largest."""
    ops = sums_by_name(device)
    dev = sorted(((k, v[0] / 1e6) for k, v in ops.items()), key=lambda kv: -kv[1])[:top]
    idle = gaps(device, window)
    names = host_at(host, [(a + b) / 2 for a, b in idle])
    by = Counter()
    for (a, b), name in zip(idle, names):
        by[name or "(no host op)"] += (b - a) / 1e6
    return {"device_ops": [[k, v] for k, v in dev],
            "idle_gaps": [[k, v] for k, v in by.most_common(top)]}
