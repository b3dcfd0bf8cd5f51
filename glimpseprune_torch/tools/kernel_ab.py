"""What the kernel A/B tools and ``chip_smoke.py`` share: the card's name
and power limit, CUDA-event and torch.profiler timing, the least time the
card could take for a piece of work, the limits a kernel is held to against
its plain version, and the report a tool writes.

The A/B tools (``sweep_vision_attention``, ``sweep_vit_fullatt``,
``i8attn_microbench``) run on ``--device cuda`` by default and fail without
a card. On ``--device cpu`` they run the plain versions at small sizes, for
the tests, and write ``NOT_MEASURED`` in place of every time (the keys of
``TIME_KEYS``); counts and bounds, which come from shapes, stay numbers.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import warnings
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
NOT_MEASURED = "not measured"
# the row keys that hold a time or a rate measured on the card
TIME_KEYS = ("ms", "device_ms", "share", "tflops_jax", "kernels", "gemm_device_ms",
             "passes_device_ms", "prep_device_ms", "attention_device_ms", "plain_ms")

# H100 SXM published peaks (NVIDIA data sheet, dense): the bf16 and int8
# tensor rates and HBM bandwidth; bound_ms is stated against them.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

# Kernels run in bf16 and their plain versions in fp32 from the same bf16
# inputs, so the two differ by the kernel's bf16 output rounding (half an
# ulp: |x| * 2**-9, under 0.016 for the |x| < 8 these attention outputs
# stay within) plus fp32 summation order (~1e-6). 2e-2 bounds both.
KERNEL_ATOL = 2e-2
# K7 and its plain version run the same int8 arithmetic (exact integer
# QK^T and, with pv_int8, PV sums) and differ by the kernel's bf16 output
# rounding and the order of fp32 operations (exp2, the softmax sums, a
# rint(p * 127) that falls on the other side of a half step). Its outputs
# are small (~0.03 at the ViT shapes), so it is held relative to their
# size in two measures: the largest error over max |ref| (bf16 rounding up
# to 2**-8 of it, plus the fp32 order: 2**-7 bounds both) and the RMS error
# over the RMS of ref (bf16 rounding ~2**-7 / sqrt(12) = 2.3e-3 at most:
# 2**-8 bounds it with the fp32 order). The int8 tiers move the output by
# more (int8 QK^T against bf16 ~8e-3 RMS, the int8 PV product 1.3e-2 to
# 3e-2), so a kernel that dropped either fails; chip_smoke.py's
# check_flash_int8 shows it on every run by holding each kernel output
# against the other references.
K7_MAX_RTOL = 2 ** -7
K7_RMS_RTOL = 2 ** -8
# K1 and K2 at the main path's shapes are held to the same two limits
# beside KERNEL_ATOL, since their outputs are as small: like Pallas they
# round P to bf16 before PV (unit roundoff 2**-8 of each probability, ~2.3e-3
# RMS of the output) and round the output to bf16.

# the SDPA backends the tools time at the attention shapes (not math)
SDPA_BACKENDS = ("flash", "efficient", "cudnn")

# device_ms_by_kernel: calls inside a trace before and after the timed ones
TRACE_PAD_CALLS = 10
# the kernel that torch.cuda._sleep launches, and its length (~10 us)
TRACE_MARK, TRACE_MARK_CYCLES = "spin_kernel", 20000


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], Any], warmup: int = 2, iters: int = 10) -> float:
    """Mean ms of ``iters`` calls of fn after ``warmup`` calls, from CUDA
    events around the whole run."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn: Callable[[], Any], iters: int = 10, tries: int = 5,
                        per_call: Optional[Dict[str, int]] = None,
                        pad_calls: int = TRACE_PAD_CALLS) -> Optional[Dict[str, float]]:
    """{kernel name: mean device ms per call} of the CUDA kernels that one
    call of ``fn`` launches, from torch.profiler: the card's own time,
    without the host's launch cost, which cuda_ms includes when the host is
    slower than the card. A trace in a long-lived process can lose the
    records of its first and its last kernels, up to several calls' worth,
    and can hold records left over from an earlier trace, so ``pad_calls``
    calls run before and after the ``iters`` that count (fewer for a call
    of thousands of kernels, whose trace takes the host seconds to read),
    and a marker kernel (``torch.cuda._sleep``, which no path launches)
    ends each of the first two groups: the kernels that count are those
    between the trace's last two markers. Each kernel's count there must be
    a whole number per call (``fn`` launches the same kernels every call),
    and its total is divided by ``iters``; ``per_call``, a dict, receives
    each kernel's launches per call. A trace that falls short of that, or
    recorded no device time, is taken again, up to ``tries`` times; then
    the result is None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for group, calls in enumerate((pad_calls, iters, pad_calls)):
                for _ in range(calls):
                    fn()
                if group < 2:
                    torch.cuda._sleep(TRACE_MARK_CYCLES)
                torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                          and e.time_range.elapsed_us() > 0), key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(kernels) if TRACE_MARK in e.name][-2:]
        total, count = Counter(), Counter()
        for e in kernels[marks[0] + 1:marks[1]] if len(marks) == 2 else ():
            total[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        short = [(k[:60], c) for k, c in count.items() if c % iters]
        if short:
            print(f"device_ms: the trace of {iters} calls counted {short} launches; again")
        elif total:
            if per_call is not None:
                per_call.update({k: c // iters for k, c in count.items()})
            return {k: t / iters / 1e3 for k, t in total.items()}
        else:
            print(f"device_ms: {len(marks)} of the 2 markers in a trace of {len(kernels)} "
                  "kernels; again")
    return None


def device_ms(fn: Callable[[], Any], iters: int = 10, tries: int = 3) -> Optional[float]:
    """Mean device ms of one call of ``fn`` (device_ms_by_kernel summed), or
    None where not measured, never 0."""
    by = device_ms_by_kernel(fn, iters, tries)
    return None if by is None else sum(by.values())


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(least ms, what bounds it) from bf16 operations, int8 operations and
    bytes."""
    ops_ms = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_errors(got: torch.Tensor, ref: torch.Tensor):
    """(max error / max |ref|, RMS error / RMS of ref)."""
    d = got.float() - ref.float()
    return ((d.abs().max() / ref.float().abs().max().clamp(min=1e-30)).item(),
            (d.norm() / ref.float().norm().clamp(min=1e-30)).item())


def rel_within(errs) -> bool:
    return errs[0] <= K7_MAX_RTOL and errs[1] <= K7_RMS_RTOL


def attention_pairs(s: int, causal: bool) -> int:
    """(query, key) pairs a causal or a full attention over s rows allows."""
    return s * (s + 1) // 2 if causal else s * s


def jax_tflop(b: int, h: int, s: int, d: int, causal: bool) -> float:
    """The JAX tools' count of an attention call's work (qk + pv), halved
    when causal (tools/i8attn_microbench.py:45, sweep_vit_fullatt.py:44),
    in TFLOP."""
    return 4 * s * s * d * h * b * (0.5 if causal else 1.0) / 1e12


def measure(fn: Callable[[], Any], dev: torch.device, iters: int, by_kernel: bool = False,
            pad_calls: Optional[int] = None, floor_ms: float = 0.0,
            tries: int = 3) -> Dict[str, Any]:
    """{"ms": CUDA-event mean over ``iters`` calls after one warm-up,
    "device_ms": the card's own time per call, from a trace of ``iters``
    calls between ``pad_calls`` (default up to TRACE_PAD_CALLS) on each
    side} and with ``by_kernel`` "kernels": {kernel name: device ms} and
    "kernel_launches": {kernel name: launches a call}; NOT_MEASURED for
    each on the CPU, where nothing is timed. A trace that sums to less than
    ``floor_ms`` (the call's bound, under which no card can run it) lost
    records: it is taken again, up to ``tries`` times, then the device
    times are NOT_MEASURED."""
    if dev.type != "cuda":
        out = {"ms": NOT_MEASURED, "device_ms": NOT_MEASURED}
        return {**out, "kernels": NOT_MEASURED, "kernel_launches": NOT_MEASURED} if by_kernel \
            else out
    ms = cuda_ms(fn, warmup=1, iters=iters)
    pad = min(TRACE_PAD_CALLS, iters) if pad_calls is None else pad_calls
    for _ in range(tries):
        per_call: Dict[str, int] = {}
        by = device_ms_by_kernel(fn, iters=iters, per_call=per_call, pad_calls=pad)
        if by is None or sum(by.values()) >= floor_ms:
            break
        print(f"device_ms: {sum(by.values()):.4f} ms a call, under the bound {floor_ms:.4f} ms; "
              "again")
    else:
        by = None
    out = {"ms": ms, "device_ms": NOT_MEASURED if by is None else sum(by.values())}
    if by_kernel:
        out["kernels"] = NOT_MEASURED if by is None else dict(
            sorted(by.items(), key=lambda kv: -kv[1]))
        out["kernel_launches"] = per_call
    return out


def timed_plain(fn: Callable[[], Any], dev: torch.device) -> Any:
    """A plain version's event ms (3 calls after one), or NOT_MEASURED on
    the CPU."""
    return cuda_ms(fn, warmup=1, iters=3) if dev.type == "cuda" else NOT_MEASURED


class Counted:
    """fn, counting its calls and, where ``counter`` reads a wrapper's
    launch count, the launches over them."""

    def __init__(self, fn: Callable[[], Any], counter: Optional[Callable[[], int]] = None):
        self.fn, self.counter, self.calls = fn, counter, 0
        self.start = None if counter is None else counter()

    def __call__(self):
        self.calls += 1
        return self.fn()

    def per_call(self) -> Optional[float]:
        """Launches a call so far (None without a counter)."""
        if self.counter is None or not self.calls:
            return None
        return (self.counter() - self.start) / self.calls


def checked(got: torch.Tensor, ref: torch.Tensor, atol: Optional[float] = KERNEL_ATOL
            ) -> Dict[str, Any]:
    """{max_abs_err, rel_err, rms_rel_err, ok}: ok when the relative errors
    are within K7_MAX_RTOL / K7_RMS_RTOL and, unless atol is None, the
    largest error within atol."""
    err = (got.float() - ref.float()).abs().max().item()
    errs = rel_errors(got, ref)
    return {"max_abs_err": err, "rel_err": errs[0], "rms_rel_err": errs[1],
            "ok": rel_within(errs) and (atol is None or err <= atol)}


def fmt(x) -> str:
    return x if isinstance(x, str) else f"{x:.4f}"


def brief(row: Dict[str, Any]) -> str:
    """A row on one line: name, shape, event and device ms, bound and share,
    the check."""
    text = (f"{row['name']} {row.get('shape', '')}: {fmt(row.get('ms', NOT_MEASURED))} ms, "
            f"device {fmt(row.get('device_ms', NOT_MEASURED))} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share "
            f"{fmt(row.get('share', NOT_MEASURED))}")
    if row.get("error"):
        text += f"; refused: {row['error']}"
    if "ok" in row and row["ok"] is not None:
        text += f"; max/rel/rms err {row['max_abs_err']:.3e}/{row['rel_err']:.3e}/" \
                f"{row['rms_rel_err']:.3e} {'ok' if row['ok'] else 'FAILED'}"
    return text


def share(bound_ms: float, ms) -> Any:
    """bound / event ms, or NOT_MEASURED."""
    return NOT_MEASURED if ms == NOT_MEASURED else bound_ms / ms


def top_kernels(row: Dict[str, Any], n: int = 12, width: int = 110) -> None:
    """Replaces a row's "kernels" and "kernel_launches" with the n kernels
    that take the most device time: {name cut to width: [device ms,
    launches a call]}."""
    kernels, launches = row["kernels"], row.pop("kernel_launches")
    if kernels != NOT_MEASURED:
        row["kernels"] = {k[:width]: [v, launches[k]] for k, v in list(kernels.items())[:n]}


def check_rows(s: int, n: int, dev) -> torch.Tensor:
    """n q rows spread evenly over s (every row when n >= s), on which an
    attention output is held to its plain version."""
    return torch.unique(torch.linspace(0, s - 1, min(n, s), device=dev).round().long())


def numpy_qkv(b: int, h: int, s: int, d: int, dev, dtype) -> Tuple[torch.Tensor, ...]:
    """q, k, v [b, h, s, d] as the JAX tools draw them: standard normals
    from numpy.random.default_rng(0), q then k then v, cast to dtype."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, s, d))).to(dev).to(dtype)
                 for _ in range(3))


@contextlib.contextmanager
def sdpa_backend(name: str):
    """scaled_dot_product_attention held to one backend of SDPA_BACKENDS."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backend = {"flash": SDPBackend.FLASH_ATTENTION, "efficient": SDPBackend.EFFICIENT_ATTENTION,
               "cudnn": SDPBackend.CUDNN_ATTENTION}[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a refused backend says why in a warning too
        with sdpa_kernel(backend):
            yield


def attention_row(name: str, shape: str, fn: Callable[[], torch.Tensor], dev, iters: int,
                  work, tflop: float, ref: Optional[torch.Tensor] = None, idx=None,
                  counter: Optional[Callable[[], int]] = None, by_kernel: bool = False,
                  refusable: bool = False, plain: Optional[Callable[[], Any]] = None
                  ) -> Dict[str, Any]:
    """One attention call's row: its output at q rows ``idx`` checked
    against ``ref`` (KERNEL_ATOL and the relative limits), event and device
    ms, the bound ``work`` = (ms, by) and its share, the JAX tools' TF/s
    from ``tflop``, the launches a call where ``counter`` reads a wrapper's
    count, and with ``plain`` (the plain version on those rows) its event
    ms as "plain_ms". A ``refusable`` call (a library backend) that raises
    RuntimeError gives a row with its error and nothing measured."""
    row: Dict[str, Any] = {"name": name, "shape": shape, "bound_ms": work[0],
                           "bound_by": work[1], "error": None}
    call = Counted(fn, counter)
    try:
        got = call()
    except RuntimeError as e:
        if not refusable:
            raise
        row.update({"error": str(e).splitlines()[0][:200], "max_abs_err": None,
                    "rel_err": None, "rms_rel_err": None, "ok": None, "ms": NOT_MEASURED,
                    "device_ms": NOT_MEASURED, "share": NOT_MEASURED,
                    "tflops_jax": NOT_MEASURED, "launches_per_call": None})
        if by_kernel:
            row.update({"kernels": NOT_MEASURED, "kernel_launches": NOT_MEASURED})
        return row
    if ref is not None:
        row.update(checked(got[:, :, idx], ref))
    del got
    row.update(measure(call, dev, iters, by_kernel, pad_calls=min(2, iters), floor_ms=work[0]))
    row["share"] = share(work[0], row["ms"])
    row["tflops_jax"] = NOT_MEASURED if row["ms"] == NOT_MEASURED else tflop / (row["ms"] * 1e-3)
    row["launches_per_call"] = call.per_call()
    if plain is not None:
        row["plain_ms"] = timed_plain(plain, dev)
    return row


def launch_failures(rows, dev) -> List[str]:
    """The rows whose wrapper counted other than one launch a call on the
    card, or any on the CPU, where the plain version runs (rows without a
    counter are left out)."""
    want = 1.0 if dev.type == "cuda" else 0.0
    return [f"{r['name']} {r.get('shape', '')}: {r['launches_per_call']} launches a call, "
            f"not {want:g}" for r in rows
            if r.get("launches_per_call") is not None and r["launches_per_call"] != want]


def write_report(tool: str, record: Dict[str, Any], out: Optional[str]) -> str:
    """The record as JSON on stdout and in ``out`` (default
    chiprun_out/<tool>.json) -> the path written."""
    path = Path(out) if out else ROOT / "chiprun_out" / f"{tool}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    text = json.dumps(record, default=str)
    path.write_text(text)
    print(text, flush=True)
    print(f"wrote {path}", file=sys.stderr)
    return str(path)
