#!/usr/bin/env python
"""Tile A/B of the port's W4A8 prefill product (K6) on the card.

Runs ``glimpseprune_torch``'s K6 (``int4_a8_kernels``: the prep pass and the
int8 GEMM) with each GEMM tile of ``A8_TILES`` that divides the shape, at
the 7B decoder's four linears with M = 1664 (batch (a) of the smoke) and at
k/v and down with M = 256 (the resume layers). The plan takes its tile from
``a8_tile``; this tool replaces that function for the run, so the library's
API has no knob for it. For each tile it prints the event ms (mean of 20
calls), the prep's and the GEMM's device ms from torch.profiler (each
kernel's total over the launches the trace counted, which must be one per
call), the grid's blocks, and checks that the output is bit-equal to the
plain stages (``int4_a8_prep_reference`` then ``int8_gemm_tn_reference``)
on the same inputs. The card's name and power limit come first; the JSON
goes to stdout and to ``chiprun_out/int4_a8_tile_ab.json``.

Usage, on a CUDA machine, from the repo root:
  python tools/torch_int4_a8_tile_ab.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, M, K, N) at the 7B's widths (hidden 3584, kv 512, intermediate 18944)
CASES = (("q_o", 1664, 3584, 3584), ("k_v", 1664, 3584, 512), ("gate_up", 1664, 3584, 18944),
         ("down", 1664, 18944, 3584), ("k_v", 256, 3584, 512), ("down", 256, 18944, 3584))
GROUP = 64


def event_ms(fn, iters=20):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_device_ms(fn, iters=10, tries=3):
    """(prep, GEMM) device ms per call, or (None, None) when no trace counted
    exactly one launch of each per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            for tag in ("prep_kernel", "gemm_kernel"):
                if tag in e.key and e.count == iters and t > 0:
                    got[tag] = t / e.count / 1e3
        if len(got) == 2:
            return got["prep_kernel"], got["gemm_kernel"]
    return None, None


def main() -> int:
    import torch

    from glimpseprune_torch.ops.cuda import int4_matmul as tm4

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    a8_tile = tm4.a8_tile
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    report, bad = {}, []
    for name, m, k, n in CASES:
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                               dtype=torch.int8)
        scales = torch.rand((k // GROUP, n), generator=gen, device="cuda") * 0.01 + 1e-3
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        want = tm4.int8_gemm_tn_reference(*tm4.int4_a8_prep_reference(x, packed, scales),
                                          torch.bfloat16)
        row = {"rule": a8_tile(m, k, n)}
        for tile in tm4.a8_fits(k, n):
            tm4.a8_tile = lambda *args, tile=tile: tile
            tm4.plan_int4_a8.cache_clear()
            try:
                plan = tm4.plan_int4_a8(m, k, n)

                def call():
                    return tm4.int4_a8_kernels(x, packed, scales)[0]

                equal = torch.equal(call(), want)
                prep, gemm = stage_device_ms(call)
                row[f"{plan.bm}x{plan.bn}"] = {"ms": event_ms(call), "prep_device_ms": prep,
                                               "gemm_device_ms": gemm, "blocks": plan.blocks,
                                               "bit_equal": equal}
                if not equal:
                    bad.append((name, m, tile))
            finally:
                tm4.a8_tile = a8_tile
                tm4.plan_int4_a8.cache_clear()
        report[f"{name}[M={m}]"] = row
        print(f"{name}[M={m}]", json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "int4_a8_tile_ab.json").write_text(json.dumps(report, indent=1))
    if bad:
        print(f"not bit-equal to the plain stages at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
