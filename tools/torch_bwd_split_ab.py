#!/usr/bin/env python
"""Grid-balance A/B of the port's flash-attention backward on the card.

Times ``glimpseprune_torch``'s ``flash_attention_backward`` (K3, and K9's
backward with q positions) with its dkv work cut into 1, 2, 3, 4, 6 and 8
chunks, at the training batch's shapes: the LLM's causal GQA layers, a
K9 q shard of them, the fuser (Dqk != Dv, no causal mask) and a small dense
call. The wrapper takes the chunk count from ``bwd_splits``; this tool
replaces that function for the run, so the library's API has no knob for
it. For each count it prints the event ms (mean of 20 calls), the device ms
from torch.profiler, the fp32 workspace bytes of the launch, and checks
that dq does not depend on the count and that dq, dk, dv stay within the
plain backward's 2^-7 of max |ref|. The card's name and power limit come
first; the JSON goes to stdout and to ``chiprun_out/bwd_split_ab.json``.

Usage, on a CUDA machine, from the repo root:
  python tools/torch_bwd_split_ab.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SPLITS = (1, 2, 3, 4, 6, 8)


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


def device_ms(fn, iters=10):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        total_us += e.self_cuda_time_total if t is None else t
    return total_us / iters / 1e3 if total_us > 0 else None


def main() -> int:
    import torch

    from glimpseprune_torch.ops.cuda import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    bwd_splits = fa.bwd_splits
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(b, s, h, d):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)

    def segs(rows):
        return torch.tensor(rows, dtype=torch.int32, device="cuda")

    llm = segs([[0] * 832, [-1] * 100 + [0] * 732])
    fuser = segs([[0] * 400 + [1] * 300 + [-1] * 70] * 2)
    cases = [  # (name, B, Hq, Hkv, S, Dqk, Dv, segment ids, causal, q shard)
        ("llm_causal", 2, 28, 4, 832, 128, 128, llm, True, None),
        ("k9_half_shard", 2, 28, 4, 832, 128, 128, llm, True, (416, 832)),
        ("fuser", 2, 4, 4, 770, 192, 64, fuser, False, None),
        ("small_dense", 1, 4, 2, 256, 64, 64, None, False, None),
    ]
    report = {}
    for name, b, hq, hkv, s, dqk, dv, seg, causal, shard in cases:
        dense = seg is None
        q, k, v, dout = rand(b, s, hq, dqk), rand(b, s, hkv, dqk), rand(b, s, hkv, dv), \
            rand(b, s, hq, dv)
        qseg, qpos = seg, None
        if shard:
            lo, hi = shard
            q, dout, qseg = q[:, :, lo:hi], dout[:, :, lo:hi], seg[:, lo:hi]
            qpos = torch.arange(lo, hi, dtype=torch.int32,
                                device="cuda").expand(b, hi - lo).contiguous()
        out, lse = fa.flash_attention_lse(q, k, v, qseg, seg, causal=causal, dense=dense,
                                          q_positions=qpos)
        ref = fa.flash_attention_backward_reference(q.float(), k.float(), v.float(), qseg, seg,
                                                    out.float(), lse, dout.float(), causal,
                                                    dense, qpos)

        def call():
            return fa.flash_attention_backward(q, k, v, qseg, seg, out, lse, dout,
                                               causal=causal, dense=dense, q_positions=qpos)

        rule = fa.bwd_splits(b, hkv, s, fa._sm_count(0), causal)
        row, first_dq = {"rule": rule}, None
        for n in SPLITS:
            fa.bwd_splits = lambda *args, n=n: n
            try:
                grads = call()
                torch.cuda.synchronize()
                ws = fa.flash_attention_backward.last_split["workspace_bytes"]
                first_dq = grads[0] if first_dq is None else first_dq
                rel = [((g.float() - r).abs().max() / r.abs().max()).item()
                       for g, r in zip(grads, ref)]
                row[f"s{n}"] = {"ms": event_ms(call), "device_ms": device_ms(call),
                                "workspace_bytes": ws, "rel_err": rel,
                                "dq_equal_to_s1": torch.equal(grads[0], first_dq)}
            finally:
                fa.bwd_splits = bwd_splits
        report[name] = row
        print(name, json.dumps(row), flush=True)
    bad = [(c, n) for c, row in report.items() for n in SPLITS
           if not (row[f"s{n}"]["dq_equal_to_s1"] and max(row[f"s{n}"]["rel_err"]) <= 2 ** -7)]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bwd_split_ab.json").write_text(json.dumps(report, indent=1))
    if bad:
        print(f"checks failed at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
