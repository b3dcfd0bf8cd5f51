"""K2 (bf16) against K7 (int8 QK^T, and with the int8 PV product) at a ViT
shape and an LLM shape, on the card: counterpart of
tools/i8attn_microbench.py.

JAX's flags and shapes: the ViT's dense bidirectional attention
[1, 16, S, 80] (``--s-vit``; 65,536 is the 16k-token image's operating
point) and the LLM's causal prefill [1, 28, S, 128] with k and v at 28
heads (``--s-llm``), both 8192 by default; ``--skip-vit`` / ``--skip-llm``
leave one out. q, k and v come from numpy.random.default_rng(0), as in JAX.
The variants: bf16 (K2), qk8 (K7) and all8 (K7 with pv_int8), and bf16
``scaled_dot_product_attention`` beside them. JAX's ``all8-bk1024`` and
``all8-bq2048`` are TPU tiles: on the card K7's kv tile is KERNEL_BLOCK_K
(64), and ``flash_attention`` refuses another block_k, so they have no row.

Each row: event ms (CUDA events over ``--iters`` calls after a warm-up),
device ms (torch.profiler; for K7 its prep kernel's and its attention
kernel's apart), the bound and its share, the JAX tool's TF/s (4 S^2 D H,
halved when causal), the launches a call, and the output held to the plain
version of its own arithmetic (``flash_attention_reference``, or
``flash_attention_int8_reference`` at the kernel's kv tile) on
``--check-rows`` q rows. The card's name and power limit come first; the
JSON goes to stdout and to chiprun_out/i8attn_microbench.json. Without a
card it fails unless given ``--device cpu`` (plain versions, small sizes,
"not measured" for every time).

  python -m glimpseprune_torch.tools.i8attn_microbench [--s-vit 65536] [--skip-llm]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from glimpseprune_torch.ops.cuda import flash_attention as fa
from glimpseprune_torch.ops.kv_cache import quantize_kv
from glimpseprune_torch.tools import kernel_ab as ab
from glimpseprune_torch.tools.common import resolve_device

TOOL = "i8attn_microbench"
# (name, qkv_int8, pv_int8), as JAX's VARIANTS less its TPU tiles
VARIANTS = (("bf16", False, False), ("qk8", True, False), ("all8", True, True))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--s-vit", type=int, default=8192)
    ap.add_argument("--s-llm", type=int, default=8192)
    ap.add_argument("--skip-llm", action="store_true")
    ap.add_argument("--skip-vit", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a row")
    ap.add_argument("--check-rows", type=int, default=256,
                    help="q rows on which each output is held to its plain version")
    ap.add_argument("--out", default=None, help="default chiprun_out/i8attn_microbench.json")
    return ap.parse_args(argv)


def variant_rows(args, dev, name: str, h: int, s: int, d: int, causal: bool
                 ) -> List[Dict[str, Any]]:
    """The three variants and SDPA at [1, h, s, d] -> rows."""
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    q, k, v = ab.numpy_qkv(1, h, s, d, dev, dtype)
    seg = torch.zeros((1, s), dtype=torch.int32, device=dev)
    dense = not causal
    idx = ab.check_rows(s, args.check_rows, dev)
    qpos = idx[None] if causal else None
    pairs = ab.attention_pairs(s, causal)
    half = 2.0 * pairs * h * d  # QK^T's operations, and PV's
    io = ab.nbytes(q, k, v, q) + (0 if dense else 2 * ab.nbytes(seg))
    tflop = ab.jax_tflop(1, h, s, d, causal)
    shape = f"{name} [1,{h},{s},{d}]{' causal' if causal else ''}"
    k8, ksc = quantize_kv(k)
    q8, qsc = quantize_kv(q[:, :, idx])
    rows = []
    for variant, qk8, pv8 in VARIANTS:
        if qk8:
            def plain(pv8=pv8):
                return fa.flash_attention_int8_reference(
                    q8, k8, v, qsc, ksc, seg[:, idx], seg, causal, dense, pv8,
                    fa.KERNEL_BLOCK_K, torch.float32, qpos)
            work = ab.bound(0.0 if pv8 else half, io, half * (2 if pv8 else 1))
            fl = fa.flavour(causal, dense, d, d) + ("+pv8" if pv8 else "")
            counter = (lambda fl=fl: fa.flash_attention_int8.launches[fl])
        else:
            def plain():
                return fa.flash_attention_reference(q[:, :, idx].float(), k.float(), v.float(),
                                                    seg[:, idx], seg, causal, dense, qpos)
            work = ab.bound(2 * half, io)
            fl = fa.flavour(causal, dense, d, d)
            counter = (lambda fl=fl: fa.flash_attention.launches[fl])
        row = ab.attention_row(
            variant, shape,
            lambda qk8=qk8, pv8=pv8: fa.flash_attention(
                q, k, v, seg, seg, causal=causal, dense=dense, qkv_int8=qk8, pv_int8=pv8,
                block_k=fa.KERNEL_BLOCK_K if qk8 else None),
            dev, args.iters, work, tflop, plain(), idx, counter, by_kernel=True, plain=plain)
        if qk8:  # K7's two kernels apart, each once a call
            row["prep_device_ms"], row["attention_device_ms"] = (
                k7_part(row, "i8::prep_kernel"), k7_part(row, "i8::attn_kernel"))
        ab.top_kernels(row)
        rows.append(row)
    ref = fa.flash_attention_reference(q[:, :, idx].float(), k.float(), v.float(), seg[:, idx],
                                       seg, causal, dense, qpos)
    rows.append(ab.attention_row(
        "sdpa", shape, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), dev,
        args.iters, ab.bound(2 * half, ab.nbytes(q, k, v, q)), tflop, ref, idx))
    for row in rows:
        print(f"{name}: " + ab.brief(row), flush=True)
    return rows


def k7_part(row, tag: str):
    """The device ms of K7's kernel named by ``tag`` in a row's trace; it
    must have launched once a call."""
    if row["kernels"] == ab.NOT_MEASURED:
        return ab.NOT_MEASURED
    names = [n for n in row["kernels"] if tag in n]
    if len(names) != 1 or row["kernel_launches"][names[0]] != 1:
        raise AssertionError(f"K7: {tag} launches a call {row['kernel_launches']}")
    return row["kernels"][names[0]]


def run(args) -> Dict[str, Any]:
    """-> the record (its "failures" list empty when every check held)."""
    dev = resolve_device(args.device)
    card = ab.card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    shapes = {}
    with torch.inference_mode():
        if not args.skip_vit:
            shapes["vit"] = variant_rows(args, dev, "vit", 16, args.s_vit, 80, False)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if not args.skip_llm:
            shapes["llm"] = variant_rows(args, dev, "llm", 28, args.s_llm, 128, True)
    failures = [f"{name} {r['name']}: {r}" for name, rows in shapes.items() for r in rows[:3]
                if not r["ok"]]
    failures += [f for rows in shapes.values() for f in ab.launch_failures(rows, dev)]
    return {"tool": TOOL, "card": card, "device": str(dev), "iters": args.iters,
            "check_rows": args.check_rows,
            "shapes": shapes, "failures": failures}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run, write the report; SystemExit if a check failed."""
    args = parse_args(argv)
    record = run(args)
    ab.write_report(TOOL, record, args.out)
    if record["failures"]:
        raise SystemExit(f"{TOOL}: {len(record['failures'])} checks failed: "
                         f"{record['failures'][:3]}")
    return record


if __name__ == "__main__":
    main()
