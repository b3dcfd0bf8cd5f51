"""The ViT's windowed block and attention kernels at the 16k-token image's
65,536-patch shape, on the card: counterpart of
tools/sweep_vision_attention.py.

Defaults: P = 65,536 patches, H = 16 heads of D = 80, windows of wp = 64
patches, an MLP of 3420: the 7B's ViT (configs/model_qwen2_5_7b_gp, a
112 px window over 14 px patches). Sections, chosen by positional
arguments as in the JAX tool (default all three):

  1   K1 (``window_attention_fused``) at each heads-per-block count that
      divides H. It is K1's one runtime knob: ``plan_window`` picks 4, the
      C launcher takes any divisor, and the shared memory does not depend
      on it. ``heads_per_block`` swaps ``plan_window`` for the run and
      restores it, so the library has no knob for it. Every variant must be
      bit-equal to the shipped plan's output and within phase 3's limits of
      ``window_attention_fused_reference``. JAX's ``wins_per_step`` merged
      windows against the TPU's per-grid-step overhead: it has no
      counterpart here, where one block is one window and a group of heads.
  1b  The windowed block taken apart in the (q8) tier: int8 weights from
      ``quantize_int8`` on numpy normals at the JAX tool's scale of 1/36
      (its qkv and proj draws; gate, up and down and the biases drawn the
      same way), W8A8 products. JAX's rows (rms [P, 1280]; the qkv product;
      qkv -> reshape -> K1; the attention half-block: rms + qkv + K1 + proj
      + residual), then the MLP half and the whole ``VisionBlock.forward``
      window path; and the parts they add up to: each of the five products
      with its GEMM alone (``torch._int_mm`` on the operands the W8A8
      product builds) and the passes around it, K1, the SwiGLU, the
      residual add. The same products and block run in the weight-only
      int8 tier (act_quant "none"), the A/B of the two tiers. The products
      and the blocks list their kernels by name from one torch.profiler
      trace. K1's output inside the (q8) block and inside the weight-only
      block must hold phase 3's limits of its plain version on the qkv the
      block gave it; each whole block's distance from the same block with
      K1's plain version is printed, not held (``block_checks`` says why).
  2   Dense K2 at [1, H, P, D] (q = k = v, as in the JAX tool) beside
      ``scaled_dot_product_attention`` under each backend that runs at
      this shape (flash, memory-efficient, cuDNN; not math). JAX swept
      (block_q, block_k); K2's forward has one tile a head dim, fixed at
      compile time (6 warps of 16 q rows, 64-key tiles), so the section
      sets it beside the library instead.

Times: CUDA events over ``--iters`` calls after a warm-up, and the card's
own time from torch.profiler (``kernel_ab.measure``); no input is perturbed
and no round trip subtracted. Each row carries the bound (``kernel_ab.bound``)
and its share; the attention rows also the JAX tools' TF/s. K2 is checked
against its plain version on ``--check-rows`` q rows (the whole plain score
matrix would take 275 GB at 65,536); K1 on every row. The card's name and
power limit come first; the JSON goes to stdout and to
chiprun_out/sweep_vision_attention.json. Without a card it fails unless
given ``--device cpu``, which runs the plain versions (at small sizes) and
writes "not measured" for every time.

  python -m glimpseprune_torch.tools.sweep_vision_attention [1] [1b] [2]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from glimpseprune_torch.config import VisionConfig
from glimpseprune_torch.models.layers import QuantLinear
from glimpseprune_torch.models.qwen2_5_vl.vision import VisionBlock
from glimpseprune_torch.ops import attention
from glimpseprune_torch.ops.cuda import flash_attention as fa
from glimpseprune_torch.ops.cuda import window_attention as wa
from glimpseprune_torch.quantization import quantize_int8
from glimpseprune_torch.tools import kernel_ab as ab
from glimpseprune_torch.tools.common import resolve_device

TOOL = "sweep_vision_attention"
SECTIONS = ("1", "1b", "2")
LINEARS = ("qkv", "proj", "gate", "up", "down")
WEIGHT_SCALE = 1 / 36.0  # the JAX tool's draw (:104-105)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", choices=SECTIONS,
                    help="the sections to run (default all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--patches", type=int, default=65536)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--head-dim", type=int, default=80)
    ap.add_argument("--wp", type=int, default=64, help="patches a window")
    ap.add_argument("--intermediate", type=int, default=3420, help="the MLP's width")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a row")
    ap.add_argument("--check-rows", type=int, default=256,
                    help="q rows on which K2 is held to its plain version")
    ap.add_argument("--out", default=None, help="default chiprun_out/sweep_vision_attention.json")
    args = ap.parse_args(argv)
    args.sections = args.sections or list(SECTIONS)
    return args


# ---- section 1: K1's heads per block

def divisors(n: int):
    return tuple(g for g in range(1, n + 1) if n % g == 0)


@contextlib.contextmanager
def heads_per_block(g: int):
    """``plan_window`` with ``g`` heads a block in place of its own choice,
    the plan otherwise the shipped one; restored on exit, also when the
    body raises."""
    shipped = wa.plan_window

    def plan(dim, wp, heads, rope):
        return dataclasses.replace(shipped(dim, wp, heads, rope), heads_per_block=g)

    wa.plan_window = plan
    try:
        yield
    finally:
        wa.plan_window = shipped


def rope_inputs(p: int, d: int, dev, dtype, gen):
    """The JAX tool's cos and sin [P, D] (normals x 0.1, + 1 for cos) and
    every patch valid."""
    cos = (torch.randn((p, d), generator=gen, device=dev) * 0.1 + 1).to(dtype)
    sin = (torch.randn((p, d), generator=gen, device=dev) * 0.1).to(dtype)
    return cos, sin, torch.ones((p,), dtype=torch.bool, device=dev)


def window_inputs(p: int, h: int, d: int, dev, dtype, gen):
    """qkv [P, 3, H, D] normals, then ``rope_inputs``."""
    qkv = torch.randn((p, 3, h, d), generator=gen, device=dev).to(dtype)
    return (qkv,) + rope_inputs(p, d, dev, dtype, gen)


def k1_work(qkv, cos, sin, valid, wp: int, out):
    """K1's bound: QK^T and PV over each window's valid pairs, every head;
    qkv, cos, sin, valid read and out written once."""
    p, _, h, d = qkv.shape
    per_window = valid.reshape(-1, wp).sum(1).double()
    return ab.bound(4.0 * float((per_window ** 2).sum()) * h * d,
                    ab.nbytes(qkv, cos, sin, valid, out))


def k1_launches() -> int:
    return wa.window_attention_fused.launches


def section1(args, dev, dtype, gen) -> Dict[str, Any]:
    p, h, d, wp = args.patches, args.heads, args.head_dim, args.wp
    qkv, cos, sin, valid = window_inputs(p, h, d, dev, dtype, gen)
    ref = wa.window_attention_fused_reference(qkv.float(), cos.float(), sin.float(), valid, wp)
    shipped = wa.plan_window(d, wp, h, True).heads_per_block
    base = wa.window_attention_fused(qkv, cos, sin, valid, wp)
    bound_ms, bound_by = k1_work(qkv, cos, sin, valid, wp, base)
    rows, failures = [], []
    for g in divisors(h):
        with heads_per_block(g):
            fn = ab.Counted(lambda: wa.window_attention_fused(qkv, cos, sin, valid, wp),
                            k1_launches)
            got = fn()
            row = {"name": "window_attention_fused", "heads_per_block": g,
                   "shipped": g == shipped, "shape": f"qkv[{p},3,{h},{d}] wp={wp}",
                   **ab.checked(got, ref),
                   "bit_equal_to_shipped": bool(torch.equal(got, base)),
                   **ab.measure(fn, dev, args.iters, floor_ms=bound_ms),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            row["launches_per_call"] = fn.per_call()
        row["share"] = ab.share(bound_ms, row["ms"])
        rows.append(row)
        if not (row["ok"] and row["bit_equal_to_shipped"]):
            failures.append(f"K1 at {g} heads a block: {row}")
        print(f"section 1: K1 heads_per_block={g}: " + ab.brief(row), flush=True)
    failures += ab.launch_failures(rows, dev)
    return {"rows": rows, "shipped_heads_per_block": shipped,
            "plain_ms": ab.timed_plain(lambda: wa.window_attention_fused_reference(
                qkv, cos, sin, valid, wp), dev),
            "failures": failures}


# ---- section 1b: the windowed block taken apart

def tool_weights(fan_in: int, fan_out: int, seed: int) -> np.ndarray:
    """The JAX tool's draw: numpy normals [in, out] from ``seed`` over 36,
    as float32."""
    return (np.random.default_rng(seed).normal(size=(fan_in, fan_out)) * WEIGHT_SCALE
            ).astype(np.float32)


def block_linears(block: VisionBlock) -> Dict[str, torch.nn.Module]:
    return {"qkv": block.attn.qkv, "proj": block.attn.proj, "gate": block.mlp.gate_proj,
            "up": block.mlp.up_proj, "down": block.mlp.down_proj}


def make_block(hidden: int, heads: int, inter: int, dev, dtype, seed: int = 0) -> VisionBlock:
    """A windowed ViT block in the (q8) tier: the five linears' int8 weights
    by ``quantize_int8`` from ``tool_weights`` with seeds seed + 0..4 (qkv,
    proj, gate, up, down: the JAX tool's qkv and proj draws at seed 0), each
    bias a draw of the same scale from seeds seed + 5..9, norms of ones."""
    cfg = VisionConfig(hidden_size=hidden, num_heads=heads, intermediate_size=inter,
                       weight_quant="int8", act_quant="prefill")
    block = VisionBlock(cfg)
    shapes = {"qkv": (hidden, 3 * hidden), "proj": (hidden, hidden), "gate": (hidden, inter),
              "up": (hidden, inter), "down": (inter, hidden)}
    for i, name in enumerate(LINEARS):
        fan_in, fan_out = shapes[name]
        w = torch.from_numpy(tool_weights(fan_in, fan_out, seed + i)).to(dev)
        bias = np.random.default_rng(seed + len(LINEARS) + i).normal(size=fan_out) * WEIGHT_SCALE
        q = QuantLinear(quantize_int8(w), torch.from_numpy(bias.astype(np.float32)))
        owner, attr = {"qkv": (block.attn, "qkv"), "proj": (block.attn, "proj"),
                       "gate": (block.mlp, "gate_proj"), "up": (block.mlp, "up_proj"),
                       "down": (block.mlp, "down_proj")}[name]
        setattr(owner, attr, q)
    return block.to(dev, dtype)


def in_tier(block: VisionBlock, act_quant: str) -> VisionBlock:
    """The same block (its modules and weights shared) under another
    act_quant tier."""
    other = copy.copy(block)
    other.cfg = dataclasses.replace(block.cfg, act_quant=act_quant)
    return other


def a8_of(block: VisionBlock) -> bool:
    return block.cfg.act_quant in ("int8", "prefill")


def attention_half(block: VisionBlock, x, cos, sin, valid, wp: int):
    """x + proj(K1(qkv(rms(x)))): the first half of the block's window path
    (VisionBlock.forward)."""
    p, a8 = x.shape[0], a8_of(block)
    qkv = block.attn.qkv(block.norm1(x), a8).reshape(p, 3, -1, block.cfg.head_dim)
    return x + block.attn.proj(attention.fused_window_attention(qkv, cos, sin, valid, wp)
                               .reshape(p, -1), a8)


def mlp_half(block: VisionBlock, x):
    """x + down(act(gate(rms(x))) up(rms(x))): the block's second half."""
    return x + block.mlp(block.norm2(x), a8_of(block))


@contextlib.contextmanager
def model_window_attention(fn):
    """The model's window attention (ops/attention.py's K1 entry) through
    ``fn``, restored on exit."""
    real = attention.window_attention_fused
    attention.window_attention_fused = fn
    try:
        yield
    finally:
        attention.window_attention_fused = real


def recording(seen: List):
    """K1, recording each call's (inputs, output) in ``seen``."""
    def call(qkv, cos, sin, valid, wp):
        out = wa.window_attention_fused(qkv, cos, sin, valid, wp)
        seen.append(((qkv, cos, sin, valid, wp), out))
        return out
    return call


def block_checks(block, weight_only, x, cos, sin, valid, wp: int) -> Dict[str, Any]:
    """K1's output inside the (q8) block and inside the weight-only block,
    each against its plain version on the qkv that block gave it, within
    phase 3's limits (held: "k1_in_q8_block", "k1_in_weight_only_block").
    Beside them, not held, each whole block with K1 against the same block
    with K1's plain version, and the (q8) block against the weight-only
    one. K1, like Pallas, rounds P to bf16, so its output moves by ~2^-9
    against the plain version's; every later rounding then falls
    differently for many values (W8A8 rounds each activation row to int8
    by its amax, bf16 products and sums round to 8 bits), and the block's
    output moves by that rounding noise: measured on an H100, 1.6% RMS in
    (q8) and 0.4% weight-only, above phase 3's 2^-8 although the rest of
    the block is the same code in both runs."""
    out: Dict[str, Any] = {}
    blocks = {}
    for tier, blk in (("q8", block), ("weight_only", weight_only)):
        seen: List = []
        with model_window_attention(recording(seen)):
            got = blk(x, cos, sin, None, valid, wp)
        (qkv, cos_, sin_, valid_, wp_), k1_out = seen[0]
        ref_k1 = wa.window_attention_fused_reference(qkv.float(), cos_.float(), sin_.float(),
                                                     valid_, wp_)
        out[f"k1_in_{tier}_block"] = ab.checked(k1_out, ref_k1)
        del seen, qkv, k1_out, ref_k1
        with model_window_attention(wa.window_attention_fused_reference):
            ref = blk(x, cos, sin, None, valid, wp)
        out[f"{tier}_block_not_held"] = ab.checked(got, ref, atol=None)
        blocks[tier] = got
    out["q8_against_weight_only_not_held"] = ab.checked(blocks["q8"], blocks["weight_only"],
                                                        atol=None)
    return out


@contextlib.contextmanager
def int_mm_operands(seen: List):
    """Records the operands of every ``torch._int_mm`` call in ``seen``."""
    real = torch._int_mm

    def spy(a, b):
        seen.append((a, b))
        return real(a, b)

    torch._int_mm = spy
    try:
        yield
    finally:
        torch._int_mm = real


def product_row(name: str, lin: QuantLinear, inp, a8: bool, args, dev) -> Dict[str, Any]:
    """One linear of the block in a tier (W8A8, or weight-only: the weight
    dequantized, then a bf16 GEMM), bias included; its kernels by name, and
    its GEMM alone: ``torch._int_mm`` on the operands the product built, or
    the matmul with the weight dequantized once."""
    m, k = inp.shape
    n = lin.out_features
    fn = ab.Counted(lambda: lin(inp, a8))
    seen: List = []
    with int_mm_operands(seen):
        out = fn()
    if a8 and seen:
        gemm = (lambda a=seen[0][0], b=seen[0][1]: torch._int_mm(a, b))
    elif a8:  # the CPU's exact int32 product: no _int_mm
        gemm = None
    else:
        w = lin.kernel_q.to(inp.dtype) * lin.kernel_scale.to(inp.dtype)
        gemm = (lambda: inp @ w)
    ops = 2.0 * m * k * n
    bound_ms, bound_by = ab.bound(0.0 if a8 else ops,
                                  ab.nbytes(inp, lin.kernel_q, lin.kernel_scale, lin.bias, out),
                                  ops if a8 else 0.0)
    row = {"name": f"{'w8a8' if a8 else 'weight-only'} {name}", "shape": f"[{m},{k}]x[{k},{n}]",
           **ab.measure(fn, dev, args.iters, by_kernel=True, floor_ms=bound_ms),
           "bound_ms": bound_ms, "bound_by": bound_by}
    gemm_ms = (ab.NOT_MEASURED if gemm is None or dev.type != "cuda"
               else ab.measure(gemm, dev, args.iters, floor_ms=ab.bound(
                   0.0 if a8 else ops, 0, ops if a8 else 0.0)[0])["device_ms"])
    row["gemm_device_ms"] = gemm_ms
    row["passes_device_ms"] = (ab.NOT_MEASURED if ab.NOT_MEASURED in (gemm_ms, row["device_ms"])
                               else row["device_ms"] - gemm_ms)
    row["share"] = ab.share(bound_ms, row["ms"])
    ab.top_kernels(row)
    return row


def timed_row(name: str, shape: str, fn, work, args, dev, by_kernel: bool = False,
              counter=None) -> Dict[str, Any]:
    """A row of event and device ms, the bound ``work`` = (ms, by), the
    share, and the K1 launches a call where ``counter`` is given."""
    call = ab.Counted(fn, counter)
    call()
    row = {"name": name, "shape": shape,
           **ab.measure(call, dev, args.iters, by_kernel, floor_ms=work[0]),
           "bound_ms": work[0], "bound_by": work[1]}
    row["share"] = ab.share(work[0], row["ms"])
    if by_kernel:
        ab.top_kernels(row)
    if counter is not None:
        row["launches_per_call"] = call.per_call()
    return row


def total(times):
    """The sum of device times, or NOT_MEASURED if one is."""
    times = list(times)
    return ab.NOT_MEASURED if ab.NOT_MEASURED in times else sum(times)


def section1b(args, dev, dtype, gen) -> Dict[str, Any]:
    p, h, d, wp = args.patches, args.heads, args.head_dim, args.wp
    hid, inter = h * d, args.intermediate
    block = make_block(hid, h, inter, dev, dtype)
    weight_only = in_tier(block, "none")
    lin = block_linears(block)
    x = torch.randn((p, hid), generator=gen, device=dev).to(dtype)
    cos, sin, valid = rope_inputs(p, d, dev, dtype, gen)
    # each product's input as the (q8) block computes it
    h1 = block.norm1(x)
    qkv = lin["qkv"](h1, True).reshape(p, 3, h, d)
    attn = attention.fused_window_attention(qkv, cos, sin, valid, wp).reshape(p, hid)
    x1 = x + lin["proj"](attn, True)
    hm = block.norm2(x1)
    gate, up = lin["gate"](hm, True), lin["up"](hm, True)
    act = block.mlp.act(gate) * up
    inputs = {"qkv": h1, "proj": attn, "gate": hm, "up": hm, "down": act}
    weights = sum(ab.nbytes(m.kernel_q, m.kernel_scale, m.bias) for m in lin.values())
    mm_ops = 2.0 * p * sum(m.in_features * m.out_features for m in lin.values())
    attn_flops = 4.0 * p * wp * h * d
    rows: Dict[str, Any] = {}

    def add(row):
        rows[row["name"]] = row
        print("section 1b: " + ab.brief(row), flush=True)
        if isinstance(row.get("kernels"), dict):  # device ms and launches a call
            for name, (ms, n) in row["kernels"].items():
                print(f"    {ms:.4f} ms x{n} {name}", flush=True)

    rms_bytes = ab.nbytes(x, block.norm1.weight, h1)
    add(timed_row("rms", f"[{p},{hid}]", lambda: block.norm1(x), ab.bound(0.0, rms_bytes), args,
                  dev))
    for a8 in (True, False):
        for name in LINEARS:
            add(product_row(name, lin[name], inputs[name], a8, args, dev))
    add(timed_row("K1", f"qkv[{p},3,{h},{d}] wp={wp}",
                  lambda: attention.fused_window_attention(qkv, cos, sin, valid, wp),
                  k1_work(qkv, cos, sin, valid, wp, attn), args, dev, counter=k1_launches))
    add(timed_row("qkv(w8a8) -> reshape -> K1", f"[{p},{hid}]x[{hid},{3 * hid}], wp={wp}",
                  lambda: attention.fused_window_attention(
                      lin["qkv"](h1, True).reshape(p, 3, h, d), cos, sin, valid, wp),
                  ab.bound(attn_flops, ab.nbytes(h1, lin["qkv"].kernel_q, cos, sin, valid, attn),
                           2.0 * p * hid * 3 * hid), args, dev, counter=k1_launches))
    add(timed_row("swiglu", f"[{p},{inter}]", lambda: block.mlp.act(gate) * up,
                  ab.bound(0.0, ab.nbytes(gate, up, act)), args, dev))
    add(timed_row("residual add", f"[{p},{hid}]", lambda: x + x1,
                  ab.bound(0.0, 3 * ab.nbytes(x)), args, dev))
    add(timed_row("attention half (w8a8)", f"[{p},{hid}]",
                  lambda: attention_half(block, x, cos, sin, valid, wp),
                  ab.bound(attn_flops, ab.nbytes(x, cos, sin, valid, x, lin["qkv"].kernel_q,
                                                 lin["proj"].kernel_q),
                           2.0 * p * hid * 4 * hid), args, dev, counter=k1_launches))
    add(timed_row("mlp half (w8a8)", f"[{p},{hid}] -> {inter}", lambda: mlp_half(block, x1),
                  ab.bound(0.0, 2 * ab.nbytes(x) + ab.nbytes(lin["gate"].kernel_q,
                                                             lin["up"].kernel_q,
                                                             lin["down"].kernel_q),
                           6.0 * p * hid * inter), args, dev))
    block_bytes = 2 * ab.nbytes(x) + ab.nbytes(cos, sin, valid) + weights
    for tier, blk, a8 in (("w8a8", block, True), ("weight-only", weight_only, False)):
        add(timed_row(f"block ({tier})", f"x[{p},{hid}] wp={wp} mlp {inter}",
                      lambda blk=blk: blk(x, cos, sin, None, valid, wp),
                      ab.bound(attn_flops + (0.0 if a8 else mm_ops), block_bytes,
                               mm_ops if a8 else 0.0),
                      args, dev, by_kernel=True, counter=k1_launches))
    checks = block_checks(block, weight_only, x, cos, sin, valid, wp)
    failures = [f"section 1b {k}: {v}" for k, v in checks.items()
                if not k.endswith("not_held") and not v["ok"]]
    failures += ab.launch_failures(rows.values(), dev)
    sums = {}
    for tier in ("w8a8", "weight-only"):
        products = [rows[f"{tier} {n}"] for n in LINEARS]
        parts = [rows["rms"]] * 2 + products + [rows["K1"], rows["swiglu"]] + [
            rows["residual add"]] * 2
        sums[tier] = {"parts_device_ms": total(r["device_ms"] for r in parts),
                      "block_device_ms": rows[f"block ({tier})"]["device_ms"],
                      "passes_device_ms": total(r["passes_device_ms"] for r in products),
                      "gemm_device_ms": total(r["gemm_device_ms"] for r in products)}
    return {"rows": rows, "sums": sums, "block_checks": checks, "failures": failures}


# ---- section 2: dense K2 beside the library

def k2_and_library(args, dev, q, k, v, seg, flavours, idx):
    """K2 in each of ``flavours`` ("dense"; "segmented" over ``seg`` [B, S],
    which must make one segment) on q, k, v [B, H, S, D], then SDPA (no
    mask: the same function) under each backend, each held to the plain
    version's output at q rows ``idx`` -> rows, K2's first (with the plain
    version's ms on those rows; a backend that refuses the shape gives a
    row with its error)."""
    b, h, s, d = q.shape

    def plain(flavour="dense"):
        sg = None if flavour == "dense" else seg
        return fa.flash_attention_reference(q[:, :, idx].float(), k.float(), v.float(),
                                            None if sg is None else sg[:, idx], sg,
                                            dense=flavour == "dense")

    ref = plain()
    flops = 4.0 * ab.attention_pairs(s, False) * h * d * b
    tflop = ab.jax_tflop(b, h, s, d, False)
    shape = f"[{b},{h},{s},{d}]"
    rows = []
    for flavour in flavours:
        sg = None if flavour == "dense" else seg
        rows.append(ab.attention_row(
            f"flash_attention[{flavour}]", shape,
            lambda sg=sg, flavour=flavour: fa.flash_attention(q, k, v, sg, sg,
                                                              dense=flavour == "dense"),
            dev, args.iters, ab.bound(flops, ab.nbytes(q, k, v, q) + 2 * ab.nbytes(sg)), tflop,
            ref, idx, lambda flavour=flavour: fa.flash_attention.launches[flavour],
            plain=lambda flavour=flavour: plain(flavour)))
    for name in ab.SDPA_BACKENDS:
        def sdpa(name=name):
            with ab.sdpa_backend(name):
                return F.scaled_dot_product_attention(q, k, v)
        rows.append(ab.attention_row(f"sdpa[{name}]", shape, sdpa, dev, args.iters,
                                     ab.bound(flops, ab.nbytes(q, k, v, q)), tflop, ref, idx,
                                     refusable=True))
    for row in rows:
        print("attention: " + ab.brief(row), flush=True)
    return rows


def section2(args, dev, dtype, gen) -> Dict[str, Any]:
    p, h, d = args.patches, args.heads, args.head_dim
    q = torch.randn((1, h, p, d), generator=gen, device=dev).to(dtype)
    idx = ab.check_rows(p, args.check_rows, dev)
    rows = k2_and_library(args, dev, q, q, q, None, ("dense",), idx)
    failures = [f"{r['name']}: {r}" for r in rows[:1] if not r["ok"]]
    failures += ab.launch_failures(rows, dev)
    return {"rows": rows, "check_rows": int(idx.numel()), "failures": failures}


def run(args) -> Dict[str, Any]:
    """The sections asked for -> the record (its "failures" list empty when
    every check held)."""
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    card = ab.card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"tool": TOOL, "card": card, "device": str(dev),
              "shape": {"patches": args.patches, "heads": args.heads, "head_dim": args.head_dim,
                        "wp": args.wp, "intermediate": args.intermediate},
              "iters": args.iters, "sections": {}, "failures": []}
    for name, section in (("1", section1), ("1b", section1b), ("2", section2)):
        if name in args.sections:
            with torch.inference_mode():
                out = section(args, dev, dtype, gen)
            record["failures"] += out.pop("failures")
            record["sections"][name] = out
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return record


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the sections, write the report; SystemExit if a check failed."""
    args = parse_args(argv)
    record = run(args)
    ab.write_report(TOOL, record, args.out)
    if record["failures"]:
        raise SystemExit(f"{TOOL}: {len(record['failures'])} checks failed: "
                         f"{record['failures'][:3]}")
    return record


if __name__ == "__main__":
    main()
