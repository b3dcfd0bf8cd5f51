#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``glimpseprune_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. find the card and print its name and power limit;
  2. build the CUDA kernels from glimpseprune_torch/csrc/, one nvcc per
     source, all at once (timed);
  3. K1, the fused window attention, and K8, window attention on roped
     q, k, v, each against its plain version at the 7B ViT's windowed shape,
     also relative to the output's size (K1 with the plain version's P in
     4 bits, K8 with K1 run on the same q, k, v, which ropes them a second
     time, as controls that must fail the check), then both on edge cases:
     a window with one valid key, trailing pad windows, the tiny config's
     head dim;
  4. K2, flash attention, against its plain version at each serving call
     site: ViT dense and segmented, LLM causal GQA, fuser Dqk != Dv, also
     relative to the output's size (controls that must fail: the plain
     version with P in 4 bits, and without key tile 0); then
     K2, K2-lse and K3 on edge cases: Sq and Skv that are no multiple of a
     tile, the tiny config's head dims (8, 16, 8/4), GQA group 7 with
     left-padded rows and a q tile that is all padding, and rows with no
     allowed key (output exactly 0, LSE exactly -1e30, dq exactly 0; dk and
     dv exactly 0 for keys no query sees);
  5. K2-lse (flash attention with the per-row LSE) and K3 (its backward)
     against their plain versions at the training batch's LLM causal GQA
     and fuser Dqk != Dv shapes, and at a small dense case: K3's dq, dk,
     dv each within GRAD_RTOL and relative to their size (2^-7 max, 2^-8
     RMS), with controls that must fail (the plain backward with dS in 4
     bits, and without key tile 0), and bit-identical over two calls;
  6. the serving path: Qwen2.5-VL-7B with the GlimpsePrune config and
     random bf16 weights, pruned and unpruned ``generate`` on a two-row
     batch and a one-row batch, with the kernels' launch counts; then the
     tiny config on the card against the same weights on the CPU in fp32;
  7. the training path: ``GPTrainer.train(max_steps=4)`` at batch 2 on the
     same 7B model over a synthetic jsonl dataset, with the kernels' launch
     counts, finite losses, changed trainable and bit-identical frozen
     weights; then one tiny-config train step on the card against the CPU;
  8. K4 (int4 decode product) at the 7B decode shapes, K5 and K6 (int4
     prefill products, W4A16 and W4A8) at the 7B decoder shapes with
     M = 1664, and K7 (int8 flash attention) dense, segmented and causal,
     with and without the int8 PV product, each against its plain version
     (K7 also against the other PV flavour and bf16 attention, which it
     must not pass: the check tells the int8 tiers apart);
  9. the quantized serving path: a fresh random 7B (``init_random``, seed
     0), quantized on the card with ``quantize_model``, in two tiers: (q8)
     int8 weights with W8A8 prefill and an int8 KV cache, pruned and
     unpruned ``generate`` on batch (a); (q4) int4 weights with W4A8
     prefill, int8 ViT attention and an int8 KV cache, pruned and unpruned
     on batches (a) and (b). Each run prints its times, peak memory, weight
     and KV-cache bytes and the first logits' distance from the bf16
     model's; each tier ends with its tiny config on the card against the
     CPU;
 10. the compressed serving path (run after phase 6, before training
     changes the model): ``generate_compressed`` with each baseline
     compressor (visionzip, divprune, cdpruner, vscan, pdrop) on batches
     (a) and (b), with keep counts, prune ratios, times and launch counts
     (K8 must not launch: no config in configs/ has a windowed block that
     emits importance); then K8 on the importance path of the same 7B bound
     to a vision config that is not in configs/, whose last block is
     windowed (full attention at blocks 7, 15, 23): one launch per ViT
     call; a two-block tower of that kind on the card against the CPU; and
     the tiny config's compressed prefill (visionzip, pdrop) on the card
     against the CPU;
 11. sequence parallelism: K9 (the flash kernel's q_positions flavours:
     forward, LSE, backward, int8) on batch (a)'s causal shape with the q
     rows cut into 2 and 4 shards and one unaligned shard, against its plain
     versions and the monolithic K2 / K2-lse / K3 / K7 (with a control that
     must fail; the backward held as in phase 5); then SP_WORLD ranks on
     this one card over gloo, started by the port's launcher, each
     building the 7B from seed 0 (checked by a checksum all-gather): SP
     generate pruned and unpruned on batches (a)
     and (b) against rank 0's single-process run (first-logit and mask-logit
     distance, keep counts, tokens, K9 launches per prefill by the
     per-call-site rule), the training batch's gradients under SP against
     one process and two SP train steps, one SP (q8) generate with the text
     attention in int8 (K9-int8), and the tiny config under SP on the card
     against the CPU; times from CUDA events and peaks per rank.
Every kernel row carries its time (CUDA events over 10 calls; for K1, K8,
K2, K2-lse, K3 and K9 also ``device_ms``, the card's own time from
torch.profiler, without the host's launch cost), its plain version's time, one PyTorch
call's time where one computes the same function (``library_ms``: SDPA
with the same boolean mask, or its autograd backward; a yardstick the port
never calls; for the int4 products, where no PyTorch call computes the
function, null with ``bf16_matmul_ms`` beside it: the bf16 matmul of the
same shape that the unquantized path pays) and ``bound_ms``: the larger of
its bytes over the card's memory rate and its operations over the tensor
peak of their type (bf16, or int8 for the int8 products), counted from this
run's inputs. Before the summary, one "speed" line per kernel row gives its
time beside the time PERF.md records for it before the tensor-core
redesign of K1, K8, K2 and K3 (``RECORDED_MS``), the rate it reached and its
share of the bound. The line before the last is a JSON object with one
entry per kernel flavour; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
K1_SRC = "glimpseprune_torch/csrc/window_attention.cu"
K1_REPLACES = "glimpseprune_tpu/ops/pallas/window_attention.py:133"
K8_REPLACES = "glimpseprune_tpu/ops/pallas/window_attention.py:198"
K2_SRC = "glimpseprune_torch/csrc/flash_attention.cu"
K2_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:400"
K2_LSE_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:208"
K3_SRC = "glimpseprune_torch/csrc/flash_attention_bwd.cu"
K3_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:808"
INT4_SRC = "glimpseprune_torch/csrc/int4_matmul.cu"
K4_REPLACES = "glimpseprune_tpu/ops/pallas/int4_matmul.py:103"
K56_REPLACES = "glimpseprune_tpu/ops/pallas/int4_matmul.py:283"
K7_REPLACES = {"dense": "glimpseprune_tpu/ops/pallas/flash_attention.py:200",
               "segmented": "glimpseprune_tpu/ops/pallas/flash_attention.py:175",
               "causal": "glimpseprune_tpu/ops/pallas/flash_attention.py:175"}
K9_REPLACES = {"flash_attention": "glimpseprune_tpu/ops/pallas/flash_attention.py:183",
               "flash_attention_lse": "glimpseprune_tpu/ops/pallas/flash_attention.py:216",
               "flash_attention_backward": "glimpseprune_tpu/ops/pallas/flash_attention.py:341",
               "flash_attention_int8": "glimpseprune_tpu/ops/pallas/flash_attention.py:191"}
KERNEL_LIBS = ("window_attention", "flash_attention", "flash_attention_bwd", "int4_matmul")
# Kernels run in bf16 and their plain versions in fp32 from the same bf16
# inputs, so the two differ by the kernel's bf16 output rounding (half an
# ulp: |x| * 2**-9, under 0.016 for the |x| < 8 these attention outputs
# stay within) plus fp32 summation order (~1e-6). 2e-2 bounds both.
KERNEL_ATOL = 2e-2
# K3's dq, dk and dv are bf16 (rounding 2**-9 of the largest entry) from
# fp32 sums taken in another order than the plain version's, over up to a
# GQA group of 7 q heads times ~900 rows: 1e-2 of max |ref| bounds both.
# The LSE is fp32 from the same fp32 scores: 1e-4 of max |ref| bounds the
# summation order of its row sums.
GRAD_RTOL = 1e-2
LSE_RTOL = 1e-4
# K4-K6 write bf16 from fp32 (K4, K5) or exact int32 (K6) sums: the output
# rounding is at most 2**-8 (bf16's unit roundoff, 3.9e-3) of the largest
# |ref|, the fp32 summation order adds ~1e-6 of it; K6's rescale is the
# plain version's, operation for operation. 4e-3 of max |ref| bounds both,
# with ~2% over the worst-case rounding (measured 2.1e-3 to 3.4e-3).
INT4_RTOL = 4e-3
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
# 3e-2), so a kernel that dropped either fails; check_flash_int8 shows it
# on every run by holding each kernel output against the other references.
K7_MAX_RTOL = 2 ** -7
K7_RMS_RTOL = 2 ** -8
# K1 and K2 at the main path's shapes are held to the same two limits
# beside KERNEL_ATOL, since their outputs are as small: like Pallas they
# round P to bf16 before PV (unit roundoff 2**-8 of each probability, ~2.3e-3
# RMS of the output) and round the output to bf16. Controls that must fail:
# the plain version with P rounded to 4 significant bits (~2.7e-2 RMS off)
# and, for K2, without key tile 0 (control_attention).
# H100 SXM published peaks (NVIDIA data sheet, dense): the bf16 and int8
# tensor rates and HBM bandwidth; bound_ms is stated against them.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
# Each kernel's time as PERF.md's kernel table records it for the CUDA-core
# kernels that the tensor-core K1, K8, K2 and K3 flavours replace (K3's and
# K9 backward's from the last run before their redesign) and for the
# kernels kept as they are, mean ms of 10 calls on an NVIDIA H100 80GB HBM3
# at 700 W at the same shapes: printed beside this run's time.
RECORDED_MS = {
    "window_attention_fused": 0.2946, "window_attention": 0.3016,
    "flash_attention[dense]": 3.7256, "flash_attention[segmented]": 5.4423,
    "flash_attention[causal]": 0.6203, "flash_attention[dqk_ne_dv]": 0.3383,
    "flash_attention_lse[causal]": 0.9003, "flash_attention_lse[dqk_ne_dv]": 0.3417,
    "flash_attention_backward[causal]": 4.4222, "flash_attention_backward[dqk_ne_dv]": 0.8967,
    "matmul_int4[3584x3584]": 0.0434, "matmul_int4[3584x512]": 0.0554,
    "matmul_int4[3584x18944]": 0.0745, "matmul_int4[18944x3584]": 0.0793,
    "matmul_int4[3584x152064]": 0.9781,
    "matmul_int4_prefill[a16,3584x3584]": 2.1540, "matmul_int4_prefill[a16,3584x512]": 0.5300,
    "matmul_int4_prefill[a16,3584x18944]": 10.4312,
    "matmul_int4_prefill[a16,18944x3584]": 12.0072,
    "matmul_int4_prefill[a8,3584x3584]": 0.8007, "matmul_int4_prefill[a8,3584x512]": 0.4945,
    "matmul_int4_prefill[a8,3584x18944]": 3.2937, "matmul_int4_prefill[a8,18944x3584]": 4.6463,
    "flash_attention_int8[dense]": 3.1134, "flash_attention_int8[dense+pv8]": 4.3081,
    "flash_attention_int8[segmented]": 4.5792, "flash_attention_int8[segmented+pv8]": 6.2714,
    "flash_attention_int8[causal]": 0.6453, "flash_attention_int8[causal+pv8]": 0.8228,
    "flash_attention[causal+qpos]": 0.5879, "flash_attention_lse[causal+qpos]": 0.5886,
    "flash_attention_backward[causal+qpos]": 2.5345, "flash_attention_int8[causal+qpos]": 0.5461,
}
# sequence parallelism on the one card: two ranks over gloo (NCCL refuses
# two ranks on one device)
SP_WORLD = 2
MAX_NEW_TOKENS = 32
TRAIN_STEPS = 4
COMPRESSORS = ("visionzip", "divprune", "cdpruner", "vscan", "pdrop")
COMPRESSED_NEW_TOKENS = 8
# the image-token budget of divprune, cdpruner and vscan (the papers' 128
# setting): under every row's image-token count, so each row really prunes
VISUAL_TOKEN_NUM = 128
# full attention at three of the 7B's four blocks: the last one is windowed,
# so its importance goes through K8 (a config that is not in configs/)
WINDOWED_LAST_FULLATT = (7, 15, 23)


def find_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def build_kernels():
    """Every kernel library at once: one nvcc process per source."""
    from glimpseprune_torch.ops.cuda.build import library_path, load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        list(pool.map(load_library, KERNEL_LIBS))
    for name in KERNEL_LIBS:
        print(f"built {name}: {library_path(name).with_suffix('.log').read_text().strip()}")
    secs = time.perf_counter() - t0
    print(f"kernel build: {secs:.1f} s")
    return secs


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch

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


def device_ms(fn, iters: int = 10, tries: int = 3):
    """Mean device time of the CUDA kernels one call of ``fn`` launches, from
    torch.profiler: the card's own time, without the host's launch cost,
    which cuda_ms includes when the host is slower than the card. A trace
    that recorded no device time is taken again, up to ``tries`` times;
    then the time is None (not measured), never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def self_us(e):  # the attribute's name in PyTorch >= 2.4, and before
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(self_us(e) for e in prof.key_averages())
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(least ms, what bounds it) from bf16 operations, int8 operations and
    bytes."""
    ops_ms = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def speed(row) -> str:
    """The line that prints a kernel row's time beside its recorded time,
    the achieved rate and the share of the bound; the row is left as it
    is. The rate is the bound's work over this run's time: GB/s for a bytes
    bound, TFLOP/s (TOP/s for the int8 products) for an operations bound."""
    share = row["bound_ms"] / row["ms"]
    int8 = row["name"].startswith(("flash_attention_int8", "matmul_int4_prefill[a8"))
    if row["bound_by"] == "bytes":
        rate = f"{share * PEAK_HBM_BYTES / 1e9:.0f} GB/s"
    elif int8:
        rate = f"{share * PEAK_INT8_OPS / 1e12:.1f} TOP/s"
    else:
        rate = f"{share * PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s"
    recorded = RECORDED_MS.get(row["name"])
    before = ("" if recorded is None
              else f", recorded {recorded:.4f} ms ({recorded / row['ms']:.1f}x)")
    device = ""
    if "device_ms" in row:  # the card's own time, and the library call's
        device = f"; on the card {fmt_ms(row['device_ms'])}"
        if "library_device_ms" in row:
            device += f" (library {fmt_ms(row['library_device_ms'])})"
    return (f"speed {row['name']} {row.get('shape', '')}: {row['ms']:.4f} ms{before}, {rate}, "
            f"{share:.1%} of the bound ({row['bound_by']}){device}")


def check_window_attention(cfg, prep, gen):
    """K1 at the ViT shape the batch gives it (H=16, D=80, wp=64), within
    KERNEL_ATOL and relative to its outputs' size (K7_MAX_RTOL, K7_RMS_RTOL),
    with the plain version's P rounded to 4 significant bits as the control
    that must fail."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention_fused,
        window_attention_fused_reference,
    )
    from glimpseprune_torch.ops.rope import rotate_half, vision_rope_cos_sin

    v = cfg.vision
    wp = (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 * v.spatial_merge_unit
    p = prep.patches.shape[0]
    qkv = torch.randn((p, 3, v.num_heads, v.head_dim), generator=gen, device="cuda").bfloat16()
    cos, sin = vision_rope_cos_sin(torch.as_tensor(prep.vis_pos_ids, device="cuda"), v.head_dim)
    cos, sin = cos.bfloat16(), sin.bfloat16()
    valid = torch.as_tensor(prep.vis_valid, device="cuda")
    got = window_attention_fused(qkv, cos, sin, valid, wp)
    torch.cuda.synchronize()
    ref = window_attention_fused_reference(qkv.float(), cos.float(), sin.float(), valid, wp)
    err = (got.float() - ref).abs().max().item()
    errs = k7_errors(got, ref)
    x, c, s = qkv.float(), cos.float()[:, None], sin.float()[:, None]
    nw = p // wp

    def windows(t):
        return t.reshape(nw, wp, v.num_heads, v.head_dim).transpose(1, 2)

    allowed = valid.reshape(nw, 1, 1, wp) | torch.eye(wp, dtype=torch.bool, device="cuda")
    control = control_attention(windows(x[:, 0] * c + rotate_half(x[:, 0]) * s),
                                windows(x[:, 1] * c + rotate_half(x[:, 1]) * s),
                                windows(x[:, 2]), allowed, round_p=True)
    control_errs = k7_errors(got, control.transpose(1, 2).reshape(got.shape))
    ms = cuda_ms(lambda: window_attention_fused(qkv, cos, sin, valid, wp))
    dev_ms = device_ms(lambda: window_attention_fused(qkv, cos, sin, valid, wp))
    plain_ms = cuda_ms(lambda: window_attention_fused_reference(qkv, cos, sin, valid, wp))
    # valid queries x valid keys of each window, QK^T and PV, every head
    per_window = valid.reshape(-1, wp).sum(1).double()
    flops = 4.0 * float((per_window ** 2).sum()) * v.num_heads * v.head_dim
    bound_ms, bound_by = bound(flops, nbytes(qkv, cos, sin, valid, got))
    shape = f"qkv[{p},3,{v.num_heads},{v.head_dim}] wp={wp} valid={int(valid.sum())}"
    print(f"K1 window_attention_fused {shape}: max_abs_err={err:.3e} rel_err={errs[0]:.3e} "
          f"rms_rel_err={errs[1]:.3e}; control p_4_bits (max/rms rel) "
          f"{control_errs[0]:.3e}/{control_errs[1]:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not (err <= KERNEL_ATOL and k7_within(errs)):
        raise AssertionError(f"K1 disagrees with its plain version: {err}, {errs}")
    if k7_within(control_errs):
        raise AssertionError("K1: the check cannot tell the kernel from P in 4 bits")
    # no single PyTorch call applies rope and attends within windows
    return {"name": "window_attention_fused", "route": "cuda", "source": K1_SRC,
            "replaces": K1_REPLACES, "max_abs_err": err, "rel_err": errs[0],
            "rms_rel_err": errs[1], "control_rms_rel_err": control_errs[1], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape}


def check_window_attention_unfused(cfg, prep, gen):
    """K8 at the 7B ViT's windowed shape (q, k, v [P, 16, 80], wp=64) with
    the batch's padded windows, held relative to its outputs' size as K7 is
    (bf16 output rounding; K7_MAX_RTOL, K7_RMS_RTOL). Control: K1 on the
    same q, k, v stacked as its qkv input ropes q and k a second time, and
    must fail the same check."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention,
        window_attention_fused,
        window_attention_reference,
    )
    from glimpseprune_torch.ops.rope import vision_rope_cos_sin

    v = cfg.vision
    wp = (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 * v.spatial_merge_unit
    p = prep.patches.shape[0]
    q, k, vv = (torch.randn((p, v.num_heads, v.head_dim), generator=gen, device="cuda")
                .bfloat16() for _ in range(3))
    valid = torch.as_tensor(prep.vis_valid, device="cuda")
    got = window_attention(q, k, vv, valid, wp)
    torch.cuda.synchronize()
    ref = window_attention_reference(q.float(), k.float(), vv.float(), valid, wp)
    errs = k7_errors(got, ref)
    cos, sin = vision_rope_cos_sin(torch.as_tensor(prep.vis_pos_ids, device="cuda"), v.head_dim)
    control = window_attention_fused(torch.stack([q, k, vv], 1).contiguous(), cos.bfloat16(),
                                     sin.bfloat16(), valid, wp)
    control_errs = k7_errors(control, ref)
    ms = cuda_ms(lambda: window_attention(q, k, vv, valid, wp))
    plain_ms = cuda_ms(lambda: window_attention_reference(q, k, vv, valid, wp))
    nw = p // wp

    def windows(t):
        return t.reshape(nw, wp, v.num_heads, v.head_dim).transpose(1, 2)

    # one SDPA call over the windows with the same mask computes K8's function
    mask = valid.reshape(nw, 1, 1, wp) | torch.eye(wp, dtype=torch.bool, device="cuda")
    qw, kw, vw = windows(q), windows(k), windows(vv)
    lib_ms = cuda_ms(lambda: sdpa(qw, kw, vw, mask))
    dev_ms = device_ms(lambda: window_attention(q, k, vv, valid, wp))
    lib_dev_ms = device_ms(lambda: sdpa(qw, kw, vw, mask))
    per_window = valid.reshape(-1, wp).sum(1).double()
    flops = 4.0 * float((per_window ** 2).sum()) * v.num_heads * v.head_dim
    bound_ms, bound_by = bound(flops, nbytes(q, k, vv, valid, got))
    shape = f"q/k/v[{p},{v.num_heads},{v.head_dim}] wp={wp} valid={int(valid.sum())}"
    err = (got.float() - ref).abs().max().item()
    print(f"K8 window_attention {shape}: max_abs_err={err:.3e} rel_err={errs[0]:.3e} "
          f"rms_rel_err={errs[1]:.3e}; K1 control (roped twice, max/rms rel) "
          f"{control_errs[0]:.3e}/{control_errs[1]:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not k7_within(errs):
        raise AssertionError(f"K8 disagrees with its plain version: {errs}")
    if k7_within(control_errs):
        raise AssertionError("K8: the check cannot tell roped from twice-roped q and k")
    return {"name": "window_attention", "route": "cuda", "source": K1_SRC,
            "replaces": K8_REPLACES, "max_abs_err": err, "rel_err": errs[0],
            "rms_rel_err": errs[1], "control_rms_rel_err": control_errs[1], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "shape": shape}


def check_window_edges(gen):
    """K1 and K8 against their plain versions, within KERNEL_ATOL, on windows
    the ViT batch does not hold: a fully valid window, a window with one
    valid key, a random half, and trailing pad windows (no valid key: each
    row attends to itself), at the 7B's head dim (80, wp=64) and at the
    tiny config's (8, wp=16, 4 heads)."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        plan_window,
        window_attention,
        window_attention_fused,
        window_attention_fused_reference,
        window_attention_reference,
    )

    report = {}
    for name, heads, dim, wp in (("7b", 16, 80, 64), ("tiny", 4, 8, 16)):
        n_win = 6
        valid = torch.zeros((n_win, wp), dtype=torch.bool, device="cuda")
        valid[0] = True
        valid[1, 5 % wp] = True
        valid[2] = torch.rand((wp,), generator=gen, device="cuda") < 0.5
        valid = valid.reshape(-1)  # windows 3-5: trailing pads
        p = n_win * wp
        qkv = torch.randn((p, 3, heads, dim), generator=gen, device="cuda").bfloat16()
        theta = torch.rand((p, dim), generator=gen, device="cuda") * 6.3
        cos, sin = theta.cos().bfloat16(), theta.sin().bfloat16()
        q, k, v = (torch.randn((p, heads, dim), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        got1 = window_attention_fused(qkv, cos, sin, valid, wp)
        got8 = window_attention(q, k, v, valid, wp)
        torch.cuda.synchronize()
        ref1 = window_attention_fused_reference(qkv.float(), cos.float(), sin.float(), valid, wp)
        ref8 = window_attention_reference(q.float(), k.float(), v.float(), valid, wp)
        errs = {"K1": (got1.float() - ref1).abs().max().item(),
                "K8": (got8.float() - ref8).abs().max().item()}
        # a pad window's row attends to itself only: its output is its v row
        pad_rows = slice(3 * wp, p)
        errs["K8_pad_rows_equal_v"] = torch.equal(got8[pad_rows], v[pad_rows])
        report[name] = {"shape": f"P={p} H={heads} D={dim} wp={wp}",
                        "plan": plan_window(dim, wp, heads, True).__dict__, **errs}
        if not (errs["K1"] <= KERNEL_ATOL and errs["K8"] <= KERNEL_ATOL
                and errs["K8_pad_rows_equal_v"]):
            raise AssertionError(f"K1/K8 edge cases ({name}) disagree with their plain "
                                 f"versions: {report[name]}")
    print("K1/K8 edge cases (one-key window, trailing pad windows, tiny dims), max abs err: "
          + json.dumps(report))
    return report


def attention_case(gen, b, hq, hkv, s, d_qk, d_v, segs, causal):
    """Random bf16 q, k, v as [B, H, S, D] views of [B, S, H, D] buffers
    (as the model passes them), the allowed-pair count and SDPA's mask."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import allowed_mask

    def rand(h, d):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)

    q, k, v = rand(hq, d_qk), rand(hkv, d_qk), rand(hkv, d_v)
    dense = segs is None
    allowed = allowed_mask(segs, segs, b, s, s, causal, dense, "cuda")
    mask = None if dense else allowed[:, None]
    return q, k, v, int(allowed.sum()), mask


def sdpa(q, k, v, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=q.shape[1] != k.shape[1])


def control_attention(q, k, v, allowed, round_p: bool = False, drop_keys: int = 0):
    """A wrong plain version that the relative check must refuse: fp32
    softmax attention with each probability rounded to 4 significant bits
    (round_p: fp8 e4m3's mantissa, without its range), or without keys
    [0, drop_keys) (a dropped k tile). q [B, Hq, Sq, D]; k, v [B, Hkv, Skv,
    D]; allowed [B, 1, Sq, Skv] bool, or None for every key; a row with no
    allowed key gives 0."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import NEG_INF

    g = q.shape[1] // k.shape[1]
    kf, vf = k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    scores = q.float() @ kf.transpose(-1, -2) * q.shape[-1] ** -0.5
    if allowed is None:
        allowed = torch.ones((1, 1) + scores.shape[2:], dtype=torch.bool, device=q.device)
    if drop_keys:
        allowed = allowed.clone()
        allowed[..., :drop_keys] = False
    p = torch.softmax(scores.masked_fill(~allowed, NEG_INF), -1)
    del scores
    if round_p:
        mant, exp = torch.frexp(p)
        p = torch.ldexp(torch.round(mant * 16) / 16, exp)
    return (p @ vf).masked_fill(~allowed.any(-1, keepdim=True), 0.0)


def check_flash_attention(cfg, prep_a, prep_b, gen):
    """K2 at its four serving call sites."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_reference,
        flavour,
    )

    v, t, gp = cfg.vision, cfg.text, cfg.gp
    n_fuse = len(gp.selected_visual_layers)
    dqk = (gp.attn_fuse_size + (gp.visual_cond_size if n_fuse else 0)) // gp.attn_fuse_num_heads
    dv = gp.attn_fuse_size // gp.attn_fuse_num_heads

    def seg(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")

    cases = [
        # (name, B, Hq, Hkv, S, Dqk, Dv, segment ids or None, causal)
        ("vit_dense", 1, v.num_heads, v.num_heads, prep_b.patches.shape[0], v.head_dim,
         v.head_dim, None, False),
        ("vit_segmented", 1, v.num_heads, v.num_heads, prep_a.patches.shape[0], v.head_dim,
         v.head_dim, seg(prep_a.full_seg[None]), False),
        ("llm_causal", prep_a.valid.shape[0], t.num_attention_heads, t.num_key_value_heads,
         prep_a.valid.shape[1], t.head_dim, t.head_dim,
         seg(np.where(prep_a.valid, 0, -1)), True),
        ("fuser", prep_a.fuser.segment_ids.shape[0], gp.attn_fuse_num_heads,
         gp.attn_fuse_num_heads, prep_a.fuser.segment_ids.shape[1], dqk, dv,
         seg(prep_a.fuser.segment_ids), False),
    ]
    rows = []
    for name, b, hq, hkv, s, d_qk, d_v, segs, causal in cases:
        q, k, vv, pairs, mask = attention_case(gen, b, hq, hkv, s, d_qk, d_v, segs, causal)
        dense = segs is None
        got = flash_attention(q, k, vv, segs, segs, causal=causal, dense=dense)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q.float(), k.float(), vv.float(), segs, segs,
                                        causal=causal, dense=dense)
        err = (got.float() - ref).abs().max().item()
        errs = k7_errors(got, ref)
        control_errs = {
            "p_4_bits": k7_errors(got, control_attention(q, k, vv, mask, round_p=True)),
            "k_tile_0_dropped": k7_errors(got, control_attention(q, k, vv, mask, drop_keys=64))}
        ms = cuda_ms(lambda: flash_attention(q, k, vv, segs, segs, causal=causal, dense=dense))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, vv, segs, segs,
                                                             causal=causal, dense=dense))
        lib_ms = cuda_ms(lambda: sdpa(q, k, vv, mask))
        dev_ms = device_ms(lambda: flash_attention(q, k, vv, segs, segs, causal=causal,
                                                   dense=dense))
        lib_dev_ms = device_ms(lambda: sdpa(q, k, vv, mask))
        bound_ms, bound_by = bound(2.0 * pairs * hq * (d_qk + d_v),
                                   nbytes(q, k, vv, got) + (0 if dense else 2 * segs.nbytes))
        fl = flavour(causal, dense, d_qk, d_v)
        shape = f"{name} q[{b},{hq},{s},{d_qk}] kv[{b},{hkv},{s},{d_qk}/{d_v}]"
        print(f"K2 flash_attention[{fl}] {shape}: max_abs_err={err:.3e} "
              f"rel_err={errs[0]:.3e} rms_rel_err={errs[1]:.3e}; controls (max/rms rel) "
              + ", ".join(f"{c} {e[0]:.3e}/{e[1]:.3e}" for c, e in control_errs.items())
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= KERNEL_ATOL and k7_within(errs)):
            raise AssertionError(f"K2 {name} disagrees with its plain version: {err}, {errs}")
        passed = [c for c, e in control_errs.items() if k7_within(e)]
        if passed:
            raise AssertionError(f"K2 {name}: the check cannot tell the kernel from {passed}")
        rows.append({"name": f"flash_attention[{fl}]", "route": "cuda", "source": K2_SRC,
                     "replaces": K2_REPLACES, "max_abs_err": err, "rel_err": errs[0],
                     "rms_rel_err": errs[1],
                     "control_rms_rel_err": min(e[1] for e in control_errs.values()), "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms, "shape": shape})
    return rows


def check_flash_edges(gen):
    """K2, K2-lse and K3 against their plain versions on shapes the main
    path does not reach: Sq and Skv that are no multiple of a tile, the tiny
    config's head dims (8, 16, 8/4), GQA group 7 with left-padded rows and
    a q tile that is all padding, and rows with no allowed key (output
    exactly 0, LSE exactly -1e30). K2 and K2-lse must agree bit for bit.
    K3 runs on K2-lse's output and LSE (check_backward's limits, no
    controls); its dq is exactly 0 on rows with no allowed key (pad rows
    among them), its dk and dv exactly 0 for keys that no query sees."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        NEG_INF,
        allowed_mask,
        flash_attention,
        flash_attention_lse,
        flash_attention_lse_reference,
        plan_flash,
    )

    def seg(rows):
        return torch.as_tensor(np.asarray(rows), dtype=torch.int32, device="cuda")

    def left_padded(pads, s):
        return seg([[-1] * n + [0] * (s - n) for n in pads])

    two = seg([[0] * 150 + [1] * 120 + [-1] * 63])
    cases = [
        # (name, B, Hq, Hkv, Sq, Skv, Dqk, Dv, q segment ids, kv segment ids, causal)
        ("ragged_dense", 2, 4, 2, 130, 197, 80, 80, None, None, False),
        ("ragged_segmented_trailing_pad", 1, 4, 4, 333, 333, 80, 80, two, two, False),
        ("tiny_vit", 1, 4, 4, 100, 100, 8, 8, seg([[0] * 60 + [1] * 40]),
         seg([[0] * 60 + [1] * 40]), False),
        ("tiny_llm", 2, 4, 2, 23, 23, 16, 16, left_padded((5, 0), 23),
         left_padded((5, 0), 23), True),
        ("tiny_fuser", 2, 4, 4, 37, 37, 8, 4, seg([[0] * 20 + [1] * 10 + [-1] * 7, [0] * 37]),
         seg([[0] * 20 + [1] * 10 + [-1] * 7, [0] * 37]), False),
        ("gqa7_left_padded", 2, 28, 4, 300, 300, 128, 128, left_padded((150, 37), 300),
         left_padded((150, 37), 300), True),
        ("no_allowed_key", 1, 4, 4, 96, 160, 64, 64, seg([[0] * 40 + [7] * 30 + [1] * 26]),
         seg([[0] * 100 + [1] * 60]), False),
        ("dqk_ne_dv_ragged", 1, 2, 2, 77, 77, 192, 64, seg([[0] * 50 + [1] * 27]),
         seg([[0] * 50 + [1] * 27]), False),
    ]
    report = {}
    for name, b, hq, hkv, sq, skv, d_qk, d_v, qseg, kseg, causal in cases:
        dense = qseg is None

        def rand(s, h, d):
            x = torch.randn((b, s, h, d), generator=gen, device="cuda")
            return x.bfloat16().transpose(1, 2)

        q, k, v = rand(sq, hq, d_qk), rand(skv, hkv, d_qk), rand(skv, hkv, d_v)
        out = flash_attention(q, k, v, qseg, kseg, causal=causal, dense=dense)
        out_l, lse = flash_attention_lse(q, k, v, qseg, kseg, causal=causal, dense=dense)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_lse_reference(q.float(), k.float(), v.float(), qseg, kseg,
                                                     causal=causal, dense=dense)
        seen = ref_lse > -1e29
        r = {"err": (out.float() - ref).abs().max().item(),
             "lse_rel_err": rel_err(lse, ref_lse, seen) if seen.any() else 0.0,
             "rows_without_key": int((~seen).sum()),
             "their_output_zero": bool((out_l[~seen] == 0).all()),
             "their_lse_-1e30": bool((lse[~seen] == NEG_INF).all()),
             "k2_equals_k2_lse": torch.equal(out, out_l),
             "plan": plan_flash(d_qk, d_v, skv).__dict__}
        report[name] = r
        if not (r["err"] <= KERNEL_ATOL and r["lse_rel_err"] <= LSE_RTOL
                and r["their_output_zero"] and r["their_lse_-1e30"] and r["k2_equals_k2_lse"]
                and torch.equal(lse <= -1e29, ~seen)):
            raise AssertionError(f"K2 edge case {name} fails: {r}")
        dout = rand(sq, hq, d_v)
        bwd = check_backward(f"K3 edge case {name}", q, k, v, qseg, kseg, out_l, lse, dout,
                             causal, dense, with_controls=False)
        dq, dk, dv = bwd.pop("grads")
        unseen_keys = ~allowed_mask(qseg, kseg, b, sq, skv, causal, dense, "cuda").any(1)
        bwd["dq_zero_on_rows_without_key"] = bool((dq[~seen] == 0).all())
        bwd["keys_no_query_sees"] = int(unseen_keys.sum())
        bwd["dk_dv_zero_there"] = bool((dk.transpose(1, 2)[unseen_keys] == 0).all()
                                       and (dv.transpose(1, 2)[unseen_keys] == 0).all())
        r["backward"] = bwd
        if not (bwd["dq_zero_on_rows_without_key"] and bwd["dk_dv_zero_there"]):
            raise AssertionError(f"K3 edge case {name}: no exact zeros where due: {bwd}")
    print("K2/K2-lse/K3 edge cases against the plain version: " + json.dumps(report))
    return report


def rel_err(got, ref, rows=None) -> float:
    """max |got - ref| / max |ref|, over the selected rows."""
    g, r = got.float(), ref.float()
    if rows is not None:
        g, r = g[rows], r[rows]
    return ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()


def control_backward(q, k, v, qseg, kseg, out, lse, dout, causal, dense, q_positions=None,
                     round_ds: bool = False, drop_keys: int = 0):
    """A wrong plain backward that the relative check must refuse: the fp32
    backward with dS rounded to 4 significant bits (round_ds), or without
    keys [0, drop_keys) (a dropped k tile, the LSE kept). Same arguments and
    result as flash_attention_backward_reference."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import LOG2E, NEG_INF, allowed_mask

    b, hq, sq, dqk = q.shape
    hkv, skv, dv = v.shape[1], v.shape[2], v.shape[3]
    g = hq // hkv
    qf, kf, vf = q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    allowed = allowed_mask(qseg, kseg, b, sq, skv, causal, dense, q.device, q_positions)[:, None]
    allowed = allowed & (lse > NEG_INF / 2)[..., None]
    if drop_keys:
        allowed[..., :drop_keys] = False
    p = torch.exp2(qf @ kf.transpose(-1, -2) * (LOG2E / dqk ** 0.5) - lse[..., None])
    p = p.masked_fill(~allowed, 0.0)
    del allowed
    dof = dout.float()
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * out.float()).sum(-1)[..., None])
    if round_ds:
        mant, exp = torch.frexp(ds)
        ds = torch.ldexp(torch.round(mant * 16) / 16, exp)
    dq = ds @ kf / dqk ** 0.5
    dk = (ds.transpose(-1, -2) @ qf / dqk ** 0.5).reshape(b, hkv, g, skv, dqk).sum(2)
    dvv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, g, skv, dv).sum(2)
    return dq, dk, dvv


def check_backward(name, q, k, v, qseg, kseg, out, lse, dout, causal, dense, q_positions=None,
                   with_controls: bool = True):
    """K3 (K9's backward with q_positions) against its plain version on one
    input: each of dq, dk, dv within GRAD_RTOL of max |ref| and within the
    relative limits K7_MAX_RTOL / K7_RMS_RTOL (k7_errors); with_controls,
    two controls (dS in 4 bits, key tile 0 dropped) must miss both limits
    on the gradients they change; a second call gives bit-identical dq, dk,
    dv.
    -> the errors (and, under "grads", the kernel's gradients); raises on a
    failure."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
    )

    def call():
        return flash_attention_backward(q, k, v, qseg, kseg, out, lse, dout, causal=causal,
                                        dense=dense, q_positions=q_positions)

    grads, again = call(), call()
    torch.cuda.synchronize()
    args = (q.float(), k.float(), v.float(), qseg, kseg, out.float(), lse, dout.float(),
            causal, dense, q_positions)
    refs = flash_attention_backward_reference(*args)
    rel = [rel_err(g, r) for g, r in zip(grads, refs)]
    errs = [k7_errors(g, r) for g, r in zip(grads, refs)]
    abs_err = max((g.float() - r).abs().max().item() for g, r in zip(grads, refs))
    del refs
    controls = {}
    for control, kw in ((("ds_4_bits", dict(round_ds=True)),
                         ("k_tile_0_dropped", dict(drop_keys=64))) if with_controls else ()):
        ctrl = control_backward(*args, **kw)
        e = [k7_errors(g, c) for g, c in zip(grads, ctrl)]
        del ctrl
        controls[control] = (max(x[0] for x in e), max(x[1] for x in e))
    r = {"max_abs_err": abs_err, "rel_err": max(rel), "rel_err_dq_dk_dv": rel,
         "k7_errs_dq_dk_dv": errs, "controls": controls,
         "deterministic": all(torch.equal(a, b) for a, b in zip(grads, again))}
    if not (max(rel) <= GRAD_RTOL and all(k7_within(e) for e in errs)):
        raise AssertionError(f"{name} disagrees with its plain version: {r}")
    passed = [c for c, e in controls.items() if e[0] <= K7_MAX_RTOL or e[1] <= K7_RMS_RTOL]
    if passed:
        raise AssertionError(f"{name}: the check cannot tell the kernel from {passed}: {r}")
    if not r["deterministic"]:
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    r["grads"] = grads
    return r


def bwd_summary(r) -> str:
    """One line of check_backward's errors."""
    return ("rel_err dq/dk/dv " + "/".join(f"{e:.2e}" for e in r["rel_err_dq_dk_dv"])
            + ", max/rms rel " + ", ".join(f"{e[0]:.2e}/{e[1]:.2e}" for e in r["k7_errs_dq_dk_dv"])
            + "; controls (max/rms rel) "
            + ", ".join(f"{c} {e[0]:.2e}/{e[1]:.2e}" for c, e in r["controls"].items())
            + f"; deterministic {r['deterministic']}")


def sdpa_backward_ms(q, k, v, mask, dout):
    """(event ms, device ms) of SDPA's autograd backward with the same
    boolean mask: the yardstick of K3 and K9's backward."""
    import torch

    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(qr, kr, vr, mask)

    def call():
        return torch.autograd.grad(lib_out, (qr, kr, vr), dout, retain_graph=True)

    return cuda_ms(call), device_ms(call)


def check_flash_training(cfg, batch, gen):
    """K2-lse and K3 at the training batch's LLM causal GQA and fuser
    shapes (the flavours the training path launches), and a small dense
    case; -> (rows for the kernels line, the dense case's errors)."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_lse,
        flash_attention_lse_reference,
        flavour,
    )

    t, gp = cfg.text, cfg.gp
    dqk = (gp.attn_fuse_size + gp.visual_cond_size) // gp.attn_fuse_num_heads
    dv = gp.attn_fuse_size // gp.attn_fuse_num_heads
    valid, fseg = batch["valid"], batch["fuser_segment_ids"].int()
    b, s = valid.shape
    cases = [
        ("llm_causal", b, t.num_attention_heads, t.num_key_value_heads, s, t.head_dim,
         t.head_dim, torch.where(valid, 0, -1).int(), True),
        ("fuser", b, gp.attn_fuse_num_heads, gp.attn_fuse_num_heads, fseg.shape[1], dqk, dv,
         fseg, False),
        ("small_dense", 1, 4, 2, 256, 64, 64, None, False),
    ]
    rows, dense_check = [], {}
    for name, b, hq, hkv, s, d_qk, d_v, segs, causal in cases:
        dense = segs is None
        q, k, v, pairs, mask = attention_case(gen, b, hq, hkv, s, d_qk, d_v, segs, causal)
        fl = flavour(causal, dense, d_qk, d_v)
        shape = f"{name} q[{b},{hq},{s},{d_qk}] kv[{b},{hkv},{s},{d_qk}/{d_v}]"
        seg_bytes = 0 if dense else 2 * segs.nbytes
        # K2-lse: output and LSE against the plain fp32 version
        out, lse = flash_attention_lse(q, k, v, segs, segs, causal=causal, dense=dense)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_lse_reference(q.float(), k.float(), v.float(), segs,
                                                         segs, causal=causal, dense=dense)
        seen = ref_lse > -1e29
        out_err = (out.float() - ref_out).abs().max().item()
        lse_err = rel_err(lse, ref_lse, seen)
        if not (out_err <= KERNEL_ATOL and lse_err <= LSE_RTOL
                and torch.equal(lse <= -1e29, ~seen)):
            raise AssertionError(f"K2-lse {name} disagrees with its plain version: "
                                 f"out {out_err}, lse {lse_err}")
        ms = cuda_ms(lambda: flash_attention_lse(q, k, v, segs, segs, causal=causal,
                                                 dense=dense))
        plain_ms = cuda_ms(lambda: flash_attention_lse_reference(q, k, v, segs, segs,
                                                                 causal=causal, dense=dense))
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, mask))
        dev_ms = device_ms(lambda: flash_attention_lse(q, k, v, segs, segs, causal=causal,
                                                       dense=dense))
        lib_dev_ms = device_ms(lambda: sdpa(q, k, v, mask))
        bound_ms, bound_by = bound(2.0 * pairs * hq * (d_qk + d_v),
                                   nbytes(q, k, v, out, lse) + seg_bytes)
        print(f"K2-lse flash_attention_lse[{fl}] {shape}: max_abs_err={out_err:.3e} "
              f"lse_rel_err={lse_err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by})")
        lse_row = {"name": f"flash_attention_lse[{fl}]", "route": "cuda", "source": K2_SRC,
                   "replaces": K2_LSE_REPLACES, "max_abs_err": out_err, "lse_rel_err": lse_err,
                   "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms,
                   "library_device_ms": lib_dev_ms, "shape": shape}

        # K3: dq, dk, dv against the plain fp32 backward on the same
        # inputs (the kernel's own forward output and LSE), per gradient
        # within GRAD_RTOL and relative to its size, with controls that
        # must fail, and bit-identical from call to call
        dout = torch.randn(out.transpose(1, 2).shape, generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)
        bwd = check_backward(f"K3 {name}", q, k, v, segs, segs, out, lse, dout, causal, dense)
        grads = bwd.pop("grads")

        def call():
            return flash_attention_backward(q, k, v, segs, segs, out, lse, dout, causal=causal,
                                            dense=dense)

        ms = cuda_ms(call)
        # the dkv chunks and fp32 workspace of the launches just timed
        split = dict(flash_attention_backward.last_split)
        dev_ms = device_ms(call)
        plain_ms = cuda_ms(lambda: flash_attention_backward_reference(
            q, k, v, segs, segs, out, lse, dout, causal=causal, dense=dense))
        lib_ms, lib_dev_ms = sdpa_backward_ms(q, k, v, mask, dout)
        bound_ms, bound_by = bound(2.0 * pairs * hq * (3 * d_qk + 2 * d_v),
                                   nbytes(q, k, v, out, lse, dout, *grads) + seg_bytes)
        print(f"K3 flash_attention_backward[{fl}] {shape}: {bwd_summary(bwd)}; kernel {ms:.4f} ms "
              f"(card {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms "
              f"(card {fmt_ms(lib_dev_ms)}), bound {bound_ms:.4f} ms ({bound_by}); dkv split "
              f"{split['splits']}x ({split['workspace_bytes']} bytes of workspace)")
        bwd_row = {"name": f"flash_attention_backward[{fl}]", "route": "cuda",
                   "source": K3_SRC, "replaces": K3_REPLACES, **bwd, **split, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms,
                   "library_device_ms": lib_dev_ms, "shape": shape}
        if dense:  # not on the training path: checked, not listed
            dense_check = {"lse_rel_err": lse_err, **bwd, "lse_ms": lse_row["ms"], "bwd_ms": ms,
                           "bwd_device_ms": dev_ms}
        else:
            rows += [lse_row, bwd_row]
    return rows, dense_check


def make_prompts(cfg, rng, n_rows, lo, hi, text_len=(20, 9)):
    """Random prompt ids in [lo, hi) with one image marker per row."""
    prompts = []
    for b in range(n_rows):
        prompts.append(
            [int(x) for x in rng.integers(lo, hi, 12)]
            + [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
            + [int(x) for x in rng.integers(lo, hi, text_len[b % len(text_len)])])
    return prompts


def timed_ms(fn):
    """(CUDA-event milliseconds of one call, its result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_outputs(cfg, prep, pre, res, do_selection):
    """Shapes, finiteness and the keep policy's bounds on one generate."""
    import torch

    b = prep.input_ids.shape[0]
    assert pre.logits.shape == (b, 1, cfg.text.vocab_size), pre.logits.shape
    assert torch.isfinite(pre.logits.float()).all(), "non-finite prefill logits"
    assert res.sequences.shape == (b, MAX_NEW_TOKENS), res.sequences.shape
    assert ((res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all()
    assert ((res.num_generated >= 0) & (res.num_generated <= MAX_NEW_TOKENS)).all()
    if not do_selection:
        assert res.keep_img is None
        return
    gp = cfg.gp
    keep, img_valid = res.keep_img, prep.img_valid
    assert not (keep & ~img_valid).any(), "kept a padding slot"
    n_valid = img_valid.sum(1)
    cap = np.floor(np.float32(gp.max_remain_ratio) * n_valid.astype(np.float32))
    kept = keep.sum(1)
    assert (kept >= np.minimum(gp.min_remain_num, n_valid)).all(), kept
    assert (kept <= np.maximum(cap, gp.min_remain_num)).all(), (kept, cap)
    mask = pre.mask_logits.float()[:, torch.as_tensor(img_valid, device=pre.mask_logits.device)]
    assert torch.isfinite(mask).all(), "non-finite mask logits"
    le = gp.le_length if gp.has_le else 0
    n_text = prep.valid.sum(1) - prep.n_img_tokens - le
    assert (pre.valid.sum(1).cpu().numpy() == n_text + kept).all(), "compaction lost tokens"


def reset_launches():
    from collections import Counter

    from glimpseprune_torch.ops.cuda.flash_attention import (
        FLAVOURS,
        INT8_FLAVOURS,
        flash_attention,
        flash_attention_backward,
        flash_attention_int8,
        flash_attention_lse,
    )
    from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4, matmul_int4_prefill
    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention,
        window_attention_fused,
    )

    window_attention_fused.launches = 0
    window_attention.launches = 0
    for fn in (flash_attention, flash_attention_lse, flash_attention_backward):
        fn.launches = dict.fromkeys(FLAVOURS, 0)
    flash_attention_int8.launches = dict.fromkeys(INT8_FLAVOURS, 0)
    matmul_int4.launches = Counter()
    matmul_int4_prefill.launches = Counter()


def read_launches(required):
    """{row name: launches} since reset_launches(); raises if a kernel that
    the path must run was never launched. An entry of ``required`` that
    ends in "*]" asks for any launch of the rows it starts."""
    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_int8,
        flash_attention_lse,
    )
    from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4, matmul_int4_prefill
    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention,
        window_attention_fused,
    )

    launches = {"window_attention_fused": window_attention_fused.launches,
                "window_attention": window_attention.launches}
    for fn in (flash_attention, flash_attention_lse, flash_attention_backward,
               flash_attention_int8, matmul_int4, matmul_int4_prefill):
        launches.update({f"{fn.__name__}[{k}]": v for k, v in fn.launches.items()})

    def count(name):
        if name.endswith("*]"):
            return sum(v for k, v in launches.items() if k.startswith(name[:-2]))
        return launches.get(name, 0)

    missing = [k for k in required if count(k) == 0]
    if missing:
        raise AssertionError(f"the path never launched {missing}")
    return launches


def run_main_path(cfg, model, cases):
    """Pruned and unpruned generate on each prepared batch; returns per-run
    timings and the kernels' launch counts."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    runner = GlimpsePruneRunner(cfg, model)
    reset_launches()
    runs = []
    for name, prep in cases:
        for do_sel in (True, False):
            mode = "pruned" if do_sel else "unpruned"
            runner.generate(prep, max_new_tokens=2, do_selection=do_sel)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
            decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                MAX_NEW_TOKENS, cfg.eos_token_id))
            generate_ms, res = timed_ms(lambda: runner.generate(
                prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel))
            peak = torch.cuda.max_memory_allocated()
            check_outputs(cfg, prep, pre, res, do_sel)
            run = {"batch": name, "mode": mode, "B": int(prep.input_ids.shape[0]),
                   "S": int(prep.input_ids.shape[1]), "patches": int(prep.patches.shape[0]),
                   "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms / MAX_NEW_TOKENS,
                   "generate_ms": generate_ms, "peak_mem_gib": peak / 2**30,
                   "kv_len": int(pre.valid.shape[1])}
            if do_sel:
                run["kept_img_tokens"] = res.keep_img.sum(1).tolist()
                run["prune_ratio"] = [float(x) for x in res.prune_ratio]
            print("main path " + json.dumps(run))
            runs.append(run)
    torch.cuda.synchronize()
    launches = read_launches(["window_attention_fused"] + [
        f"flash_attention[{k}]" for k in ("causal", "dense", "dqk_ne_dv", "segmented")])
    print("serving-path launches " + json.dumps(launches))
    return runs, launches


def check_small_reference(sp_group=None):
    """The tiny config on the card (bf16, the kernels) against the same
    weights on the CPU (fp32, the plain versions, which the CPU tests hold
    equal to the JAX package): first logits of the unpruned prefill and mask
    logits of the pruned one, relative to their largest magnitude. The bound
    catches a wrong path; bf16 rounding through the tiny model stays far
    below it. With ``sp_group`` the card runs under sequence parallelism
    over it (the patches padded to 64 so that the ViT's windows divide over
    2 ranks), the CPU unsharded."""
    import contextlib

    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import sequence_parallel

    cfg = tiny_test_config()
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          seq_multiple=8, patch_multiple=16 if sp_group is None else 64)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    def sharded():
        return contextlib.nullcontext() if sp_group is None else sequence_parallel(sp_group)

    errs = {}
    for do_sel, field in ((False, "logits"), (True, "mask_logits")):
        ref = getattr(ref_run.prefill(prep, do_sel), field).float()
        with sharded():
            got = getattr(got_run.prefill(prep, do_sel), field).float().cpu()
        if do_sel:
            img_valid = torch.as_tensor(prep.img_valid)
            ref, got = ref[:, img_valid], got[:, img_valid]
        errs[field] = ((got - ref).abs().max() / ref.abs().max()).item()
    tag = "" if sp_group is None else f" under SP over {SP_WORLD} ranks"
    print(f"tiny config{tag}, card bf16 vs CPU fp32, max error / max |ref|: "
          + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card disagrees with the CPU reference: {bad}")
    return errs


def compressor_kwargs(method):
    if method in ("divprune", "cdpruner", "vscan"):
        return {"visual_token_num": VISUAL_TOKEN_NUM}
    return {}


def expected_kept(method, n_img):
    """Image tokens each row keeps, from the selectors' static budgets (the
    ratios multiply in fp32, as in the port and the JAX package)."""
    f32 = np.float32
    n = n_img.astype(np.int64)
    if method == "visionzip":  # dominant top-k plus min(contextual k, the rest)
        dom = np.maximum((f32(0.65) * n.astype(f32)).astype(np.int64), 1)
        ctx = np.maximum((f32(0.05) * n.astype(f32)).astype(np.int64), 1)
        return dom + np.minimum(ctx, n - dom)
    if method == "pdrop":  # the last stage's ratio
        return np.maximum((f32(0.125) * n.astype(f32)).astype(np.int64), 1)
    return np.minimum(VISUAL_TOKEN_NUM, n)


def check_compressed(cfg, prep, method, pre, res):
    """Shapes, finiteness, keep counts, prune ratios and the compaction of
    one compressed generate."""
    import torch

    b = prep.input_ids.shape[0]
    assert pre.logits.shape == (b, 1, cfg.text.vocab_size), pre.logits.shape
    assert torch.isfinite(pre.logits.float()).all(), f"{method}: non-finite prefill logits"
    assert res.sequences.shape == (b, COMPRESSED_NEW_TOKENS), res.sequences.shape
    assert ((res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all()
    kept = pre.kept.cpu().numpy()
    want = expected_kept(method, prep.n_img_tokens)
    assert (kept == want).all(), f"{method}: kept {kept.tolist()}, expected {want.tolist()}"
    if res.keep_img is not None:
        assert not (res.keep_img & ~prep.img_valid).any(), f"{method}: kept a padding slot"
        assert (res.keep_img.sum(1) == want).all()
    assert ((res.prune_ratio > 0) & (res.prune_ratio < 1)).all(), res.prune_ratio
    le = cfg.gp.le_length if cfg.gp.has_le else 0
    n_text = prep.valid.sum(1) - prep.n_img_tokens - le
    assert (pre.valid.sum(1).cpu().numpy() == n_text + kept).all(), \
        f"{method}: compaction lost tokens"


def run_compressed_path(cfg, model, cases, main_runs):
    """generate_compressed with each compressor on each batch: prefill and
    decode times, printed beside the same run's pruned and unpruned
    ``generate`` (main_runs), keep counts, launch counts. K8 must not
    launch: both of the 7B's importance blocks are full-attention blocks."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    runner = GlimpsePruneRunner(cfg, model)
    reset_launches()
    runs = []
    for name, prep in cases:
        for method in COMPRESSORS:
            kw = compressor_kwargs(method)
            runner.generate_compressed(prep, method, max_new_tokens=2, **kw)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            prefill_ms, pre = timed_ms(lambda: runner.prefill_compressed(prep, method, **kw))
            decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                COMPRESSED_NEW_TOKENS, cfg.eos_token_id))
            res = runner.generate_compressed(prep, method,
                                             max_new_tokens=COMPRESSED_NEW_TOKENS, **kw)
            peak = torch.cuda.max_memory_allocated()
            check_compressed(cfg, prep, method, pre, res)
            run = {"batch": name, "method": method, "B": int(prep.input_ids.shape[0]),
                   "prefill_ms": prefill_ms,
                   "decode_ms_per_token": decode_ms / COMPRESSED_NEW_TOKENS,
                   "peak_mem_gib": peak / 2**30, "kv_len": int(pre.valid.shape[1]),
                   "kept_img_tokens": pre.kept.tolist(),
                   "prune_ratio": [float(x) for x in res.prune_ratio]}
            print("compressed path " + json.dumps(run))
            runs.append(run)
    for name, _ in cases:
        side = {r["mode"]: r for r in main_runs if r["batch"] == name}
        side.update({r["method"]: r for r in runs if r["batch"] == name})
        print(f"batch ({name}) prefill ms / decode ms per token: " + ", ".join(
            f"{k} {r['prefill_ms']:.1f} / {r['decode_ms_per_token']:.1f}"
            for k, r in side.items()))
    torch.cuda.synchronize()
    launches = read_launches(["window_attention_fused"] + [
        f"flash_attention[{k}]" for k in ("causal", "dense", "segmented")])
    print("compressed-path launches " + json.dumps(launches))
    if launches["window_attention"]:
        raise AssertionError("K8 launched on the published config, whose importance blocks "
                             "are full-attention blocks")
    return runs, launches


def windowed_last(cfg, **vision):
    """cfg with a vision tower whose last block is windowed (not in configs/)."""
    import dataclasses

    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, fullatt_block_indexes=WINDOWED_LAST_FULLATT, **vision))


def run_importance_variant(cfg, model, prep):
    """K8 on the importance path: the 7B's weights bound to a vision config
    whose last block is windowed. One ViT call with emit_importance, then
    generate_compressed with visionzip and vscan: K8 launches once per ViT
    call. The model is bound back to cfg afterwards."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    vcfg = windowed_last(cfg)
    runner = GlimpsePruneRunner(vcfg, model.set_config(vcfg))
    inputs = runner._device_inputs(prep)
    reset_launches()
    with torch.inference_mode():
        vit_ms, (merged, _, imp) = timed_ms(lambda: runner._vision(inputs, prep, True))
    launches = read_launches(["window_attention"])
    if launches["window_attention"] != 1:
        raise AssertionError(f"K8 launched {launches['window_attention']} times in one ViT call")
    n_units = prep.patches.shape[0] // cfg.vision.spatial_merge_unit
    assert [tuple(t.shape) for t in imp] == [(n_units,), (n_units, cfg.vision.head_dim),
                                             (n_units,)]
    assert all(torch.isfinite(t).all() for t in (merged.float(), *imp))
    record = {"config": f"vision fullatt_block_indexes={WINDOWED_LAST_FULLATT} "
                        "(not in configs/)", "vit_importance_ms": vit_ms}
    reset_launches()
    for method in ("visionzip", "vscan"):
        kw = compressor_kwargs(method)
        ms, pre = timed_ms(lambda: runner.prefill_compressed(prep, method, **kw))
        res = runner.generate_compressed(prep, method, max_new_tokens=COMPRESSED_NEW_TOKENS,
                                         **kw)
        check_compressed(vcfg, prep, method, pre, res)
        record[f"{method}_prefill_ms"] = ms
    launches = read_launches(["window_attention", "window_attention_fused"])
    record["launches"] = launches
    print("importance path, windowed last block " + json.dumps(record))
    if launches["window_attention"] != 4:  # two prefills, two generates: 4 ViT calls
        raise AssertionError(f"K8 launched {launches['window_attention']} times in 4 ViT calls")
    model.set_config(cfg)
    return record


def check_small_importance(cfg, model, prep):
    """A two-block tower of the 7B's width whose last block is windowed
    (full attention at block 0; not in configs/), with the 7B's first two
    blocks' weights, on batch (a) with emit_importance: on the card (bf16,
    K2 and K8) against the CPU (fp32, the plain versions), relative to the
    largest magnitude of each output, within the same 10% as the other
    card-against-CPU checks."""
    import dataclasses

    import torch

    from glimpseprune_torch.models.qwen2_5_vl.vision import VisionTransformer
    from glimpseprune_torch.ops.cuda.window_attention import window_attention

    vcfg = dataclasses.replace(cfg.vision, depth=2, fullatt_block_indexes=(0,))
    tower = VisionTransformer(vcfg)
    tower.load_state_dict({k: v for k, v in model.visual.state_dict().items()
                           if not k.startswith("blocks.") or int(k.split(".")[1]) < 2})
    tower.eval()
    gpu = copy.deepcopy(tower).to(device="cuda", dtype=torch.bfloat16)
    args = [torch.as_tensor(a) for a in (prep.patches, prep.vis_pos_ids, prep.full_seg,
                                         prep.vis_valid)]
    window_attention.launches = 0
    with torch.inference_mode():
        got = gpu(*[a.cuda() for a in args], emit_importance=True)
        torch.cuda.synchronize()
        k8 = window_attention.launches
        t0 = time.perf_counter()
        ref = tower(*args, emit_importance=True)
        cpu_s = time.perf_counter() - t0
    if k8 != 1:
        raise AssertionError(f"the two-block tower launched K8 {k8} times")
    unit_valid = torch.as_tensor(prep.vis_valid.reshape(-1, vcfg.spatial_merge_unit)[:, 0])
    names = ("merged", "received", "keys_mean", "received_local")
    errs = {}
    for name, g, r in zip(names, (got[0], *got[2]), (ref[0], *ref[2])):
        g, r = g.float().cpu()[unit_valid], r.float()[unit_valid]
        errs[name] = ((g - r).abs().max() / r.abs().max()).item()
    print(f"two-block tower, last block windowed (not in configs/), card bf16 vs CPU fp32 "
          f"({cpu_s:.1f} s on the CPU), max error / max |ref|: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card's importance path disagrees with the CPU: {bad}")
    return errs


def check_small_compressed():
    """The tiny config's compressed prefill on the card (bf16, the kernels)
    against the same weights on the CPU (fp32, the plain versions, which the
    CPU tests hold equal to the JAX runner): visionzip's keep mask and
    pdrop's compacted ids, positions and valid mask equal, first logits
    within 10% of their largest magnitude."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg = tiny_test_config()
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    errs = {}
    for method, kw in (("visionzip", {}), ("pdrop", {"stages": ((1, 0.5), (2, 0.25))})):
        ref = ref_run.prefill_compressed(prep, method, **kw)
        got = got_run.prefill_compressed(prep, method, **kw)
        if method == "visionzip":
            same = torch.equal(got.keep_img.cpu(), ref.keep_img)
        else:
            same = all(torch.equal(getattr(got, f).cpu(), getattr(ref, f))
                       for f in ("input_ids", "position_ids", "valid"))
        if not same:
            raise AssertionError(f"tiny {method}: the card kept other image tokens than the CPU")
        errs[method] = ((got.logits.float().cpu() - ref.logits).abs().max()
                        / ref.logits.abs().max()).item()
    print("tiny config compressed prefill, card bf16 vs CPU fp32, equal keep sets, first "
          "logits max error / max |ref|: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card's compressed prefill disagrees with the CPU: {bad}")
    return errs


def hash_tokenize(text: str):
    """A deterministic stand-in tokenizer: one ordinary text id per word."""
    return [1000 + zlib.crc32(w.encode()) % 149000 for w in text.split()]


def write_train_corpus(directory: Path, n_rows: int = 8):
    """n rows of VisCoT-style jsonl over random images (.npy) of the two
    smoke sizes, with random pixel boxes -> the GPDataset config dict."""
    rng = np.random.default_rng(2)
    shutil.rmtree(directory, ignore_errors=True)
    img_dir = directory / "imgs" / "cot" / "synthetic"
    img_dir.mkdir(parents=True)
    rows = []
    for i in range(n_rows):
        h, w = (896, 672) if i % 2 == 0 else (672, 504)
        np.save(img_dir / f"{i}.npy", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
        x1, y1 = x0 + rng.integers(w // 8, w // 2), y0 + rng.integers(h // 8, h // 2)
        rows.append({"question": f"What is the object in region {i} of the picture?",
                     "answer": f"It is object number {i}.", "image": f"{i}.npy",
                     "width": w, "height": h, "bboxs": [[float(x0), float(y0), float(x1),
                                                         float(y1)]],
                     "dataset": "synthetic", "split": "train"})
    jsonl = directory / "train.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return {"datasets": [{"json_path": str(jsonl), "mapper": "cot_train",
                          "bbox_type": "xyxy", "additional_mappers": ["norm_bboxes"]}]}


def make_trainer(cfg, model, work: Path):
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig

    dataset = GPDataset(write_train_corpus(work), img_dir=str(work / "imgs"))
    tcfg = TrainerConfig(batch_size=2, num_epochs=1, log_every=1, save_every=0,
                         output_dir=str(work / "ckpt"), seed=0)
    return GPTrainer(cfg, model, dataset, hash_tokenize, load_image=np.load, tcfg=tcfg)


def run_training_path(trainer):
    """GPTrainer.train(max_steps=4) at batch 2 on the 7B model, each step
    timed; -> (per-step records, launch counts)."""
    import torch

    from glimpseprune_torch.training.train_step import split_params

    trainable, frozen = split_params(trainer.model)
    # the frozen copy waits in host memory, so the steps' device peak is
    # the training's own
    frozen_before = {k: p.detach().cpu() for k, p in frozen.items()}
    trainable_before = {k: p.detach().clone() for k, p in trainable.items()}
    inner, steps = trainer.step_fn, []

    def timed_step(batch, generator):
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = timed_ms(lambda: inner(batch, generator))
        steps.append({"ms": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "S": int(batch["input_ids"].shape[1]),
                      "patches": int(batch["patches"].shape[0])})
        return metrics

    trainer.step_fn = timed_step
    reset_launches()
    history = trainer.train(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches(["window_attention_fused", "flash_attention[segmented]"] + [
        f"{fn}[{k}]" for fn in ("flash_attention_lse", "flash_attention_backward")
        for k in ("causal", "dqk_ne_dv")])
    print("training-path launches " + json.dumps(launches))
    assert len(history) == len(steps) == TRAIN_STEPS, (len(history), len(steps))
    for h, st in zip(history, steps):
        st.update({k: h[k] for k in ("step", "loss", "loc_loss", "le_loss", "mask_iou")})
        print("train step " + json.dumps(st))
        bad = [k for k in ("loss", "loc_loss", "le_loss", "mask_iou") if not np.isfinite(st[k])]
        if bad:
            raise AssertionError(f"non-finite {bad} at step {st['step']}")
    changed = [k for k, p in trainable.items() if not torch.equal(p, trainable_before[k])]
    moved = [k for k, p in frozen.items() if not torch.equal(p.cpu(), frozen_before[k])]
    print(f"trainable tensors changed: {len(changed)} of {len(trainable)}; "
          f"frozen tensors changed: {len(moved)} of {len(frozen)}")
    if len(changed) != len(trainable) or moved:
        raise AssertionError(f"unchanged trainable {sorted(set(trainable) - set(changed))}, "
                             f"changed frozen {moved}")
    return steps, launches


def check_small_train_step():
    """One tiny-config train step on the card (frozen base bf16, trainable
    fp32, the kernels) against the same weights on the CPU in fp32 with the
    plain versions, which the CPU tests hold equal to the JAX train step:
    every trainable gradient's max error / max |ref|, and the loss. The
    bound (10%) catches a wrong path or a wrong backward; bf16 rounding
    through the tiny model stays far below it."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.training.train_step import (
        compute_loss,
        init_trainable,
        new_module_filter,
    )
    from glimpseprune_torch.training.trainer import batch_from_prep

    cfg = tiny_test_config()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    answers = [[int(x) for x in rng.integers(5, 400, 4)] for _ in range(2)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          normed_bboxes=[[[0.0, 0.0, 0.5, 1.0]], [[0.5, 0.5, 1.0, 1.0]]],
                          answer_ids=answers, seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    for name, p in gpu_model.named_parameters():
        if not new_module_filter(name):
            p.data = p.data.bfloat16()
    out = {}
    for tag, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, "cuda")):
        trainable = init_trainable(model)
        total, _ = compute_loss(cfg, model, batch_from_prep(prep, device))
        total.backward()
        out[tag] = (total.item(), {k: p.grad.float().cpu() for k, p in trainable.items()})
    errs = {k: ((g - out["cpu"][1][k]).abs().max() / out["cpu"][1][k].abs().max()).item()
            for k, g in out["gpu"][1].items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(out["gpu"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    print(f"tiny train step, card bf16 vs CPU fp32: loss {out['gpu'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f}, worst gradient max error / max |ref| {errs[worst]:.4f} "
          f"({worst}) over {len(errs)} tensors")
    if not (errs[worst] <= 0.1 and loss_err <= 0.1):
        raise AssertionError(f"the card's train step disagrees with the CPU: "
                             f"{worst} {errs[worst]}, loss {loss_err}")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs[worst]}

def int4_weight(k, n, gen):
    """A random [k, n] weight at the init's scale, int4-quantized on the card."""
    import torch

    from glimpseprune_torch.quantization import quantize_int4

    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    q = quantize_int4(w)
    return q["kernel_q4"], q["kernel_scale4"]


def decoder_shapes(cfg):
    """{name: (K, N)} of the 7B decoder's linears and the head."""
    t = cfg.text
    kv = t.num_key_value_heads * t.head_dim
    return {"q_o": (t.hidden_size, t.hidden_size), "k_v": (t.hidden_size, kv),
            "gate_up": (t.hidden_size, t.intermediate_size),
            "down": (t.intermediate_size, t.hidden_size), "head": (t.hidden_size, t.vocab_size)}


def int4_row(name, key, replaces, x, packed, scales, got, ref, ms, plain_ms, out_bytes,
             flops=0.0, int8_ops=0.0, extra=()):
    """One K4-K6 row: error against the plain version, bound, and the bf16
    matmul of the same shape."""
    import torch

    from glimpseprune_torch.quantization import dequant_int4

    err = rel_err(got, ref)
    if not err <= INT4_RTOL:
        raise AssertionError(f"{name}[{key}] disagrees with its plain version: {err}")
    wb = dequant_int4(packed, scales, torch.bfloat16)
    bf16_ms = cuda_ms(lambda: x @ wb)
    del wb
    bound_ms, bound_by = bound(flops, nbytes(packed, scales, *extra) + out_bytes, int8_ops)
    m, k = x.shape
    shape = f"x[{m},{k}] w4[{k // 2},{packed.shape[1]}] g={k // scales.shape[0]}"
    print(f"{name}[{key}] {shape}: rel_err={err:.3e} kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bf16 matmul {bf16_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    # no single PyTorch call multiplies by int4 weights: library_ms is null
    return {"name": f"{name}[{key}]", "route": "cuda", "source": INT4_SRC,
            "replaces": replaces, "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "rel_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bf16_matmul_ms": bf16_ms,
            "shape": shape}


def check_int4_kernels(cfg, gen, decode_m: int, prefill_m: int):
    """K4 at the decode shapes (M = decode_m), K5 and K6 at the decoder
    shapes with M = prefill_m, each against its plain version."""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import (
        int4_prefill_a8_reference,
        int4_prefill_a16_reference,
        launch_key,
        matmul_int4,
        matmul_int4_prefill,
        matmul_int4_reference,
        requant_ratios,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    rows = []
    for name, (k, n) in decoder_shapes(cfg).items():
        packed, scales = int4_weight(k, n, gen)
        x = torch.randn((decode_m, k), generator=gen, device="cuda").bfloat16()
        got = matmul_int4(x, packed, scales)
        torch.cuda.synchronize()
        ref = matmul_int4_reference(x, packed, scales, torch.float32)
        ms = cuda_ms(lambda: matmul_int4(x, packed, scales))
        plain_ms = cuda_ms(lambda: matmul_int4_reference(x, packed, scales, torch.bfloat16))
        rows.append(int4_row("matmul_int4", launch_key(k, n), K4_REPLACES, x, packed, scales,
                             got, ref, ms, plain_ms, 2 * decode_m * n,
                             flops=2.0 * decode_m * k * n, extra=(x,)))
        if name == "head":
            continue
        x = torch.randn((prefill_m, k), generator=gen, device="cuda").bfloat16()
        # K5 (W4A16): fp32 products of bf16-rounded scaled weights
        got = matmul_int4_prefill(x, packed, scales, a8=False)
        torch.cuda.synchronize()
        ref = int4_prefill_a16_reference(x, packed, scales, torch.float32)
        ms = cuda_ms(lambda: matmul_int4_prefill(x, packed, scales, a8=False))
        plain_ms = cuda_ms(lambda: int4_prefill_a16_reference(x, packed, scales, torch.bfloat16))
        rows.append(int4_row("matmul_int4_prefill", launch_key(k, n, False), K56_REPLACES, x,
                             packed, scales, got, ref, ms, plain_ms, 2 * prefill_m * n,
                             flops=2.0 * prefill_m * k * n, extra=(x,)))
        # K6 (W4A8): the same int8 operands as the plain version, exact sums
        got = matmul_int4_prefill(x, packed, scales, a8=True)
        torch.cuda.synchronize()
        xq, xs = quantize_kv(x)
        xs = xs[:, None]
        s8, r = requant_ratios(scales)
        ref = int4_prefill_a8_reference(xq, xs, packed, r, s8, torch.float32)
        ms = cuda_ms(lambda: matmul_int4_prefill(x, packed, scales, a8=True))
        plain_ms = cuda_ms(lambda: int4_prefill_a8_reference(xq, xs, packed, r, s8,
                                                             torch.bfloat16))
        rows.append(int4_row("matmul_int4_prefill", launch_key(k, n, True), K56_REPLACES, x,
                             packed, r, got, ref, ms, plain_ms, 2 * prefill_m * n,
                             int8_ops=2.0 * prefill_m * k * n, extra=(xq, xs, s8)))
        del packed, scales, x, xq, ref, got
    torch.cuda.empty_cache()
    return rows


def k7_errors(got, ref):
    """(max error / max |ref|, RMS error / RMS of ref)."""
    d = got.float() - ref.float()
    return ((d.abs().max() / ref.float().abs().max().clamp(min=1e-30)).item(),
            (d.norm() / ref.float().norm().clamp(min=1e-30)).item())


def k7_within(errs) -> bool:
    return errs[0] <= K7_MAX_RTOL and errs[1] <= K7_RMS_RTOL


def check_flash_int8(cfg, prep_a, prep_b, gen):
    """K7 dense, segmented (the ViT's full attention on batches (b) and (a))
    and causal (the LLM's prefill on batch (a)), each with and without the
    int8 PV product, against the plain version at the kernel's kv tile.
    Controls: each output must fail the same check against the plain
    version of the other PV flavour and against bf16 attention (K2's plain
    version), or the check could not tell the int8 tiers apart."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        KERNEL_BLOCK_K,
        flash_attention_int8,
        flash_attention_int8_reference,
        flash_attention_reference,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    v, t = cfg.vision, cfg.text

    def seg(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")

    cases = [
        ("vit_dense", "dense", 1, v.num_heads, v.num_heads, prep_b.patches.shape[0],
         v.head_dim, None, False),
        ("vit_segmented", "segmented", 1, v.num_heads, v.num_heads, prep_a.patches.shape[0],
         v.head_dim, seg(prep_a.full_seg[None]), False),
        ("llm_causal", "causal", prep_a.valid.shape[0], t.num_attention_heads,
         t.num_key_value_heads, prep_a.valid.shape[1], t.head_dim,
         seg(np.where(prep_a.valid, 0, -1)), True),
    ]
    rows = []
    for name, fl, b, hq, hkv, s, d, segs, causal in cases:
        q, k, vv, pairs, mask = attention_case(gen, b, hq, hkv, s, d, d, segs, causal)
        dense = segs is None
        q8, qsc = quantize_kv(q)
        k8, ksc = quantize_kv(k)
        lib_ms = cuda_ms(lambda: sdpa(q, k, vv, mask))
        refs = {pv: flash_attention_int8_reference(q8, k8, vv, qsc, ksc, segs, segs, causal,
                                                   dense, pv, KERNEL_BLOCK_K, torch.float32)
                for pv in (False, True)}
        refs["bf16"] = flash_attention_reference(q.float(), k.float(), vv.float(), segs, segs,
                                                 causal=causal, dense=dense)
        for pv in (False, True):
            got = flash_attention_int8(q, k, vv, segs, segs, causal=causal, dense=dense,
                                       pv_int8=pv)
            torch.cuda.synchronize()
            ref = refs[pv]
            err = (got.float() - ref).abs().max().item()
            errs = k7_errors(got, ref)
            controls = {other: k7_errors(got, refs[other]) for other in (not pv, "bf16")}
            ms = cuda_ms(lambda: flash_attention_int8(q, k, vv, segs, segs, causal=causal,
                                                      dense=dense, pv_int8=pv))
            plain_ms = cuda_ms(lambda: flash_attention_int8_reference(
                q8, k8, vv, qsc, ksc, segs, segs, causal, dense, pv, KERNEL_BLOCK_K,
                torch.bfloat16))
            qk_ops, pv_ops = 2.0 * pairs * hq * d, 2.0 * pairs * hq * d
            bound_ms, bound_by = bound(0.0 if pv else pv_ops,
                                       nbytes(q8, k8, vv, qsc, ksc, got)
                                       + (0 if dense else 2 * segs.nbytes),
                                       qk_ops + (pv_ops if pv else 0.0))
            key = fl + ("+pv8" if pv else "")
            shape = f"{name} q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}]"
            names = {False: "int8 QK^T", True: "int8 QK^T + int8 PV", "bf16": "bf16"}
            print(f"K7 flash_attention_int8[{key}] {shape}: max_abs_err={err:.3e} "
                  f"rel_err={errs[0]:.3e} rms_rel_err={errs[1]:.3e}; against "
                  + ", ".join(f"{names[o]} (max/rms rel) {e[0]:.3e}/{e[1]:.3e}"
                              for o, e in controls.items())
                  + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            if not k7_within(errs):
                raise AssertionError(f"K7 {key} disagrees with its plain version: {errs}")
            passed = [names[o] for o, e in controls.items() if k7_within(e)]
            if passed:
                raise AssertionError(f"K7 {key}: the check cannot tell the kernel from "
                                     f"{passed} attention")
            rows.append({"name": f"flash_attention_int8[{key}]", "route": "cuda",
                         "source": K2_SRC, "replaces": K7_REPLACES[fl], "max_abs_err": err,
                         "rel_err": errs[0], "rms_rel_err": errs[1],
                         "control_rms_rel_err": min(e[1] for e in controls.values()),
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms, "shape": shape})
        del q, k, vv, q8, k8, got, ref, refs
    torch.cuda.empty_cache()
    return rows


def qpos_shards(s: int):
    """(name, lo, hi) of the q shards K9 is checked on: 2 and 4 equal shards
    and one that no tile boundary aligns (tests/test_sp.py:70-78)."""
    return [(f"{n}x{i}", i * s // n, (i + 1) * s // n) for n in (2, 4) for i in range(n)] + [
        ("unaligned", 100, 160)]


def check_flash_qpos(cfg, prep_a, gen):
    """K9 (the q_positions flavours: forward, LSE, backward, int8) at batch
    (a)'s causal shape, q [2, 28, 832, 128] against kv of 4 heads with
    left-padded rows, its q rows cut into 2 and 4 shards and one unaligned
    shard. Each shard against the kernel's plain version, and against the
    monolithic K2 / K2-lse / K3 / K7 call over the whole sequence: the
    forward, the LSE, dq and the int8 output equal it bit for bit (each row
    visits the same k tiles in the same order); dk and dv, each shard's part
    rounded to bf16 and summed over the shards, within GRAD_RTOL. Control:
    K2 causal on a later shard alone (rows at their local index, keys of the
    shard only) must fail. Times at the upper half shard (world 2, rank 1);
    -> the kernels line's K9 rows."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        KERNEL_BLOCK_K,
        allowed_mask,
        flash_attention,
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_int8,
        flash_attention_int8_reference,
        flash_attention_lse,
        flash_attention_lse_reference,
        flash_attention_reference,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    t = cfg.text
    b, s = prep_a.valid.shape
    hq, hkv, d = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    seg = torch.as_tensor(np.where(prep_a.valid, 0, -1), dtype=torch.int32, device="cuda")
    q, k, v, _, _ = attention_case(gen, b, hq, hkv, s, d, d, seg, True)
    dout = torch.randn((b, s, hq, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)
    mono = flash_attention(q, k, v, seg, seg, causal=True)
    mono_o, mono_lse = flash_attention_lse(q, k, v, seg, seg, causal=True)
    mono_grads = flash_attention_backward(q, k, v, seg, seg, mono_o, mono_lse, dout, causal=True)
    mono_i8 = {pv: flash_attention_int8(q, k, v, seg, seg, causal=True, pv_int8=pv)
               for pv in (False, True)}
    k8, ksc = quantize_kv(k)
    torch.cuda.synchronize()

    def shard(lo, hi):
        return (q[:, :, lo:hi], seg[:, lo:hi],
                torch.arange(lo, hi, dtype=torch.int32, device="cuda").expand(b, hi - lo)
                .contiguous())  # int32 and contiguous, as the SP path passes them

    report, dkv_sums = {}, {n: [0.0, 0.0] for n in (2, 4)}
    for name, lo, hi in qpos_shards(s):
        qs, qseg, qpos = shard(lo, hi)
        got = flash_attention(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
        out, lse = flash_attention_lse(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
        grads = flash_attention_backward(qs, k, v, qseg, seg, out, lse, dout[:, :, lo:hi],
                                         causal=True, q_positions=qpos)
        i8 = {pv: flash_attention_int8(qs, k, v, qseg, seg, causal=True, pv_int8=pv,
                                       q_positions=qpos) for pv in (False, True)}
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_attention_lse_reference(qs.float(), k.float(), v.float(), qseg,
                                                       seg, causal=True, q_positions=qpos)
        seen = ref_lse > -1e29
        ref_grads = flash_attention_backward_reference(
            qs.float(), k.float(), v.float(), qseg, seg, out.float(), lse,
            dout[:, :, lo:hi].float(), causal=True, q_positions=qpos)
        q8, qsc = quantize_kv(qs)
        i8_refs = {pv: flash_attention_int8_reference(q8, k8, v, qsc, ksc, qseg, seg, True,
                                                      False, pv, KERNEL_BLOCK_K, torch.float32,
                                                      qpos) for pv in (False, True)}
        r = {"fwd_err": (got.float() - ref_o).abs().max().item(),
             "lse_rel_err": rel_err(lse, ref_lse, seen),
             "bwd_rel_err": [rel_err(g, rr) for g, rr in zip(grads, ref_grads)],
             "bwd_k7_errs": [k7_errors(g, rr) for g, rr in zip(grads, ref_grads)],
             "bwd_abs_err": max((g.float() - rr).abs().max().item()
                                for g, rr in zip(grads, ref_grads)),
             "int8_errs": {pv: k7_errors(i8[pv], i8_refs[pv]) for pv in (False, True)},
             "int8_abs_err": (i8[False].float() - i8_refs[False]).abs().max().item(),
             "equal_to_monolithic": {
                 "forward": torch.equal(got, mono[:, :, lo:hi]),
                 "lse": torch.equal(lse, mono_lse[:, :, lo:hi]),
                 "dq": torch.equal(grads[0], mono_grads[0][:, :, lo:hi]),
                 "int8": torch.equal(i8[False], mono_i8[False][:, :, lo:hi]),
                 "int8+pv8": torch.equal(i8[True], mono_i8[True][:, :, lo:hi])}}
        report[name] = r
        if name != "unaligned":
            n = int(name.split("x")[0])
            dkv_sums[n] = [dkv_sums[n][0] + grads[1].float(), dkv_sums[n][1] + grads[2].float()]
        bad = [key for key, ok in r["equal_to_monolithic"].items() if not ok]
        if not (r["fwd_err"] <= KERNEL_ATOL and r["lse_rel_err"] <= LSE_RTOL
                and torch.equal(lse <= -1e29, ~seen) and max(r["bwd_rel_err"]) <= GRAD_RTOL
                and all(k7_within(e) for e in r["bwd_k7_errs"])
                and all(k7_within(e) for e in r["int8_errs"].values()) and not bad):
            raise AssertionError(f"K9 shard {name} [{lo}:{hi}] fails: {r}")
    for n, (dk, dv) in dkv_sums.items():
        errs = (rel_err(dk, mono_grads[1]), rel_err(dv, mono_grads[2]))
        report[f"dk_dv_sum_over_{n}_shards_rel_err"] = errs
        if not max(errs) <= GRAD_RTOL:
            raise AssertionError(f"K9: dk, dv summed over {n} shards differ from K3's: {errs}")
    # control: K2 causal on the last quarter alone
    lo, hi = 3 * s // 4, s
    control = flash_attention(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi], seg[:, lo:hi],
                              seg[:, lo:hi], causal=True)
    control_err = (control.float() - mono[:, :, lo:hi].float()).abs().max().item()
    report["control_k2_on_shard_err"] = control_err
    if control_err <= KERNEL_ATOL:
        raise AssertionError("K9: the check cannot tell a shard's global causal mask from K2's")
    print("K9 shards against the plain versions and the monolithic K2/K2-lse/K3/K7 "
          + json.dumps(report, default=str))

    # times at the upper half of the sequence (rank 1 of 2)
    lo, hi = s // 2, s
    qs, qseg, qpos = shard(lo, hi)
    ds = dout[:, :, lo:hi]
    allowed = allowed_mask(qseg, seg, b, hi - lo, s, True, False, "cuda", qpos)
    pairs, mask = int(allowed.sum()), allowed[:, None]
    seg_bytes = nbytes(qseg, seg, qpos)
    shape = f"q[{b},{hq},{hi - lo},{d}] rows {lo}:{hi} kv[{b},{hkv},{s},{d}]"
    out, lse = flash_attention_lse(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
    sdpa_ms = cuda_ms(lambda: sdpa(qs, k, v, mask))
    sdpa_dev_ms = device_ms(lambda: sdpa(qs, k, v, mask))
    rows = []

    def row(fn_name, ms, plain_ms, lib_ms, flops, nbytes_, int8_ops=0.0, **extra):
        bound_ms, bound_by = bound(flops, nbytes_ + seg_bytes, int8_ops)
        print(f"K9 {fn_name}[causal+qpos] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append({"name": f"{fn_name}[causal+qpos]", "route": "cuda",
                     "source": K3_SRC if fn_name == "flash_attention_backward" else K2_SRC,
                     "replaces": K9_REPLACES[fn_name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                     "shape": shape, **extra})

    half = report["2x1"]
    row("flash_attention",
        cuda_ms(lambda: flash_attention(qs, k, v, qseg, seg, causal=True, q_positions=qpos)),
        cuda_ms(lambda: flash_attention_reference(qs, k, v, qseg, seg, causal=True,
                                                  q_positions=qpos)),
        sdpa_ms, 4.0 * pairs * hq * d, nbytes(qs, k, v, out), max_abs_err=half["fwd_err"],
        equal_to_monolithic=half["equal_to_monolithic"]["forward"],
        device_ms=device_ms(lambda: flash_attention(qs, k, v, qseg, seg, causal=True,
                                                    q_positions=qpos)),
        library_device_ms=sdpa_dev_ms)
    row("flash_attention_lse",
        cuda_ms(lambda: flash_attention_lse(qs, k, v, qseg, seg, causal=True, q_positions=qpos)),
        cuda_ms(lambda: flash_attention_lse_reference(qs, k, v, qseg, seg, causal=True,
                                                      q_positions=qpos)),
        sdpa_ms, 4.0 * pairs * hq * d, nbytes(qs, k, v, out, lse), max_abs_err=half["fwd_err"],
        lse_rel_err=half["lse_rel_err"], equal_to_monolithic=half["equal_to_monolithic"]["lse"],
        device_ms=device_ms(lambda: flash_attention_lse(qs, k, v, qseg, seg, causal=True,
                                                        q_positions=qpos)),
        library_device_ms=sdpa_dev_ms)
    # the backward's controls and determinism at this shard
    bwd = check_backward("K9 backward", qs, k, v, qseg, seg, out, lse, ds, True, False, qpos)
    grads = bwd.pop("grads")
    print(f"K9 backward rows {lo}:{hi}: {bwd_summary(bwd)}")

    def bwd_call():
        return flash_attention_backward(qs, k, v, qseg, seg, out, lse, ds, causal=True,
                                        q_positions=qpos)

    lib_ms, lib_dev_ms = sdpa_backward_ms(qs, k, v, mask, ds)
    row("flash_attention_backward", cuda_ms(bwd_call),
        cuda_ms(lambda: flash_attention_backward_reference(qs, k, v, qseg, seg, out, lse, ds,
                                                           causal=True, q_positions=qpos)),
        lib_ms, 2.0 * pairs * hq * 5 * d, nbytes(qs, k, v, out, lse, ds, *grads),
        max_abs_err=half["bwd_abs_err"], rel_err=max(half["bwd_rel_err"]),
        k7_errs_dq_dk_dv=bwd["k7_errs_dq_dk_dv"], controls=bwd["controls"],
        deterministic=bwd["deterministic"],
        dk_dv_sum_rel_err=report["dk_dv_sum_over_2_shards_rel_err"],
        equal_to_monolithic=half["equal_to_monolithic"]["dq"],
        device_ms=device_ms(bwd_call), library_device_ms=lib_dev_ms)
    q8, qsc = quantize_kv(qs)
    got = flash_attention_int8(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
    row("flash_attention_int8",
        cuda_ms(lambda: flash_attention_int8(qs, k, v, qseg, seg, causal=True, q_positions=qpos)),
        cuda_ms(lambda: flash_attention_int8_reference(q8, k8, v, qsc, ksc, qseg, seg, True,
                                                       False, False, KERNEL_BLOCK_K,
                                                       torch.bfloat16, qpos)),
        sdpa_ms, 2.0 * pairs * hq * d, nbytes(q8, k8, v, qsc, ksc, got),
        int8_ops=2.0 * pairs * hq * d, max_abs_err=half["int8_abs_err"],
        rel_err=half["int8_errs"][False][0], rms_rel_err=half["int8_errs"][False][1],
        equal_to_monolithic=half["equal_to_monolithic"]["int8"])
    del q, k, v, dout, mono_grads, grads
    torch.cuda.empty_cache()
    return rows, report


QUANT_TIERS = {
    # name: (weight mode, quantized_config keywords, batches)
    "q8": ("int8", dict(act_quant="prefill"), ("a",)),
    "q4": ("int4", dict(act_quant="prefill", attn_qk_int8="vision", attn_pv_int8="vision"),
           ("a", "b")),
}


def quant_config(cfg, tier: str):
    import dataclasses

    from glimpseprune_torch.quantization import quantized_config

    mode, kw, _ = QUANT_TIERS[tier]
    q = quantized_config(cfg, mode, **kw)
    return dataclasses.replace(q, text=dataclasses.replace(q.text, kv_cache_quant="int8"))


def run_quant_tier(cfg, tier: str, cases):
    """One quantized tier on a fresh random 7B: bf16 first logits, then
    quantize_model on the card and pruned + unpruned generate on each
    batch -> (per-run records, launch counts)."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.kv_cache import cache_nbytes
    from glimpseprune_torch.quantization import quantize_model, quantized_bytes

    mode, _, batches = QUANT_TIERS[tier]
    qcfg = quant_config(cfg, tier)
    cases = [(n, p) for n, p in cases if n in batches]
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    bf16_bytes = quantized_bytes(model)
    runner = GlimpsePruneRunner(cfg, model)
    ref_logits = {(n, sel): runner.prefill(p, sel).logits.float().cpu()
                  for n, p in cases for sel in (True, False)}
    t0 = time.perf_counter()
    quantize_model(model, mode, cfg=qcfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    weight_bytes = quantized_bytes(model)
    print(f"{tier}: quantize_model({mode!r}) on the card in {quant_s:.1f} s: weights "
          f"{bf16_bytes / 1e9:.3f} GB bf16 -> {weight_bytes / 1e9:.3f} GB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    runner = GlimpsePruneRunner(qcfg, model)
    reset_launches()
    runs = []
    for name, prep in cases:
        for do_sel in (True, False):
            runner.generate(prep, max_new_tokens=2, do_selection=do_sel)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
            decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                MAX_NEW_TOKENS, cfg.eos_token_id))
            generate_ms, res = timed_ms(lambda: runner.generate(
                prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel))
            peak = torch.cuda.max_memory_allocated()
            check_outputs(qcfg, prep, pre, res, do_sel)
            t_cache = pre.valid.shape[1] + MAX_NEW_TOKENS
            kv_bytes = sum(cache_nbytes(runner.decode_cache(kv, t_cache))
                           for kv in (pre.kv_k, pre.kv_v))
            run = {"tier": tier, "batch": name, "mode": "pruned" if do_sel else "unpruned",
                   "B": int(prep.input_ids.shape[0]), "S": int(prep.input_ids.shape[1]),
                   "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms / MAX_NEW_TOKENS,
                   "generate_ms": generate_ms, "peak_mem_gib": peak / 2**30,
                   "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes,
                   "kv_len": int(pre.valid.shape[1]),
                   "first_logits_rel_dist_from_bf16": rel_err(
                       pre.logits.float().cpu(), ref_logits[(name, do_sel)])}
            if do_sel:
                run["kept_img_tokens"] = res.keep_img.sum(1).tolist()
            print("quantized path " + json.dumps(run))
            runs.append(run)
    torch.cuda.synchronize()
    required = ["window_attention_fused", "flash_attention[causal]",
                "flash_attention[dqk_ne_dv]"]
    if tier == "q4":
        required += ["matmul_int4[*]", "matmul_int4_prefill[a8,*]"] + [
            f"flash_attention_int8[{fl}+pv8]" for fl in ("dense", "segmented")]
    else:
        required += ["flash_attention[segmented]"]
    launches = read_launches(required)
    print(f"{tier} quantized-path launches " + json.dumps(launches))
    del runner, model
    torch.cuda.empty_cache()
    return runs, launches


def check_small_quant(cfg_tier: str):
    """The tiny config in one quantized tier on the card (bf16 activations,
    the kernels, _int_mm) against the same quantized weights on the CPU
    (fp32, the plain versions), as check_small_reference does for bf16."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg = quant_config(tiny_test_config(), cfg_tier)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    errs = {}
    for do_sel, field in ((False, "logits"), (True, "mask_logits")):
        ref = getattr(ref_run.prefill(prep, do_sel), field).float()
        got = getattr(got_run.prefill(prep, do_sel), field).float().cpu()
        if do_sel:
            img_valid = torch.as_tensor(prep.img_valid)
            ref, got = ref[:, img_valid], got[:, img_valid]
        errs[field] = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"tiny config {cfg_tier}, card bf16 vs CPU fp32, max error / max |ref|: "
          + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card disagrees with the CPU reference in {cfg_tier}: {bad}")
    return errs


def same_weights(model, world: int) -> bool:
    """Every rank's per-tensor parameter sums (float64), all-gathered and
    compared: the ranks built the same weights."""
    import torch
    import torch.distributed as dist

    sums = torch.stack([p.detach().double().sum() for p in model.parameters()])
    parts = [torch.empty_like(sums) for _ in range(world)]
    dist.all_gather(parts, sums)
    return all(torch.equal(parts[0], p) for p in parts)


def launch_counts():
    """{row name: launches} so far (no kernel required)."""
    return read_launches([])


def launches_since(before, required=()):
    """Launches since the ``before`` snapshot; raises if a kernel of
    ``required`` did not launch in between."""
    delta = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    missing = [k for k in required if not delta.get(k)]
    if missing:
        raise AssertionError(f"the SP path never launched {missing}")
    return {k: v for k, v in delta.items() if v}


class CollectiveClock:
    """While open, counts the calls of ``dist.all_gather`` and
    ``dist.all_reduce`` (the only collectives of parallel/sequence.py) and
    their host time, the card synchronized at both ends of each call: the
    share of an SP prefill or train step that the ranks spend exchanging
    data. The synchronization serializes the card's queue, so the run it
    clocks is not the timed one."""

    NAMES = ("all_gather", "all_reduce")

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.calls, self.ms = 0, 0.0
        self.originals = {n: getattr(dist, n) for n in self.NAMES}

        def clocked(fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.calls += 1
                return out
            return call

        for n, fn in self.originals.items():
            setattr(dist, n, clocked(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.originals.items():
            setattr(dist, n, fn)

    def record(self, total_ms: float) -> dict:
        return {"collectives": self.calls, "collective_ms": self.ms, "clocked_run_ms": total_ms}


def sp_expected_k9(cfg, prep, do_selection: bool, world: int) -> int:
    """K9 launches of one SP prefill by JAX's per-call-site rule: the layers
    before the keep policy over S slots and the resume layers over out_len
    (pruned), or every layer over S minus the glimpse slots (unpruned), each
    where the length divides over the ranks."""
    gp, n_layers = cfg.gp, cfg.text.num_hidden_layers
    s = prep.input_ids.shape[1]
    if not do_selection:
        s -= gp.le_length if gp.has_le else 0
        return n_layers if s % world == 0 else 0
    first = gp.reduce_layer + 1
    return ((first if s % world == 0 else 0)
            + (n_layers - first if prep.out_len % world == 0 else 0))


def sp_serve(cfg, runner, cases, rank, world, tier="bf16", modes=(True, False)):
    """Per batch and mode: rank 0 runs the single-process prefill and
    generate (the reference), then every rank runs them under SP, timed with
    CUDA events, with the kernels' launches of the SP prefill; -> records."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import sequence_parallel

    runs = []
    for name, prep in cases:
        for do_sel in modes:
            ref = None
            if rank == 0:  # the other ranks wait: this card's time is rank 0's alone
                runner.generate(prep, max_new_tokens=2, do_selection=do_sel)  # warm-up
                single_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
                res = runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                ref = (pre.logits.float().cpu(), pre.mask_logits, res, single_ms)
            dist.barrier()
            with sequence_parallel(dist.group.WORLD):
                runner.generate(prep, max_new_tokens=2, do_selection=do_sel)  # warm-up
                torch.cuda.reset_peak_memory_stats()
                before = launch_counts()
                prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
                prefill_launches = launches_since(before)
                decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                    pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                    MAX_NEW_TOKENS, cfg.eos_token_id))
                res = runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                peak = torch.cuda.max_memory_allocated()
                with CollectiveClock() as clock:
                    clocked_ms, _ = timed_ms(lambda: runner.prefill(prep, do_sel))
            check_outputs(cfg, prep, pre, res, do_sel)
            k9 = prefill_launches.get("flash_attention[causal+qpos]", 0)
            k9 += prefill_launches.get("flash_attention_int8[causal+qpos]", 0)
            want = sp_expected_k9(cfg, prep, do_sel, world)
            if k9 != want:
                raise AssertionError(f"SP {tier} ({name}) launched K9 {k9} times in one "
                                     f"prefill, not {want}")
            run = {"rank": rank, "tier": tier, "batch": name,
                   "mode": "pruned" if do_sel else "unpruned", "S": int(prep.input_ids.shape[1]),
                   "out_len": int(prep.out_len), "prefill_ms": prefill_ms,
                   "decode_ms_per_token": decode_ms / MAX_NEW_TOKENS, "peak_mem_gib": peak / 2**30,
                   "k9_launches_per_prefill": k9, "prefill_launches": prefill_launches,
                   "prefill_collectives": clock.record(clocked_ms)}
            if do_sel:
                run["kept_img_tokens"] = res.keep_img.sum(1).tolist()
            if ref is not None:
                logits, mask, single, run["single_prefill_ms"] = ref
                run["first_logits_rel_diff"] = rel_err(pre.logits.float().cpu(), logits)
                run["tokens_equal_share"] = float((res.sequences == single.sequences).mean())
                if do_sel:
                    img_valid = torch.as_tensor(prep.img_valid, device=mask.device)
                    run["mask_logits_rel_diff"] = rel_err(pre.mask_logits[:, img_valid],
                                                          mask[:, img_valid])
                    run["single_kept_img_tokens"] = single.keep_img.sum(1).tolist()
                bad = {k: run[k] for k in ("first_logits_rel_diff", "mask_logits_rel_diff")
                       if not run.get(k, 0.0) <= 0.1}
                if bad:
                    raise AssertionError(f"SP {tier} ({name}) disagrees with one process: {bad}")
            print("sp path " + json.dumps(run), flush=True)
            runs.append(run)
    return runs


def sp_train(cfg, model, rank, work: Path, steps: int = 2):
    """The smoke's training batch 2 on a GPTrainer over the 7B: rank 0's
    single-process loss and gradients (the other ranks wait) against the
    same under SP, the SP gradients equal on every rank (each holds the
    whole gradient), then ``steps`` SP train steps, timed; -> record."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import sequence_parallel
    from glimpseprune_torch.training.train_step import compute_loss

    trainer = make_trainer(cfg, model, work)
    batch = trainer.collate(trainer.cfg, next(trainer.dataset.batches(2, seed=0)),
                            trainer.tokenize, trainer.load_image, trainer.tcfg, device="cuda")
    params = trainer.optimizer.params

    def loss_and_grads():
        for p in params.values():
            p.grad = None
        total, _ = compute_loss(trainer.cfg, model, batch,
                                torch.Generator(device="cuda").manual_seed(0))
        total.backward()
        return total.item(), {k: p.grad.clone() for k, p in params.items()}

    single_ms, loss1, grads1 = None, None, None
    if rank == 0:  # the other ranks wait: this card's time is rank 0's alone
        loss_and_grads()  # warm-up
        single_ms, (loss1, grads1) = timed_ms(loss_and_grads)
    dist.barrier()
    with sequence_parallel(dist.group.WORLD):
        before = launch_counts()
        grad_ms, (loss2, grads2) = timed_ms(loss_and_grads)
        launches = launches_since(before, ["flash_attention_lse[causal+qpos]",
                                           "flash_attention_backward[causal+qpos]"])
        sums = torch.stack([g.double().sum() for g in grads2.values()])
        parts = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, sums)
        if not all(torch.equal(parts[0], p) for p in parts):
            raise AssertionError("the ranks' SP gradients differ")
        # rank 0 holds the single-process gradients; the others equal its SP ones
        errs = {k: rel_err(grads2[k], grads1[k]) for k in grads1} if rank == 0 else {}
        worst = max(errs, key=errs.get) if errs else None
        with CollectiveClock() as clock:
            clocked_ms, _ = timed_ms(loss_and_grads)
        step_records = []
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats()
            ms, metrics = timed_ms(lambda: trainer.step_fn(
                batch, torch.Generator(device="cuda").manual_seed(i)))
            step_records.append({"ms": ms, "loss": float(metrics["loss"]),
                                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    record = {"rank": rank, "S": int(batch["input_ids"].shape[1]),
              "patches": int(batch["patches"].shape[0]), "loss_single": loss1, "loss_sp": loss2,
              "loss_rel_diff": 0.0 if loss1 is None else abs(loss2 - loss1) / abs(loss1),
              "single_loss_and_grad_ms": single_ms, "sp_loss_and_grad_ms": grad_ms,
              "worst_grad_rel_diff": errs.get(worst, 0.0), "worst_grad": worst,
              "grad_rel_diff": errs, "steps": step_records, "launches": launches,
              "loss_and_grad_collectives": clock.record(clocked_ms)}
    print("sp train " + json.dumps({k: v for k, v in record.items() if k != "grad_rel_diff"}),
          flush=True)
    bad = [st for st in step_records if not np.isfinite(st["loss"])]
    if bad or not (record["worst_grad_rel_diff"] <= 0.1 and record["loss_rel_diff"] <= 0.1):
        raise AssertionError(f"SP training disagrees with one process: {worst} "
                             f"{record['worst_grad_rel_diff']}, loss {loss2} vs {loss1}, "
                             f"steps {step_records}")
    shutil.rmtree(work, ignore_errors=True)
    return record


def sp_rank(rank: int, world: int, cases):
    """Phase 11 on one rank: the 7B with the same random weights as every
    other rank (checked by checksum), SP generate in bf16 and q8, SP
    training, the tiny config under SP against the CPU; -> records."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.quantization import quantize_model

    torch.cuda.set_device(0)
    cfg = ModelConfig.load(str(ROOT / "configs" / "model_qwen2_5_7b_gp"))
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    if not same_weights(model, world):
        raise AssertionError(f"rank {rank} built other weights than rank 0")
    reset_launches()
    out = {"rank": rank, "gloo_gather_ms": gloo_gather_ms(cfg, cases[0][1], world),
           "serve": sp_serve(cfg, GlimpsePruneRunner(cfg, model), cases, rank,
                                           world)}
    out["train"] = sp_train(cfg, model, rank, ROOT / "build" / f"chip_smoke_sp_train{rank}")
    del model
    torch.cuda.empty_cache()
    qcfg = sp_q8_config(cfg)
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    quantize_model(model, "int8", cfg=qcfg)
    out["q8"] = sp_serve(qcfg, GlimpsePruneRunner(qcfg, model), cases[:1], rank, world,
                         tier="q8", modes=(True,))
    del model
    torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    out["tiny"] = check_small_reference(dist.group.WORLD)
    return out


def gloo_gather_ms(cfg, prep, world: int, iters: int = 10):
    """Host-clock ms of one gather_kv of this rank's K and V shard (bf16 on
    the card, through gloo) at the LLM's and the ViT's full-attention shape
    of ``prep``: what each sharded attention layer adds to the prefill."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import gather_kv, get_sequence_parallel, sequence_parallel

    t, v = cfg.text, cfg.vision
    b, s = prep.input_ids.shape
    # (shape of the stacked k and v shard, its sequence dim)
    shapes = {"llm": ((2, b, s // world, t.num_key_value_heads, t.head_dim), 2),
              "vit": ((2, prep.patches.shape[0] // world, v.num_heads, v.head_dim), 1)}
    out = {}
    with sequence_parallel(dist.group.WORLD):
        sp = get_sequence_parallel()
        for name, (shape, dim) in shapes.items():
            x = torch.randn(shape, device="cuda").bfloat16()
            gather_kv(x, dim, sp)  # warm-up
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                gather_kv(x, dim, sp)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def sp_q8_config(cfg):
    """(q8) with the text tower's attention in int8 too (K9-int8 under SP)."""
    import dataclasses

    from glimpseprune_torch.quantization import quantized_config

    q = quantized_config(cfg, "int8", act_quant="prefill", attn_qk_int8="text")
    return dataclasses.replace(q, text=dataclasses.replace(q.text, kv_cache_quant="int8"))


def run_sp_path(cases):
    """Phase 11: SP_WORLD ranks on the one card over gloo, started by the
    port's launcher; -> (every rank's records, summed launches)."""
    from glimpseprune_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch(sp_rank, SP_WORLD, cases, backend="gloo", timeout_s=900)
    secs = time.perf_counter() - t0
    required = ["flash_attention[causal+qpos]", "flash_attention_lse[causal+qpos]",
                "flash_attention_backward[causal+qpos]", "flash_attention_int8[causal+qpos]",
                "window_attention_fused", "flash_attention[segmented]"]
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks)
                for k in set().union(*(r["launches"] for r in ranks))}
    missing = [k for k in required if not launches.get(k)]
    if missing:
        raise AssertionError(f"the SP path never launched {missing}")
    print(f"SP path over {SP_WORLD} ranks on one card (gloo) in {secs:.1f} s; launches, summed "
          "over the ranks: " + json.dumps(launches))
    return ranks, launches, secs


def main() -> int:
    smi = find_card()
    import torch

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

    t_start = time.perf_counter()
    build_s = build_kernels()
    cfg = ModelConfig.load(str(ROOT / "configs" / "model_qwen2_5_7b_gp"))
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (896, 672, 3), dtype=np.uint8),
              rng.integers(0, 256, (672, 504, 3), dtype=np.uint8)]
    lo, hi = 1000, 150000  # ordinary text ids, clear of the special tokens
    # (a) two rows, two image sizes: segmented ViT attention, padded windows,
    # left-padded LLM rows; (b) one 896x672 image: 3072 patches, one unpadded
    # segment, so the ViT's full attention takes the dense flavour
    prep_a = prepare_inputs(cfg, make_prompts(cfg, rng, 2, lo, hi), images)
    prep_b = prepare_inputs(cfg, make_prompts(cfg, rng, 1, lo, hi), images[:1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_window_attention(cfg, prep_a, gen)]
    k8_row = check_window_attention_unfused(cfg, prep_a, gen)
    window_edges = check_window_edges(gen)
    kernels += check_flash_attention(cfg, prep_a, prep_b, gen)
    flash_edges = check_flash_edges(gen)

    t0 = time.perf_counter()
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init_random: {n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    runs, serve_launches = run_main_path(cfg, model, [("a", prep_a), ("b", prep_b)])
    small = check_small_reference()

    # phase 10: the compressed serving path, before training changes the model
    t_comp = time.perf_counter()
    compressed_runs, compressed_launches = run_compressed_path(
        cfg, model, [("a", prep_a), ("b", prep_b)], runs)
    importance_variant = run_importance_variant(cfg, model, prep_a)
    k8_row["launches"] = importance_variant["launches"]["window_attention"]
    k8_row["launches_7b_compressed"] = compressed_launches["window_attention"]
    k8_row["note"] = (f"launches: the importance path of a vision config with full attention "
                      f"at {WINDOWED_LAST_FULLATT} (not in configs/), 4 ViT calls; 0 on the "
                      "published 7B's compressed path")
    small_importance = check_small_importance(cfg, model, prep_a)
    small_compressed = check_small_compressed()
    compressed_s = time.perf_counter() - t_comp

    work = ROOT / "build" / "chip_smoke_train"
    trainer = make_trainer(cfg, model, work)
    first = trainer.collate(trainer.cfg, next(trainer.dataset.batches(2, seed=0)),
                            trainer.tokenize, trainer.load_image, trainer.tcfg, device="cuda")
    train_kernels, dense_check = check_flash_training(cfg, first, gen)
    print("K2-lse and K3 small dense case (checked, not on the training path): "
          + json.dumps(dense_check))
    kernels += train_kernels
    t_train = time.perf_counter()
    steps, train_launches = run_training_path(trainer)
    train_s = time.perf_counter() - t_train
    small_train = check_small_train_step()
    shutil.rmtree(work, ignore_errors=True)
    del trainer, model, first
    torch.cuda.empty_cache()

    # phase 8: the quantized tiers' kernels at the main path's shapes
    quant_kernels = check_int4_kernels(cfg, gen, decode_m=prep_a.input_ids.shape[0],
                                       prefill_m=int(prep_a.valid.size))
    quant_kernels += check_flash_int8(cfg, prep_a, prep_b, gen)
    # phase 9: the quantized serving path
    t_quant = time.perf_counter()
    quant_runs, quant_launches, small_quant = [], {}, {}
    for tier in QUANT_TIERS:
        tier_runs, quant_launches[tier] = run_quant_tier(cfg, tier, [("a", prep_a),
                                                                     ("b", prep_b)])
        quant_runs += tier_runs
        small_quant[tier] = check_small_quant(tier)
    quant_s = time.perf_counter() - t_quant

    # phase 11: K9 against its plain versions and the monolithic kernels,
    # then the SP path over SP_WORLD ranks on this card (the parent holds no
    # model: each rank builds its own 7B)
    torch.cuda.empty_cache()
    k9_rows, k9_report = check_flash_qpos(cfg, prep_a, gen)
    torch.cuda.empty_cache()
    sp_ranks, sp_launches, sp_s = run_sp_path([("a", prep_a), ("b", prep_b)])
    for k in k9_rows:
        k["launches"] = sp_launches[k["name"]]
        k["launches_per_rank"] = [r["launches"].get(k["name"], 0) for r in sp_ranks]

    for k in kernels:
        path = train_launches if k["name"].startswith(("flash_attention_lse",
                                                       "flash_attention_backward")) else \
            serve_launches
        k["launches"] = path[k["name"]]
    kernels.insert(1, k8_row)
    off_path = {  # why a checked flavour has no launch on the (q4) path
        "matmul_int4_prefill[a16": "no shape routes W4A16 (JAX int4_matmul.py:268)",
        "flash_attention_int8[causal": "q4 runs int8 attention in the ViT only",
        "flash_attention_int8[": "q4 runs the ViT's int8 attention with int8 PV"}
    for k in quant_kernels:  # launches on the (q4) quantized serving path
        k["launches"] = quant_launches["q4"].get(k["name"], 0)
        if not k["launches"]:
            k["note"] = next(v for p, v in off_path.items() if k["name"].startswith(p))
    kernels += quant_kernels
    kernels += k9_rows
    for k in kernels:
        print(speed(k))
    print(json.dumps({"card": smi, "build_s": build_s, "runs": runs,
                      "window_edge_cases": window_edges, "flash_edge_cases": flash_edges,
                      "tiny_reference_err": small, "train_steps": steps,
                      "train_path_s": train_s, "tiny_train_err": small_train,
                      "training_launches": train_launches, "quantized_runs": quant_runs,
                      "quantized_launches": quant_launches, "quantized_path_s": quant_s,
                      "tiny_quantized_err": small_quant,
                      "compressed_runs": compressed_runs,
                      "compressed_launches": compressed_launches,
                      "importance_variant": importance_variant,
                      "importance_tower_err": small_importance,
                      "tiny_compressed_err": small_compressed,
                      "compressed_path_s": compressed_s,
                      "k9_shards": k9_report, "sp_path_s": sp_s, "sp_launches": sp_launches,
                      "sp_ranks": sp_ranks,
                      "total_s": time.perf_counter() - t_start}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
