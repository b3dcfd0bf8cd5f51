#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``glimpseprune_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. find the card and print its name and power limit;
  2. build the CUDA kernels from glimpseprune_torch/csrc/, one nvcc per
     source, all at once (timed);
  3. K1, the fused window attention, against its plain version at the 7B
     ViT shape;
  4. K2, flash attention, against its plain version at each serving call
     site: ViT dense and segmented, LLM causal GQA, fuser Dqk != Dv;
  5. K2-lse (flash attention with the per-row LSE) and K3 (its backward)
     against their plain versions at the training batch's LLM causal GQA
     and fuser Dqk != Dv shapes, and at a small dense case;
  6. the serving path: Qwen2.5-VL-7B with the GlimpsePrune config and
     random bf16 weights, pruned and unpruned ``generate`` on a two-row
     batch and a one-row batch, with the kernels' launch counts; then the
     tiny config on the card against the same weights on the CPU in fp32;
  7. the training path: ``GPTrainer.train(max_steps=4)`` at batch 2 on the
     same 7B model over a synthetic jsonl dataset, with the kernels' launch
     counts, finite losses, changed trainable and bit-identical frozen
     weights; then one tiny-config train step on the card against the CPU.
Every kernel row carries its time, its plain version's time, one PyTorch
call's time where one computes the same function (``library_ms``: SDPA
with the same boolean mask, or its autograd backward; a yardstick the port
never calls) and ``bound_ms``: the larger of its bytes
over the card's memory rate and its operations over the bf16 tensor peak,
counted from this run's inputs. The line before the last is a JSON object
with one entry per kernel flavour; the last line is {"ok": true,
"device": {...}}.
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
K2_SRC = "glimpseprune_torch/csrc/flash_attention.cu"
K2_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:400"
K2_LSE_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:208"
K3_SRC = "glimpseprune_torch/csrc/flash_attention_bwd.cu"
K3_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:808"
KERNEL_LIBS = ("window_attention", "flash_attention", "flash_attention_bwd")
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
# H100 SXM published peaks (NVIDIA data sheet, dense): the bf16 tensor
# rate and HBM bandwidth; bound_ms is stated against them.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
MAX_NEW_TOKENS = 32
TRAIN_STEPS = 4


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


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it) from operations and bytes."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_window_attention(cfg, prep, gen):
    """K1 at the ViT shape the batch gives it (H=16, D=80, wp=64)."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention_fused,
        window_attention_fused_reference,
    )
    from glimpseprune_torch.ops.rope import vision_rope_cos_sin

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
    ms = cuda_ms(lambda: window_attention_fused(qkv, cos, sin, valid, wp))
    plain_ms = cuda_ms(lambda: window_attention_fused_reference(qkv, cos, sin, valid, wp))
    # valid queries x valid keys of each window, QK^T and PV, every head
    per_window = valid.reshape(-1, wp).sum(1).double()
    flops = 4.0 * float((per_window ** 2).sum()) * v.num_heads * v.head_dim
    bound_ms, bound_by = bound(flops, nbytes(qkv, cos, sin, valid, got))
    shape = f"qkv[{p},3,{v.num_heads},{v.head_dim}] wp={wp} valid={int(valid.sum())}"
    print(f"K1 window_attention_fused {shape}: max_abs_err={err:.3e} "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {KERNEL_ATOL}")
    # no single PyTorch call applies rope and attends within windows
    return {"name": "window_attention_fused", "route": "cuda", "source": K1_SRC,
            "replaces": K1_REPLACES, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "shape": shape}


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
        ms = cuda_ms(lambda: flash_attention(q, k, vv, segs, segs, causal=causal, dense=dense))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, vv, segs, segs,
                                                             causal=causal, dense=dense))
        lib_ms = cuda_ms(lambda: sdpa(q, k, vv, mask))
        bound_ms, bound_by = bound(2.0 * pairs * hq * (d_qk + d_v),
                                   nbytes(q, k, vv, got) + (0 if dense else 2 * segs.nbytes))
        fl = flavour(causal, dense, d_qk, d_v)
        shape = f"{name} q[{b},{hq},{s},{d_qk}] kv[{b},{hkv},{s},{d_qk}/{d_v}]"
        print(f"K2 flash_attention[{fl}] {shape}: max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"K2 {name} disagrees with its plain version: {err}")
        rows.append({"name": f"flash_attention[{fl}]", "route": "cuda", "source": K2_SRC,
                     "replaces": K2_REPLACES, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "shape": shape})
    return rows


def rel_err(got, ref, rows=None) -> float:
    """max |got - ref| / max |ref|, over the selected rows."""
    g, r = got.float(), ref.float()
    if rows is not None:
        g, r = g[rows], r[rows]
    return ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()


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
        bound_ms, bound_by = bound(2.0 * pairs * hq * (d_qk + d_v),
                                   nbytes(q, k, v, out, lse) + seg_bytes)
        print(f"K2-lse flash_attention_lse[{fl}] {shape}: max_abs_err={out_err:.3e} "
              f"lse_rel_err={lse_err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by})")
        lse_row = {"name": f"flash_attention_lse[{fl}]", "route": "cuda", "source": K2_SRC,
                   "replaces": K2_LSE_REPLACES, "max_abs_err": out_err, "lse_rel_err": lse_err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms, "shape": shape}

        # K3: dq, dk, dv against the plain fp32 backward on the same
        # inputs (the kernel's own forward output and LSE)
        dout = torch.randn(out.transpose(1, 2).shape, generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)
        grads = flash_attention_backward(q, k, v, segs, segs, out, lse, dout, causal=causal,
                                         dense=dense)
        torch.cuda.synchronize()
        refs = flash_attention_backward_reference(q.float(), k.float(), v.float(), segs, segs,
                                                  out.float(), lse, dout.float(),
                                                  causal=causal, dense=dense)
        errs = [rel_err(g, r) for g, r in zip(grads, refs)]
        abs_err = max((g.float() - r).abs().max().item() for g, r in zip(grads, refs))
        if not max(errs) <= GRAD_RTOL:
            raise AssertionError(f"K3 {name} disagrees with its plain version: "
                                 f"dq, dk, dv max err / max |ref| = {errs}")
        ms = cuda_ms(lambda: flash_attention_backward(q, k, v, segs, segs, out, lse, dout,
                                                      causal=causal, dense=dense))
        plain_ms = cuda_ms(lambda: flash_attention_backward_reference(
            q, k, v, segs, segs, out, lse, dout, causal=causal, dense=dense))
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        lib_out = sdpa(qr, kr, vr, mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qr, kr, vr), dout,
                                                     retain_graph=True))
        del lib_out
        bound_ms, bound_by = bound(2.0 * pairs * hq * (3 * d_qk + 2 * d_v),
                                   nbytes(q, k, v, out, lse, dout, *grads) + seg_bytes)
        print(f"K3 flash_attention_backward[{fl}] {shape}: max_abs_err={abs_err:.3e} "
              f"rel_err dq/dk/dv={errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        bwd_row = {"name": f"flash_attention_backward[{fl}]", "route": "cuda",
                   "source": K3_SRC, "replaces": K3_REPLACES, "max_abs_err": abs_err,
                   "rel_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms, "shape": shape}
        if dense:  # not on the training path: checked, not listed
            dense_check = {"lse_rel_err": lse_err, "grad_rel_err": max(errs),
                           "lse_ms": lse_row["ms"], "bwd_ms": ms}
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
    from glimpseprune_torch.ops.cuda.flash_attention import (
        FLAVOURS,
        flash_attention,
        flash_attention_backward,
        flash_attention_lse,
    )
    from glimpseprune_torch.ops.cuda.window_attention import window_attention_fused

    window_attention_fused.launches = 0
    for fn in (flash_attention, flash_attention_lse, flash_attention_backward):
        fn.launches = dict.fromkeys(FLAVOURS, 0)


def read_launches(required):
    """{row name: launches} since reset_launches(); raises if a kernel that
    the path must run was never launched."""
    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_lse,
    )
    from glimpseprune_torch.ops.cuda.window_attention import window_attention_fused

    launches = {"window_attention_fused": window_attention_fused.launches}
    for fn in (flash_attention, flash_attention_lse, flash_attention_backward):
        launches.update({f"{fn.__name__}[{k}]": v for k, v in fn.launches.items()})
    missing = [k for k in required if launches[k] == 0]
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


def check_small_reference():
    """The tiny config on the card (bf16, the kernels) against the same
    weights on the CPU (fp32, the plain versions, which the CPU tests hold
    equal to the JAX package): first logits of the unpruned prefill and mask
    logits of the pruned one, relative to their largest magnitude. The bound
    catches a wrong path; bf16 rounding through the tiny model stays far
    below it."""
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
    for do_sel, field in ((False, "logits"), (True, "mask_logits")):
        ref = getattr(ref_run.prefill(prep, do_sel), field).float()
        got = getattr(got_run.prefill(prep, do_sel), field).float().cpu()
        if do_sel:
            img_valid = torch.as_tensor(prep.img_valid)
            ref, got = ref[:, img_valid], got[:, img_valid]
        errs[field] = ((got - ref).abs().max() / ref.abs().max()).item()
    print("tiny config, card bf16 vs CPU fp32, max error / max |ref|: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card disagrees with the CPU reference: {bad}")
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
    kernels += check_flash_attention(cfg, prep_a, prep_b, gen)

    t0 = time.perf_counter()
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init_random: {n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    runs, serve_launches = run_main_path(cfg, model, [("a", prep_a), ("b", prep_b)])
    small = check_small_reference()

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

    for k in kernels:
        path = train_launches if k["name"].startswith(("flash_attention_lse",
                                                       "flash_attention_backward")) else \
            serve_launches
        k["launches"] = path[k["name"]]
    print(json.dumps({"card": smi, "build_s": build_s, "runs": runs,
                      "tiny_reference_err": small, "train_steps": steps,
                      "train_path_s": train_s, "tiny_train_err": small_train,
                      "training_launches": train_launches,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
