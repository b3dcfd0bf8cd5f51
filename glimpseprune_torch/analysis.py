"""Analytic FLOPs accounting + oracle retention analysis.

Rebuild of the reference analysis tools:
- `cal_flops.py` (reference cal_flops.py:11-60, :284-450): analytic
  prefill/decode FLOPs for the vanilla vs GP pipelines, reportable from
  eval result jsonls (num_gen_tokens + mask_ratio per sample)
- `avg_tokens.py` (reference avg_tokens.py:69-113): dataset-level oracle
  retention if ground-truth bboxes were rasterized on the token grid

A copy of glimpseprune_tpu/analysis.py over the port's config and
preprocessing; tests/test_torch_analysis.py holds the two equal.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from glimpseprune_torch.config import ModelConfig


# --------------------------------------------------------------------- #
# FLOPs model


def llm_layer_flops(cfg: ModelConfig, seq: int, kv_len: Optional[int] = None) -> float:
    """FLOPs of one decoder layer processing `seq` new tokens against
    `kv_len` total keys (defaults to seq: full self-attention prefill)."""
    t = cfg.text
    kv_len = kv_len if kv_len is not None else seq
    h, hd = t.hidden_size, t.head_dim
    q_dim = t.num_attention_heads * hd
    kv_dim = t.num_key_value_heads * hd
    proj = 2 * seq * h * (q_dim + 2 * kv_dim) + 2 * seq * q_dim * h  # qkv + o
    attn = 2 * seq * kv_len * q_dim * 2  # qk^T and pv
    mlp = 2 * seq * h * t.intermediate_size * 3
    return float(proj + attn + mlp)


def vision_flops(cfg: ModelConfig, n_patches: int) -> float:
    v = cfg.vision
    per_block = (
        2 * n_patches * v.hidden_size * (4 * v.hidden_size)       # qkv+o proj
        + 2 * n_patches * (v.window_size // v.patch_size) ** 2 * v.hidden_size * 2
        + 2 * n_patches * v.hidden_size * v.intermediate_size * 3
    )
    merger = 2 * (n_patches // v.spatial_merge_unit) * (
        v.spatial_merge_unit * v.hidden_size
    ) * (v.spatial_merge_unit * v.hidden_size + v.out_hidden_size)
    embed = 2 * n_patches * (3 * v.temporal_patch_size * v.patch_size**2) * v.hidden_size
    return float(v.depth * per_block + merger + embed)


def lm_head_flops(cfg: ModelConfig, seq: int) -> float:
    return float(2 * seq * cfg.text.hidden_size * cfg.text.vocab_size)


def vanilla_pipeline_flops(cfg: ModelConfig, n_text: int, n_img: int,
                           n_decode: int) -> Dict[str, float]:
    t = cfg.text
    s = n_text + n_img
    prefill = vision_flops(cfg, n_img * cfg.vision.spatial_merge_unit)
    prefill += t.num_hidden_layers * llm_layer_flops(cfg, s) + lm_head_flops(cfg, 1)
    decode = sum(
        t.num_hidden_layers * llm_layer_flops(cfg, 1, kv_len=s + i) + lm_head_flops(cfg, 1)
        for i in range(n_decode)
    )
    return {"prefill": prefill, "decode": decode, "total": prefill + decode}


def gp_pipeline_flops(cfg: ModelConfig, n_text: int, n_img: int, n_keep: int,
                      n_decode: int) -> Dict[str, float]:
    t = cfg.text
    gp = cfg.gp
    s = n_text + n_img + (gp.le_length if gp.has_le else 0)
    r = n_text + n_keep
    reduce_layer = min(gp.reduce_layer, t.num_hidden_layers - 1)
    prefill = vision_flops(cfg, n_img * cfg.vision.spatial_merge_unit)
    prefill += (reduce_layer + 1) * llm_layer_flops(cfg, s)
    prefill += (t.num_hidden_layers - reduce_layer - 1) * llm_layer_flops(cfg, r)
    # harvest row + fuser (tiny, counted for completeness)
    prefill += 2 * s * t.num_attention_heads * t.head_dim * len(gp.selected_layers)
    n_fuser = len(gp.selected_visual_layers)
    qk = gp.attn_fuse_size + gp.visual_cond_size
    prefill += n_fuser * (
        2 * n_img * qk * qk * 2 + 2 * n_img * n_img * qk * 2
        + 2 * n_img * gp.attn_fuse_size * gp.attn_fuse_size * 2 * 3
    )
    prefill += lm_head_flops(cfg, 1)
    decode = sum(
        t.num_hidden_layers * llm_layer_flops(cfg, 1, kv_len=r + i) + lm_head_flops(cfg, 1)
        for i in range(n_decode)
    )
    return {"prefill": prefill, "decode": decode, "total": prefill + decode}


def flops_report_from_results(
    results_jsonl: str,
    cfg: ModelConfig,
    n_text: int = 64,
    n_img_default: int = 1280,
) -> Dict[str, float]:
    """Average per-sample FLOPs, vanilla vs GP, from an eval results file."""
    rows = [json.loads(l) for l in open(results_jsonl)]
    if not rows:
        return {}
    van, gp = [], []
    for r in rows:
        n_img = n_img_default
        if r.get("token_grid"):
            n_img = int(np.prod(r["token_grid"]))
        n_keep = int(round(r.get("mask_ratio", 1.0) * n_img))
        nd = int(r.get("num_gen_tokens", 0) or 0)
        van.append(vanilla_pipeline_flops(cfg, n_text, n_img, nd)["total"])
        gp.append(gp_pipeline_flops(cfg, n_text, n_img, n_keep, nd)["total"])
    return {
        "avg_vanilla_tflops": float(np.mean(van)) / 1e12,
        "avg_gp_tflops": float(np.mean(gp)) / 1e12,
        "flops_reduction": 1.0 - float(np.mean(gp)) / float(np.mean(van)),
        "num_samples": len(rows),
    }


# --------------------------------------------------------------------- #
# oracle retention (avg_tokens)


def oracle_retention(
    samples: Iterable,
    cfg: ModelConfig,
    image_sizes: Optional[Sequence[Tuple[int, int]]] = None,
    max_pixels: Optional[int] = None,
) -> Dict[str, float]:
    """Average token retention if ground-truth bboxes drove pruning.

    samples: EvalSample-like with .normed_bboxes and .img_path (or pass
    image_sizes (h, w) to avoid touching the filesystem; a ``.npy`` image's
    size is read from its header, other files' through PIL).
    """
    from glimpseprune_torch.evalsuite.data import read_image_size
    from glimpseprune_torch.preprocessing.image import (
        DEFAULT_MAX_PIXELS,
        smart_resize,
    )
    from glimpseprune_torch.preprocessing.ref_masks import ref_token_mask_from_bboxes

    v = cfg.vision
    factor = v.patch_size * v.spatial_merge_size
    ratios: List[float] = []
    for i, s in enumerate(samples):
        if s.normed_bboxes is None:
            continue
        if image_sizes is not None:
            h, w = image_sizes[i]
        else:
            w, h = read_image_size(s.img_path)
        rh, rw = smart_resize(h, w, factor, max_pixels=max_pixels or DEFAULT_MAX_PIXELS)
        grid = (rh // factor, rw // factor)
        mask = ref_token_mask_from_bboxes(s.normed_bboxes, grid)
        ratios.append(float(mask.mean()))
    return {
        "avg_retention": float(np.mean(ratios)) if ratios else 0.0,
        "avg_prune_rate": 1.0 - float(np.mean(ratios)) if ratios else 0.0,
        "num_samples": len(ratios),
    }
