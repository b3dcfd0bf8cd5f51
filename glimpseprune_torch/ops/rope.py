"""Rotary position embeddings: 2-D vision RoPE and 3-D mRoPE.

Counterpart of glimpseprune_tpu/ops/rope.py, same layouts: the mRoPE
section merge happens when the tables are built, so attention sees
ordinary [B, L, D] cos/sin tables.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., L, n_heads, head_dim]; cos/sin: [..., L, head_dim],
    broadcast over heads and computed in x's dtype."""
    cos = cos[..., :, None, :].to(x.dtype)
    sin = sin[..., :, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exponent)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  mrope_section: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids [3, B, L] -> (cos, sin) each [B, L, head_dim], fp32.

    Frequencies are taken `mrope_section[i]` at a time from position
    channel i % 3 (t, h, w), then duplicated for both rotate_half halves."""
    sections = list(mrope_section)
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope_section {sections} does not cover head_dim {head_dim}")
    inv = _inv_freq(head_dim, theta, position_ids.device)
    freqs = position_ids.float()[..., None] * inv  # [3, B, L, head_dim//2]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(freqs[i % 3, ..., start:start + sec])
        start += sec
    half = torch.cat(parts, dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()


def vision_rope_cos_sin(pos_ids: torch.Tensor, head_dim: int,
                        theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos_ids [P, 2] (h, w) -> (cos, sin) each [P, head_dim], fp32.

    Half the rotary dims encode h and half encode w; the [P, head_dim//2]
    table is duplicated to cover both rotate_half halves."""
    inv = _inv_freq(head_dim // 2, theta, pos_ids.device)
    h = pos_ids[:, 0].float()[:, None] * inv
    w = pos_ids[:, 1].float()[:, None] * inv
    half = torch.cat([h, w], dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()
