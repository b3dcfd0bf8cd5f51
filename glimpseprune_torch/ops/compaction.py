"""Fixed-budget sequence and KV compaction.

Counterpart of glimpseprune_tpu/ops/compaction.py:21-96. Each row's
surviving positions are gathered in order and right-aligned (left-padded)
into [B, R] buffers with a validity mask. The JAX package writes the float
gathers as one-hot matmuls (a TPU workaround); here they are index gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompactedState(NamedTuple):
    """Gather plan for one compaction: apply to any [B, L, ...] tensor."""

    src: torch.Tensor     # [B, R] source index into the length-L axis
    valid: torch.Tensor   # [B, R] bool; False = left padding
    n_kept: torch.Tensor  # [B] survivor counts


def compaction_indices(keep: torch.Tensor, out_len: int) -> CompactedState:
    """keep [B, L] bool -> left-padded gather plan of length out_len.

    If a row keeps more than out_len tokens, the latest survivors win."""
    b, l = keep.shape
    pos = torch.arange(l, device=keep.device)
    order = torch.argsort(torch.where(keep, pos, pos + l), dim=-1)  # kept first, in order
    n = keep.sum(-1)
    src_rank = torch.arange(out_len, device=keep.device)[None, :] - (out_len - n)[:, None]
    valid = src_rank >= 0
    src = torch.gather(order, 1, src_rank.clamp(0, l - 1))
    return CompactedState(src=src, valid=valid, n_kept=n)


def _batch_index(plan: CompactedState) -> torch.Tensor:
    return torch.arange(plan.src.shape[0], device=plan.src.device)[:, None]


def gather_tokens(x: torch.Tensor, plan: CompactedState, fill=0) -> torch.Tensor:
    """x [B, L, ...] -> [B, R, ...]; padding slots get `fill`."""
    out = x[_batch_index(plan), plan.src]
    vmask = plan.valid.reshape(plan.valid.shape + (1,) * (x.ndim - 2))
    return torch.where(vmask, out, torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def gather_positions(position_ids: torch.Tensor, plan: CompactedState) -> torch.Tensor:
    """position_ids [3, B, L] -> [3, B, R]; padding slots get 1 (the
    reference pads positions with 1)."""
    out = torch.gather(position_ids, 2, plan.src[None].expand(position_ids.shape[0], -1, -1))
    return torch.where(plan.valid[None], out, torch.ones_like(out))


def gather_kv(kv: torch.Tensor, plan: CompactedState) -> torch.Tensor:
    """kv [n_layers, B, L, heads, dim] -> [n_layers, B, R, heads, dim]."""
    out = kv[:, _batch_index(plan), plan.src]
    return torch.where(plan.valid[None, :, :, None, None], out, torch.zeros_like(out))
