"""Keep-set policy: threshold, ratio cap, minimum floor and anchors.

Counterpart of glimpseprune_tpu/ops/keep_policy.py (``_descending_rank``
:27, ``keep_scores_with_policy`` :41), with the same static-shape [B, N]
formulation:

1. keep = prob > threshold
2. if the kept count exceeds floor(max_remain_ratio * N_valid), the keep
   set is replaced by the top-floor(ratio * N_valid) tokens
3. if fewer than min_remain_num survive, the top-min_remain_num are added
4. anchor positions are forced kept
"""

from __future__ import annotations

from typing import Optional

import torch


def descending_rank(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-row rank (0 = largest) among valid entries; invalid entries rank
    after all valid ones. Ties are broken by position (stable sort)."""
    neg = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(-neg, dim=-1, stable=True).indices
    return torch.sort(order, dim=-1, stable=True).indices


def keep_scores_with_policy(probs: torch.Tensor, valid: torch.Tensor, threshold: float,
                            max_remain_ratio: Optional[float],
                            min_remain_num: Optional[int],
                            anchor_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """probs/valid [B, N] -> keep mask [B, N] (False on invalid slots)."""
    probs = probs.float()
    keep = (probs > threshold) & valid
    n_valid = valid.sum(-1, keepdim=True)
    rank = descending_rank(probs, valid)
    if max_remain_ratio is not None:
        cap = torch.floor(max_remain_ratio * n_valid.float()).long()
        over = keep.sum(-1, keepdim=True) > cap
        keep = torch.where(over, (rank < cap) & valid, keep)
    if min_remain_num is not None:
        under = keep.sum(-1, keepdim=True) < min_remain_num
        keep = torch.where(under, keep | ((rank < min_remain_num) & valid), keep)
    if anchor_mask is not None:
        keep = keep | (anchor_mask & valid)
    return keep
