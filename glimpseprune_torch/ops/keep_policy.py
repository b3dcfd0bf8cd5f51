"""Keep-set policy: threshold, ratio cap, minimum floor and anchors.

Counterpart of glimpseprune_tpu/ops/keep_policy.py (``_descending_rank``
:27, ``keep_scores_with_policy`` :41, and the per-image policy of
``gp.per_image_policy``, ``_group_rank_desc`` :92 and
``keep_scores_with_policy_grouped`` :112), with the same static-shape [B, N]
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


def group_rank_desc(scores: torch.Tensor, groups: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-row rank (0 = best) of each entry within its group by descending
    score (JAX ``_group_rank_desc`` :92); invalid entries form their own
    trailing group. Ties within a group are broken by position."""
    n = scores.shape[-1]
    g = torch.where(valid, groups.long(), torch.full_like(groups.long(), n))
    keys = g * (n + 1) + descending_rank(scores, valid)  # unique per row
    order = torch.argsort(keys, dim=-1)
    sorted_g = torch.gather(g, -1, order)
    pos = torch.arange(n, device=scores.device).expand_as(g)
    is_start = torch.ones_like(valid)
    is_start[:, 1:] = sorted_g[:, 1:] != sorted_g[:, :-1]
    group_start = torch.cummax(torch.where(is_start, pos, torch.full_like(pos, -1)), -1).values
    return torch.gather(pos - group_start, -1, torch.argsort(order, dim=-1))


def keep_scores_with_policy_grouped(probs: torch.Tensor, valid: torch.Tensor,
                                    group_ids: torch.Tensor, threshold: float,
                                    max_remain_ratio: Optional[float],
                                    min_remain_num: Optional[int],
                                    anchor_mask: Optional[torch.Tensor] = None,
                                    max_groups: int = 8) -> torch.Tensor:
    """The keep policy per image of a multi-image row (JAX
    ``keep_scores_with_policy_grouped`` :112, ``gp.per_image_policy``): the
    threshold, the ratio cap and the floor are counted within each image
    (group_ids [B, N], at most max_groups a row), not over the row."""
    probs = probs.float()
    keep = (probs > threshold) & valid
    rank = group_rank_desc(probs, group_ids, valid)
    one_hot = (group_ids.long()[..., None] == torch.arange(max_groups, device=probs.device)) \
        & valid[..., None]  # [B, N, G]
    g = group_ids.long().clamp(0, max_groups - 1)

    def group_count(mask):  # per entry: the count of True within its group
        return torch.gather((one_hot & mask[..., None]).sum(1), -1, g)

    n_valid_g = group_count(valid)
    if max_remain_ratio is not None:
        cap = torch.floor(max_remain_ratio * n_valid_g.float()).long()
        keep = torch.where(group_count(keep) > cap, (rank < cap) & valid, keep)
    if min_remain_num is not None:
        under = group_count(keep) < min_remain_num
        keep = torch.where(under, keep | ((rank < min_remain_num) & valid), keep)
    if anchor_mask is not None:
        keep = keep | (anchor_mask & valid)
    return keep
