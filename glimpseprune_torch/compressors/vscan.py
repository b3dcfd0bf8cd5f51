"""VScan (ViT stage): complementary global + local window scan, then
merging.

Counterpart of glimpseprune_tpu/compressors/vscan.py (reference
qwen_vscan/model/qwen2_5_vl_utils.py:136 ``window_selection`` walks tokens
in descending local-attention order, capping each 4x4 token window at
ceil(K_local / n_windows); :97 ``token_merging`` folds dropped tokens into
their nearest kept token by cosine similarity). The greedy walk has an
exact closed form: a token is kept iff its within-window score rank is
under the cap AND its rank among such eligible tokens is under K_local.
Global picks then take the top K - K_local by last-block attention with the
kept tokens masked out (qwen2_5_vl_custom.py:245-257). The JAX one-hot
matmul of the merge is a scatter-add.
"""

from __future__ import annotations

import torch

from glimpseprune_torch.compressors.divprune import cosine_similarity
from glimpseprune_torch.ops.keep_policy import descending_rank


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """Inverse of each row's permutation."""
    ar = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def window_capped_rank(
    scores: torch.Tensor,   # [B, N]
    valid: torch.Tensor,    # [B, N]
    grid_hw: torch.Tensor,  # [B, 2] merged (h, w); tokens are raster order
    window: int,
) -> torch.Tensor:
    """Within-window descending-score rank per token [B, N] (padding forms
    its own group)."""
    b, n = scores.shape
    j = torch.arange(n, device=scores.device)[None, :]
    h = grid_hw[:, 0:1]
    w = grid_hw[:, 1:2].clamp(min=1)
    row, col = j // w, j % w
    nwh = (h // window).clamp(min=1)
    nww = (w // window).clamp(min=1)
    win_id = torch.minimum(row // window, nwh - 1) * nww + torch.minimum(col // window, nww - 1)
    win_id = torch.where(valid, win_id, n)

    # lexicographic sort by (window, global score rank)
    keys = win_id.long() * (n + 1) + descending_rank(scores, valid)
    order = torch.argsort(keys, dim=-1)
    sorted_win = torch.gather(win_id, 1, order)
    pos = torch.arange(n, device=scores.device).expand(b, n)
    is_start = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    is_start[:, 1:] = sorted_win[:, 1:] != sorted_win[:, :-1]
    group_start = torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    return torch.gather(pos - group_start, 1, _inverse(order))


def vscan_select(
    local_scores: torch.Tensor,   # [B, N] attention received, local layer
    global_scores: torch.Tensor,  # [B, N] attention received, last layer
    valid: torch.Tensor,          # [B, N]
    grid_hw: torch.Tensor,        # [B, 2]
    k: int,
    window: int = 4,
) -> torch.Tensor:
    """Keep mask [B, N]: K/2 window-capped local picks + K - K/2 global
    picks, K = min(k, n_valid) per row."""
    k_eff = valid.sum(-1).clamp(max=k)
    k_local = k_eff // 2
    k_global = k_eff - k_local
    n_windows = (grid_hw[:, 0] // window).clamp(min=1) * (grid_hw[:, 1] // window).clamp(min=1)
    cap = torch.ceil(k_local / n_windows.clamp(min=1)).to(torch.int32)

    w_rank = window_capped_rank(local_scores, valid, grid_hw, window)
    eligible = (w_rank < cap[:, None]) & valid
    keep_local = eligible & (descending_rank(local_scores, eligible) < k_local[:, None])

    g_scores = global_scores.float().masked_fill(keep_local, -float("inf"))
    g_rank = descending_rank(g_scores, valid & ~keep_local)
    keep_global = valid & ~keep_local & (g_rank < k_global[:, None])
    return keep_local | keep_global


def merge_dropped_into_kept(
    embeds: torch.Tensor,  # [B, N, D]
    keep: torch.Tensor,    # [B, N]
    valid: torch.Tensor,
    scaling: float = 1.0,
) -> torch.Tensor:
    """Each dropped token joins its nearest kept token (cosine); kept tokens
    become (scaling * kept + sum of assigned) / (scaling + count)."""
    x = embeds.float()
    sim = cosine_similarity(x).masked_fill(~keep[:, None, :], -float("inf"))
    assign = sim.argmax(-1)  # [B, N] nearest kept index
    dropped = valid & ~keep
    summed = torch.zeros_like(x).scatter_add_(
        1, assign[..., None].expand_as(x), x * dropped[..., None])
    counts = torch.zeros(keep.shape, dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, assign, dropped.float())
    merged = (scaling * x + summed) / (scaling + counts)[..., None]
    return torch.where(keep[..., None], merged, x).to(embeds.dtype)
