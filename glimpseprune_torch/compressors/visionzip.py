"""VisionZip: attention-dominant top-k + uniform-stride contextual merging.

Counterpart of glimpseprune_tpu/compressors/visionzip.py (reference
qwen_visionzip/qwen2_5vl_visionzip.py:1916-1972 for the selection and
merge, :598-615 for the importance: per-token attention received in the
last ViT block, merge-unit pooled, with head-averaged keys as the
similarity metric). The JAX one-hot matmul of the merge is a scatter-add.
"""

from __future__ import annotations

from typing import Tuple

import torch

from glimpseprune_torch.ops.keep_policy import descending_rank


def visionzip_select(
    embeds: torch.Tensor,      # [B, N, D] merged visual embeds (LLM space)
    importance: torch.Tensor,  # [B, N] attention-received scores
    keys: torch.Tensor,        # [B, N, Dk] similarity metric (ViT keys)
    valid: torch.Tensor,       # [B, N]
    dominant_ratio: float = 0.65,
    contextual_ratio: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (keep mask [B, N], updated embeds [B, N, D]).

    Kept set = dominant top-k by importance plus contextual targets
    (uniform stride over the non-dominant subsequence); each remaining
    non-dominant token is merged (key-similarity argmax) into its nearest
    target, whose embedding becomes target + mean(assigned)."""
    b, n, d = embeds.shape
    n_valid = valid.sum(-1)
    # the ratios multiply in fp32, as in the JAX package
    dom_k = (dominant_ratio * n_valid).to(torch.int32).clamp(min=1)
    ctx_k_static = max(int(contextual_ratio * n), 1)
    ctx_k = (contextual_ratio * n_valid).to(torch.int32).clamp(min=1)

    rank = descending_rank(importance.float(), valid)
    dominant = (rank < dom_k[:, None]) & valid

    # ordinal position within the valid non-dominant subsequence
    nd = valid & ~dominant
    pos_nd = torch.cumsum(nd, dim=-1) - 1
    step = (nd.sum(-1) // ctx_k).clamp(min=1)[:, None]
    is_target = nd & (pos_nd % step == 0) & (pos_nd // step < ctx_k[:, None])

    # up to ctx_k_static target slots per row, in natural order
    tpos = torch.arange(n, device=embeds.device)
    t_idx = torch.argsort(torch.where(is_target, tpos, tpos + n), dim=-1)[:, :ctx_k_static]
    t_valid = torch.gather(is_target, 1, t_idx)

    kn = keys.float()
    kn = kn / torch.linalg.vector_norm(kn, dim=-1, keepdim=True).clamp(min=1e-8)
    t_keys = torch.gather(kn, 1, t_idx[:, :, None].expand(-1, -1, kn.shape[-1]))
    sim = (kn @ t_keys.transpose(1, 2)).masked_fill(~t_valid[:, None, :], -float("inf"))

    to_merge = nd & ~is_target
    assign = sim.argmax(-1)  # [B, N] into the target slots
    src = embeds.float() * to_merge[..., None]
    agg = torch.zeros((b, ctx_k_static, d), dtype=torch.float32, device=embeds.device)
    agg.scatter_add_(1, assign[..., None].expand(-1, -1, d), src)
    counts = torch.zeros((b, ctx_k_static), dtype=torch.float32, device=embeds.device)
    counts.scatter_add_(1, assign, to_merge.float())
    agg = agg / counts.clamp(min=1.0)[..., None]

    t_embeds = torch.gather(embeds, 1, t_idx[:, :, None].expand(-1, -1, d))
    new_t = t_embeds + torch.where(t_valid[..., None], agg, 0.0).to(embeds.dtype)
    upd = torch.where(t_valid[..., None], new_t, t_embeds)
    new_embeds = embeds.scatter(1, t_idx[:, :, None].expand(-1, -1, d), upd)

    keep = dominant | is_target
    return keep & valid, new_embeds
