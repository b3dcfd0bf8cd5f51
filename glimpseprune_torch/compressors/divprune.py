"""DivPrune: greedy max-min diversity selection (training-free).

Counterpart of glimpseprune_tpu/compressors/divprune.py (reference
llava_divprune/model/llava_arch.py:152-172): iteratively add the token
whose minimum cosine distance to the already-selected set is largest; the
first pick is the token with the largest nearest-other distance. The JAX
``fori_loop`` is a Python loop of k - 1 device-side steps that never reads
back to the host.
"""

from __future__ import annotations

import torch


def cosine_similarity(features: torch.Tensor) -> torch.Tensor:
    """[B, N, D] -> [B, N, N] fp32 cosine similarities (norms floored at
    1e-8)."""
    f = features.float()
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-8)
    return f @ f.transpose(1, 2)


def divprune_select(features: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """features [B, N, D], valid [B, N] -> keep mask [B, N] with exactly
    min(k, n_valid) True per row."""
    b, n, _ = features.shape
    dist = 1.0 - cosine_similarity(features)
    big = 1e9
    dist = dist.masked_fill(~(valid[:, :, None] & valid[:, None, :]), big)
    # first pick: largest second-smallest column distance (the self-distance
    # ~0 takes the smallest slot, as the reference's topk(..., 2)[1])
    second = torch.topk(dist, 2, dim=1, largest=False).values[:, 1, :]
    first = torch.where(valid, second, -big).argmax(-1)
    ar = torch.arange(b, device=features.device)
    keep = torch.zeros((b, n), dtype=torch.bool, device=features.device)
    keep[ar, first] = True
    min_d = dist[ar, first]  # [B, N] distance to the selected set
    n_valid = valid.sum(-1)
    for i in range(1, k):
        scores = torch.where(valid & ~keep, min_d, -big)
        j = scores.argmax(-1)
        can_add = (i < n_valid) & (scores[ar, j] > -big)
        keep[ar, j] = keep[ar, j] | can_add
        min_d = torch.minimum(min_d, dist[ar, j])
    return keep & valid
