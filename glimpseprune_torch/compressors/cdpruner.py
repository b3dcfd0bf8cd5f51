"""CDPruner: conditional-DPP greedy MAP selection.

Counterpart of glimpseprune_tpu/compressors/cdpruner.py (reference
llava_cdpruner/model/llava_arch.py:141-188): kernel = relevance x cosine
similarity x relevance; the fast greedy MAP picks the token with the
largest conditional marginal gain (di2s) each step and updates the
Cholesky-style residuals (cis). The JAX ``fori_loop`` is a Python loop of
k device-side steps that never reads back to the host.
"""

from __future__ import annotations

import torch

from glimpseprune_torch.compressors.divprune import cosine_similarity


def cdpruner_select(features: torch.Tensor, relevance: torch.Tensor, valid: torch.Tensor,
                    k: int) -> torch.Tensor:
    """features [B, N, D] (similarity space), relevance [B, N] (higher =
    keep), valid [B, N] -> keep mask [B, N] with min(k, n_valid) True per
    row. relevance is min-max normalized over each row's valid tokens, as
    in the reference."""
    b, n, _ = features.shape
    sim = cosine_similarity(features)
    inf = float("inf")
    r = relevance.float()
    rmin = torch.where(valid, r, inf).amin(-1, keepdim=True)
    rmax = torch.where(valid, r, -inf).amax(-1, keepdim=True)
    r = (r - rmin + 1e-6) / (rmax - rmin).clamp(min=1e-6)
    r = torch.where(valid, r, 0.0)
    kernel = r[:, :, None] * sim * r[:, None, :]
    kernel = kernel.masked_fill(~(valid[:, :, None] & valid[:, None, :]), 0.0)

    neg_inf = -1e30
    di2s = torch.where(valid, torch.diagonal(kernel, dim1=1, dim2=2), neg_inf)
    cis = torch.zeros((k, b, n), dtype=torch.float32, device=features.device)
    keep = torch.zeros((b, n), dtype=torch.bool, device=features.device)
    ar = torch.arange(b, device=features.device)
    for i in range(k):
        j = di2s.argmax(-1)  # [B]
        dj = di2s[ar, j]
        can_add = dj > neg_inf / 2
        keep[ar, j] = keep[ar, j] | can_add
        # rows of cis from step i on are still zero: they add nothing
        proj = torch.einsum("tb,tbn->bn", cis[:i, ar, j], cis[:i])
        eis = (kernel[ar, j] - proj) / dj.clamp(min=1e-12).sqrt()[:, None]
        eis = torch.where(can_add[:, None], eis, 0.0)
        cis[i] = eis
        di2s = di2s - eis.square()
        di2s[ar, j] = neg_inf
    return keep & valid
