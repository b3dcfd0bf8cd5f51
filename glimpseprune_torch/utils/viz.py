"""Mask visualization: overlay keep masks on images (reference demo_gp.py:23-52
`apply_mask_on_image`), plus an ASCII renderer for terminal demos.

A copy of glimpseprune_tpu/utils/viz.py (numpy only), kept in the port so
that the port imports nothing of the JAX package; tests/test_torch_analysis.py
holds the two equal."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def apply_mask_on_image(
    image: np.ndarray,          # [H, W, 3] uint8
    token_mask: np.ndarray,     # [gh, gw] bool keep mask
    alpha: float = 0.5,
    dim_color: Tuple[int, int, int] = (0, 0, 0),
) -> np.ndarray:
    """Dim dropped-token regions; kept regions stay at full brightness."""
    h, w = image.shape[:2]
    gh, gw = token_mask.shape
    ys = (np.arange(h) * gh // h).clip(0, gh - 1)
    xs = (np.arange(w) * gw // w).clip(0, gw - 1)
    pixel_keep = token_mask[ys[:, None], xs[None, :]]
    out = image.astype(np.float32)
    dim = out * (1 - alpha) + np.array(dim_color, dtype=np.float32) * alpha
    out = np.where(pixel_keep[..., None], out, dim)
    return out.astype(np.uint8)


def ascii_mask(token_mask: np.ndarray, kept: str = "#", dropped: str = ".") -> str:
    return "\n".join("".join(kept if v else dropped for v in row) for row in token_mask)
