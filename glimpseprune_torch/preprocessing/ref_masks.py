"""Bounding-box -> token-grid reference masks.

A copy of glimpseprune_tpu/preprocessing/ref_masks.py, kept in the port so that the port
imports nothing of the JAX package; tests/test_torch_config.py holds the
two equal.

Semantics follow the reference processor (transformers_gp/models/qwen2_5_vl/
process_gp.py:12-57): normalized xyxy boxes rasterized onto the merged token
grid with inclusive corners, clamped to grid bounds.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _bbox_to_grid_corners(bbox, H: int, W: int):
    x1, y1, x2, y2 = bbox
    gx1 = int(x1 * W)
    gy1 = int(y1 * H)
    gx2 = min(int(x2 * W), W - 1)
    gy2 = min(int(y2 * H), H - 1)
    return gx1, gy1, gx2, gy2


def ref_token_mask_from_bboxes(
    normed_bboxes: Sequence[Sequence[float]], grid_hw: Tuple[int, int]
) -> np.ndarray:
    """N normalized [0,1] xyxy boxes -> bool mask [H, W] on the token grid."""
    H, W = grid_hw
    mask = np.zeros((H, W), dtype=bool)
    for bbox in normed_bboxes:
        gx1, gy1, gx2, gy2 = _bbox_to_grid_corners(bbox, H, W)
        mask[gy1 : gy2 + 1, gx1 : gx2 + 1] = True
    return mask


def bbox_grid_indices(
    normed_bboxes: Sequence[Sequence[float]], grid_hw: Tuple[int, int]
) -> List[int]:
    """Flat token-grid indices covered by the boxes, first-hit order."""
    H, W = grid_hw
    seen = np.zeros(H * W, dtype=bool)
    out: List[int] = []
    for bbox in normed_bboxes:
        gx1, gy1, gx2, gy2 = _bbox_to_grid_corners(bbox, H, W)
        for i in range(gy1, gy2 + 1):
            for j in range(gx1, gx2 + 1):
                idx = i * W + j
                if not seen[idx]:
                    seen[idx] = True
                    out.append(idx)
    return out


def ref_token_mask_from_image_mask(
    image_mask: np.ndarray, grid_hw: Tuple[int, int], threshold: int = 127
) -> np.ndarray:
    """Grayscale PIL-style mask array -> bool token-grid mask (nearest resize)."""
    from PIL import Image

    H, W = grid_hw
    pil = Image.fromarray(image_mask)
    resized = np.asarray(pil.resize((W, H), Image.NEAREST))
    return resized > threshold
