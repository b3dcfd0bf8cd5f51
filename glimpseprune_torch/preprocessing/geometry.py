"""Host-side vision geometry for the windowed ViT.

A copy of glimpseprune_tpu/preprocessing/geometry.py, kept in the port so that the port
imports nothing of the JAX package; tests/test_torch_config.py holds the
two equal.

All index machinery the reference computes on-device per call (window
permutation, cu_seqlens, vision RoPE position ids — reference
transformers_gp/models/qwen2_5_vl/model_gp.py:1757-1825 `_visual_forward`)
is host-known from `grid_thw` alone, so we compute it once in numpy and feed
the jitted ViT statically-shaped arrays:

- `window_index`: permutation over *merged* token positions grouping tokens
  into spatial windows (the ViT runs on the permuted sequence).
- segment ids instead of cu_seqlens: per-patch int arrays where attention is
  allowed iff seg[i] == seg[j] — the XLA/splash-attention-friendly encoding of
  block-diagonal masks.
- vision RoPE (h, w) position ids in merge-block raster order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def cu_seqlens_from_grid(grid_thw: np.ndarray) -> np.ndarray:
    """Per-frame full-attention boundaries: repeat h*w by t, cumsum."""
    grid_thw = np.asarray(grid_thw)
    lens = np.repeat(grid_thw[:, 1] * grid_thw[:, 2], grid_thw[:, 0])
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def get_window_index(
    grid_thw: np.ndarray,
    window_size: int,
    spatial_merge_size: int,
    patch_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Window permutation over merged tokens + patch-level window boundaries.

    Returns (window_index [num_merged_tokens], cu_window_seqlens [num_windows+1]).
    Semantics match Qwen2.5-VL's window partitioning: each image's merged
    token grid is padded up to a multiple of the merger window, windows are
    enumerated row-major, and in-window tokens keep raster order.
    """
    grid_thw = np.asarray(grid_thw)
    merge_unit = spatial_merge_size * spatial_merge_size
    win = window_size // spatial_merge_size // patch_size  # merged tokens per window side

    index_parts: List[np.ndarray] = []
    cu: List[int] = [0]
    base = 0
    for t, h, w in grid_thw:
        lh, lw = int(h) // spatial_merge_size, int(w) // spatial_merge_size
        idx = np.arange(int(t) * lh * lw).reshape(int(t), lh, lw)
        pad_h = (-lh) % win
        pad_w = (-lw) % win
        idx_p = np.full((int(t), lh + pad_h, lw + pad_w), -1, dtype=np.int64)
        idx_p[:, :lh, :lw] = idx
        nwh, nww = (lh + pad_h) // win, (lw + pad_w) // win
        idx_p = idx_p.reshape(int(t), nwh, win, nww, win)
        idx_p = idx_p.transpose(0, 1, 3, 2, 4).reshape(int(t), nwh * nww, win, win)
        seqlens = (idx_p != -1).sum(axis=(2, 3)).reshape(-1)
        flat = idx_p.reshape(-1)
        valid = flat[flat != -1]
        index_parts.append(valid + base)
        cu_part = np.cumsum(seqlens) * merge_unit + cu[-1]
        cu.extend(int(x) for x in cu_part)
        base += int(t) * lh * lw
    window_index = np.concatenate(index_parts).astype(np.int32)
    cu_window_seqlens = np.array(cu, dtype=np.int32)
    # drop empty windows from full-window padding
    keep = np.concatenate([[True], np.diff(cu_window_seqlens) != 0])
    return window_index, cu_window_seqlens[keep]


def segment_ids_from_cu_seqlens(cu_seqlens: np.ndarray, total_len: int) -> np.ndarray:
    """cu_seqlens boundaries -> per-position segment ids [total_len]."""
    seg = np.zeros(total_len, dtype=np.int32)
    for i in range(1, len(cu_seqlens) - 1):
        seg[cu_seqlens[i] :] += 1
    return seg


def vision_pos_ids(grid_thw: np.ndarray, spatial_merge_size: int) -> np.ndarray:
    """(h, w) RoPE position ids per patch in merge-block raster order [N, 2]."""
    grid_thw = np.asarray(grid_thw)
    parts = []
    for t, h, w in grid_thw:
        h, w = int(h), int(w)
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))

        def merge_order(x):
            m = spatial_merge_size
            return (
                x.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
            )

        p = np.stack([merge_order(hpos), merge_order(wpos)], axis=-1)
        parts.append(np.tile(p, (int(t), 1)))
    return np.concatenate(parts, axis=0).astype(np.int32)


@dataclass
class VisionGeometry:
    """Everything the jitted ViT needs, precomputed from grid_thw.

    **Window-padded layout** (TPU-native): every attention window occupies
    exactly `window_patches` consecutive slots (edge windows padded), so
    windowed blocks run as a dense batched [n_windows, wp] attention — no
    big masks, MXU-shaped — and only the few full-attention blocks need
    segment masking. The reference instead packs variable-length windows and
    loops cu_seqlens (model_gp.py:1760-1801).

    Arrays over `padded_len` slots (= n_windows * window_patches, rounded up
    to the bucket):
      patch_src        [padded_len]  natural patch index per slot, -1 = pad
      full_segment_ids [padded_len]  image/frame id per slot, -1 = pad
      pos_ids          [padded_len, 2] RoPE (h, w) ids (0 at pads)
      patch_valid      [padded_len]  bool
      slot_of_merged   [n_merged_real] natural merged token -> merged-slot row
    """

    grid_thw: np.ndarray
    num_patches: int
    padded_len: int
    window_patches: int                 # wp: patches per window (static)
    patch_src: np.ndarray
    full_segment_ids: np.ndarray
    pos_ids: np.ndarray
    patch_valid: np.ndarray
    slot_of_merged: np.ndarray

    @property
    def n_windows(self) -> int:
        return self.padded_len // self.window_patches


def build_vision_geometry(
    grid_thw: np.ndarray,
    window_size: int,
    spatial_merge_size: int,
    patch_size: int,
    padded_len: int = None,
) -> VisionGeometry:
    """Window-padded packed geometry for one batch of images.

    Slot layout: images in order; per image, windows row-major; per window,
    merged tokens in raster order padded to win*win merged slots; per merged
    token its merge_unit patches. `padded_len` (if given) must be a multiple
    of window_patches; extra slots become whole pad windows.
    """
    grid_thw = np.asarray(grid_thw)
    mu = spatial_merge_size * spatial_merge_size
    win = window_size // spatial_merge_size // patch_size  # merged tokens/side
    wp = win * win * mu  # patches per window
    num_patches = int((grid_thw[:, 0] * grid_thw[:, 1] * grid_thw[:, 2]).sum())
    n_merged_real = num_patches // mu

    # natural merged index grid per image -> window-padded slot order
    merged_src_parts: List[np.ndarray] = []  # natural merged idx per merged slot
    seg_parts: List[np.ndarray] = []
    base = 0
    for img_id, (t, h, w) in enumerate(grid_thw):
        lh, lw = int(h) // spatial_merge_size, int(w) // spatial_merge_size
        for tt in range(int(t)):
            idx = base + tt * lh * lw + np.arange(lh * lw).reshape(lh, lw)
            pad_h = (-lh) % win
            pad_w = (-lw) % win
            idx_p = np.full((lh + pad_h, lw + pad_w), -1, dtype=np.int64)
            idx_p[:lh, :lw] = idx
            nwh, nww = (lh + pad_h) // win, (lw + pad_w) // win
            idx_p = idx_p.reshape(nwh, win, nww, win).transpose(0, 2, 1, 3).reshape(-1)
            merged_src_parts.append(idx_p)
            seg_parts.append(np.where(idx_p >= 0, img_id, -1))
        base += int(t) * lh * lw
    merged_src = np.concatenate(merged_src_parts)  # [n_merged_slots]
    merged_seg = np.concatenate(seg_parts)

    n_merged_slots = len(merged_src)
    real_len = n_merged_slots * mu
    if padded_len is None:
        padded_len = real_len
    assert padded_len % wp == 0 and padded_len >= real_len, (padded_len, real_len, wp)
    n_slots_padded = padded_len // mu
    pad_n = n_slots_padded - n_merged_slots
    merged_src = np.concatenate([merged_src, np.full(pad_n, -1, dtype=np.int64)])
    merged_seg = np.concatenate([merged_seg, np.full(pad_n, -1, dtype=np.int32)])

    # patch-level arrays
    patch_src = np.where(
        merged_src[:, None] >= 0,
        merged_src[:, None] * mu + np.arange(mu)[None, :],
        -1,
    ).reshape(-1).astype(np.int32)
    full_seg = np.repeat(merged_seg, mu).astype(np.int32)
    patch_valid = patch_src >= 0

    pos_nat = vision_pos_ids(grid_thw, spatial_merge_size)  # [num_patches, 2]
    pos = np.zeros((padded_len, 2), dtype=np.int32)
    pos[patch_valid] = pos_nat[patch_src[patch_valid]]

    slot_of_merged = np.full(n_merged_real, -1, dtype=np.int32)
    real_slots = np.nonzero(merged_src >= 0)[0]
    slot_of_merged[merged_src[real_slots]] = real_slots

    return VisionGeometry(
        grid_thw=grid_thw,
        num_patches=num_patches,
        padded_len=padded_len,
        window_patches=wp,
        patch_src=patch_src,
        full_segment_ids=full_seg,
        pos_ids=pos,
        patch_valid=patch_valid,
        slot_of_merged=slot_of_merged,
    )
