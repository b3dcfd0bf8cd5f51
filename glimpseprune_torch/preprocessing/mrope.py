"""mRoPE (multimodal rotary) position-index computation, host-side.

A copy of glimpseprune_tpu/preprocessing/mrope.py, kept in the port so that the port
imports nothing of the JAX package; tests/test_torch_config.py holds the
two equal.

Numpy reimplementation of Qwen2.5-VL's 3-D rope index semantics: text tokens
advance all three (t, h, w) components together; each vision span gets grid
coordinates offset from the running position; after a span the running
position jumps to max+1. Verified against the HF implementation in
tests/test_preprocessing.py. The reference calls this on-device per prefill
(model_gp.py:1963); here it is pure preprocessing feeding the jitted model a
[3, B, L] int array.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def get_rope_index(
    input_ids: np.ndarray,
    image_grid_thw: Optional[np.ndarray] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    attention_mask: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[Sequence[float]] = None,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    tokens_per_second: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (position_ids [3, B, L], rope_deltas [B, 1])."""
    input_ids = np.asarray(input_ids)
    B, L = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    position_ids = np.ones((3, B, L), dtype=np.int64)
    deltas = np.zeros((B, 1), dtype=np.int64)

    if image_grid_thw is None and video_grid_thw is None:
        # pure text: sequential positions over non-padded tokens
        for b in range(B):
            sel = attention_mask[b] == 1
            n = int(sel.sum())
            position_ids[:, b, sel] = np.arange(n)
            deltas[b, 0] = n - L
        return position_ids, deltas

    img_idx = 0
    vid_idx = 0
    for b in range(B):
        sel = attention_mask[b] == 1
        ids = input_ids[b][sel]
        tokens = ids.tolist()
        n = len(tokens)

        vision_starts = np.nonzero(ids == vision_start_token_id)[0]
        next_after = ids[vision_starts + 1] if len(vision_starts) else np.array([])
        n_images = int((next_after == image_token_id).sum())
        n_videos = int((next_after == video_token_id).sum())

        pos_parts = []
        st = 0
        remain_images, remain_videos = n_images, n_videos
        for _ in range(n_images + n_videos):
            ed_image = tokens.index(image_token_id, st) if (remain_images > 0 and image_token_id in tokens[st:]) else n + 1
            ed_video = tokens.index(video_token_id, st) if (remain_videos > 0 and video_token_id in tokens[st:]) else n + 1
            if ed_image < ed_video:
                t, h, w = (int(x) for x in image_grid_thw[img_idx])
                spgt = 0.0
                img_idx += 1
                remain_images -= 1
                ed = ed_image
            else:
                t, h, w = (int(x) for x in video_grid_thw[vid_idx])
                spgt = second_per_grid_ts[vid_idx] if second_per_grid_ts is not None else 1.0
                vid_idx += 1
                remain_videos -= 1
                ed = ed_video
            gt, gh, gw = t, h // spatial_merge_size, w // spatial_merge_size
            text_len = ed - st
            st_idx = (pos_parts[-1].max() + 1) if pos_parts else 0
            if text_len > 0:
                txt = np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx
                pos_parts.append(txt)
            # HF casts second_per_grid_t to the int64 range_tensor dtype
            # BEFORE the multiply (modeling_qwen2_5_vl.py:1093-1097), so
            # fractional seconds-per-grid truncate to whole steps — matched
            # here for positional parity with released checkpoints
            t_index = (
                np.broadcast_to(np.arange(gt)[:, None], (gt, gh * gw))
                * int(spgt) * tokens_per_second
            ).astype(np.int64).reshape(-1)
            h_index = np.broadcast_to(np.arange(gh)[None, :, None], (gt, gh, gw)).reshape(-1)
            w_index = np.broadcast_to(np.arange(gw)[None, None, :], (gt, gh, gw)).reshape(-1)
            pos_parts.append(np.stack([t_index, h_index, w_index]) + text_len + st_idx)
            st = ed + gt * gh * gw

        if st < n:
            st_idx = (pos_parts[-1].max() + 1) if pos_parts else 0
            text_len = n - st
            pos_parts.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)

        positions = np.concatenate(pos_parts, axis=1)
        position_ids[:, b, sel] = positions
        deltas[b, 0] = positions.max() + 1 - L
    return position_ids, deltas
