"""LLaVA-family host orchestration: input prep for the shared runner.

Counterpart of glimpseprune_tpu/models/llava/runner.py
(``expand_to_square_and_resize`` :32, ``llava_normalize`` :52,
``prepare_llava_inputs`` :57, ``prepare_llava_chat_inputs`` :174,
``make_llava_runner`` :212), in numpy as there. It gives the same
``PreparedInputs`` as the Qwen prep, with LLaVA's geometry: the image
padded to a square with the CLIP mean and resized to 336 (llava's "pad"),
normalized pixels [B, S, S, 3] in ``patches``, a fixed G x G token grid,
the identity fuser permutation with one global segment, 1-D positions
broadcast over the three mRoPE channels, left-padded rows, and bbox ref
masks and anchors on the G x G grid. Generation runs through the shared
``GlimpsePruneRunner`` with a ``Llava_GP``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.models.llava.gp_model import CLIPTowerConfig
from glimpseprune_torch.models.qwen2_5_vl.inputs import FuserGeometry, PreparedInputs, _round_up
from glimpseprune_torch.preprocessing.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from glimpseprune_torch.preprocessing.ref_masks import ref_token_mask_from_bboxes


def expand_to_square_and_resize(image: np.ndarray, size: int) -> np.ndarray:
    """Pad to square with the CLIP background mean, then resize bicubically
    with PIL (llava 'pad'). PIL returns a copy where the square already has
    the target side, so then no resize runs and PIL is not imported: the
    same pixels, on a machine without PIL."""
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    h, w = image.shape[:2]
    side = max(h, w)
    bg = tuple(int(x * 255) for x in OPENAI_CLIP_MEAN)
    canvas = np.empty((side, side, 3), dtype=np.uint8)
    canvas[...] = np.array(bg, dtype=np.uint8)
    top = (side - h) // 2
    left = (side - w) // 2
    canvas[top: top + h, left: left + w] = image
    if side == size:
        return canvas
    from PIL import Image

    return np.asarray(Image.fromarray(canvas).resize((size, size), Image.BICUBIC))


def llava_normalize(image: np.ndarray) -> np.ndarray:
    x = image.astype(np.float32) / 255.0
    return (x - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD


def prepare_llava_inputs(
    cfg: ModelConfig,
    clip_cfg: CLIPTowerConfig,
    prompt_ids: Sequence[Sequence[int]],
    images: Sequence[np.ndarray],
    normed_bboxes=None,
    answer_ids=None,
    seq_multiple: int = 64,
) -> PreparedInputs:
    """One image marker (``cfg.image_token_id``) per prompt, expanded to
    G * G image slots; the glimpse slots (eos ids) follow the prompt, then
    the answer where ``answer_ids`` is given (its labels, -100 elsewhere)."""
    B = len(prompt_ids)
    g = clip_cfg.grid
    N = g * g
    gp = cfg.gp
    le_len = gp.le_length if gp.has_le else 0

    pixels = np.stack(
        [llava_normalize(expand_to_square_and_resize(np.asarray(im), clip_cfg.image_size))
         for im in images]
    )  # [B, S, S, 3]

    rows, label_rows, le_starts = [], [], []
    for b, ids in enumerate(prompt_ids):
        ids = list(ids)
        if ids.count(cfg.image_token_id) != 1:
            raise ValueError(f"prompt {b} must hold exactly one image marker "
                             f"{cfg.image_token_id}")
        at = ids.index(cfg.image_token_id)
        expanded = ids[:at] + [cfg.image_token_id] * N + ids[at + 1:]
        if answer_ids is not None:
            ans = list(answer_ids[b])
            rows.append(expanded + [cfg.eos_token_id] * le_len + ans)
            label_rows.append([-100] * (len(expanded) + le_len) + ans)
        else:
            rows.append(expanded + [cfg.eos_token_id] * le_len)
        le_starts.append(len(expanded))

    S = _round_up(max(len(r) for r in rows), seq_multiple)
    input_ids = np.full((B, S), cfg.pad_token_id, dtype=np.int32)
    valid = np.zeros((B, S), dtype=bool)
    labels = None if answer_ids is None else np.full((B, S), -100, dtype=np.int32)
    le_start_arr = np.zeros((B,), dtype=np.int32)
    img_slots = np.zeros((B, N), dtype=np.int32)
    img_valid = np.ones((B, N), dtype=bool)
    packed_idx = np.zeros((B, N), dtype=np.int32)
    for b, row in enumerate(rows):
        off = S - len(row)
        input_ids[b, off:] = row
        valid[b, off:] = True
        if labels is not None:
            labels[b, off:] = label_rows[b]
        le_start_arr[b] = off + le_starts[b]
        img_slots[b] = np.nonzero(input_ids[b] == cfg.image_token_id)[0]
        packed_idx[b] = b * N + np.arange(N)

    # 1-D positions broadcast to the three mRoPE channels (Llama rope uses
    # one section, which reads channel 0)
    pos1d = np.where(valid, np.cumsum(valid, axis=1) - 1, 1)
    position_ids = np.broadcast_to(pos1d[None], (3, B, S)).astype(np.int64).copy()

    hw = np.stack([np.repeat(np.arange(g), g), np.tile(np.arange(g), g)], axis=-1)
    fuser = FuserGeometry(
        window_index=np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy(),
        reverse_index=np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy(),
        segment_ids=np.zeros((B, N), dtype=np.int32),
        pos_ids=np.broadcast_to(hw[None], (B, N, 2)).astype(np.int32).copy(),
        valid=img_valid.copy(),
    )

    budgets = np.zeros((B,), dtype=np.int64)
    for b in range(B):
        if gp.max_remain_ratio is not None:
            k = max(int(gp.max_remain_ratio * N), gp.min_remain_num or 0)
            budgets[b] = min(N, k + len(gp.anchor_positions))
        else:
            budgets[b] = N
    n_text = valid.sum(1) - N - le_len
    out_len = _round_up(int((n_text + budgets).max()), seq_multiple)

    ref_masks = None
    if normed_bboxes is not None:
        ref_masks = np.zeros((B, N), dtype=bool)
        for b, bxs in enumerate(normed_bboxes):
            if bxs is None:
                continue
            ref_masks[b] = ref_token_mask_from_bboxes(bxs, (g, g)).reshape(-1)

    anchor = None
    if gp.anchor_positions:
        anchor = np.zeros((B, N), dtype=bool)
        for b in range(B):
            for a in gp.anchor_positions:
                idx = {"tl": 0, "tr": g - 1, "bl": (g - 1) * g, "br": N - 1}[a]
                anchor[b, idx] = True

    dummy = np.zeros((1,), dtype=np.int32)
    return PreparedInputs(
        input_ids=input_ids,
        valid=valid,
        position_ids=position_ids,
        patches=pixels,            # [B, S, S, 3]: Llava_GP.vision_encode's input
        vis_pos_ids=dummy,
        full_seg=dummy,
        vis_valid=dummy,
        packed_idx=packed_idx,
        img_slots=img_slots,
        img_valid=img_valid,
        img_group=np.zeros((B, N), dtype=np.int32),
        fuser=fuser,
        le_start=le_start_arr if gp.has_le else None,
        grids=np.broadcast_to(np.array([1, g, g]), (B, 3)).copy(),
        grid_hw_rows=[[(g, g)] for _ in range(B)],
        out_len=out_len,
        n_img_tokens=np.full((B,), N, dtype=np.int64),
        ref_token_masks=ref_masks,
        anchor_mask=anchor,
        labels=labels,
    )


def prepare_llava_chat_inputs(
    cfg: ModelConfig,
    clip_cfg: CLIPTowerConfig,
    messages_list,
    images: Sequence[np.ndarray],
    tokenize,
    is_sft: bool = False,
    **kwargs,
) -> PreparedInputs:
    """The vicuna_v1 chat entry point (JAX :174-209): ``<image>`` markers
    map to ``cfg.image_token_id``, ``</s>`` (vicuna's sep2) to eos."""
    from glimpseprune_torch.preprocessing.chat import (
        LLAVA_IMAGE_TOKEN,
        chat_prompt_ids,
        render_vicuna_v1,
        split_sft_conversation,
    )

    sids = {LLAVA_IMAGE_TOKEN: cfg.image_token_id, "</s>": cfg.eos_token_id}
    prompts, answers = [], ([] if is_sft else None)
    for messages in messages_list:
        if is_sft:
            p, a = split_sft_conversation(messages, tokenize, sids, renderer=render_vicuna_v1)
            prompts.append(p)
            answers.append(a)
        else:
            text = render_vicuna_v1(messages, add_generation_prompt=True)
            prompts.append(chat_prompt_ids(text, tokenize, sids))
    return prepare_llava_inputs(cfg, clip_cfg, prompts, images, answer_ids=answers, **kwargs)


def make_llava_runner(cfg: ModelConfig, clip_cfg: CLIPTowerConfig, state: dict,
                      device="cuda", dtype=None):
    """A GlimpsePruneRunner over a Llava_GP holding ``state``, the port's
    state dict (``convert_llava_state_dict``'s output, or a whole model's),
    on the card unless the caller asks for another device, in dtype
    (default bf16); the GlimpsePrune modules that ``state`` lacks are drawn
    from seed 0."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    model = init_random(cfg, 0, device, dtype or torch.bfloat16, clip_cfg=clip_cfg,
                        base=state)
    return GlimpsePruneRunner(cfg, model)
