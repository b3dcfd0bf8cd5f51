"""Host-side input preparation for one batch, as numpy arrays.

A numpy copy of the JAX package's host prep: ``PreparedInputs`` and
``prepare_inputs`` (glimpseprune_tpu/models/qwen2_5_vl/runner.py:34-354),
``_vis_dense_hint`` (runner.py:410), and ``FuserGeometry`` with
``build_fuser_geometry`` (glimpseprune_tpu/gp/fuser.py:34-106). It is a
copy, not an import, because both of those modules import jax at module
top and the port never loads jax. tests/test_torch_inputs.py holds the copy
equal to the original, field by field. The numpy-only modules the prep
calls (``config``, ``preprocessing``) are the port's own copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.preprocessing import build_vision_geometry, get_rope_index


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class FuserGeometry:
    """Host-precomputed per-row (single image per row) fuser geometry.

    All arrays [B, N] (N = padded merged-token slots per row):
      window_index:  natural -> window order permutation within the row
      reverse_index: inverse permutation
      segment_ids:   attention blocks in *window order* (window or global,
                     chosen by attn_fuse_global at build time); -1 = padding
      pos_ids:       [B, N, 2] RoPE (h, w) ids in *window order*
      valid:         real-token mask in *natural order*
    """

    window_index: np.ndarray
    reverse_index: np.ndarray
    segment_ids: np.ndarray
    pos_ids: np.ndarray
    valid: np.ndarray


def build_fuser_geometry(
    grid_hw_list,  # per row: (h, w) or a LIST of (h, w) for multi-image rows
    n_slots: int,
    window_size: int,
    spatial_merge_size: int,
    patch_size: int,
    attn_fuse_global: bool,
) -> FuserGeometry:
    """Per-row fuser geometry; multi-image rows concatenate their images'
    token spans (the reference fuser runs the packed multi-image sequence
    with cu_seqlens boundaries; here per-image segment-id offsets)."""
    from glimpseprune_torch.preprocessing.geometry import (
        get_window_index,
        segment_ids_from_cu_seqlens,
        vision_pos_ids,
    )

    B = len(grid_hw_list)
    mu = spatial_merge_size * spatial_merge_size
    win_idx = np.zeros((B, n_slots), dtype=np.int32)
    rev_idx = np.zeros((B, n_slots), dtype=np.int32)
    segs = np.full((B, n_slots), -1, dtype=np.int32)
    pos = np.zeros((B, n_slots, 2), dtype=np.int32)
    valid = np.zeros((B, n_slots), dtype=bool)
    for b, grids in enumerate(grid_hw_list):
        if grids and isinstance(grids[0], (int, np.integer)):
            grids = [grids]  # single (h, w)
        off = 0
        seg_off = 0
        for (h, w) in grids:
            n = int(h) * int(w)
            grid = np.array([[1, h * spatial_merge_size, w * spatial_merge_size]])
            widx, cu_win = get_window_index(
                grid, window_size, spatial_merge_size, patch_size
            )
            if attn_fuse_global:
                seg_merged = np.zeros(n, dtype=np.int32)
                n_segs = 1
            else:
                seg_merged = segment_ids_from_cu_seqlens(cu_win // mu, n)
                n_segs = int(seg_merged.max()) + 1 if n else 0
            p_nat = vision_pos_ids(grid, spatial_merge_size)
            p_merged = p_nat.reshape(n, mu, 2)[:, 0] // spatial_merge_size
            win_idx[b, off : off + n] = off + widx
            segs[b, off : off + n] = seg_off + seg_merged
            pos[b, off : off + n] = p_merged[widx]
            valid[b, off : off + n] = True
            off += n
            seg_off += n_segs
        if off < n_slots:
            win_idx[b, off:] = np.arange(off, n_slots)
        rev_idx[b] = np.argsort(win_idx[b])
    return FuserGeometry(win_idx, rev_idx, segs, pos, valid)


@dataclass
class PreparedInputs:
    """Everything the jitted model consumes, as numpy arrays."""

    input_ids: np.ndarray          # [B, S]
    valid: np.ndarray              # [B, S]
    position_ids: np.ndarray       # [3, B, S]
    patches: np.ndarray            # [P, in_dim] window-padded slot order
    vis_pos_ids: np.ndarray        # [P, 2]
    full_seg: np.ndarray           # [P]
    vis_valid: np.ndarray          # [P] real-patch mask
    packed_idx: np.ndarray         # [B, N]
    img_slots: np.ndarray          # [B, N]
    img_valid: np.ndarray          # [B, N]
    img_group: np.ndarray          # [B, N] image index per slot (multi-image)
    fuser: FuserGeometry
    le_start: Optional[np.ndarray]  # [B]
    grids: np.ndarray              # [n_total_images, 3] flat, marker order
    out_len: int
    n_img_tokens: np.ndarray       # [B]
    grid_hw_rows: Optional[list] = None  # per row: [(h, w), ...] merged grids
    ref_token_masks: Optional[np.ndarray] = None  # [B, N]
    anchor_mask: Optional[np.ndarray] = None      # [B, N]
    labels: Optional[np.ndarray] = None           # [B, S]


def prepare_inputs(
    cfg: ModelConfig,
    prompt_ids: Sequence[Sequence[int]],
    images: Sequence[np.ndarray],
    normed_bboxes: Optional[Sequence[Optional[Sequence[Sequence[float]]]]] = None,
    answer_ids: Optional[Sequence[Sequence[int]]] = None,
    min_pixels: Optional[int] = None,
    max_pixels: Optional[int] = None,
    seq_multiple: int = 64,
    patch_multiple: int = 256,
    videos: Optional[Sequence] = None,
    video_seconds_per_grid: Optional[Sequence] = None,
) -> PreparedInputs:
    """Build statically-shaped model inputs for one batch.

    prompt_ids: token id lists with one `cfg.image_token_id` marker per
    image (un-expanded, reference processor semantics process_gp.py:132-144)
    and one `cfg.video_token_id` marker per video. images[b]: one HWC uint8
    array, or a LIST of arrays for multi-image rows (markers are expanded in
    order); [] for text-or-video-only rows. videos[b]: None, one [T, H, W, C]
    array, or a list of them; video_seconds_per_grid[b]: seconds per temporal
    grid step (scalar or per-video list; drives the mRoPE time axis,
    reference get_rope_index video branch + second_per_grid_ts).
    normed_bboxes[b]: bbox list (single image) or list of per-image bbox
    lists. answer_ids: training targets; when given, the glimpse slots are
    spliced in front of the answer and labels are emitted.
    """
    from glimpseprune_torch.preprocessing.image import (
        DEFAULT_MAX_PIXELS,
        DEFAULT_MIN_PIXELS,
        preprocess_image,
        preprocess_video,
    )
    from glimpseprune_torch.preprocessing.ref_masks import ref_token_mask_from_bboxes

    v = cfg.vision
    mu = v.spatial_merge_unit
    B = len(prompt_ids)
    if len(images) != B:
        raise ValueError("images: one entry (array or list) per row")
    images_per_row = [
        list(im) if isinstance(im, (list, tuple))
        else ([] if im is None else [im])
        for im in images
    ]

    def _listify(x):
        if x is None:
            return []
        return list(x) if isinstance(x, (list, tuple)) else [x]

    videos_per_row = [_listify(x) for x in (videos or [None] * B)]
    spg_per_row = [_listify(x) for x in (video_seconds_per_grid or [None] * B)]

    # ---- per-row visual entries in MARKER ORDER (images/videos interleaved
    # exactly as their markers appear in the prompt)
    entries_row: List[list] = []
    for b, ids in enumerate(prompt_ids):
        ids = list(ids)
        n_im = ids.count(cfg.image_token_id)
        n_vid = ids.count(cfg.video_token_id)
        if n_im != len(images_per_row[b]):
            raise ValueError(
                f"row {b}: {n_im} image markers for {len(images_per_row[b])} images")
        if n_vid != len(videos_per_row[b]):
            raise ValueError(
                f"row {b}: {n_vid} video markers for {len(videos_per_row[b])} videos")
        im_it = iter(images_per_row[b])
        vid_it = iter(videos_per_row[b])
        spg_it = iter(spg_per_row[b] or [1.0] * n_vid)
        entries = []
        for t in ids:
            if t == cfg.image_token_id:
                entries.append(("image", np.asarray(next(im_it)), None))
            elif t == cfg.video_token_id:
                spg = next(spg_it, 1.0)
                entries.append(("video", np.asarray(next(vid_it)),
                                float(spg if spg is not None else 1.0)))
        entries_row.append(entries)
    n_imgs_row = [len(e) for e in entries_row]  # visual entries per row

    # ---- vision: patchify all visuals (row-major marker order), pack
    patch_list, grids = [], []
    for entries in entries_row:
        for kind, arr, _ in entries:
            fn = preprocess_video if kind == "video" else preprocess_image
            p, g = fn(
                arr,
                patch_size=v.patch_size,
                temporal_patch_size=v.temporal_patch_size,
                merge_size=v.spatial_merge_size,
                min_pixels=min_pixels or DEFAULT_MIN_PIXELS,
                max_pixels=max_pixels or DEFAULT_MAX_PIXELS,
            )
            patch_list.append(p)
            grids.append(g)
    grids = np.array(grids)  # [n_total_visuals, 3] thw, marker order
    patches_nat = np.concatenate(patch_list, axis=0)
    n_patches = patches_nat.shape[0]
    geo0 = build_vision_geometry(grids, v.window_size, v.spatial_merge_size, v.patch_size)
    wp = geo0.window_patches
    bucket = max(wp, _round_up(patch_multiple, wp))
    padded_p = _round_up(geo0.padded_len, bucket)
    geo = build_vision_geometry(
        grids, v.window_size, v.spatial_merge_size, v.patch_size, padded_len=padded_p
    )
    patches_win = np.zeros((padded_p, patches_nat.shape[1]), dtype=patches_nat.dtype)
    patches_win[geo.patch_valid] = patches_nat[geo.patch_src[geo.patch_valid]]

    n_per_image = (grids[:, 0] * grids[:, 1] * grids[:, 2]) // mu
    img_offsets = np.concatenate([[0], np.cumsum(n_imgs_row)[:-1]])  # first image idx/row
    n_img = np.array([
        int(n_per_image[img_offsets[b] : img_offsets[b] + n_imgs_row[b]].sum())
        for b in range(B)
    ])  # merged tokens per row
    N = int(n_img.max())

    # packed_idx[b, j] = merged-slot row of natural token j of row b
    moffs_img = np.concatenate([[0], np.cumsum(n_per_image)[:-1]])  # per image
    packed_idx = np.zeros((B, N), dtype=np.int32)
    img_group = np.full((B, N), -1, dtype=np.int32)

    # ---- text: expand image/video markers, append/splice le slots, left-pad
    gp = cfg.gp
    le_len = gp.le_length if gp.has_le else 0
    rows, label_rows, le_starts = [], [], []
    for b, ids in enumerate(prompt_ids):
        ids = list(ids)
        expanded = []
        img_i = img_offsets[b]
        for t in ids:
            if t in (cfg.image_token_id, cfg.video_token_id):
                expanded.extend([t] * int(n_per_image[img_i]))
                img_i += 1
            else:
                expanded.append(t)
        if answer_ids is not None:
            ans = list(answer_ids[b])
            row = expanded + [cfg.eos_token_id] * le_len + ans
            lab = [-100] * (len(expanded) + le_len) + ans
            le_starts.append(len(expanded))
            label_rows.append(lab)
        else:
            row = expanded + [cfg.eos_token_id] * le_len
            le_starts.append(len(expanded))
        rows.append(row)

    S = _round_up(max(len(r) for r in rows), seq_multiple)
    input_ids = np.full((B, S), cfg.pad_token_id, dtype=np.int32)
    valid = np.zeros((B, S), dtype=bool)
    labels = None if answer_ids is None else np.full((B, S), -100, dtype=np.int32)
    le_start_arr = np.zeros((B,), dtype=np.int32)
    img_slots = np.zeros((B, N), dtype=np.int32)
    img_valid = np.zeros((B, N), dtype=bool)
    for b, row in enumerate(rows):
        off = S - len(row)  # left padding
        input_ids[b, off:] = row
        valid[b, off:] = True
        if labels is not None:
            labels[b, off:] = label_rows[b]
        le_start_arr[b] = off + le_starts[b]
        pos = np.nonzero((input_ids[b] == cfg.image_token_id)
                         | (input_ids[b] == cfg.video_token_id))[0]
        img_slots[b, : len(pos)] = pos
        img_valid[b, : len(pos)] = True

    # per-row (possibly multi-image/video) fuser geometry + packed/group maps.
    # A video contributes one FRAME entry per temporal grid step (per-frame
    # fuser attention segments = the reference's per-frame cu_seqlens) but
    # ONE budget group (the keep policy treats the whole video as one visual,
    # like the reference's contiguous image_token span, model_gp.py:1495-1549).
    grid_hw_rows = []
    for b in range(B):
        row_grids = []
        off = 0
        # keep_scores_with_policy_grouped clips group ids to max_groups=8;
        # more visuals per row would silently share budget groups
        if n_imgs_row[b] > 8:
            raise ValueError(
                f"row {b} has {n_imgs_row[b]} visuals; max supported per row is 8")
        for i in range(n_imgs_row[b]):
            gi = grids[img_offsets[b] + i]
            t = int(gi[0])
            hw = (int(gi[1]) // v.spatial_merge_size, int(gi[2]) // v.spatial_merge_size)
            row_grids.extend([hw] * t)
            ni = t * hw[0] * hw[1]
            mo = moffs_img[img_offsets[b] + i]
            packed_idx[b, off : off + ni] = geo.slot_of_merged[mo : mo + ni]
            img_group[b, off : off + ni] = i
            off += ni
        grid_hw_rows.append(row_grids)
    grid_hw = [r[0] for r in grid_hw_rows]  # first image per row (anchors/ref)
    fuser = build_fuser_geometry(
        grid_hw_rows, N, v.window_size, v.spatial_merge_size, v.patch_size,
        gp.attn_fuse_global,
    )

    # ---- position ids (le slots get sequential text positions, matching
    # reference _append_le position arithmetic model_gp.py:1178-1185).
    # Image and video grids split back out of marker order for the reference
    # get_rope_index contract (video branch scales t by second_per_grid_ts).
    flat_entries = [e for entries in entries_row for e in entries]
    is_video = np.array([k == "video" for k, _, _ in flat_entries], dtype=bool)
    image_grids = grids[~is_video] if (~is_video).any() else None
    video_grids = grids[is_video] if is_video.any() else None
    spg_list = [s for k, _, s in flat_entries if k == "video"] or None
    position_ids, _ = get_rope_index(
        input_ids, image_grids, video_grids, valid.astype(np.int64),
        second_per_grid_ts=spg_list,
        spatial_merge_size=v.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
    )

    # ---- budgets -> static out_len (per-visual caps summed; a video's t*h*w
    # tokens form one budget group, matching img_group above)
    budgets = np.zeros((B,), dtype=np.int64)
    for b in range(B):
        tot = 0
        for i in range(n_imgs_row[b]):
            nb = int(n_per_image[img_offsets[b] + i])
            if gp.max_remain_ratio is not None:
                k = int(gp.max_remain_ratio * nb)
                k = max(k, gp.min_remain_num or 0) + len(gp.anchor_positions)
                tot += min(nb, k)
            else:
                tot += nb
        budgets[b] = tot
    n_text = valid.sum(1) - n_img - le_len
    out_len = _round_up(int((n_text + budgets).max()), seq_multiple)

    ref_masks = None
    if normed_bboxes is not None:
        ref_masks = np.zeros((B, N), dtype=bool)
        for b, bxs in enumerate(normed_bboxes):
            if bxs is None:
                continue
            per_image = bxs if (bxs and isinstance(bxs[0][0], (list, tuple))) else [bxs]
            off = 0
            for i, (h, w) in enumerate(grid_hw_rows[b]):
                if i < len(per_image) and per_image[i]:
                    ref_masks[b, off : off + h * w] = ref_token_mask_from_bboxes(
                        per_image[i], (h, w)
                    ).reshape(-1)
                off += h * w

    anchor = None
    if gp.anchor_positions:
        if max(n_imgs_row) != 1 or is_video.any():
            raise ValueError(
                "anchor_positions unsupported with multi-image/video rows "
                "(reference model_gp.py:1524-1525 raises the same)")
        anchor = np.zeros((B, N), dtype=bool)
        for b in range(B):
            h, w = grid_hw[b]
            for a in gp.anchor_positions:
                idx = {"tl": 0, "tr": w - 1, "bl": (h - 1) * w, "br": h * w - 1}[a]
                anchor[b, idx] = True

    return PreparedInputs(
        input_ids=input_ids,
        valid=valid,
        position_ids=position_ids,
        patches=patches_win,
        vis_pos_ids=geo.pos_ids,
        full_seg=geo.full_segment_ids,
        vis_valid=geo.patch_valid,
        packed_idx=packed_idx,
        img_slots=img_slots,
        img_valid=img_valid,
        img_group=img_group,
        fuser=fuser,
        grid_hw_rows=grid_hw_rows,
        le_start=le_start_arr if gp.has_le else None,
        grids=grids,
        out_len=out_len,
        n_img_tokens=n_img,
        ref_token_masks=ref_masks,
        anchor_mask=anchor,
        labels=labels,
    )



def _vis_dense_hint(prep) -> bool:
    """True iff the packed patch sequence is ONE valid segment (a single
    unpadded image/video): the ViT full-attention flash kernel then compiles
    mask-free (static promise; ops/attention.segment_attention(dense=))."""
    if getattr(prep, "patches", None) is None or prep.full_seg is None:
        return False
    fs = np.asarray(prep.full_seg)
    vv = np.asarray(prep.vis_valid)
    return (
        fs.size > 0 and bool(vv.all())
        and bool((fs == fs.flat[0]).all()) and int(fs.flat[0]) >= 0
    )
