"""Image preprocessing: Qwen dynamic-resolution tiling + patchification.

A copy of glimpseprune_tpu/preprocessing/image.py, kept in the port so that the port
imports nothing of the JAX package; tests/test_torch_config.py holds the
two equal.

Reimplements (in numpy, host-side) the semantics of the HF Qwen2.5-VL image
processor the reference relies on everywhere (SURVEY.md §2.9): `smart_resize`
dynamic-resolution tiling, CLIP normalization, and the merge-block patch
ordering that the windowed ViT consumes. Verified against the HF processor in
tests/test_preprocessing.py.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

DEFAULT_MIN_PIXELS = 56 * 56
DEFAULT_MAX_PIXELS = 14 * 14 * 4 * 1280  # 1_003_520, HF processor default


def _round_by_factor(x: float, factor: int) -> int:
    return round(x / factor) * factor


def _ceil_by_factor(x: float, factor: int) -> int:
    return math.ceil(x / factor) * factor


def _floor_by_factor(x: float, factor: int) -> int:
    return math.floor(x / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[int, int]:
    """Qwen dynamic-resolution target size.

    Returns (h, w) that are multiples of `factor`, keep total pixels within
    [min_pixels, max_pixels], and approximately preserve aspect ratio.
    """
    if max(height, width) / min(height, width) > 200:
        raise ValueError(
            f"absolute aspect ratio must be < 200, got {max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, _round_by_factor(height, factor))
    w_bar = max(factor, _round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, _floor_by_factor(height / beta, factor))
        w_bar = max(factor, _floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = _ceil_by_factor(height * beta, factor)
        w_bar = _ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def _bicubic_resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize HWC uint8/float image to (h, w) with PIL bicubic (matches HF).
    Without PIL this raises an ImportError that names the native path, which
    resizes images without it (videos still need PIL)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"resizing a {image.shape[0]}x{image.shape[1]} image to {size[0]}x{size[1]} "
            "needs PIL, which is not installed: pass prepare_inputs(use_native_preproc=True) "
            "or set GP_NATIVE_PREPROC=1 to resize images with the native C++ path "
            "(videos still need PIL)") from e

    h, w = size
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    pil = Image.fromarray(image)
    pil = pil.resize((w, h), resample=Image.BICUBIC)
    return np.asarray(pil)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC, rescaled to [0,1] then CLIP-normalized."""
    x = image.astype(np.float32) / 255.0
    return (x - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD


def patchify_image(
    frames: np.ndarray,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Normalized frames [T, H, W, C] -> flat patches + grid_thw.

    Output patch ordering follows the Qwen2.5-VL convention (2x2 merge-block
    raster order), producing [grid_t*grid_h*grid_w, C*tps*ps*ps] rows that
    the ViT patch-embed consumes directly.
    """
    t, h, w, c = frames.shape
    if t % temporal_patch_size != 0:
        reps = temporal_patch_size - (t % temporal_patch_size)
        frames = np.concatenate([frames, np.repeat(frames[-1:], reps, axis=0)], axis=0)
        t = frames.shape[0]
    grid_t = t // temporal_patch_size
    grid_h, grid_w = h // patch_size, w // patch_size

    patches = frames.transpose(0, 3, 1, 2)  # [T, C, H, W]
    patches = patches.reshape(
        grid_t,
        temporal_patch_size,
        c,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size * patch_size
    )
    return flat, (grid_t, grid_h, grid_w)


def preprocess_video(
    frames: np.ndarray,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    resized_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Video pipeline: per-frame resize (one shared smart_resize geometry)
    -> normalize -> temporal patchify. frames [T, H, W, C] uint8 ->
    (patches [t*h*w, C*tps*ps*ps], grid (t, h, w)) with t = ceil(T / tps)
    (trailing frame repeated to fill the last temporal pair, HF convention).

    Reference: the Qwen processor's video path feeds the same patchify with
    grid_t > 1 (process_gp.py consumes `videos=` through
    Qwen2VLImageProcessor._preprocess; mRoPE handles the temporal axis via
    second_per_grid_ts, preprocessing/mrope.py get_rope_index)."""
    frames = np.asarray(frames)
    assert frames.ndim == 4, f"expected [T, H, W, C], got {frames.shape}"
    if frames.shape[-1] == 4:
        frames = frames[..., :3]
    factor = patch_size * merge_size
    if resized_hw is None:
        resized_hw = smart_resize(
            frames.shape[1], frames.shape[2], factor, min_pixels, max_pixels
        )
    resized = np.stack([
        _bicubic_resize(f, resized_hw) if f.shape[:2] != tuple(resized_hw) else f
        for f in frames
    ])
    return patchify_image(
        normalize_image(resized), patch_size, temporal_patch_size, merge_size
    )


def preprocess_image(
    image: np.ndarray,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    resized_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Full single-image pipeline: resize -> normalize -> patchify."""
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    factor = patch_size * merge_size
    if resized_hw is None:
        resized_hw = smart_resize(
            image.shape[0], image.shape[1], factor, min_pixels, max_pixels
        )
    if image.shape[:2] != tuple(resized_hw):
        image = _bicubic_resize(image, resized_hw)
    x = normalize_image(image)
    frames = x[None]  # single frame -> T=1, repeated to temporal_patch_size
    return patchify_image(frames, patch_size, temporal_patch_size, merge_size)
