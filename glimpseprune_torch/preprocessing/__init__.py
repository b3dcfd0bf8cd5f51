"""Host-side preprocessing (numpy): image tiling and patchification, ViT
window geometry, mRoPE position ids, bbox reference masks.

Copies of the numpy-only modules of glimpseprune_tpu/preprocessing/, so
that the port imports nothing of the JAX package (the card's machine has
no jax); tests/test_torch_config.py holds each copy equal to its original.
"""

from glimpseprune_torch.preprocessing.geometry import (
    VisionGeometry,
    build_vision_geometry,
    cu_seqlens_from_grid,
    get_window_index,
    segment_ids_from_cu_seqlens,
    vision_pos_ids,
)
from glimpseprune_torch.preprocessing.image import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    normalize_image,
    patchify_image,
    preprocess_image,
    smart_resize,
)
from glimpseprune_torch.preprocessing.mrope import get_rope_index
from glimpseprune_torch.preprocessing.ref_masks import (
    bbox_grid_indices,
    ref_token_mask_from_bboxes,
)

__all__ = [
    "OPENAI_CLIP_MEAN",
    "OPENAI_CLIP_STD",
    "normalize_image",
    "patchify_image",
    "preprocess_image",
    "smart_resize",
    "cu_seqlens_from_grid",
    "get_window_index",
    "segment_ids_from_cu_seqlens",
    "vision_pos_ids",
    "VisionGeometry",
    "build_vision_geometry",
    "bbox_grid_indices",
    "ref_token_mask_from_bboxes",
    "get_rope_index",
]
