"""Mask visualization: overlay keep masks on images (reference demo_gp.py:23-52
`apply_mask_on_image`), plus an ASCII renderer for terminal demos.

A copy of glimpseprune_tpu/utils/viz.py (numpy only), kept in the port so
that the port imports nothing of the JAX package; tests/test_torch_analysis.py
holds the two equal. ``encode_png`` / ``decode_png`` write and read 8-bit
RGB PNGs with the standard library alone (``zlib``, ``struct``): the card's
machine has no PIL, and the demo's overlays and the attention heatmaps are
written there too."""

from __future__ import annotations

import struct
import zlib
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


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """An [H, W, 3] uint8 array as the bytes of an 8-bit RGB PNG (every
    scanline filter 0, one zlib stream)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes an [H, W, 3] uint8 array, not {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The [H, W, 3] uint8 array of a PNG that ``encode_png`` wrote (8-bit
    RGB, filter 0 on every scanline); other PNGs raise."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    if (depth, color) != (8, 2):
        raise ValueError(f"decode_png reads 8-bit RGB, not depth {depth} color type {color}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("decode_png reads filter-0 scanlines only")
    return raw[:, 1:].reshape(h, w, 3).copy()
