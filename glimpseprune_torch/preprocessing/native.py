"""ctypes bindings for the native (C++) image preprocessing.

Counterpart of glimpseprune_tpu/preprocessing/native.py (``build`` :33,
``available`` :64, ``resize_bicubic_native`` :71, ``preprocess_image_native``
:80), over the port's own copy of the source, ``csrc/gp_preproc.cpp``.
``preprocess_image_native`` is signature-compatible with
``preprocessing.image.preprocess_image`` (the same ``smart_resize``
geometry; resize, normalize and patchify fused in C++) and needs no PIL,
which a machine with the card may lack: an image that must be resized goes
through here (``prepare_inputs(use_native_preproc=True)`` or
``GP_NATIVE_PREPROC=1``).

The library is built with ``g++ -O3 -fPIC -shared -std=c++17`` at first use
into ``build/glimpseprune_torch/`` beside the package (git-ignored), under a
name keyed by a hash of the source and the flags, as ``ops/cuda/build.py``
names its libraries. It is not built with ``-march=native``, so it gives the
same results on every x86-64 host. Unlike the JAX package, nothing falls
back quietly: a build or load that fails raises, and ``available()``
reports it as False only where the caller asks.

Run ``python -m glimpseprune_torch.preprocessing.native`` to build it and
time it against the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from glimpseprune_torch.preprocessing.image import (
    DEFAULT_MAX_PIXELS,
    DEFAULT_MIN_PIXELS,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    smart_resize,
)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gp_preproc.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glimpseprune_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None


def library_path() -> Path:
    """Where the library built from SOURCE lives (keyed by the source and
    the flags)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"gp_preproc-{digest[:16]}.so"


def build(force: bool = False) -> str:
    """Compile the shared library (g++, one file) unless it is built; a
    failed build raises."""
    so = library_path()
    if so.exists() and not force:
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return str(so)


def load():
    """The loaded library, built first if needed; a failure raises."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    lib.gp_preprocess.argtypes = [u8p, i, i, i, i, i, f32p, f32p, i, i, i, f32p]
    lib.gp_preprocess.restype = None
    lib.gp_resize_bicubic.argtypes = [u8p, i, i, i, u8p, i, i]
    lib.gp_resize_bicubic.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (the error is dropped:
    callers that need the library call ``load`` and let it raise)."""
    try:
        load()
        return True
    except (OSError, RuntimeError):
        return False


def resize_bicubic_native(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """PIL-convention bicubic resize of an HWC uint8 image to (th, tw)."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or min(image.shape) < 1 or th < 1 or tw < 1:
        raise ValueError(f"resize of a {image.shape} image to {th}x{tw}")
    h, w, c = image.shape
    out = np.empty((th, tw, c), dtype=np.uint8)
    lib.gp_resize_bicubic(image, h, w, c, out, th, tw)
    return out


def preprocess_image_native(
    image: np.ndarray,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    resized_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """The fused native pipeline; signature-compatible with preprocess_image."""
    lib = load()
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    factor = patch_size * merge_size
    if resized_hw is None:
        resized_hw = smart_resize(h, w, factor, min_pixels, max_pixels)
    th, tw = resized_hw
    if th < factor or tw < factor or th % factor or tw % factor or min(h, w) < 1:
        raise ValueError(f"resized_hw {resized_hw} is not a positive multiple of {factor}")
    grid = (1, th // patch_size, tw // patch_size)
    row_len = c * temporal_patch_size * patch_size * patch_size
    out = np.empty((grid[1] * grid[2], row_len), dtype=np.float32)
    mean = np.ascontiguousarray(OPENAI_CLIP_MEAN, dtype=np.float32)
    std = np.ascontiguousarray(OPENAI_CLIP_STD, dtype=np.float32)
    lib.gp_preprocess(image, h, w, c, th, tw, mean, std,
                      patch_size, temporal_patch_size, merge_size, out)
    return out, grid


if __name__ == "__main__":
    import time

    from glimpseprune_torch.preprocessing.image import preprocess_image

    build(force=True)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (768, 1024, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    ref, grid_ref = preprocess_image(img)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, grid = preprocess_image_native(img)
    t_cc = time.perf_counter() - t0
    assert grid == tuple(grid_ref), (grid, grid_ref)
    print(f"numpy + PIL: {t_py * 1e3:.1f} ms  native: {t_cc * 1e3:.1f} ms  "
          f"max|diff| {np.abs(out - ref).max():.4f}")
