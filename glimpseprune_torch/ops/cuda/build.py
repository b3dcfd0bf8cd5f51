"""Build this package's CUDA sources and load them with ctypes.

Each kernel source in ``glimpseprune_torch/csrc/`` has a plain C interface
(``*.cuh`` headers there hold helpers the sources share).
On first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/glimpseprune_torch/`` beside the package (a git-ignored directory),
under a file name keyed by a hash of the source and the flags, so a changed
source is rebuilt and an unchanged one is reused. ptxas's register and
shared-memory report for each build is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "glimpseprune_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# dynamic shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448

_loaded: dict = {}
_functions: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (keyed by the
    source, the shared ``csrc/*.cuh`` headers and the flags)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it once per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def kernel_function(name: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``csrc/<name>.cu`` with its argument
    types set once (setting them on every call costs microseconds of host
    time per launch)."""
    fn = _functions.get((name, entry))
    if fn is None:
        fn = getattr(load_library(name), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(name, entry)] = fn
    return fn


def current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, where a
    kernel launches. (The private call skips building a Stream object:
    microseconds per launch.)"""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
