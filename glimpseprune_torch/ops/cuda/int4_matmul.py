"""K4, K5 and K6: products of activations with int4 weights.

Replaces the Pallas kernels of glimpseprune_tpu/ops/pallas/int4_matmul.py:
- K4, ``matmul_int4`` :103 (body ``_kernel`` :51), the decode product for
  M <= 128 rows;
- K5 and K6, ``matmul_int4_prefill`` :283 with a8=False (W4A16, body
  ``_kernel_prefill_a16`` :191) and a8=True (W4A8, ``_kernel_prefill_a8``
  :219, wrapper :335-354).
The CUDA source is ``glimpseprune_torch/csrc/int4_matmul.cu``; its header
says what bounds each kernel on the H100 and how the design answers. The
shape gates (``kernel_applicable`` :91, ``prefill_applicable`` :261,
``prefill_routable`` :268) are copied exactly, so
``quantization.matmul_int4_auto`` routes a shape as the JAX package does.

Weights: packed int8 [K/2, N] (row r in the low nibble, row r + K/2 in the
high nibble) and f32 group scales [K/g, N]. Dispatch is by device: a CPU
tensor takes the plain PyTorch version beside each kernel, a CUDA tensor
launches the kernel (or raises). Each wrapper counts its launches in
``.launches``, a Counter keyed by the weight shape (``launch_key``).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from glimpseprune_torch.ops.cuda.build import check_launch, current_stream, kernel_function
from glimpseprune_torch.ops.kv_cache import quantize_kv

# the Pallas kernels' tiles, which the routing gates are written in
_BKP = 256      # packed-row tile
_BN = 512       # output-column tile
_M_MAX = 128    # the decode kernel's largest M
# K4's launch: 512 columns per block; K split in whole groups so that the
# grid has at least this many blocks, each split at most this many groups
_K4_COLS_PER_BLOCK = 512
_K4_MIN_BLOCKS = 264
_K4_MAX_GROUPS = 32


def kernel_applicable(m: int, kdim: int, n: int, g: int) -> bool:
    """Shape gate of the decode kernel K4 (JAX :91)."""
    return (m <= _M_MAX and g == 64 and kdim % (2 * _BKP) == 0
            and (kdim // 2) % g == 0 and n % _BN == 0)


def _prefill_tiles(kdim: int, n: int, g: int):
    """(bkp, bn) of the Pallas prefill kernel, or None (JAX :251)."""
    bkp = next((b for b in (_BKP, 128, 64) if (kdim // 2) % b == 0 and b % g == 0), None)
    bn = next((b for b in (_BN, 256, 128) if n % b == 0), None)
    return (bkp, bn) if bkp and bn else None


def prefill_applicable(m: int, kdim: int, n: int, g: int) -> bool:
    """Shape gate of the prefill kernels K5 and K6 (JAX :261)."""
    return (m > _M_MAX and g >= 64 and kdim % (2 * g) == 0
            and _prefill_tiles(kdim, n, g) is not None)


def prefill_routable(m: int, kdim: int, n: int, g: int, a8: bool) -> bool:
    """Does the model route this product to the prefill kernel (JAX :268)?
    Only W4A8 with full 256-wide packed k-tiles: W4A16 (K5) never routes,
    since dequantize-then-matmul measured faster on the TPU."""
    if not (a8 and prefill_applicable(m, kdim, n, g)):
        return False
    return _prefill_tiles(kdim, n, g)[0] == _BKP


def launch_key(k: int, n: int, a8: Optional[bool] = None) -> str:
    """The launch-count key of a weight shape: "KxN" for K4, "a16,KxN" or
    "a8,KxN" for K5 and K6."""
    return f"{k}x{n}" if a8 is None else f"{'a8' if a8 else 'a16'},{k}x{n}"


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., K/2, N] -> the int4 values int8 [..., K, N]
    (arithmetic shifts sign-extend each nibble)."""
    return torch.cat([(packed << 4) >> 4, packed >> 4], dim=-2)


def _check(x, packed, scales, name):
    k = x.shape[-1]
    if packed.dim() != 2 or packed.dtype != torch.int8 or 2 * packed.shape[0] != k:
        raise ValueError(f"{name}: packed weights must be int8 [K/2, N] with K = {k}")
    if scales.dim() != 2 or scales.shape[1] != packed.shape[1] or k % scales.shape[0]:
        raise ValueError(f"{name}: scales must be [K/g, N]")
    return k, packed.shape[1], k // scales.shape[0]


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _cuda_operands(name, out_dtype, *tensors):
    if out_dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel writes bf16")
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on different devices")
    return [t.contiguous() for t in tensors]


# ---------------------------------------------------------------- K4

def matmul_int4_reference(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K4, in fp32: per 64-row group, the partial dot of x
    with the raw int4 values, times the group's scale, summed over groups."""
    k, n, g = _check(x, packed, scales, "matmul_int4")
    x2 = x.reshape(-1, k).float()
    q = unpack_int4(packed).float().reshape(k // g, g, n)
    partial = torch.einsum("mgk,gkn->mgn", x2.reshape(-1, k // g, g), q)
    y = (partial * scales.float()[None]).sum(1)
    return y.to(out_dtype).reshape(x.shape[:-1] + (n,))


def k4_split(k: int, n: int, g: int):
    """(ksplit, groups per split) of K4's launch."""
    half_groups = k // 2 // g
    col_blocks = -(-n // _K4_COLS_PER_BLOCK)
    want = max(-(-_K4_MIN_BLOCKS // col_blocks), -(-half_groups // _K4_MAX_GROUPS))
    per = -(-half_groups // min(want, half_groups))
    return -(-half_groups // per), per


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K4: x [..., K] @ int4 [K/2, N] (+ scales [K/g, N]) -> [..., N] for
    M <= 128 rows (M = the product of x's leading dims). The caller checks
    ``kernel_applicable``; this function raises where it does not hold. On
    the card: one launch of the split-K kernel and its reduction pass."""
    k, n, g = _check(x, packed, scales, "matmul_int4")
    m = x.numel() // k
    if not kernel_applicable(m, k, n, g):
        raise ValueError(f"matmul_int4: shape M={m} K={k} N={n} g={g} is not the kernel's")
    if _device(x, "matmul_int4") == "cpu":
        return matmul_int4_reference(x, packed, scales, out_dtype)
    if x.dtype != torch.bfloat16:
        raise ValueError("matmul_int4: x must be bf16 on the card")
    x2, packed, scales = _cuda_operands("matmul_int4", out_dtype, x.reshape(m, k), packed,
                                        scales.float())
    ksplit, per = k4_split(k, n, g)
    part = torch.empty((ksplit, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    fn = kernel_function("int4_matmul", "int4_gemv_bf16",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, k, n, g, ksplit, per, current_stream(x.device))
    check_launch(rc, "matmul_int4")
    matmul_int4.launches[launch_key(k, n)] += 1
    return out.reshape(x.shape[:-1] + (n,))


# ------------------------------------------------------------- K5, K6

def requant_ratios(scales: torch.Tensor):
    """W4A8's weight requantization (JAX :341-342): per-column int8 scale
    s8 = max_g(s) * 7/127 [1, N] and ratios r = s / s8 [K/g, N], in fp32."""
    s = scales.float()
    s8 = s.amax(-2, keepdim=True).clamp(min=1e-12) * (7.0 / 127.0)
    return s8, s / s8


def int4_prefill_a16_reference(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K5: each weight times its group scale in fp32,
    rounded to x's dtype, then the product in fp32."""
    k, n, g = _check(x2, packed, scales, "matmul_int4_prefill")
    rows = scales.float().repeat_interleave(g, dim=0)
    w = (unpack_int4(packed).float() * rows).to(x2.dtype)
    return (x2.float() @ w.float()).to(out_dtype)


def int4_prefill_a8_reference(xq: torch.Tensor, xs: torch.Tensor, packed: torch.Tensor,
                              r: torch.Tensor, s8: torch.Tensor,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6: q8 = round(q4 * r) per weight, the integer
    product xq @ q8 (exact: float64 holds every int32 sum), then
    acc * xs[row] * s8[col] in fp32."""
    k, n, g = _check(xq, packed, r, "matmul_int4_prefill")
    q8 = torch.round(unpack_int4(packed).float() * r.float().repeat_interleave(g, dim=0))
    acc = xq.double() @ q8.double()
    return (acc.float() * xs.float() * s8.float()).to(out_dtype)


def matmul_int4_prefill(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16,
                        a8: bool = False) -> torch.Tensor:
    """x [..., K] @ int4 [K/2, N] -> [..., N] at prefill M (> 128 rows).

    a8=False is K5 (W4A16), a8=True is K6 (W4A8): x quantized per row to
    int8 and the weights requantized per column, both prepared here in
    plain PyTorch as the JAX package prepares them outside its kernel. The
    caller checks ``prefill_applicable``; this function raises where it
    does not hold."""
    k, n, g = _check(x, packed, scales, "matmul_int4_prefill")
    m = x.numel() // k
    if not prefill_applicable(m, k, n, g):
        raise ValueError(f"matmul_int4_prefill: shape M={m} K={k} N={n} g={g} "
                         "is not the kernel's")
    x2 = x.reshape(m, k)
    cpu = _device(x, "matmul_int4_prefill") == "cpu"
    if a8:
        xq, xs = quantize_kv(x2)  # per-row int8 activations (JAX :336-339)
        xs = xs[:, None]
        s8, r = requant_ratios(scales)
        if cpu:
            out = int4_prefill_a8_reference(xq, xs, packed, r, s8, out_dtype)
        else:
            ops = _cuda_operands("matmul_int4_prefill", out_dtype, xq, xs, packed, r, s8)
            out = _launch_gemm("int4_gemm_a8_bf16", ops, m, k, n, g)
    else:
        if cpu:
            out = int4_prefill_a16_reference(x2, packed, scales, out_dtype)
        else:
            if x.dtype != torch.bfloat16:
                raise ValueError("matmul_int4_prefill: x must be bf16 on the card")
            ops = _cuda_operands("matmul_int4_prefill", out_dtype, x2, packed,
                                 scales.float())
            out = _launch_gemm("int4_gemm_a16_bf16", ops, m, k, n, g)
    if not cpu:
        matmul_int4_prefill.launches[launch_key(k, n, a8)] += 1
    return out.reshape(x.shape[:-1] + (n,))


def _launch_gemm(entry: str, ops, m: int, k: int, n: int, g: int) -> torch.Tensor:
    out = torch.empty((m, n), dtype=torch.bfloat16, device=ops[0].device)
    fn = kernel_function("int4_matmul", entry,
                         [ctypes.c_void_p] * (len(ops) + 1) + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
    rc = fn(*(t.data_ptr() for t in ops), out.data_ptr(), m, k, n, g,
            current_stream(out.device))
    check_launch(rc, "matmul_int4_prefill")
    return out


matmul_int4.launches = Counter()
matmul_int4_prefill.launches = Counter()
