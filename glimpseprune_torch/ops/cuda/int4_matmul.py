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

K4 on the card is one launch (``int4_decode``): a cp.async ring streams
each packed group of the weights once, with its scales and x's matching
columns; the nibbles become bf16 and multiply on the tensor cores, fp32
partials per group are scaled at its end, and K splits over the blocks of
a thread-block cluster that sum their parts over distributed shared memory
in rank order (deterministic, no second kernel, no partials in device
memory). ``plan_int4_decode`` is its host plan (tile, split, cluster,
stages, shared-memory bytes, grid, and the ints the C launcher takes and
checks against its own formulas); ``quantization.matmul_int4_auto``, which
checks the gate, launches through it directly.

K5 on the card is two kernels behind one C call: a prep pass (the packed
weights to W16^T, bf16 [N, K], each weight rounded as the plain version
rounds it) and a bf16 tensor-core GEMM. ``plan_int4_a16`` is its host plan,
which the C launcher checks against its own formulas;
``int4_a16_prep_reference`` and ``bf16_gemm_tn_reference`` are the plain
versions of the two stages, which compose to ``int4_prefill_a16_reference``.

K6 on the card is two kernels behind one C call: a prep pass (x to int8
rows and their scales; the packed weights to W8^T, int8 [N, K], and the
per-column scales s8) and an int8 tensor-core GEMM with the rescale in its
epilogue. ``plan_int4_a8`` is its host plan (tile, warps, stages,
shared-memory bytes, grids), which the C launcher checks against its own
formulas. ``int4_a8_prep_reference`` and ``int8_gemm_tn_reference`` are
the plain versions of the two stages; composed, they equal
``int4_prefill_a8_reference`` bit for bit, and so does the card.

A tensor-parallel shard (parallel/mesh.py, quantization.matmul_int4_auto)
takes the whole layer's route: a column shard of K4 plans for the whole
layer's N (``n_whole``), so its columns sum their groups as the unsharded
layer's do; a row shard of K4 writes its fp32 sums unrounded (``f32``);
a row shard of K6 is given the row scales and s8 of the whole
contraction and leaves its int32 sums to the caller's all-reduce and
``a8_rescale`` (``matmul_int4_a8_sums``).

Weights: packed int8 [K/2, N] (row r in the low nibble, row r + K/2 in the
high nibble) and f32 group scales [K/g, N]. Dispatch is by device: a CPU
tensor takes the plain PyTorch version beside each kernel, a CUDA tensor
launches the kernel (or raises). Each wrapper counts its launches in
``.launches``, a Counter keyed by the weight shape (``launch_key``).
"""

from __future__ import annotations

import array
import ctypes
import functools
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from glimpseprune_torch.ops.cuda.build import check_launch, current_stream, kernel_function
from glimpseprune_torch.ops.kv_cache import quantize_kv

# the Pallas kernels' tiles, which the routing gates are written in
_BKP = 256      # packed-row tile
_BN = 512       # output-column tile
_M_MAX = 128    # the decode kernel's largest M
SMS = 132       # the H100's SMs, which K4's, K5's and K6's grids are sized to fill


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


# K4 on the card (csrc/int4_matmul.cu, namespace k4). Its tiles, in the
# order of ``GP_K4_TILES``: (n8 slices of x rows a warp holds, warps along
# M, warps along N, m16 column tiles a warp holds). A block holds 16 x
# tiles x (warps along N) columns and 8 x slices x (warps along M) rows of
# x; a stage is one packed group of K4_GROUP_ROWS packed rows, K4_STAGES
# slots. K4_CLASSES lists, for M of up to 8, 16, 32, 64 and 128 rows, its
# wide and its narrow tile: the plan takes the wide one where its grid, K
# split as far as a cluster of K4_MAX_CLUSTER goes, has a block for each of
# the SMS SMs, else the narrow one, then splits K until the grid has
# K4_SPLIT_BLOCKS blocks.
K4_TILES = ((1, 1, 4, 2), (1, 1, 1, 1), (2, 1, 4, 2), (2, 1, 1, 1), (4, 1, 4, 2),
            (4, 1, 1, 1), (4, 2, 2, 2), (4, 2, 1, 1), (4, 4, 1, 2), (4, 4, 1, 1))
K4_CLASSES = ((8, (0, 1)), (16, (2, 3)), (32, (4, 5)), (64, (6, 7)), (128, (8, 9)))
K4_GROUP_ROWS = 64
K4_STAGES = 4
K4_MAX_CLUSTER = 8
K4_SPLIT_BLOCKS = 4 * SMS
# int4_decode_bf16's arguments: x, packed, scales, out, the plan's ints, stream
_K4_ARGTYPES = [ctypes.c_void_p] * 6


@dataclass(frozen=True)
class DecodePlan:
    """How one K4 call runs: tile ``tile`` of K4_TILES (``bn`` columns and
    ``mpad`` rows of x a block, ``warps`` warps, ``stages`` packed groups in
    flight, ``smem_bytes`` per block) on ``grid`` blocks, K split
    ``ksplit`` ways in ``groups_per_split`` packed groups over the blocks of
    one thread-block cluster (its size is ``ksplit``). ``args`` holds the
    ints the C launcher takes (at ``args_ptr``), ``key`` the launch-count
    key."""
    tile: int
    bn: int
    mpad: int
    warps: int
    stages: int
    ksplit: int
    groups_per_split: int
    smem_bytes: int
    grid: int
    args: array.array = field(compare=False, repr=False)
    args_ptr: int = field(compare=False, repr=False)
    key: str = field(compare=False, repr=False)


def k4_smem_bytes(tile: int) -> int:
    """Shared memory of one K4 block of tile ``tile`` (csrc/int4_matmul.cu
    ``k4::smem_bytes``): K4_STAGES stages, each a packed group of its
    columns, the group's lo and hi scale rows and x's 64 lo and 64 hi bf16
    columns, or the fp32 sums that reuse the ring, whichever is larger."""
    bn, mpad = k4_block(tile)
    return max(K4_STAGES * (K4_GROUP_ROWS * bn + 8 * bn + 256 * mpad), 4 * mpad * bn)


def k4_block(tile: int) -> Tuple[int, int]:
    """(columns, rows of x) of one K4 block of tile ``tile``."""
    sl, wm, wn, tw = K4_TILES[tile]
    return 16 * tw * wn, 8 * sl * wm


def k4_split_groups(groups: int, want: int) -> Tuple[int, int]:
    """(splits, packed groups a split) for ``groups`` packed groups cut into
    at most ``want`` whole, non-empty splits."""
    per = -(-groups // min(want, groups))
    return -(-groups // per), per


def k4_tile(m: int, k: int, n: int) -> int:
    """K4's tile for x [m, k] @ W [k, n]: the wide tile of M's class where
    its grid, K split as far as a cluster goes, reaches SMS blocks, else the
    narrow one (the k/v projections: 16 columns a block)."""
    wide, narrow = next(t for top, t in K4_CLASSES if m <= top)
    ksplit, _ = k4_split_groups(k // 2 // K4_GROUP_ROWS, K4_MAX_CLUSTER)
    return wide if n // k4_block(wide)[0] * ksplit >= SMS else narrow


@functools.lru_cache(maxsize=1024)
def plan_int4_decode(m: int, k: int, n: int, n_whole: Optional[int] = None,
                     f32: bool = False) -> DecodePlan:
    """K4's plan for x [m, k] @ W [k, n], or ValueError for a shape the
    kernel refuses: the tile from ``k4_tile``, K split in whole packed
    groups over the blocks of one cluster, and the grid. ``n_whole``, a
    column-parallel shard's whole layer's N, picks the tile and the split
    (so its columns sum their groups as the whole layer's do); the grid
    covers the shard's n. ``f32``: the kernel writes its fp32 sums
    unrounded (a row-parallel shard's partial sums)."""
    if not (0 < m <= _M_MAX and k > 0 and k % (2 * K4_GROUP_ROWS) == 0 and n > 0):
        raise ValueError(f"matmul_int4: K4 takes no shape M={m} K={k} N={n}")
    nw = n if n_whole is None else n_whole
    tile = k4_tile(m, k, nw)
    bn, mpad = k4_block(tile)
    if n % bn or nw % bn:
        raise ValueError(f"matmul_int4: K4's {bn}-column tile does not divide N={n}")
    groups = k // 2 // K4_GROUP_ROWS
    ksplit, per = k4_split_groups(groups, min(K4_MAX_CLUSTER, -(-K4_SPLIT_BLOCKS // (nw // bn))))
    _, wm, wn, _ = K4_TILES[tile]
    smem, grid = k4_smem_bytes(tile), n // bn * ksplit
    args = array.array("i", (m, k, n, tile, smem, ksplit, per, grid, int(f32)))
    return DecodePlan(tile, bn, mpad, wm * wn, K4_STAGES, ksplit, per, smem, grid, args,
                      args.buffer_info()[0], launch_key(k, n))


def int4_decode(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                n_whole: Optional[int] = None, f32: bool = False) -> torch.Tensor:
    """K4's launch on the card, counted, for callers that have checked
    ``kernel_applicable`` and hold bf16 x (16-byte aligned), int8 packed
    weights and f32 scales, contiguous, on one card: one plan lookup, the
    output, one ctypes call on the current stream, no host sync.
    ``n_whole`` and ``f32`` (an fp32 output, not rounded): as
    ``plan_int4_decode``'s."""
    k, n = x.shape[-1], packed.shape[1]
    plan = plan_int4_decode(x.numel() // k, k, n, n_whole, f32)
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32 if f32 else torch.bfloat16,
                      device=x.device)
    fn = kernel_function("int4_matmul", "int4_decode_bf16", _K4_ARGTYPES)
    rc = fn(x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
            plan.args_ptr, current_stream(x.device))
    check_launch(rc, "matmul_int4")
    matmul_int4.launches[plan.key] += 1
    return out


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16,
                whole: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K4: x [..., K] @ int4 [K/2, N] (+ scales [K/g, N]) -> [..., N] for
    M <= 128 rows (M = the product of x's leading dims). The caller checks
    ``kernel_applicable``; this function raises where it does not hold. On
    the card: one launch (``int4_decode``), bf16 x and out only.

    ``whole`` = (K, N) of the unsharded layer where the weights are a
    tensor-parallel shard (parallel/mesh.py): the gate is the whole
    layer's, and a column shard takes its tile and K split. ``out_dtype``
    torch.float32 on the card: the kernel's fp32 sums, unrounded (a
    row-parallel shard's partial sums)."""
    k, n, g = _check(x, packed, scales, "matmul_int4")
    m = x.numel() // k
    kw, nw = (k, n) if whole is None else whole
    if not kernel_applicable(m, kw, nw, g):
        raise ValueError(f"matmul_int4: shape M={m} K={k} N={n} g={g} is not the kernel's")
    if _device(x, "matmul_int4") == "cpu":
        return matmul_int4_reference(x, packed, scales, out_dtype)
    if x.dtype != torch.bfloat16:
        raise ValueError("matmul_int4: x must be bf16 on the card")
    f32 = out_dtype == torch.float32
    x, packed, scales = _cuda_operands("matmul_int4", torch.bfloat16, x, packed,
                                       scales.float())
    if not f32 and out_dtype != torch.bfloat16:
        raise ValueError("matmul_int4: the kernel writes bf16 or fp32")
    if x.data_ptr() % 16:  # the kernel copies x in 16-byte chunks
        x = x.clone()
    return int4_decode(x, packed, scales, None if nw == n else nw, f32)


# ------------------------------------------------------------- K5, K6

def requant_ratios(scales: torch.Tensor):
    """W4A8's weight requantization (JAX :341-342): per-column int8 scale
    s8 = max_g(s) * 7/127 [1, N] and ratios r = s / s8 [K/g, N], in fp32."""
    s = scales.float()
    s8 = s.amax(-2, keepdim=True).clamp(min=1e-12) * (7.0 / 127.0)
    return s8, s / s8


def _a16_weights(packed: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype):
    """K5's weights [K, N]: each int4 value times its group scale in fp32,
    rounded to ``dtype`` (JAX :201-206)."""
    g = 2 * packed.shape[0] // scales.shape[0]
    rows = scales.float().repeat_interleave(g, dim=0)
    return (unpack_int4(packed).float() * rows).to(dtype)


def int4_prefill_a16_reference(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K5: each weight times its group scale in fp32,
    rounded to x's dtype, then the product in fp32."""
    _check(x2, packed, scales, "matmul_int4_prefill")
    return (x2.float() @ _a16_weights(packed, scales, x2.dtype).float()).to(out_dtype)


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


# K5 on the card (csrc/int4_matmul.cu, namespace k5). The GEMM's tiles, in
# the order the plan tries them (``GP_A16_TILES``): (BM, BN, warps along M,
# warps along N, bytes of K per stage, stages in the cp.async ring). The
# prep's blocks are 256 threads, each dequantizing A16_PREP_COLS columns,
# A16_PREP_TILE packed rows at a time. The wide tile is taken where its grid
# gives A16_MIN_BLOCKS (two blocks per SM); the prep splits K until its
# grid has A16_PREP_BLOCKS, eight blocks per SM, which keep more of its
# loads in flight than two.
A16_TILES = ((128, 128, 2, 4, 128, 3), (64, 64, 2, 2, 128, 3))
A16_PREP_COLS = 64
A16_PREP_TILE = 64
A16_MIN_BLOCKS = 2 * SMS
A16_PREP_BLOCKS = 8 * SMS
# int4_a16_bf16's arguments: x, packed, scales, W16^T, out, the ints, stream
_A16_ARGTYPES = [ctypes.c_void_p] * 7


@dataclass(frozen=True)
class A16Plan:
    """How one K5 call runs: GEMM tile ``tile`` of A16_TILES (``bm`` x
    ``bn`` outputs, ``warps`` warps, ``stages`` k tiles in flight,
    ``smem_bytes`` per block) on a ``grid_m`` x ``grid_n`` grid, M tiles
    fastest; the prep on N / A16_PREP_COLS x ``prep_ksplit`` column blocks
    of ``prep_tiles`` packed-row tiles."""
    tile: int
    bm: int
    bn: int
    warps: int
    stages: int
    smem_bytes: int
    grid_m: int
    grid_n: int
    prep_ksplit: int
    prep_tiles: int

    @property
    def blocks(self) -> int:
        return self.grid_m * self.grid_n

    @property
    def prep_blocks(self) -> int:
        return self.grid_n * self.bn // A16_PREP_COLS * self.prep_ksplit


def a16_smem_bytes(tile: int) -> int:
    """Shared memory of one K5 GEMM block of tile ``tile``
    (csrc/int4_matmul.cu ``k5::smem_bytes``): its stages of a [BM, BK] x
    tile and a [BN, BK] W16^T tile, BK bytes of bf16, swizzled without
    padding."""
    bm, bn, _, _, bk, stages = A16_TILES[tile]
    return stages * (bm + bn) * bk


@functools.lru_cache(maxsize=1024)
def plan_int4_a16(m: int, k: int, n: int) -> A16Plan:
    """K5's plan for x [m, k] @ W [k, n], or ValueError for a shape the
    kernels refuse: the first of A16_TILES whose grid has A16_MIN_BLOCKS
    blocks, else the last that divides N; its grid; the prep's K split."""
    if not (m > 0 and k > 0 and k % (2 * A16_PREP_TILE) == 0 and n > 0
            and n % A16_PREP_COLS == 0):
        raise ValueError(f"matmul_int4_prefill: K5 takes no shape M={m} K={k} N={n}")
    fits = [i for i, t in enumerate(A16_TILES) if n % t[1] == 0 and 2 * k % t[4] == 0]
    tile = next((i for i in fits if -(-m // A16_TILES[i][0]) * (n // A16_TILES[i][1])
                 >= A16_MIN_BLOCKS), fits[-1])
    bm, bn, wm, wn, _, stages = A16_TILES[tile]
    tiles = k // 2 // A16_PREP_TILE
    per = -(-tiles // min(tiles, -(-A16_PREP_BLOCKS // (n // A16_PREP_COLS))))
    return A16Plan(tile, bm, bn, wm * wn, stages, a16_smem_bytes(tile), -(-m // bm), n // bn,
                   -(-tiles // per), per)


def int4_a16_prep_reference(packed: torch.Tensor, scales: torch.Tensor,
                            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of K5's prep: the packed weights -> W16^T [N, K], the
    weights of ``int4_prefill_a16_reference`` transposed and contiguous."""
    return _a16_weights(packed, scales, dtype).t().contiguous()


def bf16_gemm_tn_reference(x2: torch.Tensor, w16t: torch.Tensor,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K5's GEMM: x [M, K] . W16^T [N, K]^T in fp32."""
    return (x2.float() @ w16t.float().t()).to(out_dtype)


def int4_a16_kernels(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor):
    """K5 on the card, uncounted: x2 bf16 [M, K] -> (out bf16 [M, N], W16^T
    bf16 [N, K]), the prep's output kept for checks. One ctypes call
    launches the prep and the GEMM on the current stream; W16^T is scratch
    of N x K x 2 bytes."""
    k, n, g = _check(x2, packed, scales, "matmul_int4_prefill")
    m = x2.shape[0]
    if x2.dtype != torch.bfloat16 or scales.dtype != torch.float32:
        raise ValueError("matmul_int4_prefill: K5 takes bf16 x and f32 scales on the card")
    x2, packed, scales = _cuda_operands("matmul_int4_prefill", torch.bfloat16, x2, packed,
                                        scales)
    if x2.data_ptr() % 16:  # the GEMM copies x in 16-byte chunks
        x2 = x2.clone()
    plan = plan_int4_a16(m, k, n)
    w16t = torch.empty((n, k), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    ints = array.array("i", (m, k, n, g, plan.tile, plan.smem_bytes, plan.grid_m, plan.grid_n,
                             plan.prep_ksplit, plan.prep_tiles))
    fn = kernel_function("int4_matmul", "int4_a16_bf16", _A16_ARGTYPES)
    rc = fn(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), w16t.data_ptr(),
            out.data_ptr(), ints.buffer_info()[0], current_stream(x2.device))
    check_launch(rc, "matmul_int4_prefill")
    return out, w16t


# K6 on the card (csrc/int4_matmul.cu, namespace k6). The GEMM's tiles, in
# the order the plan tries them (``GP_A8_TILES``): (BM, BN, warps along M,
# warps along N, bytes of K per stage, stages in the cp.async ring). The
# prep's blocks are 256 threads: a row block quantizes A8_PREP_ROWS rows of
# x, a column block requantizes A8_PREP_COLS columns, A8_PREP_TILE packed
# rows at a time.
A8_TILES = ((128, 128, 2, 4, 128, 3), (64, 64, 2, 2, 128, 3))
A8_PREP_ROWS = 8
A8_PREP_COLS = 64
A8_PREP_TILE = 64
# the wide tile is taken where its grid gives two blocks per SM, and the
# prep's column blocks split K until they do
A8_SMS = SMS
A8_MIN_BLOCKS = 2 * A8_SMS


@dataclass(frozen=True)
class A8Plan:
    """How one K6 call runs: GEMM tile ``tile`` of A8_TILES (``bm`` x ``bn``
    outputs, ``warps`` warps, ``stages`` k tiles in flight,
    ``smem_bytes`` per block) on a ``grid_m`` x ``grid_n`` grid, M tiles
    fastest; the prep on ``prep_row_blocks`` row blocks and N / A8_PREP_COLS
    x ``prep_ksplit`` column blocks of ``prep_tiles`` packed-row tiles."""
    tile: int
    bm: int
    bn: int
    warps: int
    stages: int
    smem_bytes: int
    grid_m: int
    grid_n: int
    prep_row_blocks: int
    prep_ksplit: int
    prep_tiles: int

    @property
    def blocks(self) -> int:
        return self.grid_m * self.grid_n

    @property
    def prep_blocks(self) -> int:
        return self.prep_row_blocks + self.grid_n * self.bn // A8_PREP_COLS * self.prep_ksplit


def a8_smem_bytes(tile: int) -> int:
    """Shared memory of one GEMM block of tile ``tile`` (csrc/int4_matmul.cu
    ``k6::smem_bytes``): its stages of a [BM, BK] x tile and a [BN, BK]
    W8^T tile, int8, swizzled without padding."""
    bm, bn, _, _, bk, stages = A8_TILES[tile]
    return stages * (bm + bn) * bk


def a8_fits(k: int, n: int):
    """The A8_TILES that divide a [k, n] weight (the narrow one divides every
    shape the prep takes)."""
    return [i for i, t in enumerate(A8_TILES) if n % t[1] == 0 and k % t[4] == 0]


def a8_tile(m: int, k: int, n: int) -> int:
    """K6's GEMM tile for x [m, k] @ W [k, n]: the first of A8_TILES whose
    grid has at least A8_MIN_BLOCKS blocks, else the last that divides the
    shape. ``tools/torch_int4_a8_tile_ab.py`` replaces this function to time
    the other tile."""
    fits = a8_fits(k, n)
    return next((i for i in fits if -(-m // A8_TILES[i][0]) * (n // A8_TILES[i][1])
                 >= A8_MIN_BLOCKS), fits[-1])


@functools.lru_cache(maxsize=1024)
def plan_int4_a8(m: int, k: int, n: int) -> A8Plan:
    """K6's plan for x [m, k] @ W [k, n], or ValueError for a shape the
    kernels refuse: the GEMM tile from ``a8_tile``, its grid, and the
    prep's row blocks and K split."""
    if not (m > 0 and k > 0 and k % (2 * A8_PREP_TILE) == 0 and n % A8_PREP_COLS == 0):
        raise ValueError(f"matmul_int4_prefill: K6 takes no shape M={m} K={k} N={n}")
    tile = a8_tile(m, k, n)
    if tile not in a8_fits(k, n):
        raise ValueError(f"matmul_int4_prefill: K6's tile {tile} does not divide N={n}")
    bm, bn, wm, wn, _, stages = A8_TILES[tile]
    tiles = k // 2 // A8_PREP_TILE
    slices = n // A8_PREP_COLS
    per = -(-tiles // min(tiles, -(-A8_MIN_BLOCKS // slices)))
    return A8Plan(tile, bm, bn, wm * wn, stages, a8_smem_bytes(tile), -(-m // bm), n // bn,
                  -(-m // A8_PREP_ROWS), -(-tiles // per), per)


def int4_a8_prep_reference(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                           xs: Optional[torch.Tensor] = None, s8: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K6's prep: x [M, K] -> xq int8 [M, K] and xs f32 [M]
    (``quantize_kv``, JAX :336-339); the packed weights -> W8^T int8 [N, K],
    q8 = round(q4 * r) transposed, and s8 f32 [N] (``requant_ratios``, JAX
    :341-342, :232-237). Given ``xs`` [M] and ``s8`` [N] (a row-parallel
    shard's, taken over the whole contraction), x is quantized by xs and r
    = s / s8, and both come back as given."""
    k, n, g = _check(x2, packed, scales, "matmul_int4_prefill")
    if (xs is None) != (s8 is None):
        raise ValueError("matmul_int4_prefill: give both xs and s8, or neither")
    if xs is None:
        xq, xs = quantize_kv(x2)
        s8, r = requant_ratios(scales)
        s8 = s8[0]
    else:
        xs, s8 = xs.float(), s8.float()
        xq = torch.clamp(torch.round(x2.float() / xs[:, None]), -127, 127).to(torch.int8)
        r = scales.float() / s8[None, :]
    q8 = torch.round(unpack_int4(packed).float() * r.repeat_interleave(g, dim=0))
    return xq, xs, q8.to(torch.int8).t().contiguous(), s8


def int8_gemm_tn_reference(xq: torch.Tensor, xs: torch.Tensor, w8t: torch.Tensor,
                           s8: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6's GEMM: xq [M, K] . W8^T [N, K]^T as an exact
    integer sum (float64 holds every int32 sum), then acc * xs[row] *
    s8[col] in fp32; with ``out_dtype`` torch.int32 the sums alone, not
    rescaled (a row-parallel shard's, ``a8_rescale`` after their
    all-reduce)."""
    acc = xq.double() @ w8t.double().t()
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    return a8_rescale(acc, xs, s8, out_dtype)


def a8_rescale(acc: torch.Tensor, xs: torch.Tensor, s8: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """K6's epilogue: acc [M, N] (int32 sums) * xs[row] * s8[col], two fp32
    multiplies in that order, rounded to ``out_dtype``."""
    return (acc.float() * xs.float()[:, None] * s8.float()[None, :]).to(out_dtype)


def int4_a8_kernels(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    xs: Optional[torch.Tensor] = None, s8: Optional[torch.Tensor] = None):
    """K6 on the card, uncounted: x2 bf16 [M, K] -> (out bf16 [M, N],
    (xq, xs, w8t, s8)), the prep's outputs kept for checks. One ctypes call
    launches the prep and the GEMM on the current stream; W8^T is scratch
    of N x K bytes. Given ``xs`` f32 [M] and ``s8`` f32 [N] (a row-parallel
    shard's, over the whole contraction), the prep reads them and out is
    the GEMM's int32 sums [M, N], not rescaled."""
    k, n, g = _check(x2, packed, scales, "matmul_int4_prefill")
    m = x2.shape[0]
    if x2.dtype != torch.bfloat16 or scales.dtype != torch.float32:
        raise ValueError("matmul_int4_prefill: K6 takes bf16 x and f32 scales on the card")
    given = xs is not None
    if given != (s8 is not None):
        raise ValueError("matmul_int4_prefill: give both xs and s8, or neither")
    if given and (xs.shape != (m,) or s8.shape != (n,) or xs.dtype != torch.float32
                  or s8.dtype != torch.float32):
        raise ValueError(f"matmul_int4_prefill: xs must be f32 [{m}] and s8 f32 [{n}]")
    x2, packed, scales = _cuda_operands("matmul_int4_prefill", torch.bfloat16, x2, packed,
                                        scales)
    if x2.data_ptr() % 16:  # the prep reads x in 16-byte chunks
        x2 = x2.clone()
    plan = plan_int4_a8(m, k, n)
    dev = x2.device
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    w8t = torch.empty((n, k), dtype=torch.int8, device=dev)
    if given:
        xs, s8 = xs.to(dev).contiguous(), s8.to(dev).contiguous()
        out = torch.empty((m, n), dtype=torch.int32, device=dev)
    else:
        xs = torch.empty((m,), dtype=torch.float32, device=dev)
        s8 = torch.empty((n,), dtype=torch.float32, device=dev)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    # the ints travel as one array: a ctypes call costs ~0.3 us per argument
    ints = array.array("i", (m, k, n, g, plan.tile, plan.smem_bytes, plan.grid_m, plan.grid_n,
                             plan.prep_row_blocks, plan.prep_ksplit, plan.prep_tiles,
                             int(given)))
    fn = kernel_function("int4_matmul", "int4_a8_bf16", [ctypes.c_void_p] * 10)
    rc = fn(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            w8t.data_ptr(), s8.data_ptr(), out.data_ptr(), ints.buffer_info()[0],
            current_stream(dev))
    check_launch(rc, "matmul_int4_prefill")
    return out, (xq, xs, w8t, s8)


def matmul_int4_a8_sums(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                        xs: torch.Tensor, s8: torch.Tensor) -> torch.Tensor:
    """K6 on a row-parallel shard, counted: x2 [M, K/tp] (this rank's
    contraction columns) @ its int4 rows, quantized by the given row
    scales ``xs`` [M] and per-column ``s8`` [N] of the whole contraction ->
    the int32 sums [M, N], which the caller all-reduces and rescales
    (``a8_rescale``). On the CPU the plain prep and GEMM; on the card the
    kernel (``int4_a8_kernels`` with xs and s8 given)."""
    k, n, _ = _check(x2, packed, scales, "matmul_int4_prefill")
    if _device(x2, "matmul_int4_prefill") == "cpu":
        xq, xs, w8t, s8 = int4_a8_prep_reference(x2, packed, scales, xs, s8)
        return int8_gemm_tn_reference(xq, xs, w8t, s8, torch.int32)
    if x2.dtype != torch.bfloat16:
        raise ValueError("matmul_int4_prefill: the card takes bf16 x")
    acc, _ = int4_a8_kernels(x2, packed, scales.float(), xs, s8)
    matmul_int4_prefill.launches[launch_key(k, n, True)] += 1
    return acc


def matmul_int4_prefill(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16,
                        a8: bool = False, whole: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """x [..., K] @ int4 [K/2, N] -> [..., N] at prefill M (> 128 rows).

    a8=False is K5 (W4A16): on the CPU ``int4_prefill_a16_reference``; on
    the card K5's prep kernel dequantizes the weights to W16^T and its bf16
    GEMM multiplies (``int4_a16_kernels``). a8=True is K6 (W4A8): x
    quantized per row to int8 and the weights requantized per column. On
    the CPU both are prepared in plain PyTorch, as the JAX package prepares
    them outside its kernel, and ``int4_prefill_a8_reference`` multiplies;
    on the card K6's prep kernel prepares them and its GEMM multiplies
    (``int4_a8_kernels``). The card takes bf16 x and writes bf16 only. The
    caller checks ``prefill_applicable``; this function raises where it
    does not hold, on ``whole`` = (K, N), the unsharded layer's shape, for a
    column-parallel shard (a row-parallel one takes ``matmul_int4_a8_sums``)."""
    k, n, g = _check(x, packed, scales, "matmul_int4_prefill")
    m = x.numel() // k
    kw, nw = (k, n) if whole is None else whole
    if not prefill_applicable(m, kw, nw, g):
        raise ValueError(f"matmul_int4_prefill: shape M={m} K={k} N={n} g={g} "
                         "is not the kernel's")
    x2 = x.reshape(m, k)
    cpu = _device(x, "matmul_int4_prefill") == "cpu"
    if a8:
        if cpu:
            xq, xs = quantize_kv(x2)  # per-row int8 activations (JAX :336-339)
            s8, r = requant_ratios(scales)
            out = int4_prefill_a8_reference(xq, xs[:, None], packed, r, s8, out_dtype)
        else:
            if out_dtype != torch.bfloat16:
                raise ValueError("matmul_int4_prefill: the kernel writes bf16")
            out, _ = int4_a8_kernels(x2, packed, scales)
    else:
        if cpu:
            out = int4_prefill_a16_reference(x2, packed, scales, out_dtype)
        else:
            if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
                raise ValueError("matmul_int4_prefill: the card takes bf16 x and writes bf16")
            out, _ = int4_a16_kernels(x2, packed, scales.float())
    if not cpu:
        matmul_int4_prefill.launches[launch_key(k, n, a8)] += 1
    return out.reshape(x.shape[:-1] + (n,))


matmul_int4.launches = Counter()
matmul_int4_prefill.launches = Counter()
