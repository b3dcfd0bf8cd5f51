// int4-weight matrix products: K4 (decode), K5 (W4A16 prefill) and K6 (W4A8
// prefill).
//
// Replaces the Pallas kernels of glimpseprune_tpu/ops/pallas/int4_matmul.py:
// - K4, `matmul_int4` :103 (body `_kernel` :51): x [M, K] bf16 (M <= 128) @
//   int4 weights, each 64-row group's partial dot scaled on the result;
// - K5, `matmul_int4_prefill(a8=False)` :283 (body `_kernel_prefill_a16`
//   :191): each weight scaled by its group scale in fp32, rounded to bf16,
//   then a bf16 product with an fp32 accumulator;
// - K6, `matmul_int4_prefill(a8=True)` (body `_kernel_prefill_a8` :219,
//   wrapper :335-354): x quantized per row to int8 (JAX :336-339), the
//   weights requantized to per-column int8, q8 = rint(q4 * r) with
//   s8 = max_g(s) * 7/127 and r = s_group / s8_col (JAX :341-342,
//   :232-237), an int32 accumulator, and out = acc * x_scale[row] * s8[col].
// Weights are packed as quantization.quantize_int4 packs them: int8
// [K/2, N], row r in the low nibble and row r + K/2 in the high nibble; the
// scales are f32 [K/g, N], lo groups first.
//
// What bounds them on the H100. K4 reads 0.5 byte per weight (plus 4 bytes
// of scale per 64) for 2 * M flops: at decode batch it is bound by bytes,
// like a GEMV, and its narrow shapes by latency. It is one launch that
// streams each packed byte once for any M <= 128: a cp.async ring of
// 16-byte copies holds, per stage, one packed group (64 packed rows: a lo
// and a hi group) of the block's columns, the two groups' scales and x's
// matching columns in bf16. Each nibble becomes a bf16 exactly (a LOP3 and
// one bf16x2 fma for two of them), and mma.sync.m16n8k16 multiplies with
// the output columns as A rows and x's rows as B columns, 8 per n8 slice,
// so decode's M = 1 or 2 wastes the 8-row slice, not the weight stream.
// fp32 partials per group are scaled at the group's end, as the Pallas body
// does. K is split across the blocks of a thread-block cluster of up to 8,
// toward four blocks an SM (every decoder shape but the head splits), and
// the ranks sum each other's fp32 sums over distributed shared memory
// in rank order and write bf16: no second kernel, no partials in device
// memory, no atomics, so runs repeat bit for bit. Every address a thread
// copies to or reads from is fixed up to a stage's base, so the loop is
// the copies, the dequantization and the products. The host plan
// (ops/cuda/int4_matmul.py `plan_int4_decode`) picks the tile by M and N,
// the split and the grid; the launcher refuses a plan that disagrees with
// its own formulas.
//
// K5 and K6 at prefill M (a few thousand rows) are bound by operations:
// 2 M K N of them over ~0.5 K N + 2 M (K + N) bytes, 400 to 2,100 a byte
// at the 7B's decoder shapes and M = 1664, above the ~295 at which the
// H100's bf16 tensor cores, not its memory, are the limit.
//
// K5, which no path routes to (JAX :268), is two kernels behind one entry
// point (namespace k5), on K6's pattern. A prep pass (column blocks, K
// split across blocks toward eight blocks an SM) turns the packed
// weights into W16^T, bf16 [N, K] with K contiguous, each weight
// bf16_rn(q4 * s) with the product in fp32, as the plain version rounds it:
// the dequantization runs once per weight, not once per output row tile,
// and the transpose goes through shared memory so that global reads and
// writes are 16 bytes a thread. The prep is bound by bytes (0.5 read and 2
// written a weight); W16^T is scratch of N K 2 bytes from the wrapper,
// 25.7 / 3.7 / 135.8 / 135.8 MB at the 7B's q/o, k/v, gate/up and down.
// x is bf16 already, the GEMM's A operand, so the prep makes no pass over
// it. The GEMM multiplies x by W16^T on the bf16 tensor cores
// (mma.sync m16n8k16, fp32 sums) from a cp.async ring of 64-element k
// tiles laid out as K6's (its XOR swizzle, so ldmatrix.x4 reads both
// operands without bank conflicts, one barrier per k tile), M tiles
// fastest in the grid so that the M tiles in flight share each W16^T
// panel through L2, and no split K, so calls repeat bit for bit. The host
// plan (`plan_int4_a16`) picks 128 x 128 or, where that grid gives under
// two blocks per SM (k/v), 64 x 64. Later work, shared with K6's second
// pass: wgmma with TMA, and dequantizing in registers inside the GEMM with
// no W16^T round trip.
//
// K6 is two kernels behind one entry point (namespace k6). A prep pass
// turns x into int8 rows with their scales (row blocks) and the packed
// weights into W8^T, int8 [N, K] with K contiguous, plus s8 (column
// blocks): the requantization runs once per weight, not once per output
// row tile, and the transpose goes through shared memory so that global
// reads and writes are 16 bytes a thread. The GEMM then multiplies
// xq [M, K] by W8^T on the int8 tensor cores (mma.sync m16n8k32, int32
// sums) from a cp.async ring of kStages k tiles, XOR-swizzled so that
// ldmatrix.x4 reads both operands without bank conflicts, one barrier per
// k tile; the M-tile index runs fastest in the grid, so the M tiles in
// flight share each column panel of W8^T through L2. The host plan
// (ops/cuda/int4_matmul.py `plan_int4_a8`) picks the tile: 128 x 128, or
// 64 x 64 where the wide tile gives under two blocks per SM (the k/v
// projection's N = 512). The int32 sums are exact and the epilogue is the
// plain version's two fp32 multiplies, so K6 equals its plain version bit
// for bit. On a row-parallel shard (parallel/mesh.py) both scales belong to
// the whole contraction: the caller all-reduces the rows' amax and the
// columns' largest group scale, the prep takes the row scales and s8 as
// given, and the GEMM writes its int32 sums with no epilogue, to be
// all-reduced and rescaled by the caller, as one process's would be.
// wgmma, TMA and dequantizing in registers inside the GEMM (no W8^T round
// trip) are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// The int4 values of a packed byte as fp32: the low nibble (row r) and the
// high nibble (row r + K/2), sign-extended by arithmetic shifts.
__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)((int8_t)(b << 4) >> 4);
}

__device__ __forceinline__ float hi_nibble(int8_t b) { return (float)(b >> 4); }

// ---------------------------------------------------------------- K4
namespace k4 {

// A stage of the ring holds one packed group: kGroupRows packed rows of the
// block's BN columns (the weights of lo group i and of hi group K/2g + i),
// those two groups' scales, and x's matching 64 lo and 64 hi columns for
// the block's MPAD rows in bf16 (rows at or past M are zeros). kStages
// slots, loads kStages - 2 groups ahead: a slot is refilled two iterations
// after it was read, so the copy is issued before the barrier that waits
// for the current group.
constexpr int kGroupRows = 64;
constexpr int kStages = 4;
constexpr int kMaxCluster = 8;

// The tiles, in the order the host plan lists them: X(index, n8 slices of
// x rows a warp holds, warps along M, warps along N, m16 column tiles a
// warp holds). A block holds BN = 16 x tiles x warps along N columns and
// MPAD = 8 x slices x warps along M rows of x. Each class of M (by its n8
// slices: 1, 2, 3-4, 5-8, 9-16) has a wide tile and a narrow one of 16
// columns a block, for outputs too narrow for the wide one to fill the
// card (the k/v projections).
#define GP_K4_TILES(X)                                                                  \
  X(0, 1, 1, 4, 2) X(1, 1, 1, 1, 1) X(2, 2, 1, 4, 2) X(3, 2, 1, 1, 1) X(4, 4, 1, 4, 2) \
  X(5, 4, 1, 1, 1) X(6, 4, 2, 2, 2) X(7, 4, 2, 1, 1) X(8, 4, 4, 1, 2) X(9, 4, 4, 1, 1)

__host__ __device__ constexpr int stage_bytes(int bn, int mpad) {
  return kGroupRows * bn + 8 * bn + 256 * mpad;
}

// the ring, or the fp32 sums [MPAD, BN] that reuse it after the last stage
__host__ __device__ constexpr int smem_bytes(int bn, int mpad) {
  return kStages * stage_bytes(bn, mpad) > 4 * mpad * bn ? kStages * stage_bytes(bn, mpad)
                                                         : 4 * mpad * bn;
}

struct Args {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* w;         // [K/2, N] packed int4
  const float* s;          // [K/64, N] group scales, lo groups first
  __nv_bfloat16* out;      // [M, N], or null when `sums` is given
  float* sums;             // [M, N] fp32 sums, not rounded, or null
  int m, k, n, per;        // per: packed groups of one K split
};

// Byte offset of 16-byte chunk `ch` of packed row `r` in a stage's weight
// tile of BN-byte rows. The chunk is XORed with 2 * (r / 2 % 4), within the
// row's chunks, so that the four rows one word load of a warp reads,
// 2t + {0, 1, 8, 9} for t = 0..3, fall on 32 distinct banks at BN = 128
// (and at 16, unswizzled). The swizzle repeats every 8 rows.
template <int BN>
__device__ __forceinline__ int wswz(int r, int ch) {
  return r * BN + ((ch ^ ((((r >> 1) & 3) << 1) & (BN / 16 - 1))) << 4);
}

// Two int4 values, two's complement in bits 0-3 and 16-19 of v, as two
// bf16 in one register, exactly: (nibble ^ 8) | 0x4300 is the bf16 128 + q
// + 8 (one LOP3: its constants go in registers, as a LOP3 takes one
// immediate), and one bf16x2 fma subtracts 136. The Pallas body casts the
// same values to x's dtype (JAX :66-67).
__device__ __forceinline__ uint32_t int4x2_bf16(uint32_t v) {
  uint32_t biased, r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(biased) : "r"(v), "r"(0x000F000Fu),
      "r"(0x43084308u));  // (v & mask) ^ magic
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(biased), "r"(0x3F803F80u),
      "r"(0xC308C308u));
  return r;
}

// The A fragments of TW m16 tiles, lo and hi, from the words of packed
// rows k and k + 1 (bytes: the thread's 2 TW columns): tile tl holds
// columns 2 tl (fragment row g) and 2 tl + 1 (row g + 8); `h` picks
// fragment registers 0/1 (k = 2t, 2t + 1) or 2/3 (k = 2t + 8, 2t + 9).
template <int TW>
__device__ __forceinline__ void a_frags(uint32_t w0, uint32_t w1, int h, uint32_t (&lo)[TW][4],
                                        uint32_t (&hi)[TW][4]) {
#pragma unroll
  for (int tl = 0; tl < TW; ++tl) {
    // bytes 0, 1: two columns of row k; bytes 2, 3: the same of row k + 1
    const uint32_t p = __byte_perm(w0, w1, tl == 0 ? 0x5410 : 0x7632);
    lo[tl][2 * h] = int4x2_bf16(p);
    hi[tl][2 * h] = int4x2_bf16(p >> 4);
    lo[tl][2 * h + 1] = int4x2_bf16(p >> 8);
    hi[tl][2 * h + 1] = int4x2_bf16(p >> 12);
  }
}

// out [M, N] = sum over the K splits (the blocks of one cluster, in rank
// order) of sum over the split's groups of (x . q4) * s, per group and
// column. The products run on mma.sync.m16n8k16 with the output columns as
// A rows and x's rows as B columns (one n8 slice for M <= 8), fp32 group
// partials, scaled at each group's end. Every address a thread copies to or
// reads from is fixed per thread up to the stage's base: they are computed
// once, before the loop.
template <int SL, int WM, int WN, int TW>
__global__ void __launch_bounds__(32 * WM * WN) decode_kernel(Args a) {
  constexpr int kThreads = 32 * WM * WN;
  constexpr int BN = 16 * TW * WN, MPAD = 8 * SL * WM;
  constexpr int kW = kGroupRows * BN, kS = 8 * BN, kStage = stage_bytes(BN, MPAD);
  constexpr int kRowChunks = BN / 16, kRowStep = kThreads / kRowChunks;
  constexpr int kWCopies = (kGroupRows + kRowStep - 1) / kRowStep;
  static_assert(kThreads % kRowChunks == 0 && kRowStep % 8 == 0 && BN / 2 <= kThreads,
                "a thread's weight chunks share one swizzle, its scale chunk is one");
  extern __shared__ __align__(128) uint8_t smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ksplit = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = blockIdx.x / ksplit * BN;
  const int kh = a.k / 2, groups = kh / kGroupRows;
  const int g0 = rank * a.per, ng = min(groups, g0 + a.per) - g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t = lane & 3;

  // x's rows past M stay zero in every slot: written once
  for (int slot = 0; slot < kStages; ++slot)
    for (int c = tid; c < (MPAD - a.m) * 16; c += kThreads)
      *reinterpret_cast<uint4*>(smem + slot * kStage + kW + kS + a.m * 256 + 16 * c) =
          make_uint4(0u, 0u, 0u, 0u);

  // the copies: weight chunk tid % kRowChunks of packed rows tid /
  // kRowChunks + j kRowStep; scale chunk tid (lo row, then hi row)
  const int wr0 = tid / kRowChunks;
  const int w_dst = wswz<BN>(wr0, tid % kRowChunks);
  const int8_t* w_src = a.w + (long)wr0 * a.n + n0 + 16 * (tid % kRowChunks);
  const long w_step = (long)kRowStep * a.n, g_step = (long)kGroupRows * a.n;
  const int s_half = tid / (BN / 4), s_ch = tid % (BN / 4);
  const int s_dst = kW + 4 * (s_half * BN + 4 * s_ch);
  const float* s_src = a.s + (long)s_half * groups * a.n + n0 + 4 * s_ch;
  // x: chunk tid % 16 (0-7 the lo columns, 8-15 the hi ones) of rows
  // tid / 16 + j kXRowStep, XOR-swizzled by row % 8 so that ldmatrix reads
  // 8 rows on distinct banks
  constexpr int kXRowStep = kThreads / 16, kXCopies = (MPAD + kXRowStep - 1) / kXRowStep;
  const int x_ch = tid & 15, x_r0 = tid >> 4;
  const __nv_bfloat16* x_src = a.x + (long)x_r0 * a.k + (x_ch & 8 ? kh : 0) + 8 * (x_ch & 7);
  auto load_stage = [&](int slot, int gi) {
    uint8_t* st = smem + slot * kStage;
    const int8_t* wsrc = w_src + gi * g_step;
#pragma unroll
    for (int j = 0; j < kWCopies; ++j)
      if (kWCopies * kRowStep == kGroupRows || wr0 + j * kRowStep < kGroupRows)
        gp_tc::cp_async16(st + w_dst + j * kRowStep * BN, wsrc + j * w_step, 16);
    if (tid < BN / 2) gp_tc::cp_async16(st + s_dst, s_src + (long)gi * a.n, 16);
#pragma unroll
    for (int j = 0; j < kXCopies; ++j) {
      const int r = x_r0 + j * kXRowStep;
      if (r < a.m)
        gp_tc::cp_async16(st + kW + kS + r * 256 + ((x_ch ^ (r & 7)) << 4),
                          x_src + (long)j * kXRowStep * a.k + gi * kGroupRows, 16);
    }
  };

  // the reads: the thread's words of packed rows 16 ks + 2t + {0, 1, 8, 9}
  // (their swizzle is 2t: one offset, then immediates), and the ldmatrix
  // rows of x: matrices 0-1 the lo columns 16 ks .. +15, 2-3 the hi ones,
  // chunk (lane / 16) * 8 + 2 ks + lane / 8 % 2, swizzled by row % 8 =
  // lane % 8; ks adds bits 1-2 to the chunk, so it XORs into the offset
  const int wcol = (wn * 8 + g) * 2 * TW;  // the thread's 2 TW columns in the tile
  const int a_off = 2 * t * BN + (((wcol >> 4) ^ ((2 * t) & (kRowChunks - 1))) << 4) + (wcol & 15);
  const int b_off = (wm * SL * 8 + (lane & 7)) * 256 +
                    (((((lane >> 4) << 3) | ((lane >> 3) & 1)) ^ (lane & 7)) << 4);

  float acc[TW][SL][4];
#pragma unroll
  for (int tl = 0; tl < TW; ++tl)
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tl][sl][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < ng) load_stage(s, g0 + s);
    gp_tc::cp_async_commit();
  }
  for (int it = 0; it < ng; ++it) {
    const int pf = it + kStages - 2;  // its slot was last read at it - 2
    if (pf < ng) load_stage(pf % kStages, g0 + pf);
    gp_tc::cp_async_commit();
    gp_tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // group it has landed in every thread's copies
    const uint8_t* st = smem + (it % kStages) * kStage;
    const uint8_t* xs = st + kW + kS;

    float plo[TW][SL][4], phi[TW][SL][4];  // this group's partial dots
#pragma unroll
    for (int tl = 0; tl < TW; ++tl)
#pragma unroll
      for (int sl = 0; sl < SL; ++sl)
#pragma unroll
        for (int e = 0; e < 4; ++e) plo[tl][sl][e] = phi[tl][sl][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kGroupRows / 16; ++ks) {
      const uint8_t* wp = st + a_off + 16 * ks * BN;
      auto word = [&](int row) -> uint32_t {  // the thread's 2 TW bytes of a packed row
        return TW == 2 ? *reinterpret_cast<const uint32_t*>(wp + row * BN)
                       : (uint32_t)*reinterpret_cast<const uint16_t*>(wp + row * BN);
      };
      uint32_t alo[TW][4], ahi[TW][4];
      a_frags<TW>(word(0), word(1), 0, alo, ahi);
      a_frags<TW>(word(8), word(9), 1, alo, ahi);
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        if ((wm * SL + sl) * 8 >= a.m) break;  // the same for the whole warp
        uint32_t b[4];
        gp_tc::ldsm_x4(b, xs + sl * 8 * 256 + (b_off ^ (ks << 5)));
#pragma unroll
        for (int tl = 0; tl < TW; ++tl) {
          gp_tc::mma_16816(plo[tl][sl], alo[tl], b[0], b[1]);
          gp_tc::mma_16816(phi[tl][sl], ahi[tl], b[2], b[3]);
        }
      }
    }
    // the group's end: each partial times its column's scale (JAX :81-83);
    // fragment rows g and g + 8 of tile tl are columns 2 tl and 2 tl + 1
    const float* ss = reinterpret_cast<const float*>(st + kW) + wcol;
#pragma unroll
    for (int tl = 0; tl < TW; ++tl) {
      const float2 slo = *reinterpret_cast<const float2*>(ss + 2 * tl);
      const float2 shi = *reinterpret_cast<const float2*>(ss + BN + 2 * tl);
#pragma unroll
      for (int sl = 0; sl < SL; ++sl)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[tl][sl][e] = fmaf(plo[tl][sl][e], e < 2 ? slo.x : slo.y, acc[tl][sl][e]);
          acc[tl][sl][e] = fmaf(phi[tl][sl][e], e < 2 ? shi.x : shi.y, acc[tl][sl][e]);
        }
    }
  }
  gp_tc::cp_async_wait<0>();
  __syncthreads();  // every stage is read: the ring now holds the block's sums

  // sums [MPAD, BN] in fp32: accumulator (g, 2t) of tile tl is column
  // wcol + 2 tl at row 2t, (g + 8, 2t) column wcol + 2 tl + 1
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int tl = 0; tl < TW; ++tl)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wm * SL + sl) * 8 + 2 * t + h;
        *reinterpret_cast<float2*>(red + row * BN + wcol + 2 * tl) =
            make_float2(acc[tl][sl][h], acc[tl][sl][h + 2]);
      }
  cluster.sync();  // every rank's sums are in its shared memory
  // rank r writes pairs of outputs r, r + ksplit, ..., each the sum of the
  // ranks' sums, read over distributed shared memory all at once and added
  // in rank order: no atomics, so runs repeat bit for bit
  for (int i = tid * ksplit + rank; i < a.m * (BN / 2); i += kThreads * ksplit) {
    const int off = i / (BN / 2) * BN + 2 * (i % (BN / 2));
    float2 part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < ksplit)
        part[q] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(red, q) + off);
    float2 v = part[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < ksplit) {
        v.x += part[q].x;
        v.y += part[q].y;
      }
    const long o = (long)(off / BN) * a.n + n0 + off % BN;
    if (a.sums != nullptr)
      *reinterpret_cast<float2*>(a.sums + o) = v;
    else
      *reinterpret_cast<__nv_bfloat162*>(a.out + o) = __floats2bfloat162_rn(v.x, v.y);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int SL, int WM, int WN, int TW>
int launch(const Args& a, int smem, int ksplit, int grid, cudaStream_t stream) {
  constexpr int BN = 16 * TW * WN, MPAD = 8 * SL * WM;
  if (a.m > MPAD || a.n % BN != 0 || smem != smem_bytes(BN, MPAD) ||
      grid != a.n / BN * ksplit)
    return (int)cudaErrorInvalidValue;
  const int err = gp_tc::raise_smem_cap<decode_kernel<SL, WM, WN, TW>>(smem);
  if (err != 0) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ksplit;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(32 * WM * WN);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_kernel<SL, WM, WN, TW>, a);
}

}  // namespace k4

// ---------------------------------------------------------------- K6
namespace k6 {

// The prep: 256 threads a block; a row block quantizes kPrepRows rows of x,
// one warp each; a column block requantizes kPrepCols columns of the
// weights, kPrepTile packed rows at a time, over its share of K.
constexpr int kPrepThreads = 256;
constexpr int kPrepRows = 8;
constexpr int kPrepCols = 64;
constexpr int kPrepTile = 64;

// The GEMM's tiles, in the order the host plan tries them: X(index, BM, BN,
// warps along M, warps along N, bytes of K per stage, stages in the ring)
#define GP_A8_TILES(X) X(0, 128, 128, 2, 4, 128, 3) X(1, 64, 64, 2, 2, 128, 3)

inline int smem_bytes(int bm, int bn, int bk, int stages) { return stages * (bm + bn) * bk; }

struct PrepArgs {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* w;         // [K/2, N] packed int4
  const float* s;          // [K/g, N] group scales
  int8_t* xq;              // [M, K]
  float* xs;               // [M]
  int8_t* w8t;             // [N, K]
  float* s8;               // [N]
  int m, k, n, g, row_blocks, col_slices, tiles_per_block;
  int given;               // 1: xs and s8 are the caller's (read, not computed)
};

// x rows -> int8 as ops/kv_cache.quantize_kv computes them on the card: the
// amax in bf16 (exact as fp32), floored at 1e-8, times the fp32 reciprocal
// of 127 (PyTorch's CUDA division of a tensor by a Python scalar multiplies
// by its reciprocal), then x / scale as an IEEE division, rounded half to
// even and clamped to +-127.
__device__ __forceinline__ void prep_rows(const PrepArgs& a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPrepRows + warp;
  if (row >= a.m) return;
  const __nv_bfloat16* xr = a.x + (long)row * a.k;
  float scale;
  if (a.given) {
    scale = a.xs[row];
  } else {
    float amax = 0.f;
#pragma unroll 4
    for (int c = lane * 8; c < a.k; c += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    scale = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
    if (lane == 0) a.xs[row] = scale;
  }
  int8_t* qr = a.xq + (long)row * a.k;
#pragma unroll 4
  for (int c = lane * 8; c < a.k; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r = rintf(__fdiv_rn(__bfloat162float(e[i]), scale));
      const int qi = (int)fminf(fmaxf(r, -127.f), 127.f);
      q[i >> 2] |= (uint32_t)(qi & 0xff) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(q[0], q[1]);
  }
}

// Weights -> W8^T and s8, as requant_ratios and the plain version compute
// them: s8 = max(max_g s, 1e-12) * (float)(7/127), r = s / s8 (IEEE), and
// q8 = rint(q4 * r) in fp32, rounded half to even. Each tile of 64 packed
// rows lies in one group on each half (64 divides g). The tile goes into
// shared memory with 16-byte stores, its 16-byte row chunks XOR-swizzled by
// (row / 16) so that the column reads below hit 8 distinct banks a warp;
// a thread then owns 16 packed rows of one column and writes 16 lo and 16
// hi bytes of that column's W8^T row, four threads 64 contiguous bytes.
__device__ __forceinline__ void prep_cols(const PrepArgs& a) {
  __shared__ __align__(16) int8_t tile[kPrepTile * kPrepCols];
  __shared__ float part[kPrepThreads];
  __shared__ float s8s[kPrepCols];
  __shared__ float rs[2][kPrepCols];
  const int tid = threadIdx.x;
  const int b = blockIdx.x - a.row_blocks;
  const int slice = b % a.col_slices, split = b / a.col_slices;
  const int n0 = slice * kPrepCols;
  const int groups = a.k / a.g, kh = a.k / 2;

  if (a.given) {  // s8 of the whole contraction, the caller's
    if (tid < kPrepCols) s8s[tid] = a.s8[n0 + tid];
  } else {  // s8 of the slice's columns: four partial maxima per column
    const int c = tid % kPrepCols;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int gi = tid / kPrepCols; gi < groups; gi += kPrepThreads / kPrepCols)
      mx = fmaxf(mx, a.s[(long)gi * a.n + n0 + c]);
    part[tid] = mx;
    __syncthreads();
    if (tid < kPrepCols) {
      mx = part[tid];
#pragma unroll
      for (int p = 1; p < kPrepThreads / kPrepCols; ++p)
        mx = fmaxf(mx, part[p * kPrepCols + tid]);
      const float s8 = __fmul_rn(fmaxf(mx, 1e-12f), (float)(7.0 / 127.0));
      s8s[tid] = s8;
      if (split == 0) a.s8[n0 + tid] = s8;
    }
  }

  const int tiles = kh / kPrepTile;
  const int t0 = split * a.tiles_per_block;
  const int t1 = min(tiles, t0 + a.tiles_per_block);
  const int lr = tid >> 2, lq = tid & 3;                          // the tile load
  const int c = (tid >> 5) * 8 + ((tid & 31) >> 2), j = tid & 3;  // the transpose
  const int8_t* wsrc = a.w + (long)lr * a.n + n0 + 16 * lq;
  int4 v = make_int4(0, 0, 0, 0);
  if (t0 < t1) v = *reinterpret_cast<const int4*>(wsrc + (long)t0 * kPrepTile * a.n);
  for (int t = t0; t < t1; ++t) {
    const int kp0 = t * kPrepTile;
    __syncthreads();  // s8s is written; the previous tile is no longer read
    *reinterpret_cast<int4*>(tile + lr * kPrepCols + 16 * (lq ^ ((lr >> 4) & 3))) = v;
    // the next tile's load is in flight during this one's transpose
    if (t + 1 < t1) v = *reinterpret_cast<const int4*>(wsrc + (long)(t + 1) * kPrepTile * a.n);
    if (tid < 2 * kPrepCols) {
      const int half = tid / kPrepCols, cc = tid % kPrepCols;
      const int gi = (half * kh + kp0) / a.g;
      rs[half][cc] = __fdiv_rn(a.s[(long)gi * a.n + n0 + cc], s8s[cc]);
    }
    __syncthreads();
    const float rlo = rs[0][c], rhi = rs[1][c];
    uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int8_t p = tile[(16 * j + i) * kPrepCols + 16 * ((c >> 4) ^ j) + (c & 15)];
      const int ql = __float2int_rn(__fmul_rn(lo_nibble(p), rlo));
      const int qh = __float2int_rn(__fmul_rn(hi_nibble(p), rhi));
      lo[i >> 2] |= (uint32_t)(ql & 0xff) << (8 * (i & 3));
      hi[i >> 2] |= (uint32_t)(qh & 0xff) << (8 * (i & 3));
    }
    int8_t* dst = a.w8t + (long)(n0 + c) * a.k + kp0 + 16 * j;
    *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(dst + kh) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

__global__ void __launch_bounds__(kPrepThreads) prep_kernel(PrepArgs a) {
  if ((int)blockIdx.x < a.row_blocks)
    prep_rows(a);
  else
    prep_cols(a);
}

struct GemmArgs {
  const int8_t* xq;    // [M, K]
  const float* xs;     // [M]
  const int8_t* w8t;   // [N, K]
  const float* s8;     // [N]
  __nv_bfloat16* out;  // [M, N], or null when `sums` is given
  int* sums;           // [M, N] int32 sums with no epilogue, or null
  int m, k, n;
};

// Byte offset of 16-byte chunk `ch` of row `row` in a stage's tile of
// BK-byte rows, with no padding: the chunk is XORed with the row's index
// among the rows that share a bank line (row % 8 at BK = 128, row / 2 % 4
// at 64), so the 8 rows x 16 bytes that one ldmatrix phase reads fall on
// 32 distinct banks.
template <int BK>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int kChunks = BK / 16;
  return row * BK + ((ch ^ ((row / (8 / kChunks)) & (kChunks - 1))) << 4);
}

// out tile [BM, BN] = xq [BM, K] . W8^T [BN, K]^T, rescaled, over a ring of
// STAGES k tiles of BK bytes. Warps hold (BM / WM) x (BN / WN) of the tile:
// MT m16 by NT n8 mma tiles. Rows at or past M are read as zeros (cp.async
// with no source bytes) and not written.
template <int BM, int BN, int WM, int WN, int BK, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN, WM * WN == 8 ? 2 : 4) gemm_kernel(GemmArgs a) {
  constexpr int kThreads = 32 * WM * WN;
  constexpr int kChunks = BK / 16;
  constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * (BM / WM), wn = (warp % WN) * (BN / WN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = a.k / BK;

  auto load_stage = [&](int stage, int kt) {
    int8_t* sa = smem + stage * (BM + BN) * BK;
    int8_t* sb = sa + BM * BK;
    const long k0 = (long)kt * BK;
#pragma unroll
    for (int idx = tid; idx < BM * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx % kChunks;
      const bool in = m0 + r < a.m;
      gp_tc::cp_async16(sa + swz<BK>(r, ch),
                        a.xq + (in ? (long)(m0 + r) * a.k + k0 + 16 * ch : 0), in ? 16 : 0);
    }
#pragma unroll
    for (int idx = tid; idx < BN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx % kChunks;
      gp_tc::cp_async16(sb + swz<BK>(r, ch), a.w8t + (long)(n0 + r) * a.k + k0 + 16 * ch, 16);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    gp_tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gp_tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_stage(pf % STAGES, pf);
    gp_tc::cp_async_commit();
    const int8_t* sa = smem + (kt % STAGES) * (BM + BN) * BK;
    const int8_t* sb = sa + BM * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + 16 * i + (lane & 15);
        gp_tc::ldsm_x4(af[i], sa + swz<BK>(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int r = wn + 8 * j + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        gp_tc::ldsm_x4(t, sb + swz<BK>(r, 2 * kk + ((lane >> 3) & 1)));
        bf[j][0] = t[0];
        bf[j][1] = t[1];
        bf[j + 1][0] = t[2];
        bf[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) gp_tc::mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  gp_tc::cp_async_wait<0>();

  // out = (float)acc * xs[row] * s8[col], two fp32 multiplies in the plain
  // version's order (JAX :247-248), rounded to bf16; or, for a row-parallel
  // shard whose sums are all-reduced before the rescale, the int32 sums
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + grp + 8 * h;
      if (row >= a.m) continue;
      if (a.sums != nullptr) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn + 8 * j + 2 * tig;
          *reinterpret_cast<int2*>(a.sums + (long)row * a.n + col) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
        continue;
      }
      const float xs = a.xs[row];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn + 8 * j + 2 * tig;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), xs), a.s8[col]);
        const float v1 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), xs), a.s8[col + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.out + (long)row * a.n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <int BM, int BN, int WM, int WN, int BK, int STAGES>
int launch_gemm(const GemmArgs& a, int smem, int grid_m, int grid_n, cudaStream_t stream) {
  if (smem != smem_bytes(BM, BN, BK, STAGES) || a.k % BK != 0 ||
      grid_m != (a.m + BM - 1) / BM || grid_n * BN != a.n)
    return (int)cudaErrorInvalidValue;
  const int err = gp_tc::raise_smem_cap<gemm_kernel<BM, BN, WM, WN, BK, STAGES>>(smem);
  if (err != 0) return err;
  gemm_kernel<BM, BN, WM, WN, BK, STAGES>
      <<<dim3(grid_m, grid_n), 32 * WM * WN, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace k6

// ---------------------------------------------------------------- K5
namespace k5 {

// The prep: 256 threads a block; a block dequantizes kPrepCols columns of
// the weights, kPrepTile packed rows at a time, over its share of K.
constexpr int kPrepThreads = 256;
constexpr int kPrepCols = 64;
constexpr int kPrepTile = 64;

// The GEMM's tiles, in the order the host plan tries them: X(index, BM, BN,
// warps along M, warps along N, bytes of K per stage, stages in the ring)
#define GP_A16_TILES(X) X(0, 128, 128, 2, 4, 128, 3) X(1, 64, 64, 2, 2, 128, 3)

inline int smem_bytes(int bm, int bn, int bk, int stages) { return stages * (bm + bn) * bk; }

struct PrepArgs {
  const int8_t* w;      // [K/2, N] packed int4
  const float* s;       // [K/g, N] group scales, lo groups first
  __nv_bfloat16* w16t;  // [N, K]
  int k, n, g, col_slices, tiles_per_block;
};

// Weights -> W16^T as the plain version computes them: w = bf16_rn(q4 * s)
// with the product in fp32. Each tile of 64 packed rows lies in one group
// on each half (64 divides g). The tile goes into shared memory with
// 16-byte stores, swizzled as K6's prep swizzles it; a thread then owns 16
// packed rows of one column and writes 16 lo and 16 hi bf16 of that
// column's W16^T row, four threads 128 contiguous bytes of each half.
__global__ void __launch_bounds__(kPrepThreads) prep_kernel(PrepArgs a) {
  __shared__ __align__(16) int8_t tile[kPrepTile * kPrepCols];
  __shared__ float ss[2][kPrepCols];
  const int tid = threadIdx.x;
  const int slice = blockIdx.x % a.col_slices, split = blockIdx.x / a.col_slices;
  const int n0 = slice * kPrepCols, kh = a.k / 2;
  const int tiles = kh / kPrepTile;
  const int t0 = split * a.tiles_per_block;
  const int t1 = min(tiles, t0 + a.tiles_per_block);
  const int lr = tid >> 2, lq = tid & 3;                          // the tile load
  const int c = (tid >> 5) * 8 + ((tid & 31) >> 2), j = tid & 3;  // the transpose
  const int8_t* wsrc = a.w + (long)lr * a.n + n0 + 16 * lq;
  const int8_t* col = tile + 16 * j * kPrepCols + 16 * ((c >> 4) ^ j) + (c & 15);
  // thread tid < 2 kPrepCols loads the scale of column tid % kPrepCols in
  // the lo (then the hi) half's group of each tile
  const int half = tid / kPrepCols;
  const float* ssrc = a.s + n0 + tid % kPrepCols;
  auto scale = [&](int t) { return ssrc[(long)((half * kh + t * kPrepTile) / a.g) * a.n]; };
  int4 v = make_int4(0, 0, 0, 0);
  float sv = 0.f;
  if (t0 < t1) {
    v = *reinterpret_cast<const int4*>(wsrc + (long)t0 * kPrepTile * a.n);
    if (half < 2) sv = scale(t0);
  }
  for (int t = t0; t < t1; ++t) {
    const int kp0 = t * kPrepTile;
    __syncthreads();  // the previous tile is no longer read
    *reinterpret_cast<int4*>(tile + lr * kPrepCols + 16 * (lq ^ ((lr >> 4) & 3))) = v;
    if (half < 2) ss[half][tid % kPrepCols] = sv;
    // the next tile's loads are in flight during this one's transpose
    if (t + 1 < t1) {
      v = *reinterpret_cast<const int4*>(wsrc + (long)(t + 1) * kPrepTile * a.n);
      if (half < 2) sv = scale(t + 1);
    }
    __syncthreads();
    const float slo = ss[0][c], shi = ss[1][c];
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int8_t p0 = col[i * kPrepCols], p1 = col[(i + 1) * kPrepCols];
      lo[i / 2] = gp_tc::pack_bf16(__fmul_rn(lo_nibble(p0), slo), __fmul_rn(lo_nibble(p1), slo));
      hi[i / 2] = gp_tc::pack_bf16(__fmul_rn(hi_nibble(p0), shi), __fmul_rn(hi_nibble(p1), shi));
    }
    uint4* dst = reinterpret_cast<uint4*>(a.w16t + (long)(n0 + c) * a.k + kp0 + 16 * j);
    dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    dst += kh / 8;  // the hi half, kh bf16 further
    dst[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dst[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
}

struct GemmArgs {
  const __nv_bfloat16* x;     // [M, K]
  const __nv_bfloat16* w16t;  // [N, K]
  __nv_bfloat16* out;         // [M, N]
  int m, k, n;
};

// out tile [BM, BN] = x [BM, K] . W16^T [BN, K]^T over a ring of STAGES k
// tiles of BK bytes (BK / 2 bf16), laid out as K6's GEMM lays out its int8
// tiles (k6::swz): a k16 step of bf16 is the 32 bytes of an s8 k32 step,
// so the ldmatrix addresses are K6's. Warps hold (BM / WM) x (BN / WN) of
// the tile: MT m16 by NT n8 mma tiles, 16 warps an SM (two blocks of the
// wide tile). Rows at or past M are read as zeros (cp.async with no source
// bytes) and not written.
template <int BM, int BN, int WM, int WN, int BK, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN, 16 / (WM * WN)) gemm_kernel(GemmArgs a) {
  constexpr int kThreads = 32 * WM * WN;
  constexpr int kChunks = BK / 16;
  constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * (BM / WM), wn = (warp % WN) * (BN / WN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long row_bytes = 2L * a.k;
  const int nk = (int)(row_bytes / BK);
  const int8_t* xb = reinterpret_cast<const int8_t*>(a.x);
  const int8_t* wb = reinterpret_cast<const int8_t*>(a.w16t);

  auto load_stage = [&](int stage, int kt) {
    int8_t* sa = smem + stage * (BM + BN) * BK;
    int8_t* sb = sa + BM * BK;
    const long k0 = (long)kt * BK;
#pragma unroll
    for (int idx = tid; idx < BM * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx % kChunks;
      const bool in = m0 + r < a.m;
      gp_tc::cp_async16(sa + k6::swz<BK>(r, ch),
                        xb + (in ? (m0 + r) * row_bytes + k0 + 16 * ch : 0), in ? 16 : 0);
    }
#pragma unroll
    for (int idx = tid; idx < BN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx % kChunks;
      gp_tc::cp_async16(sb + k6::swz<BK>(r, ch), wb + (n0 + r) * row_bytes + k0 + 16 * ch, 16);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    gp_tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gp_tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_stage(pf % STAGES, pf);
    gp_tc::cp_async_commit();
    const int8_t* sa = smem + (kt % STAGES) * (BM + BN) * BK;
    const int8_t* sb = sa + BM * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + 16 * i + (lane & 15);
        gp_tc::ldsm_x4(af[i], sa + k6::swz<BK>(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int r = wn + 8 * j + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        gp_tc::ldsm_x4(t, sb + k6::swz<BK>(r, 2 * kk + ((lane >> 3) & 1)));
        bf[j][0] = t[0];
        bf[j][1] = t[1];
        bf[j + 1][0] = t[2];
        bf[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) gp_tc::mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  gp_tc::cp_async_wait<0>();

  // out = bf16_rn(acc), as the plain version rounds its fp32 product
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + grp + 8 * h;
      if (row >= a.m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn + 8 * j + 2 * tig;
        *reinterpret_cast<__nv_bfloat162*>(a.out + (long)row * a.n + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <int BM, int BN, int WM, int WN, int BK, int STAGES>
int launch_gemm(const GemmArgs& a, int smem, int grid_m, int grid_n, cudaStream_t stream) {
  if (smem != smem_bytes(BM, BN, BK, STAGES) || (2L * a.k) % BK != 0 ||
      grid_m != (a.m + BM - 1) / BM || grid_n * BN != a.n)
    return (int)cudaErrorInvalidValue;
  const int err = gp_tc::raise_smem_cap<gemm_kernel<BM, BN, WM, WN, BK, STAGES>>(smem);
  if (err != 0) return err;
  gemm_kernel<BM, BN, WM, WN, BK, STAGES>
      <<<dim3(grid_m, grid_n), 32 * WM * WN, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace k5

}  // namespace

// K4 on `stream`, one launch. p holds the ints of the host plan
// (ops/cuda/int4_matmul.py `plan_int4_decode`): m, k, n, the tile's index in
// GP_K4_TILES, its shared-memory bytes, the K split (the cluster's size),
// packed groups per split and the grid; then f32: 0 writes out in bf16, 1
// writes the fp32 sums unrounded (a row-parallel shard's partial sums,
// which meet in an fp32 all-reduce and are rounded once, as one process's). A plan that disagrees with this
// file's own formulas, or a pointer off 16 bytes, is refused.
extern "C" int int4_decode_bf16(const void* x, const void* w, const void* s, void* out,
                                const int* p, void* stream) {
  const int m = p[0], k = p[1], n = p[2], tile = p[3], smem = p[4], ksplit = p[5];
  const int per = p[6], grid = p[7], f32 = p[8];
  const int groups = k / 2 / k4::kGroupRows;
  if (m <= 0 || k <= 0 || k % (2 * k4::kGroupRows) != 0 || n <= 0 || ksplit < 1 ||
      ksplit > k4::kMaxCluster || per <= 0 || (long)ksplit * per < groups ||
      (long)(ksplit - 1) * per >= groups || (f32 != 0 && f32 != 1) ||
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)s | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const k4::Args a{(const __nv_bfloat16*)x, (const int8_t*)w, (const float*)s,
                   f32 ? nullptr : (__nv_bfloat16*)out, f32 ? (float*)out : nullptr, m, k, n,
                   per};
  switch (tile) {
#define GP_K4_CASE(I, SL, WM, WN, TW) \
  case I:                             \
    return k4::launch<SL, WM, WN, TW>(a, smem, ksplit, grid, (cudaStream_t)stream);
    GP_K4_TILES(GP_K4_CASE)
#undef GP_K4_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K6: the prep pass, then the GEMM, on `stream`. p holds the ints of the
// host plan (ops/cuda/int4_matmul.py `plan_int4_a8`): m, k, n, g, the tile's
// index in GP_A8_TILES, its shared-memory bytes, the grid's M and N tiles,
// the prep's row blocks, K splits and tiles per split; then `given`. With
// given = 0 the prep computes x's row scales into xs and s8 from the
// weights' own groups, and out is bf16 [M, N]. With given = 1 (a row-parallel
// shard, whose row scales and s8 come from the whole contraction) the prep
// reads xs and s8, and out is the GEMM's int32 sums [M, N], not rescaled. A
// plan that disagrees with this file's own formulas is refused.
extern "C" int int4_a8_bf16(const void* x, const void* w, const void* s, void* xq, void* xs,
                            void* w8t, void* s8, void* out, const int* p, void* stream) {
  const int m = p[0], k = p[1], n = p[2], g = p[3], tile = p[4], smem = p[5];
  const int grid_m = p[6], grid_n = p[7], row_blocks = p[8], ksplit = p[9], per = p[10];
  const int given = p[11];
  const int tiles = k / 2 / k6::kPrepTile;
  if (m <= 0 || g <= 0 || g % k6::kPrepTile != 0 || k % (2 * g) != 0 ||
      n % k6::kPrepCols != 0 || row_blocks != (m + k6::kPrepRows - 1) / k6::kPrepRows ||
      ksplit <= 0 || per <= 0 || (long)ksplit * per < tiles || (long)(ksplit - 1) * per >= tiles ||
      (given != 0 && given != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  k6::PrepArgs pa{(const __nv_bfloat16*)x, (const int8_t*)w, (const float*)s, (int8_t*)xq,
                  (float*)xs, (int8_t*)w8t, (float*)s8, m, k, n, g, row_blocks,
                  n / k6::kPrepCols, per, given};
  k6::prep_kernel<<<row_blocks + pa.col_slices * ksplit, k6::kPrepThreads, 0, st>>>(pa);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const k6::GemmArgs ga{(const int8_t*)xq, (const float*)xs, (const int8_t*)w8t,
                        (const float*)s8, given ? nullptr : (__nv_bfloat16*)out,
                        given ? (int*)out : nullptr, m, k, n};
  switch (tile) {
#define GP_A8_CASE(I, BM, BN, WM, WN, BK, STAGES) \
  case I:                                         \
    return k6::launch_gemm<BM, BN, WM, WN, BK, STAGES>(ga, smem, grid_m, grid_n, st);
    GP_A8_TILES(GP_A8_CASE)
#undef GP_A8_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K5: the prep pass, then the GEMM, on `stream`. p holds the ints of the
// host plan (ops/cuda/int4_matmul.py `plan_int4_a16`): m, k, n, g, the
// tile's index in GP_A16_TILES, its shared-memory bytes, the grid's M and N
// tiles, the prep's K splits and tiles per split. A plan that disagrees
// with this file's own formulas, or a pointer off 16 bytes, is refused.
extern "C" int int4_a16_bf16(const void* x, const void* w, const void* s, void* w16t, void* out,
                             const int* p, void* stream) {
  const int m = p[0], k = p[1], n = p[2], g = p[3], tile = p[4], smem = p[5];
  const int grid_m = p[6], grid_n = p[7], ksplit = p[8], per = p[9];
  const int tiles = k / 2 / k5::kPrepTile;
  if (m <= 0 || k <= 0 || g <= 0 || g % k5::kPrepTile != 0 || k % (2 * g) != 0 || n <= 0 ||
      n % k5::kPrepCols != 0 || ksplit <= 0 || per <= 0 || (long)ksplit * per < tiles ||
      (long)(ksplit - 1) * per >= tiles ||
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)s | (uintptr_t)w16t | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const k5::PrepArgs pa{(const int8_t*)w, (const float*)s, (__nv_bfloat16*)w16t, k, n, g,
                        n / k5::kPrepCols, per};
  k5::prep_kernel<<<pa.col_slices * ksplit, k5::kPrepThreads, 0, st>>>(pa);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const k5::GemmArgs ga{(const __nv_bfloat16*)x, (const __nv_bfloat16*)w16t,
                        (__nv_bfloat16*)out, m, k, n};
  switch (tile) {
#define GP_A16_CASE(I, BM, BN, WM, WN, BK, STAGES) \
  case I:                                          \
    return k5::launch_gemm<BM, BN, WM, WN, BK, STAGES>(ga, smem, grid_m, grid_n, st);
    GP_A16_TILES(GP_A16_CASE)
#undef GP_A16_CASE
  }
  return (int)cudaErrorInvalidValue;
}
