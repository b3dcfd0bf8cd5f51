// Flash attention backward (bf16 in and out, fp32 accumulators): K3, and
// with `qpos` K9's backward.
//
// Replaces the Pallas backward `_flash_bwd_impl`
// (glimpseprune_tpu/ops/pallas/flash_attention.py:808, kernels `_bwd_dq_kernel`
// :697 and `_bwd_dkv_kernel` :739, shared tile `_bwd_tile` :665), and the
// `q_positions` adapters `_bwd_dq_qpos_adapter` (:787) and
// `_bwd_dkv_qpos_adapter` (:795) under the custom VJP
// `_flash_attention_qpos_diff` (:341-397).
//
// Semantics, as in the Pallas kernels: the probability tile is recomputed
// from q, k and the forward's log2-domain LSE (csrc/flash_attention.cu),
// p = exp2(s * log2(e) / sqrt(Dqk) - lse), with the forward's masks (segment
// ids, or none when dense; causal by slot, or by qpos[b, s] for K9, whose q
// rows are a shard of the sequence that k and v hold whole), and a row whose
// LSE is -1e30 (it saw no allowed key) has p = 0. With dsum = rowsum(dO * O)
// (the dq kernel's prologue computes it) and ds = p * (dO V^T - dsum):
//   dq = ds K / sqrt(Dqk),  dk = ds^T Q / sqrt(Dqk),  dv = p^T dO,
// dk and dv summed over the q heads of each GQA group (for K9: this shard's
// part, which the caller sums over the shards). Dqk and Dv are separate
// (the fuser's 192/64); q, k, v, dO, dq, dk, dv are strided [B, S, H, D]
// views.
//
// What bounds it on the H100: 2 * (3*Dqk + 2*Dv) FLOP per allowed (q, k)
// pair and q head against O(S * D) bytes, far above the card's ridge point:
// it is bound by tensor-core operations. The dq and dkv kernels both
// recompute Q K^T and dO V^T, so they do 7 products of a tile pair where
// the function needs 5 (1.4x the bound's operations at Dqk = Dv;
// chip_smoke.py's bound counts the function's 5). The design, on
// mma.sync.m16n8k16 bf16 products with fp32 sums (csrc/tensor_core.cuh):
// - `dq`: one block of four warps per (batch, q head, 64-row q tile); each
//   warp owns 16 q rows, keeps their Q and dO A fragments in registers
//   (where they fit beside the accumulators: not at 256/128), and walks the
//   k tiles: S = Q K^T and dP = dO V^T in registers, 32 keys at a time, P
//   and dS built there, and dS's C fragments repacked in place as the A
//   operand of dq += dS K, with K read through ldmatrix.trans (the
//   forward's P -> PV step). Its prologue also computes dsum = rowsum(dO O)
//   of its rows (16 lanes a row, a fixed butterfly) for itself and `dkv`.
// - `dkv`: one block of four warps per (batch, kv head, split, 64-key k
//   tile); each warp owns 16 key rows and computes the transposes,
//   S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T sit in registers as the A
//   operands of dv += P^T dO and dk += dS^T Q (dO, Q through
//   ldmatrix.trans): neither goes through shared memory.
// - The streamed tiles (K, V and key segments in `dq`; Q, dO and the q
//   rows' LSE, dsum, segments and positions in `dkv`) arrive by cp.async in
//   a ring of two stages, one barrier per tile: the next tile's copy
//   overlaps this tile's products. A row that is not 16-byte aligned (the
//   tiny config's Dv = 4) is copied element by element.
// - Before its walk a block lists the tiles it visits (one warp per tile
//   reads its segment and position range): up to the causal limit (the q
//   tile's largest position; in `dkv` a q tile whose largest position
//   reaches the k tile), less those whose segment range misses its own,
//   each marked "full" when every pair in it is allowed (no mask
//   arithmetic then). A listed tile with no allowed key for a row adds
//   exact zeros (p = 0, so ds = 0). A pre-pass kernel that wrote every
//   tile's range once did not pay for its launch and was not kept.
// - Grid balance: the heaviest blocks go first (the grid's slowest index
//   is the q tile, last first, in `dq`, and the k tile, first first, in
//   `dkv`: under causal masking they walk the most tiles). At the LLM's
//   causal shape `dkv` has 104 (batch, kv head, k tile) blocks for 132
//   SMs, and the one holding k tile 0 walks 7 q heads x 13 q tiles; so each
//   block's list of (q head, q tile) items is cut into `splits` contiguous
//   chunks, one block each; with splits > 1 they write fp32 partial dk, dv
//   to a workspace [B, Hkv, splits, Skv, DQK + DV] (allocated by the
//   caller: 41 MB at that shape with 6 splits), and a third kernel sums
//   the chunks in split order and writes bf16 (the wrapper's `bwd_splits`
//   picks the count from the shape; without causal masking the blocks are
//   balanced and never split). No
//   atomics anywhere: the same inputs give bit-identical dq, dk, dv from
//   run to run.
// - K9's dq equals the monolithic K3's rows bit for bit: a row's arithmetic
//   does not depend on the other rows of its tile, the k tile is 64 keys
//   whatever Sq, every row visits its k tiles in ascending order, a tile
//   that one tiling lists and another skips adds exact zeros, and a full
//   tile computes p as a masked one does for its allowed pairs.
// - Head dims are padded in shared memory to a built pair (DQK, DV), the
//   forward's (ops/cuda/flash_attention.py FWD_DIMS), so training never
//   reaches a forward that the backward refuses; pad columns are zero and
//   never stored; rows carry 16 bytes of padding, so ldmatrix's eight rows
//   fall in distinct banks.
// Registers (ptxas -v, sm_90a): dq 242 and dkv 246 at 128/128, no spill,
// so two blocks of each fit on an SM (107 KB of shared memory each); at
// 192/64 both use 255, dq with 8 bytes of spill; 256/128, which no config
// uses, spills 204 bytes in dkv.
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace gp_tc;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
// keys of a k tile and rows of a q tile: fixed, so K9's walk never depends on Sq
constexpr int kBK = 64;
constexpr int kStages = 2;  // ring of streamed tiles
constexpr int kWarps = 4;   // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 32;    // score columns a warp holds in registers at a time

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const bf16* out;    // the forward's output
  const float* lse;   // [B, Hq, Sq]
  float* dsum;        // [B, Hq, Sq] rowsum(dO * O): written by the dq kernel, read by dkv
  const int* qseg;    // [B, Sq] or null when dense
  const int* kseg;    // [B, Skv] or null when dense
  const int* qpos;    // [B, Sq] global q slots (K9) or null: q row s is slot s
  bf16* dq_out;
  bf16* dk_out;
  bf16* dv_out;
  float* ws;  // [B, Hkv, splits, Skv, DQK + DV] partial dk, dv (splits > 1)
  int heads_q, heads_kv, group, sq, skv, dqk, dv, splits;
  long q_sb, q_sh, q_ss;  // element strides of batch, head, sequence
  long k_sb, k_sh, k_ss;
  long v_sb, v_sh, v_ss;
  long do_sb, do_sh, do_ss;
  long o_sb, o_sh, o_ss;
  long dq_sb, dq_sh, dq_ss;
  long dk_sb, dk_sh, dk_ss;
  long dv_sb, dv_sh, dv_ss;
  float scale;       // 1 / sqrt(dqk)
  float scale_log2;  // log2(e) / sqrt(dqk)
  int causal;
  // rows that may move as 16-byte chunks: bit 0 q, 1 k, 2 v, 3 dO, 6 O; even
  // widths (4-byte pair stores): bit 4 dq and dk, 5 dv
  int vec;
};

// Shared-memory bytes of a block of either kernel, less its tile list (one
// int per listed tile): three tiles of each width in bf16 with 8 elements of
// row padding, nine 64-entry int/float row vectors and 8 slots.
// ops/cuda/flash_attention.py's `plan_flash_bwd` computes the same number
// and the launcher checks they agree.
__host__ __device__ constexpr int smem_fixed(int dqk, int dv) {
  return 2 * 3 * kBK * (dqk + 8 + dv + 8) + 4 * (9 * kBK + 8);
}

struct TileRange {
  int lo, hi;      // smallest and largest segment id >= 0 (INT_MAX, -1 without one)
  int pmin, pmax;  // smallest and largest position (INT_MAX, -1 without a row)
  bool one;        // every row exists and has the one segment id lo == hi >= 0
};

// Over rows r0 .. r0 + kBK - 1 (< n) of one batch row, reduced over the
// warp; seg null: dense, every row's id is 0; pos null: a row's position is
// its index.
__device__ __forceinline__ TileRange tile_range(const int* seg, const int* pos, int r0, int n,
                                                int lane) {
  int l = 0x7fffffff, h = -1, pmn = 0x7fffffff, pmx = -1;
  bool all = r0 + kBK <= n;
  for (int r = r0 + lane; r < min(r0 + kBK, n); r += 32) {
    const int s = seg == nullptr ? 0 : seg[r];
    if (s >= 0) {
      l = min(l, s);
      h = max(h, s);
    } else {
      all = false;
    }
    const int p = pos == nullptr ? r : pos[r];
    pmn = min(pmn, p);
    pmx = max(pmx, p);
  }
  TileRange t;
  t.lo = __reduce_min_sync(0xffffffffu, l);
  t.hi = __reduce_max_sync(0xffffffffu, h);
  t.pmin = __reduce_min_sync(0xffffffffu, pmn);
  t.pmax = __reduce_max_sync(0xffffffffu, pmx);
  t.one = __all_sync(0xffffffffu, all) && t.lo == t.hi;
  return t;
}

// One warp: the tiles first + j (j < n) whose flag list[first + j] is 1
// (visit) or 2 (visit, every pair allowed: no mask arithmetic), in
// ascending order, at the front of `list` as tile * 2 + full (in place: an
// entry is written below every entry not yet read); -> their count.
__device__ __forceinline__ int compact(int* list, int first, int n, int lane) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const int flag = j < n ? list[first + j] : 0;
    const unsigned m = __ballot_sync(0xffffffffu, flag != 0);
    if (flag != 0) list[count + __popc(m & ((1u << lane) - 1u))] = (first + j) * 2 + (flag >> 1);
    count += __popc(m);
    __syncwarp();
  }
  return count;
}

// Two adjacent bf16 outputs of `left` columns still inside the row: one
// 4-byte store where `pair` says the row allows it
__device__ __forceinline__ void store2(bf16* dst, float x0, float x1, int left, bool pair) {
  if (pair && left >= 2) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
  } else {
    if (left >= 1) dst[0] = __float2bfloat16(x0);
    if (left >= 2) dst[1] = __float2bfloat16(x1);
  }
}

// c[NT][4] = A (16 rows at `arow` of a [.][LD] tile) times B^T (8 * NT
// rows at `brow`), over the DP / 16 k-steps of the head dim
template <int DP, int LD, int NT>
__device__ __forceinline__ void scores(float (&c)[NT][4], const bf16* arow,
                                       const bf16* brow, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, arow + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, brow + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_16816(c[2 * np], af, bf[0], bf[1]);
      mma_16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// scores() with A's fragments already in registers
template <int DP, int LD, int NT>
__device__ __forceinline__ void scores_frag(float (&c)[NT][4],
                                            const uint32_t (&af)[DP / 16][4], const bf16* brow,
                                            int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, brow + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_16816(c[2 * np], af[kk], bf[0], bf[1]);
      mma_16816(c[2 * np + 1], af[kk], bf[2], bf[3]);
    }
}

// A's fragments (16 rows at `arow` of a [.][LD] tile) into registers
template <int DP, int LD>
__device__ __forceinline__ void load_frags(uint32_t (&af)[DP / 16][4], const bf16* arow,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(af[kk], arow + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// acc[DP/8][4] += X (16 x 8 * NT, the C fragments x repacked as bf16 A
// fragments) times the 8 * NT rows at `brow` of a [.][LD] tile (ldmatrix.trans)
template <int DP, int LD, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4], const float (&x)[NT][4],
                                           const bf16* brow, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, brow + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                            (lane >> 4) * 8);
      mma_16816(acc[2 * np], xa, bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], xa, bf[2], bf[3]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int LDQ = DQK + 8, LDV = DV + 8;
  // Q's and dO's A fragments stay in registers where they fit beside the
  // accumulators (not at 256/128)
  constexpr bool kAreg = DQK + DV <= 256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                    // [kStages][kBK][LDQ]
  bf16* vs = ks + kStages * kBK * LDQ;                              // [kStages][kBK][LDV]
  bf16* qs = vs + kStages * kBK * LDV;                              // [kBK][LDQ]
  bf16* dos = qs + kBK * LDQ;                                       // [kBK][LDV]
  int* kseg_s = reinterpret_cast<int*>(dos + kBK * LDV);           // [kStages][kBK]
  int* qseg_s = kseg_s + kStages * kBK;                             // [kBK]
  int* qpos_s = qseg_s + kBK;                                       // [kBK]
  float* lse_s = reinterpret_cast<float*>(qpos_s + kBK);            // [kBK]
  float* dsum_s = lse_s + kBK;                                      // [kBK]
  // [8]: q seg min, max, pos max, tile count, pos min, one segment
  int* red = reinterpret_cast<int*>(dsum_s + kBK);
  int* list = red + 8;  // [k tiles] (smem_fixed reserves the dkv kernel's larger rows)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wrow = warp * 16;
  // the last q tiles first: under causal masking they walk the most k tiles
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBK, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / a.group;
  const bool dense = a.qseg == nullptr;
  const int sq = a.sq, skv = a.skv;
  const long row0 = ((long)b * a.heads_q + h) * sq;
  const bf16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
  const bf16* vg = a.v + b * a.v_sb + kvh * a.v_sh;
  const int* qsegg = dense ? nullptr : a.qseg + (long)b * sq;
  const int* ksegg = dense ? nullptr : a.kseg + (long)b * skv;
  const int* qposg = a.qpos == nullptr ? nullptr : a.qpos + (long)b * sq;

  if (a.dqk < DQK) {
    zero_pad<DQK, LDQ>(qs, kBK, a.dqk, tid, kThreads);
    zero_pad<DQK, LDQ>(ks, kStages * kBK, a.dqk, tid, kThreads);
  }
  if (a.dv < DV) {
    zero_pad<DV, LDV>(dos, kBK, a.dv, tid, kThreads);
    zero_pad<DV, LDV>(vs, kStages * kBK, a.dv, tid, kThreads);
  }
  load_rows<DQK, LDQ>(qs, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, sq, kBK, a.dqk, a.vec & 1,
                      tid, kThreads);
  load_rows<DV, LDV>(dos, a.dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, sq, kBK, a.dv,
                     a.vec & 8, tid, kThreads);
  if (tid < kBK) {  // a row past Sq allows no key
    const int s = q0 + tid;
    const bool in = s < sq;
    qseg_s[tid] = in ? (dense ? 0 : qsegg[s]) : -1;
    qpos_s[tid] = in ? (qposg != nullptr ? qposg[s] : s) : -1;
    lse_s[tid] = in ? a.lse[row0 + s] : kNegInf;
  }
  // dsum = rowsum(dO * O) of the tile's rows, for this kernel and the dkv
  // kernel: 16 lanes a row, 8 columns each, summed by a fixed butterfly
  for (int r0 = warp * 2; r0 < kBK; r0 += 2 * kWarps) {
    const int r = r0 + (lane >> 4), c = (lane & 15) * 8, s = q0 + r;
    float x = 0.f;
    if (s < sq && c < a.dv) {
      const bf16* dor = a.dout + b * a.do_sb + h * a.do_sh + s * a.do_ss + c;
      const bf16* orow = a.out + b * a.o_sb + h * a.o_sh + s * a.o_ss + c;
      if ((a.vec & 8) && (a.vec & 64) && c + 8 <= a.dv) {
        const uint4 du = *reinterpret_cast<const uint4*>(dor);
        const uint4 ou = *reinterpret_cast<const uint4*>(orow);
        const bf16* d8 = reinterpret_cast<const bf16*>(&du);
        const bf16* o8 = reinterpret_cast<const bf16*>(&ou);
#pragma unroll
        for (int e = 0; e < 8; ++e) x += __bfloat162float(d8[e]) * __bfloat162float(o8[e]);
      } else {
        for (int e = 0; e < 8 && c + e < a.dv; ++e)
          x += __bfloat162float(dor[e]) * __bfloat162float(orow[e]);
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if ((lane & 15) == 0) {
      dsum_s[r] = s < sq ? x : 0.f;
      if (s < sq) a.dsum[row0 + s] = x;
    }
  }
  if (warp == 0) {
    const TileRange qr = tile_range(qsegg, qposg, q0, sq, lane);
    if (lane == 0) {
      red[0] = qr.lo;
      red[1] = qr.hi;
      red[2] = qr.pmax;
      red[4] = qr.pmin;
      red[5] = qr.one;
    }
  }
  __syncthreads();
  {  // the k tiles this q tile visits, in order, each marked full or not
    const int qlo = red[0], qhi = red[1], pmax = red[2], pmin = red[4];
    const bool qone = red[5] != 0;
    int n_kt = qhi < 0 ? 0 : (skv + kBK - 1) / kBK;  // every row padding: dq = 0
    if (a.causal) n_kt = min(n_kt, pmax < 0 ? 0 : pmax / kBK + 1);
    for (int t = warp; t < n_kt; t += kWarps) {
      const TileRange kr = tile_range(ksegg, nullptr, t * kBK, skv, lane);
      const bool hit = kr.hi >= qlo && kr.lo <= qhi;
      const bool full = qone && kr.one && kr.lo == qlo && (!a.causal || t * kBK + kBK - 1 <= pmin);
      if (lane == 0) list[t] = hit ? 1 + full : 0;
    }
    __syncthreads();
    if (warp == 0) {
      const int count = compact(list, 0, n_kt, lane);
      if (lane == 0) red[3] = count;
    }
    __syncthreads();
  }
  const int n_tiles = red[3];

  int rseg[2], rpos[2];
  float rlse[2], rdsum[2];
  bool rok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wrow + g + 8 * hh;
    rseg[hh] = qseg_s[r];
    rpos[hh] = qpos_s[r];
    rlse[hh] = lse_s[r];
    rdsum[hh] = dsum_s[r];
    rok[hh] = rseg[hh] >= 0 && rlse[hh] > kNegInf * 0.5f;
  }
  float acc[DQK / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // K, V (and key segment) tile of list entry i into stage i % kStages
  auto load_tile = [&](int i) {
    const int k0 = (list[i] >> 1) * kBK, st = i % kStages;
    load_rows<DQK, LDQ>(ks + st * kBK * LDQ, kg, a.k_ss, k0, skv, kBK, a.dqk, a.vec & 2, tid,
                        kThreads);
    load_rows<DV, LDV>(vs + st * kBK * LDV, vg, a.v_ss, k0, skv, kBK, a.dv, a.vec & 4, tid,
                       kThreads);
    if (!dense && tid < kBK) {
      const int t = k0 + tid;
      cp_async4(kseg_s + st * kBK + tid, ksegg + (t < skv ? t : 0), t < skv ? 4 : 0);
    }
  };
  // the first kStages - 1 tiles in flight (with Q and dO in the first
  // group); each iteration waits for its tile and, after the barrier (every
  // warp is done with the previous tile's stage), refills that stage
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  uint32_t qf[kAreg ? DQK / 16 : 1][4], dof[kAreg ? DV / 16 : 1][4];  // A fragments
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if constexpr (kAreg) {
      if (i == 0) {
        load_frags<DQK, LDQ>(qf, qs + wrow * LDQ, lane);
        load_frags<DV, LDV>(dof, dos + wrow * LDV, lane);
      }
    }
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const int k0 = (list[i] >> 1) * kBK, st = i % kStages;
    const bool full = (list[i] & 1) != 0;
    const bf16* kst = ks + st * kBK * LDQ;
    const bf16* vst = vs + st * kBK * LDV;
    const int* kss = kseg_s + st * kBK;
#pragma unroll
    for (int j0 = 0; j0 < kBK; j0 += kSub) {
      float s[kSub / 8][4], dp[kSub / 8][4];
      if constexpr (kAreg) {
        scores_frag<DQK, LDQ>(s, qf, kst + j0 * LDQ, lane);
        scores_frag<DV, LDV>(dp, dof, vst + j0 * LDV, lane);
      } else {
        scores<DQK, LDQ>(s, qs + wrow * LDQ, kst + j0 * LDQ, lane);
        scores<DV, LDV>(dp, dos + wrow * LDV, vst + j0 * LDV, lane);
      }
      // P and dS in registers: ds = p (dp - dsum), p = 0 where masked
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + n * 8 + 2 * t4 + (e & 1), hh = e >> 1;
          const int t = k0 + j;
          bool ok = full;
          if (!full) {
            ok = rok[hh] && t < skv;
            if (!dense) ok = ok && kss[j] == rseg[hh];
            if (a.causal) ok = ok && t <= rpos[hh];
          }
          const float p = ok ? fast_exp2(fmaf(s[n][e], a.scale_log2, -rlse[hh])) : 0.f;
          s[n][e] = p * (dp[n][e] - rdsum[hh]);
        }
      accumulate<DQK, LDQ>(acc, s, kst + j0 * LDQ, lane);  // dq += dS K
    }
  }
  cp_async_wait<0>();

  bf16* dqg = a.dq_out + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = q0 + wrow + g + 8 * hh;
    if (s >= sq) continue;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (c < a.dqk)
        store2(dqg + s * a.dq_ss + c, acc[n][2 * hh] * a.scale, acc[n][2 * hh + 1] * a.scale,
               a.dqk - c, a.vec & 16);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args a) {
  constexpr int LDQ = DQK + 8, LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                        // [kBK][LDQ]
  bf16* qs = ks + kBK * LDQ;                                            // [kStages][kBK][LDQ]
  bf16* vs = qs + kStages * kBK * LDQ;                                  // [kBK][LDV]
  bf16* dos = vs + kBK * LDV;                                           // [kStages][kBK][LDV]
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kBK * LDV);  // [kStages][kBK]
  float* dsum_s = lse_s + kStages * kBK;                                // [kStages][kBK]
  int* qseg_s = reinterpret_cast<int*>(dsum_s + kStages * kBK);        // [kStages][kBK]
  int* qpos_s = qseg_s + kStages * kBK;                                 // [kStages][kBK]
  int* kseg_s = qpos_s + kStages * kBK;                                 // [kBK]
  int* red = kseg_s + kBK;  // [8]: key seg min, max, item count, one segment
  int* list = red + 8;      // [q tiles]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wrow = warp * 16;
  // the first k tiles first: under causal masking they walk the most q tiles
  const int k0 = blockIdx.z * kBK, b = blockIdx.y;
  const int kvh = blockIdx.x / a.splits, split = blockIdx.x - kvh * a.splits;
  const bool dense = a.qseg == nullptr;
  const int sq = a.sq, skv = a.skv;
  const int* qsegg = dense ? nullptr : a.qseg + (long)b * sq;
  const int* ksegg = dense ? nullptr : a.kseg + (long)b * skv;
  const int* qposg = a.qpos == nullptr ? nullptr : a.qpos + (long)b * sq;

  if (a.dqk < DQK) {
    zero_pad<DQK, LDQ>(ks, kBK, a.dqk, tid, kThreads);
    zero_pad<DQK, LDQ>(qs, kStages * kBK, a.dqk, tid, kThreads);
  }
  if (a.dv < DV) {
    zero_pad<DV, LDV>(vs, kBK, a.dv, tid, kThreads);
    zero_pad<DV, LDV>(dos, kStages * kBK, a.dv, tid, kThreads);
  }
  load_rows<DQK, LDQ>(ks, a.k + b * a.k_sb + kvh * a.k_sh, a.k_ss, k0, skv, kBK, a.dqk,
                      a.vec & 2, tid, kThreads);
  load_rows<DV, LDV>(vs, a.v + b * a.v_sb + kvh * a.v_sh, a.v_ss, k0, skv, kBK, a.dv, a.vec & 4,
                     tid, kThreads);
  if (tid < kBK) {  // -2 past the k end: no query sees such a key
    const int t = k0 + tid;
    kseg_s[tid] = t < skv ? (dense ? 0 : ksegg[t]) : -2;
  }
  if (warp == 0) {
    const TileRange kr = tile_range(ksegg, nullptr, k0, skv, lane);
    if (lane == 0) {
      red[0] = kr.lo;
      red[1] = kr.hi;
      red[3] = kr.one;
    }
  }
  __syncthreads();
  {  // the q tiles that reach this k tile, in order, each marked full or not
    const int klo = red[0], khi = red[1];
    const bool kone = red[3] != 0;
    const int n_qt = khi < 0 ? 0 : (sq + kBK - 1) / kBK;  // all-padding keys: dk = dv = 0
    // with q rows at their slots, q tiles wholly above the diagonal are not scanned
    const int qt0 = a.causal && a.qpos == nullptr ? min(k0 / kBK, n_qt) : 0;
    for (int t = qt0 + warp; t < n_qt; t += kWarps) {
      const TileRange qr = tile_range(qsegg, qposg, t * kBK, sq, lane);
      const bool hit = qr.hi >= 0 && qr.hi >= klo && qr.lo <= khi && (!a.causal || qr.pmax >= k0);
      const bool full = kone && qr.one && qr.lo == klo && (!a.causal || qr.pmin >= k0 + kBK - 1);
      if (lane == 0) list[t] = hit ? 1 + full : 0;
    }
    __syncthreads();
    if (warp == 0) {
      const int count = compact(list, qt0, n_qt - qt0, lane);
      if (lane == 0) red[2] = count;
    }
    __syncthreads();
  }
  // this block's chunk of the (q head of the group, listed q tile) items
  const int n_list = red[2];
  const int n_items = a.group * n_list;
  const int it0 = (int)((long)n_items * split / a.splits);
  const int n_it = (int)((long)n_items * (split + 1) / a.splits) - it0;

  int kseg_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) kseg_r[hh] = kseg_s[wrow + g + 8 * hh];  // < 0: no query sees it
  float acc_k[DQK / 8][4], acc_v[DV / 8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n) acc_k[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) acc_v[n][e] = 0.f;
  }

  // Q, dO and the q rows' LSE, dsum, segments, positions of item i into
  // stage i % kStages (rows past Sq read as zeros and are masked by index)
  auto load_item = [&](int i) {
    const int item = it0 + i, gi = item / n_list;
    const int h = kvh * a.group + gi, q0 = (list[item - gi * n_list] >> 1) * kBK;
    const int st = i % kStages;
    load_rows<DQK, LDQ>(qs + st * kBK * LDQ, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, sq, kBK,
                        a.dqk, a.vec & 1, tid, kThreads);
    load_rows<DV, LDV>(dos + st * kBK * LDV, a.dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, sq,
                       kBK, a.dv, a.vec & 8, tid, kThreads);
    const int r = tid & (kBK - 1), s = q0 + r;
    const int n = s < sq ? 4 : 0, sr = s < sq ? s : 0;
    if (tid < kBK) {
      const long row = ((long)b * a.heads_q + h) * sq + sr;
      cp_async4(lse_s + st * kBK + r, a.lse + row, n);
      cp_async4(dsum_s + st * kBK + r, a.dsum + row, n);
    } else {
      if (!dense) cp_async4(qseg_s + st * kBK + r, qsegg + sr, n);
      if (qposg != nullptr) cp_async4(qpos_s + st * kBK + r, qposg + sr, n);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_it) load_item(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n_it) load_item(i + kStages - 1);
    cp_async_commit();
    const int item = it0 + i, gi = item / n_list;
    const int entry = list[item - gi * n_list], q0 = (entry >> 1) * kBK, st = i % kStages;
    const bool full = (entry & 1) != 0;
    const bf16* qst = qs + st * kBK * LDQ;
    const bf16* dost = dos + st * kBK * LDV;
    const float* lss = lse_s + st * kBK;
    const float* dss = dsum_s + st * kBK;
    const int* qss = qseg_s + st * kBK;
    const int* qps = qpos_s + st * kBK;
#pragma unroll
    for (int i0 = 0; i0 < kBK; i0 += kSub) {
      float p[kSub / 8][4], ds[kSub / 8][4];
      scores<DQK, LDQ>(p, ks + wrow * LDQ, qst + i0 * LDQ, lane);    // S^T = K Q^T
      scores<DV, LDV>(ds, vs + wrow * LDV, dost + i0 * LDV, lane);   // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i0 + n * 8 + 2 * t4 + (e & 1), hh = e >> 1;
          const int s = q0 + c;
          const float lse = lss[c];
          bool ok = full;
          if (!full) {
            ok = kseg_r[hh] >= 0 && s < sq && lse > kNegInf * 0.5f;
            if (!dense) ok = ok && qss[c] == kseg_r[hh];
            if (a.causal) ok = ok && k0 + wrow + g + 8 * hh <= (qposg != nullptr ? qps[c] : s);
          }
          const float pv = ok ? fast_exp2(fmaf(p[n][e], a.scale_log2, -lse)) : 0.f;
          ds[n][e] = pv * (ds[n][e] - dss[c]);
          p[n][e] = pv;
        }
      accumulate<DV, LDV>(acc_v, p, dost + i0 * LDV, lane);   // dv += P^T dO
      accumulate<DQK, LDQ>(acc_k, ds, qst + i0 * LDQ, lane);  // dk += dS^T Q
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + wrow + g + 8 * hh;
    if (t >= skv) continue;
    if (a.splits == 1) {
      bf16* dkr = a.dk_out + b * a.dk_sb + kvh * a.dk_sh + t * a.dk_ss;
      bf16* dvr = a.dv_out + b * a.dv_sb + kvh * a.dv_sh + t * a.dv_ss;
#pragma unroll
      for (int n = 0; n < DQK / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c < a.dqk)
          store2(dkr + c, acc_k[n][2 * hh] * a.scale, acc_k[n][2 * hh + 1] * a.scale, a.dqk - c,
                 a.vec & 16);
      }
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c < a.dv) store2(dvr + c, acc_v[n][2 * hh], acc_v[n][2 * hh + 1], a.dv - c, a.vec & 32);
      }
    } else {  // this chunk's fp32 part, summed by flash_bwd_dkv_sum_kernel
      float* w = a.ws + ((((long)b * a.heads_kv + kvh) * a.splits + split) * skv + t) * (DQK + DV);
#pragma unroll
      for (int n = 0; n < DQK / 8; ++n)
        *reinterpret_cast<float2*>(w + n * 8 + 2 * t4) =
            make_float2(acc_k[n][2 * hh], acc_k[n][2 * hh + 1]);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<float2*>(w + DQK + n * 8 + 2 * t4) =
            make_float2(acc_v[n][2 * hh], acc_v[n][2 * hh + 1]);
    }
  }
}

// dk, dv = the sum over the splits of the workspace's parts, in split order
// (one thread per 4 columns of a key row, 16-byte loads)
template <int DQK, int DV>
__global__ void flash_bwd_dkv_sum_kernel(const Args a) {
  constexpr int kLd = DQK + DV, kChunks = kLd / 4;
  const int b = blockIdx.y;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)a.heads_kv * a.skv * kChunks) return;
  const int c = (int)(i % kChunks) * 4;
  const long r = i / kChunks;
  const int t = (int)(r % a.skv), kvh = (int)(r / a.skv);
  const bool is_k = c < DQK;
  const int col = is_k ? c : c - DQK, width = is_k ? a.dqk : a.dv;
  if (col >= width) return;  // pad columns
  const float* w = a.ws + (((long)b * a.heads_kv + kvh) * a.splits * a.skv + t) * kLd + c;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < a.splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(w + (long)s * a.skv * kLd);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const float f = is_k ? a.scale : 1.f;
  bf16* dst = is_k ? a.dk_out + b * a.dk_sb + kvh * a.dk_sh + t * a.dk_ss + col
                   : a.dv_out + b * a.dv_sb + kvh * a.dv_sh + t * a.dv_ss + col;
  const bool pair = a.vec & (is_k ? 16 : 32);
  store2(dst, sum.x * f, sum.y * f, width - col, pair);
  if (width - col > 2) store2(dst + 2, sum.z * f, sum.w * f, width - col - 2, pair);
}

template <int DQK, int DV>
int launch(const Args& a, int batch, int smem_dq, int smem_dkv, void* stream) {
  if (smem_dq != smem_fixed(DQK, DV) + 4 * ((a.skv + kBK - 1) / kBK) ||
      smem_dkv != smem_fixed(DQK, DV) + 4 * ((a.sq + kBK - 1) / kBK))
    return (int)cudaErrorInvalidValue;  // the wrapper's plan and this build disagree
  int err = raise_smem_cap<flash_bwd_dq_kernel<DQK, DV>>(smem_dq);
  if (err == 0) err = raise_smem_cap<flash_bwd_dkv_kernel<DQK, DV>>(smem_dkv);
  if (err != 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid_dq(a.heads_q, batch, (a.sq + kBK - 1) / kBK);
  flash_bwd_dq_kernel<DQK, DV><<<grid_dq, kThreads, smem_dq, st>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid_dkv(a.heads_kv * a.splits, batch, (a.skv + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<DQK, DV><<<grid_dkv, kThreads, smem_dkv, st>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0 || a.splits == 1) return err;
  const long per_batch = (long)a.heads_kv * a.skv * ((DQK + DV) / 4);
  const dim3 grid_sum((unsigned)((per_batch + 255) / 256), batch);
  flash_bwd_dkv_sum_kernel<DQK, DV><<<grid_sum, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The padded head-dim pairs the kernels are built for: the forward's
// (ops/cuda/flash_attention.py BWD_DIMS lists the same).
int dispatch(const Args& a, int batch, int dqk_pad, int dv_pad, int smem_dq, int smem_dkv,
             void* stream) {
#define GP_BWD_CASE(DQK, DV) \
  if (dqk_pad == DQK && dv_pad == DV) return launch<DQK, DV>(a, batch, smem_dq, smem_dkv, stream);
  GP_BWD_CASE(16, 16)
  GP_BWD_CASE(64, 64)
  GP_BWD_CASE(80, 80)
  GP_BWD_CASE(128, 128)
  GP_BWD_CASE(192, 64)
  GP_BWD_CASE(256, 128)
#undef GP_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 and K9's backward: q, k, v, dout bf16 [B, H, S, D] with the given
// element strides; out bf16 (the forward's output, strided likewise); lse
// f32 [B, Hq, Sq]; dsum f32 [B, Hq, Sq], written here; dq, dk, dv bf16
// strided outputs; ws f32 [B, Hkv, splits, Skv, dqk_pad + dv_pad] or null when
// splits == 1. The ints come as one array p: batch, heads_q, heads_kv, sq,
// skv, dqk, dv, the padded dqk and dv, the dq and dkv kernels'
// shared-memory bytes and the dkv splits of the wrapper's plan, the batch,
// head and sequence strides of q, k, v, dout, out, dq, dk and dv, causal, and
// vec (which rows may move as 16-byte chunks or 4-byte pairs).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* out, const void* lse,
                                        void* dsum,
                                        const void* qseg, const void* kseg, const void* qpos,
                                        void* dq, void* dk, void* dv, void* ws, const int* p,
                                        void* stream) {
  const int batch = p[0], heads_q = p[1], heads_kv = p[2], sq = p[3], skv = p[4];
  const int dqk = p[5], dvd = p[6], dqk_pad = p[7], dv_pad = p[8];
  const int smem_dq = p[9], smem_dkv = p[10], splits = p[11];
  const int* st = p + 12;
  const int causal = p[36], vec = p[37];
  if (heads_kv <= 0 || heads_q % heads_kv != 0 || dvd <= 0 || dvd > dv_pad || dqk <= 0 ||
      dqk > dqk_pad || (qseg == nullptr) != (kseg == nullptr) || (qpos != nullptr && !causal) ||
      (qpos == nullptr && causal && sq != skv) || splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.out = (const bf16*)out;
  a.dsum = (float*)dsum;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.qpos = (const int*)qpos;
  a.dq_out = (bf16*)dq;
  a.dk_out = (bf16*)dk;
  a.dv_out = (bf16*)dv;
  a.ws = (float*)ws;
  a.heads_q = heads_q;
  a.heads_kv = heads_kv;
  a.group = heads_q / heads_kv;
  a.sq = sq;
  a.skv = skv;
  a.dqk = dqk;
  a.dv = dvd;
  a.splits = splits;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.do_sb = st[9]; a.do_sh = st[10]; a.do_ss = st[11];
  a.o_sb = st[12]; a.o_sh = st[13]; a.o_ss = st[14];
  a.dq_sb = st[15]; a.dq_sh = st[16]; a.dq_ss = st[17];
  a.dk_sb = st[18]; a.dk_sh = st[19]; a.dk_ss = st[20];
  a.dv_sb = st[21]; a.dv_sh = st[22]; a.dv_ss = st[23];
  a.scale = 1.f / sqrtf((float)dqk);
  a.scale_log2 = 1.4426950408889634f * a.scale;
  a.causal = causal;
  a.vec = vec;
  return dispatch(a, batch, dqk_pad, dv_pad, smem_dq, smem_dkv, stream);
}
