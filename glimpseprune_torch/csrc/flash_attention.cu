// Flash attention forward (bf16 in and out, fp32 softmax and accumulators).
//
// K2 replaces the forward of the Pallas kernel `flash_attention`
// (glimpseprune_tpu/ops/pallas/flash_attention.py:400 -> `_flash_attention_impl`
// :490, bodies `_kernel` :32 and `_dense_kernel_adapter` :639), and with a
// non-null `lse` its training flavour K2-lse (`_lse_kernel_adapter` :208,
// `_dense_lse_kernel_adapter` :224): the per-row log-sum-exp [B, Hq, Sq] f32
// in the log2 domain, m2 + log2(l) with scores pre-scaled by log2(e) (as the
// Pallas kernel's :54, :170), or -1e30 for a row with no allowed key. The
// backward (csrc/flash_attention_bwd.cu) reads it in the same convention.
//
// Semantics, as in the Pallas kernel: q head h reads kv head h / group
// (GQA). Unless `dense`, key t is allowed for query s iff
// kseg[t] == qseg[s] and qseg[s] >= 0; `causal` also requires t <= s (slot
// indices). A row with no allowed key writes 0. The qk head dim and the v
// head dim may differ (the fuser runs 192/64).
//
// K9, the `q_positions` flavour (`qpos`, [B, Sq] int32 or null), replaces
// the Pallas adapters `_qpos_kernel_adapter` (:183), `_i8_qpos_kernel_adapter`
// (:191) and `_qpos_lse_kernel_adapter` (:216): the q rows are a shard of a
// longer sequence (sequence parallelism), k and v are the whole sequence in
// slot order, and causal allows key t for query s iff t <= qpos[b, s]. The
// causal tile limit comes from the largest position in the q tile (JAX
// :71-72).
//
// What bounds K2 on the H100: at the main-path shapes (ViT full attention
// over a few thousand patches at D=80, the LLM's causal prefill at D=128, the
// fuser at 192/64) the products dominate, 4*S^2*D FLOP per head against
// O(S*D) bytes, far above the card's ridge point: the kernel is bound by
// tensor-core operations and, at D=80, by the exponentials of the softmax.
// The design is FlashAttention-2's schedule on mma.sync tensor-core tiles:
// - one block per (batch, q head, q tile); each warp owns 16 q rows for the
//   whole walk, so a row's softmax state never leaves its warp. Six warps
//   (96 rows) at head dims up to 80, four (64 rows) above, where the q tile
//   shares shared memory with the second k stage until its fragments sit in
//   registers, so that three D=128 blocks fit on an SM;
// - QK^T and PV run as mma.sync.m16n8k16 bf16 products with fp32 sums, the
//   Pallas kernel's numerics (p is cast to v's dtype before PV, :158); K and
//   V come from shared memory through ldmatrix (V through its transposing
//   form), Q's fragments stay in registers, and P goes straight from the
//   score accumulators into the A fragment, so scores never leave
//   registers; row max and row sum come from quad shuffles, and the
//   exponentials of each 16 keys overlap the PV products of the previous 16;
// - K and V tiles of 64 keys arrive by 16-byte cp.async into a ring of two
//   stages, one barrier per tile: the next tile's copy overlaps this tile's
//   products. The inputs are read as the strided [B,S,H,D] buffers they are;
//   a row that is not 16-byte aligned (the tiny config's Dv=4) is copied
//   element by element;
// - head dims are padded in shared memory to a supported pair (DQK, DV):
//   the tiny config's 16, the configs' 64, 80, 128 and 192/64, and 256/128
//   for any other head dims up to the old 256/128 limits; multiples of 16
//   (the contraction depth of the QK^T product and two n-tiles of PV). Pad
//   columns are zero and never stored. Shared-memory
//   rows carry 16 extra bytes, so ldmatrix's eight rows hit distinct banks
//   at every width (D=80's 160-byte rows fit no swizzle atom);
// - before the walk, each block lists the k tiles it visits: all tiles up to
//   the causal limit, less those whose key segments miss the q tile's
//   segment range, each marked "full" when no key of it is masked for any
//   row of the tile (no mask arithmetic then).
// A row's result does not depend on the other rows of its tile: every row
// visits the tiles of 64 keys in ascending order, a masked score is -inf,
// and p = 2^fma(s, scale, -m) is computed alike on masked and full tiles, so
// a tile that holds no allowed key for a row adds exact zeros (p = 0, and
// alpha = 1 once the row has seen a key). So a K9 shard equals the
// monolithic call bit for bit, whatever its tile size and offset. wgmma
// and TMA are later work: a warpgroup's 64-row tile would halve the blocks
// of the small grids (the fuser's, the LLM's resume layers) and D=80 rows
// fit no TMA swizzle.
//
// K7, the int8 serving flavour (entry `flash_attention_i8`), replaces the
// Pallas adapters `_i8_kernel_adapter` (flash_attention.py:175) and
// `_i8_dense_kernel_adapter` (:200) with the per-row quantization
// `_quant_rows_i8` (:232), which JAX does outside its kernel; with `qpos` it
// is K9-int8 (`_i8_qpos_kernel_adapter` :191). It computes: int8 q and k
// rows with f32 per-row scales; an exact int32 QK^T rescaled as
// (s * (q_scale * sm_scale * log2 e)) * k_scale (:103-111); K2's masks and
// log2-domain online softmax; then either P rounded to v's dtype (bf16)
// before a bf16 PV product with fp32 sums (:157-160) or, with `pv_int8`, p
// at the static scale 1/127 and v quantized per column over each kv tile of
// 64 keys (:139-155), the tile's PV an exact int32 sum, added as
// acc * alpha + pv * (v_scale * (1/127)). The numbers depend on the kv tile
// length, 64: the plain version takes it as an argument.
//
// What bounds K7 on the H100 is what bounds K2, at half K2's tensor-core
// time (the int8 rate is twice the bf16 one): the products and, at D=80,
// the softmax's exponentials and the per-score rescale. The design:
// - one prep launch per call (prep_kernel) quantizes the q and k rows (8
//   values a lane, several rows a warp), bit for bit as
//   ops/kv_cache.quantize_kv does on the card,
//   into int8 rows zero-padded to a multiple of 32 (the depth of
//   mma.m16n8k32), and, under pv_int8, each kv tile of v into per-column
//   scales and V8^T [B, Hkv, tiles, Dv_pad, 64]: v is quantized once per
//   tile and kv head, not once per q block;
// - the attention kernel (attn_kernel) is K2's schedule on
//   mma.sync.m16n8k32 s8 products: warps of 16 q rows with their q8
//   fragments in registers for the block's life, k8 tiles of 64 keys (with
//   their scales and segments) in a two-stage cp.async ring read by
//   ldmatrix (rows padded by 16 bytes, so eight rows hit distinct banks),
//   one barrier per tile, the rank-1 rescale, the masks and the online
//   softmax in registers with quad shuffles, and K2's tile list
//   (list_tiles);
// - under pv_int8, rint(p * 127) goes from the score registers, four to a
//   register, into the A operand of a second s8 product against the V8^T
//   tile. The S accumulators hold keys 8n + 2t and 8n + 2t + 1 of each n8
//   tile, while the A operand wants keys 4t..4t+3 of each 16; key_at maps
//   A positions to keys and the prep stores V8^T's keys in that order, so
//   the int32 sums are exact. Each tile's int32 sum is rescaled per column
//   into the fp32 accumulator. Without pv_int8, P goes to bf16 A fragments
//   and v comes as a bf16 tile through the transposing ldmatrix, as in K2.
// A K9-int8 shard equals the monolithic K7 call bit for bit, by K2's
// argument above, and no atomics touch the numbers, so two calls are
// bit-identical. wgmma and TMA are later work, as for K2: a warpgroup's
// 64-row tile would halve the blocks of the smaller grids (K9-int8's shard:
// 392 blocks of 64 rows), and D=80's 96-byte int8 rows fit no TMA swizzle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// Before the walk, each block lists the k tiles (of kBK keys) it visits,
// in ascending order: all tiles up to the causal limit (the largest q
// position of the tile), less those whose key segments miss the q tile's
// segment range, each entry kt * 2 + full, full when no key of the tile is
// masked for any row (no mask arithmetic then). Fills qseg_s and qpos_s
// ([BQ]: a row past Sq gets segment -1 and position -1, so it allows no key
// and never raises a limit) and returns the count. `tiles` holds four ints
// per k tile of Skv (the list and the tiles' smallest and largest key
// segment and whether one segment fills them); red, 8 ints. The q rows'
// segments and positions and each k tile's key segments are read together:
// one round trip to memory is cheaper than two. Ends with a barrier.
template <int BQ, int kBK>
__device__ __forceinline__ int list_tiles(const int* qseg, const int* ksegg, const int* qpos,
                                          int b, int q0, int sq, int skv, int causal,
                                          int* qseg_s, int* qpos_s, int* red, int* tiles) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool dense = qseg == nullptr;
  if (tid == 0) {
    red[0] = 0x7fffffff;  // min, max q seg; max, min q pos; all rows valid; tile count
    red[1] = -1;
    red[2] = -1;
    red[3] = 0x7fffffff;
    red[4] = 1;
  }
  int seg = -1, pos = -1;
  if (tid < BQ && q0 + tid < sq) {
    seg = dense ? 0 : qseg[(long)b * sq + q0 + tid];
    pos = qpos != nullptr ? qpos[(long)b * sq + q0 + tid] : q0 + tid;
  }
  const int n_all = (skv + kBK - 1) / kBK;
  int* tlo = tiles + n_all;  // [n k tiles] each
  int* thi = tlo + n_all;
  int* tone = thi + n_all;
  if (!dense) {
    for (int kt = warp; kt < n_all; kt += n_warps) {
      const int t0 = kt * kBK + lane, t1 = t0 + 32;
      const int s0 = t0 < skv ? ksegg[t0] : -2;
      const int s1 = t1 < skv ? ksegg[t1] : -2;
      const int lo = __reduce_min_sync(0xffffffffu, min(s0 < 0 ? 0x7fffffff : s0,
                                                         s1 < 0 ? 0x7fffffff : s1));
      const int hi = __reduce_max_sync(0xffffffffu, max(s0, s1));
      const bool one = __all_sync(0xffffffffu, s0 == lo && s1 == lo);
      if (lane == 0) {
        tlo[kt] = lo;
        thi[kt] = hi;
        tone[kt] = one;
      }
    }
  }
  __syncthreads();
  if (tid < BQ) {
    if (q0 + tid < sq) {
      if (seg >= 0) {
        atomicMin(&red[0], seg);
        atomicMax(&red[1], seg);
      } else {
        red[4] = 0;
      }
      atomicMax(&red[2], pos);
      atomicMin(&red[3], pos);
    }
    qseg_s[tid] = seg;
    qpos_s[tid] = pos;
  }
  __syncthreads();
  if (warp == 0) {
    const int qlo = red[0], qhi = red[1], pmax = red[2], pmin = red[3];
    const bool qall = red[4] != 0 && qlo == qhi;  // every row of the tile has one segment
    int n_kt = n_all;
    if (causal) n_kt = min(n_kt, pmax < 0 ? 0 : pmax / kBK + 1);
    if (qhi < 0) n_kt = 0;  // every row of the tile is padding: all zeros
    int count = 0;
    for (int base = 0; base < n_kt; base += 32) {
      const int kt = base + lane, k0 = kt * kBK;
      // a tile whose key segments miss the q tile's range is skipped (a
      // tile that holds no allowed key for a row would add exact zeros)
      bool hit = kt < n_kt, full = false;
      if (hit) {
        if (!dense) hit = thi[kt] >= qlo && tlo[kt] <= qhi;
        full = qall && (dense || (tone[kt] && tlo[kt] == qlo)) && k0 + kBK <= skv &&
               (!causal || k0 + kBK - 1 <= pmin);
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) tiles[count + __popc(m & ((1u << lane) - 1u))] = kt * 2 + (full ? 1 : 0);
      count += __popc(m);
    }
    if (lane == 0) red[5] = count;
  }
  __syncthreads();
  return red[5];
}

// Masks one warp's 16 x 64 score tile (thread (g, t) of a quad holds rows
// g and g + 8, keys 8n + 2t and 8n + 2t + 1 of n8 tile n): a key that the
// row may not see (past Skv, in another segment, after the row's causal
// position) is -inf. kseg holds the tile's key segments.
template <int NT>
__device__ __forceinline__ void mask_tile(float (&s)[NT][4], int k0, int t4, int skv,
                                          bool dense, bool causal, const int (&rseg)[2],
                                          const int (&rpos)[2], const int* kseg) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + 2 * t4 + (e & 1);
      const int t = k0 + j;
      const int hh = e >> 1;
      bool ok = t < skv;
      if (!dense) ok = ok && rseg[hh] >= 0 && rseg[hh] == kseg[j];
      if (causal) ok = ok && t <= rpos[hh];
      if (!ok) s[n][e] = __int_as_float((int)0xff800000);
    }
}

// One online-softmax step in the log2 domain over a warp's score tile, a
// row's scores over its quad; s * scale are the log2-domain scores (scale 1
// when s already is). Updates the rows' running maxima m_run, rescales the
// output accumulators o by alpha = 2^(m_old - m_new), and gives m_use, the
// maxima that p = 2^(s * scale - m_use) takes as one fma, so a masked key
// gives exactly 0: a row that has seen no key keeps m = -inf and uses 0 (p
// = 0, and alpha 0 wipes nothing).
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(const float (&s)[NT][4], float scale,
                                             float (&m_run)[2], float (&o)[NO][4],
                                             float (&m_use)[2], float (&alpha)[2]) {
  const float kMinusInf = __int_as_float((int)0xff800000);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kMinusInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[hh], mx * scale);
    m_use[hh] = m_new == kMinusInf ? 0.f : m_new;
    alpha[hh] = gp_tc::fast_exp2(m_run[hh] - m_use[hh]);
    m_run[hh] = m_new;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * hh] *= alpha[hh];
      o[n][2 * hh + 1] *= alpha[hh];
    }
  }
}

// O += P V over a tile of 64 keys, 16 at a time: P = 2^(s * scale - m_use)
// goes from the score registers to bf16 A fragments (rounded to v's dtype,
// as the Pallas kernel's p.astype(v.dtype)), V is a bf16 tile [64][LDV] read
// by the transposing ldmatrix, and the exponentials of the next 16 keys
// overlap this step's products. Each row's fp32 p is added to sum.
template <int NT, int NO, int LDV>
__device__ __forceinline__ void pv_bf16(float (&s)[NT][4], float scale, const float (&m_use)[2],
                                        const __nv_bfloat16* vst, int lane, float (&o)[NO][4],
                                        float (&sum)[2]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
    for (int n = 2 * kk; n < 2 * kk + 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = gp_tc::fast_exp2(fmaf(s[n][e], scale, -m_use[e >> 1]));
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    const uint32_t pa[4] = {gp_tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            gp_tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            gp_tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            gp_tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t bf[4];
      gp_tc::ldsm_x4_trans(bf, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                                   np * 16 + (lane >> 4) * 8);
      gp_tc::mma_16816(o[2 * np], pa, bf[0], bf[1]);
      gp_tc::mma_16816(o[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

// ------------------------------------------------------------------ K2

namespace fwd {

using namespace gp_tc;

constexpr int kBK = 64;      // keys per k tile: fixed, so K9's tile walk never depends on Sq
constexpr int kStages = 2;   // ring of k/v tiles in shared memory

// Warps per block, 16 q rows each: six at head dims up to 80 (the ViT: a
// 96-row tile reads each k/v tile for more rows, and 154 registers still fit
// two blocks per SM), four above (the LLM's D=128, the fuser's 192/64: the
// 64-row q tile then shares the second k stage, see kQAlias).
__host__ __device__ constexpr int warps_for(int dqk) { return dqk <= 80 ? 6 : 4; }

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;       // [B, Hq, Sq] or null
  const int* qseg;  // [B, Sq] or null when dense
  const int* kseg;  // [B, Skv] or null when dense
  const int* qpos;  // [B, Sq] global q slots (K9) or null: q row s is slot s
  int heads_q, group, sq, skv, dqk, dv;
  long q_sb, q_sh, q_ss;  // element strides of batch, head, sequence
  long k_sb, k_sh, k_ss;
  long v_sb, v_sh, v_ss;
  long o_sb, o_sh, o_ss;
  float scale_log2;  // log2(e) / sqrt(dqk)
  int causal;
  int vec;  // bit 0: q rows, 1: k rows, 2: v rows, 3: o rows may move as 16-byte chunks
};

// Shared-memory bytes of one block, less the k-tile arrays (four ints per
// k tile); ops/cuda/flash_attention.py's `plan_flash` computes the same
// number and the launcher checks they agree.
__host__ __device__ constexpr int smem_fixed(int dqk, int dv) {
  return 2 * ((warps_for(dqk) == 4 ? 0 : 16 * warps_for(dqk) * (dqk + 8)) +
              kStages * kBK * (dqk + 8) + kStages * kBK * (dv + 8)) +
         4 * (kStages * kBK + 2 * 16 * warps_for(dqk) + 8);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(32 * warps_for(DQK), DQK == 128 && DV == 128 ? 3 : 1)
    flash_fwd_kernel(const Args a) {
  // D=128 fits three blocks per SM in shared memory; the launch bound keeps
  // the registers (168) from cutting that to two
  constexpr int kWarps = warps_for(DQK), kThreads = 32 * kWarps;
  constexpr int BQ = 16 * kWarps;
  constexpr int LDQ = DQK + 8, LDV = DV + 8;
  constexpr int NKS = DQK / 16;  // k-steps of QK^T
  constexpr int NT = kBK / 8;    // n-tiles of a warp's 16 x 64 scores
  constexpr int NO = DV / 8;     // n-tiles of its 16 x DV output
  // A 64-row q tile lives in the last k stage until its fragments are in
  // registers (before that stage is first filled); a 96-row one has its own.
  constexpr bool kQAlias = BQ == kBK;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw) + (kQAlias ? 0 : BQ * LDQ);
  __nv_bfloat16* qs = kQAlias ? ks + (kStages - 1) * kBK * LDQ
                              : reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDQ]
  __nv_bfloat16* vs = ks + kStages * kBK * LDQ;                    // [kStages][kBK][LDV]
  int* kseg_s = reinterpret_cast<int*>(vs + kStages * kBK * LDV);  // [kStages][kBK]
  int* qseg_s = kseg_s + kStages * kBK;                            // [BQ]
  int* qpos_s = qseg_s + BQ;                                       // [BQ]
  int* red = qpos_s + BQ;  // [8]: min, max q seg; max, min q pos; all rows valid; tile count
  int* tiles = red + 8;    // [n k tiles]: the visited tiles, kt * 2 + full

  const float kMinusInf = __int_as_float((int)0xff800000);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const bool dense = a.qseg == nullptr;
  const int sq = a.sq, skv = a.skv;

  const __nv_bfloat16* qg = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + b * a.v_sb + kvh * a.v_sh;
  const int* ksegg = dense ? nullptr : a.kseg + (long)b * skv;

  if (a.dqk < DQK) {
    zero_pad<DQK, LDQ>(ks, kStages * kBK, a.dqk, tid, kThreads);
    if (!kQAlias) zero_pad<DQK, LDQ>(qs, BQ, a.dqk, tid, kThreads);
  }
  if (a.dv < DV) zero_pad<DV, LDV>(vs, kStages * kBK, a.dv, tid, kThreads);
  load_rows<DQK, LDQ>(qs, qg, a.q_ss, q0, sq, BQ, a.dqk, a.vec & 1, tid, kThreads);
  const int n_tiles = list_tiles<BQ, kBK>(a.qseg, ksegg, a.qpos, b, q0, sq, skv, a.causal,
                                          qseg_s, qpos_s, red, tiles);

  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;  // this warp's first row in the tile
  int rseg[2], rpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rseg[hh] = qseg_s[wrow + g + 8 * hh];
    rpos[hh] = qpos_s[wrow + g + 8 * hh];
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMinusInf, kMinusInf}, l_run[2] = {0.f, 0.f};
  uint32_t qf[NKS][4];  // Q's A fragments, loaded once

  // K, V (and key segment) tile of list entry i into stage i % kStages
  auto load_tile = [&](int i) {
    const int k0 = (tiles[i] >> 1) * kBK, st = i % kStages;
    load_rows<DQK, LDQ>(ks + st * kBK * LDQ, kg, a.k_ss, k0, skv, kBK, a.dqk, a.vec & 2, tid,
                        kThreads);
    load_rows<DV, LDV>(vs + st * kBK * LDV, vg, a.v_ss, k0, skv, kBK, a.dv, a.vec & 4, tid,
                       kThreads);
    if (!dense && tid < kBK) {
      const int t = k0 + tid;
      cp_async4(kseg_s + st * kBK + tid, ksegg + (t < skv ? t : 0), t < skv ? 4 : 0);
    }
  };

  // the first kStages - 1 tiles in flight (with Q in the first group); then
  // each iteration waits for its tile, and after the barrier (every warp is
  // done with the previous tile's stage) refills that stage kStages - 1 ahead
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
        ldsm_x4(qf[kk], qs + (wrow + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
      if (kQAlias) __syncthreads();  // the next load_tile overwrites Q's rows
    }
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const int entry = tiles[i];
    const int k0 = (entry >> 1) * kBK;
    const bool full = (entry & 1) != 0;
    const int st = i % kStages;
    const __nv_bfloat16* kst = ks + st * kBK * LDQ;
    const __nv_bfloat16* vst = vs + st * kBK * LDV;
    const int* kss = kseg_s + st * kBK;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }

    // a key no row of the tile may see is -inf (a full tile has none); the
    // online softmax; O += P V
    if (!full) mask_tile(s, k0, t4, skv, dense, a.causal, rseg, rpos, kss);
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
    softmax_step(s, a.scale_log2, m_run, o, m_use, alpha);
    pv_bf16<NT, NO, LDV>(s, a.scale_log2, m_use, vst, lane, o, sum);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
  }
  cp_async_wait<0>();
  __syncthreads();  // Q's copies (when no tile ran) have landed before the rows are reused

  // normalize, stage this warp's rows in its own Q rows, then 16-byte stores
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float m = m_run[hh];
    const bool seen = m != kMinusInf;  // a row that saw no allowed key writes 0
    const float inv = seen ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    const int r = wrow + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(qs + r * LDQ + n * 8 + 2 * t4) =
          pack_bf16(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    const int s = q0 + r;
    if (a.lse != nullptr && t4 == 0 && s < sq)
      a.lse[((long)b * a.heads_q + h) * sq + s] = seen ? m + log2f(fmaxf(l, 1e-30f)) : kNegInf;
  }
  __syncwarp();
  __nv_bfloat16* og = a.o + b * a.o_sb + h * a.o_sh;
  constexpr int kOutChunks = DV / 8;
  for (int idx = lane; idx < 16 * kOutChunks; idx += 32) {
    const int r = wrow + idx / kOutChunks, c = (idx % kOutChunks) * 8;
    const int s = q0 + r;
    if (s >= sq || c >= a.dv) continue;
    const __nv_bfloat16* src = qs + r * LDQ + c;
    __nv_bfloat16* dst = og + (long)s * a.o_ss + c;
    if ((a.vec & 8) && c + 8 <= a.dv) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < a.dv; ++e) dst[e] = src[e];
    }
  }
}

template <int DQK, int DV>
int launch(const Args& a, int batch, int smem, void* stream) {
  if (smem != smem_fixed(DQK, DV) + 16 * ((a.skv + kBK - 1) / kBK))
    return (int)cudaErrorInvalidValue;  // the wrapper's plan and this build disagree
  const int err = raise_smem_cap<flash_fwd_kernel<DQK, DV>>(smem);
  if (err != 0) return err;
  constexpr int BQ = 16 * warps_for(DQK);
  dim3 grid((a.sq + BQ - 1) / BQ, a.heads_q, batch);
  flash_fwd_kernel<DQK, DV><<<grid, 32 * warps_for(DQK), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The padded head-dim pairs the kernel is built for (ops/cuda/flash_attention.py
// FWD_DIMS lists the same).
int dispatch(const Args& a, int batch, int dqk_pad, int dv_pad, int smem, void* stream) {
#define GP_FWD_CASE(DQK, DV) \
  if (dqk_pad == DQK && dv_pad == DV) return launch<DQK, DV>(a, batch, smem, stream);
  GP_FWD_CASE(16, 16)
  GP_FWD_CASE(64, 64)
  GP_FWD_CASE(80, 80)
  GP_FWD_CASE(128, 128)
  GP_FWD_CASE(192, 64)
  GP_FWD_CASE(256, 128)
#undef GP_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace fwd

// ------------------------------------------------------------------ K7

namespace i8 {

using namespace gp_tc;

constexpr int kBK = 64;             // keys per k tile, and the tile that pv_int8 quantizes v over
constexpr int kStages = 2;          // ring of k/v tiles in shared memory
constexpr int kPrepThreads = 256;   // the prep: kPasses passes of q or k rows a warp,
constexpr int kPasses = 4;          // prep_rows(dp) a block; one block per v tile
constexpr int kMaxDvp = 128;

// Lanes that quantize one q or k row of dp <= 256 int8 bytes (the padded
// head dim), 8 a lane: a power of two, so that a warp holds
// 32 / row_lanes(dp) rows side by side.
__host__ __device__ constexpr int row_lanes(int dp) {
  return dp <= 32 ? 4 : dp <= 64 ? 8 : dp <= 128 ? 16 : 32;
}

// q or k rows one prep block quantizes
__host__ __device__ constexpr int prep_rows(int dp) {
  return kPasses * (kPrepThreads / 32) * (32 / row_lanes(dp));
}

// Warps per block, 16 q rows each, as K2's: six at padded qk head dims up
// to 96 (the ViT's 80), four above (the LLM's 128).
__host__ __device__ constexpr int warps_for(int dqp) { return dqp <= 96 ? 6 : 4; }

// Shared-memory bytes of one attention block, less the k-tile arrays (four
// ints per k tile); ops/cuda/flash_attention.py's `plan_flash_int8` computes
// the same number and the launcher checks they agree: the q tile and
// kStages k tiles of int8 rows padded by 16 bytes; kStages v tiles (V8^T
// rows of kBK bytes padded by 16, and the tile's column scales, or bf16
// rows padded by 8 elements); kStages stages of key scales and segments,
// the q rows' segments and positions, and 8 slots.
__host__ __device__ constexpr int smem_fixed(int dqp, int dvp, bool pv8) {
  return (16 * warps_for(dqp) + kStages * kBK) * (dqp + 16) +
         (pv8 ? kStages * dvp * (kBK + 16) + 4 * kStages * dvp : 2 * kStages * kBK * (dvp + 8)) +
         4 * (2 * kStages * kBK + 2 * 16 * warps_for(dqp) + 8);
}

// The key at A position `pos` (0..31) of a 32-key group in the PV product:
// position 16h + 4t + i holds key 16h + 8(i / 2) + 2t + i % 2, the key whose
// probability thread t of the quad holds there (S accumulators hold keys
// 8n + 2t and 8n + 2t + 1 of each n8 tile; A wants 4t..4t+3 of each 16).
// The prep stores V8^T's keys in this order (ops/cuda/flash_attention.py
// `k7_key_order` is the same map).
__host__ __device__ constexpr int key_at(int pos) {
  return 16 * (pos >> 4) + 8 * ((pos & 3) >> 1) + 2 * ((pos >> 2) & 3) + (pos & 1);
}

struct PrepArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int8_t* q8;   // [B, Hq, Sq, dqp]
  float* qsc;   // [B, Hq, Sq]
  int8_t* k8;   // [B, Hkv, Skv, dqp]
  float* ksc;   // [B, Hkv, Skv]
  int8_t* v8t;  // [B, Hkv, n_kt, dvp, kBK] (pv_int8)
  float* vsc;   // [B, Hkv, n_kt, dvp] (pv_int8)
  int batch, heads_q, heads_kv, sq, skv, dqk, dv, dqp, dvp, n_kt;
  long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int q_blocks, k_blocks;  // row blocks of q, then of k; the v tiles' blocks follow
  int vec;  // bit 0: q rows, 1: k rows, 2: v rows may be read as 16-byte chunks
};

// 8 bf16 from x, n of them real (none when n <= 0), the rest zeros: one
// 16-byte load where vec allows it and all 8 are real.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* x, int n, bool vec) {
  if (vec && n >= 8) return *reinterpret_cast<const uint4*>(x);
  uint4 r = make_uint4(0, 0, 0, 0);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
  for (int i = 0; i < 8 && i < n; ++i) e[i] = x[i];
  return r;
}

// x / scale rounded half to even and clamped to +-127 (an IEEE division)
__device__ __forceinline__ uint32_t quant_byte(__nv_bfloat16 x, float scale) {
  const float r = rintf(__fdiv_rn(__bfloat162float(x), scale));
  return (uint32_t)((int)fminf(fmaxf(r, -127.f), 127.f) & 0xff);
}

// the scale of an amax, as PyTorch computes amax.clamp(min=1e-8) / 127.0 on
// the card: a division of a tensor by a Python scalar multiplies by its
// fp32 reciprocal (K6's prep does the same)
__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
}

// The q or k rows [row0, row0 + prep_rows(dp)) of the n_rows rows of x
// ([B, H, S, d] strided) -> int8 rows of dp bytes (zeros past d) and their
// scales, bit for bit as quantize_kv on the card: the amax in bf16 (exact
// as fp32), its scale, x / scale. Each warp takes kPasses passes of
// 32 / row_lanes(dp) rows, row_lanes(dp) lanes a row; all its loads are
// issued before the first row is reduced.
__device__ __forceinline__ void quant_rows(const __nv_bfloat16* x, long sb, long sh, long ss,
                                           int heads, int len, int n_rows, int row0, int d,
                                           int dp, bool vec, int8_t* q, float* scale) {
  const int lanes = row_lanes(dp), per_pass = 32 / lanes;
  const int lane = threadIdx.x & 31, c = (lane % lanes) * 8;
  const int first = row0 + (threadIdx.x >> 5) * kPasses * per_pass + lane / lanes;
  uint4 raw[kPasses];
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int row = first + j * per_pass;
    const int s = row % len, bh = row / len;
    raw[j] = row < n_rows ? load8(x + (bh / heads) * sb + (bh % heads) * sh + s * ss + c,
                                  d - c, vec)
                          : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int row = first + j * per_pass;
    if (__all_sync(0xffffffffu, row >= n_rows)) return;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
    for (int o = lanes >> 1; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = scale_of(amax);
    if (row >= n_rows) continue;
    if (c == 0) scale[row] = sc;
    if (c >= dp) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < d) w[i >> 2] |= quant_byte(e[i], sc) << (8 * (i & 3));
    *reinterpret_cast<uint2*>(q + (long)row * dp + c) = make_uint2(w[0], w[1]);
  }
}

// One kv tile of v (kBK keys of one kv head) -> its column scales and V8^T
// rows, as the plain version quantizes the tile: each column's amax over
// the tile's keys (keys past Skv and columns past Dv read as zeros, which
// change no amax), its scale, v / scale. A V8^T row holds one column's kBK
// bytes, in key_at order within each 32-key group.
__device__ __forceinline__ void prep_v_tile(const PrepArgs& a, int blk) {
  __shared__ __align__(16) __nv_bfloat16 vt[kBK][kMaxDvp + 8];
  __shared__ float sc[kMaxDvp];
  const int tid = threadIdx.x;
  const int kt = blk % a.n_kt, bh = blk / a.n_kt;  // bh = b * Hkv + kv head
  const __nv_bfloat16* vg = a.v + (bh / a.heads_kv) * a.v_sb + (bh % a.heads_kv) * a.v_sh;
  const int k0 = kt * kBK, chunks = a.dvp / 8;
  for (int idx = tid; idx < kBK * chunks; idx += kPrepThreads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    const int t = k0 + r;
    *reinterpret_cast<uint4*>(&vt[r][c]) =
        load8(vg + (t < a.skv ? (long)t * a.v_ss + c : 0), t < a.skv ? a.dv - c : 0, a.vec & 4);
  }
  __syncthreads();
  for (int c = tid; c < a.dvp; c += kPrepThreads) {
    float amax = 0.f;
    for (int r = 0; r < kBK; ++r) amax = fmaxf(amax, fabsf(__bfloat162float(vt[r][c])));
    sc[c] = scale_of(amax);
    a.vsc[(long)blk * a.dvp + c] = sc[c];
  }
  __syncthreads();
  int8_t* dst = a.v8t + (long)blk * a.dvp * kBK;
  for (int idx = tid; idx < a.dvp * (kBK / 16); idx += kPrepThreads) {
    const int c = idx / (kBK / 16), p0 = (idx % (kBK / 16)) * 16;
    const float scale = sc[c];
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int p = p0 + i;
      w[i >> 2] |= quant_byte(vt[(p & ~31) + key_at(p & 31)][c], scale) << (8 * (i & 3));
    }
    *reinterpret_cast<uint4*>(dst + c * kBK + p0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(kPrepThreads) prep_kernel(const PrepArgs a) {
  const int blk = blockIdx.x;
  if (blk >= a.q_blocks + a.k_blocks) {
    prep_v_tile(a, blk - a.q_blocks - a.k_blocks);
    return;
  }
  const bool is_q = blk < a.q_blocks;
  const int row0 = (is_q ? blk : blk - a.q_blocks) * prep_rows(a.dqp);
  if (is_q)
    quant_rows(a.q, a.q_sb, a.q_sh, a.q_ss, a.heads_q, a.sq, a.batch * a.heads_q * a.sq, row0,
               a.dqk, a.dqp, a.vec & 1, a.q8, a.qsc);
  else
    quant_rows(a.k, a.k_sb, a.k_sh, a.k_ss, a.heads_kv, a.skv, a.batch * a.heads_kv * a.skv,
               row0, a.dqk, a.dqp, a.vec & 2, a.k8, a.ksc);
}

struct Args {
  const int8_t* q8;        // [B, Hq, Sq, DQP]
  const float* qsc;        // [B, Hq, Sq]
  const int8_t* k8;        // [B, Hkv, Skv, DQP]
  const float* ksc;        // [B, Hkv, Skv]
  const int8_t* v8t;       // [B, Hkv, n_kt, DVP, kBK] (PV8)
  const float* vsc;        // [B, Hkv, n_kt, DVP] (PV8)
  const __nv_bfloat16* v;  // [B, Hkv, Skv, Dv] strided (not PV8)
  __nv_bfloat16* o;
  const int* qseg;  // [B, Sq] or null when dense
  const int* kseg;  // [B, Skv] or null when dense
  const int* qpos;  // [B, Sq] global q slots (K9-int8) or null: q row s is slot s
  int heads_q, heads_kv, group, sq, skv, dv, n_kt;
  long v_sb, v_sh, v_ss;
  long o_sb, o_sh, o_ss;
  float scale_log2;  // log2(e) / sqrt(dqk)
  int causal;
  int vec;  // bit 2: v rows may move as 16-byte chunks; 3: o as 4-byte pairs
};

// rint(p * 127) of four probabilities in [0, 1], packed low byte first:
// p * 127 rounded to fp32 as the plain version rounds it, then added to
// 1.5 * 2^23, which rounds it half to even to an integer held in the low
// mantissa bits (no F2I and no shifts: faster than __float2int_rn on the
// card); the low bytes, 0..127, are the values
__device__ __forceinline__ uint32_t pack_p8(float p0, float p1, float p2, float p3) {
  constexpr float kMagic = 12582912.0f;
  const uint32_t b0 = __float_as_uint(__fadd_rn(__fmul_rn(p0, 127.f), kMagic));
  const uint32_t b1 = __float_as_uint(__fadd_rn(__fmul_rn(p1, 127.f), kMagic));
  const uint32_t b2 = __float_as_uint(__fadd_rn(__fmul_rn(p2, 127.f), kMagic));
  const uint32_t b3 = __float_as_uint(__fadd_rn(__fmul_rn(p3, 127.f), kMagic));
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

template <int DQP, int DVP, bool PV8>
__global__ void __launch_bounds__(32 * warps_for(DQP), DQP == 128 ? 3 : 2)
    attn_kernel(const Args a) {
  constexpr int kWarps = warps_for(DQP), kThreads = 32 * kWarps;
  constexpr int BQ = 16 * kWarps;
  constexpr int LDQ = DQP + 16;  // int8 q and k rows
  constexpr int LDT = kBK + 16;  // int8 V8^T rows
  constexpr int LDV = DVP + 8;   // bf16 v rows
  constexpr int NKS = DQP / 32;  // k-steps of QK^T
  constexpr int NT = kBK / 8;    // n-tiles of a warp's 16 x 64 scores
  constexpr int NO = DVP / 8;    // n-tiles of its 16 x DVP output
  constexpr int kChunks = DQP / 16;
  constexpr int kVStage = PV8 ? DVP * LDT : 2 * kBK * LDV;  // bytes of one v stage

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem_raw);  // [BQ][LDQ]
  int8_t* ks = qs + BQ * LDQ;                        // [kStages][kBK][LDQ]
  unsigned char* vs = reinterpret_cast<unsigned char*>(ks + kStages * kBK * LDQ);
  float* vsc_s = reinterpret_cast<float*>(vs + kStages * kVStage);  // [kStages][DVP] (PV8)
  float* ksc_s = vsc_s + (PV8 ? kStages * DVP : 0);                 // [kStages][kBK]
  int* kseg_s = reinterpret_cast<int*>(ksc_s + kStages * kBK);      // [kStages][kBK]
  int* qseg_s = kseg_s + kStages * kBK;                             // [BQ]
  int* qpos_s = qseg_s + BQ;                                        // [BQ]
  int* red = qpos_s + BQ;  // [8]
  int* tiles = red + 8;    // [n k tiles]: the visited tiles, kt * 2 + full

  const float kMinusInf = __int_as_float((int)0xff800000);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const bool dense = a.qseg == nullptr;
  const int sq = a.sq, skv = a.skv;
  const long q_row0 = ((long)b * a.heads_q + h) * sq;     // this head's first q row
  const long k_row0 = ((long)b * a.heads_kv + kvh) * skv;  // its kv head's first key
  const long tile0 = ((long)b * a.heads_kv + kvh) * a.n_kt;  // and first v tile
  const int8_t* qg = a.q8 + q_row0 * DQP;
  const int8_t* kg = a.k8 + k_row0 * DQP;
  const float* kscg = a.ksc + k_row0;
  const __nv_bfloat16* vg = PV8 ? nullptr : a.v + b * a.v_sb + kvh * a.v_sh;
  const int* ksegg = dense ? nullptr : a.kseg + (long)b * skv;

  if (!PV8 && a.dv < DVP)
    zero_pad<DVP, LDV>(reinterpret_cast<__nv_bfloat16*>(vs), kStages * kBK, a.dv, tid, kThreads);
  for (int idx = tid; idx < BQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool in = q0 + r < sq;
    cp_async16(qs + r * LDQ + 16 * c, qg + (in ? (long)(q0 + r) * DQP + 16 * c : 0), in ? 16 : 0);
  }
  const int n_tiles = list_tiles<BQ, kBK>(a.qseg, ksegg, a.qpos, b, q0, sq, skv, a.causal,
                                          qseg_s, qpos_s, red, tiles);

  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;  // this warp's first row in the tile
  int rseg[2], rpos[2];
  float qscale[2];  // q_scale * sm_scale * log2(e), the product JAX forms first (:111)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wrow + g + 8 * hh;
    rseg[hh] = qseg_s[r];
    rpos[hh] = qpos_s[r];
    qscale[hh] = q0 + r < sq ? __fmul_rn(a.qsc[q_row0 + q0 + r], a.scale_log2) : 0.f;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMinusInf, kMinusInf}, l_run[2] = {0.f, 0.f};
  uint32_t qf[NKS][4];  // Q8's A fragments, loaded once

  // k8 (with its key scales and segments) and v tiles of list entry i into
  // stage i % kStages
  auto load_tile = [&](int i) {
    const int kt = tiles[i] >> 1, k0 = kt * kBK, st = i % kStages;
    int8_t* kd = ks + st * kBK * LDQ;
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx - r * kChunks;
      const bool in = k0 + r < skv;
      cp_async16(kd + r * LDQ + 16 * c, kg + (in ? (long)(k0 + r) * DQP + 16 * c : 0),
                 in ? 16 : 0);
    }
    if constexpr (PV8) {
      const int8_t* vt = a.v8t + (tile0 + kt) * DVP * kBK;
      int8_t* vd = reinterpret_cast<int8_t*>(vs + st * kVStage);
      for (int idx = tid; idx < DVP * (kBK / 16); idx += kThreads) {
        const int r = idx / (kBK / 16), c = idx % (kBK / 16);
        cp_async16(vd + r * LDT + 16 * c, vt + r * kBK + 16 * c, 16);
      }
      if (tid < DVP / 4)
        cp_async16(vsc_s + st * DVP + 4 * tid, a.vsc + (tile0 + kt) * DVP + 4 * tid, 16);
    } else {
      load_rows<DVP, LDV>(reinterpret_cast<__nv_bfloat16*>(vs + st * kVStage), vg, a.v_ss, k0,
                          skv, kBK, a.dv, a.vec & 4, tid, kThreads);
    }
    if (tid < kBK) {
      const int t = k0 + tid;
      cp_async4(ksc_s + st * kBK + tid, kscg + (t < skv ? t : 0), t < skv ? 4 : 0);
      if (!dense) cp_async4(kseg_s + st * kBK + tid, ksegg + (t < skv ? t : 0), t < skv ? 4 : 0);
    }
  };

  // the first kStages - 1 tiles in flight (with Q8 in the first group); then
  // each iteration waits for its tile, and after the barrier (every warp is
  // done with the previous tile's stage) refills that stage kStages - 1 ahead
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
        ldsm_x4(qf[kk], qs + (wrow + (lane & 15)) * LDQ + (2 * kk + (lane >> 4)) * 16);
    }
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const int entry = tiles[i];
    const int k0 = (entry >> 1) * kBK;
    const bool full = (entry & 1) != 0;
    const int st = i % kStages;
    const int8_t* kst = ks + st * kBK * LDQ;
    const float* kss = ksc_s + st * kBK;
    const int* ksg = kseg_s + st * kBK;

    // S = Q8 K8^T, exact in int32
    int si[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) si[n][e] = 0;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ +
                        (2 * kk + ((lane >> 3) & 1)) * 16);
        mma_s8(si[2 * np], qf[kk], bf[0], bf[1]);
        mma_s8(si[2 * np + 1], qf[kk], bf[2], bf[3]);
      }

    // the rank-1 rescale in JAX's order, (s * (q_scale * scale2)) * k_scale,
    // then the mask: a key no row of the tile may see is -inf (a full tile
    // has none)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 kc = *reinterpret_cast<const float2*>(kss + n * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fmul_rn(__fmul_rn(__int2float_rn(si[n][e]), qscale[e >> 1]),
                            (e & 1) ? kc.y : kc.x);
    }
    if (!full) mask_tile(s, k0, t4, skv, dense, a.causal, rseg, rpos, ksg);

    // online softmax in the log2 domain (the scores are already scaled)
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
    softmax_step(s, 1.f, m_run, o, m_use, alpha);

    if constexpr (PV8) {
      // P at the static scale 1/127, four keys to a register in the A
      // operand's key order (key_at), against V8^T stored in that order; the
      // tile's exact int32 sums rescaled per column: acc += pv * (vsc / 127)
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int n = 4 * kk; n < 4 * kk + 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(s[n][e] - m_use[e >> 1]);
            s[n][e] = p;
            sum[e >> 1] += p;
          }
        const int n = 4 * kk;
        pa[kk][0] = pack_p8(s[n][0], s[n][1], s[n + 1][0], s[n + 1][1]);
        pa[kk][1] = pack_p8(s[n][2], s[n][3], s[n + 1][2], s[n + 1][3]);
        pa[kk][2] = pack_p8(s[n + 2][0], s[n + 2][1], s[n + 3][0], s[n + 3][1]);
        pa[kk][3] = pack_p8(s[n + 2][2], s[n + 2][3], s[n + 3][2], s[n + 3][3]);
      }
      const int8_t* vst = reinterpret_cast<const int8_t*>(vs + st * kVStage);
      const float* vss = vsc_s + st * DVP;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        int pv[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, vst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT +
                          (2 * kk + ((lane >> 3) & 1)) * 16);
          mma_s8(pv[0], pa[kk], bf[0], bf[1]);
          mma_s8(pv[1], pa[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = 2 * np + jj;
          const float2 vc = *reinterpret_cast<const float2*>(vss + n * 8 + 2 * t4);
          const float c0 = __fmul_rn(vc.x, 1.0f / 127.0f), c1 = __fmul_rn(vc.y, 1.0f / 127.0f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n][e] =
                __fadd_rn(o[n][e], __fmul_rn(__int2float_rn(pv[jj][e]), (e & 1) ? c1 : c0));
        }
      }
    } else {
      const __nv_bfloat16* vst = reinterpret_cast<const __nv_bfloat16*>(vs + st * kVStage);
      pv_bf16<NT, NO, LDV>(s, 1.f, m_use, vst, lane, o, sum);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
  }
  cp_async_wait<0>();

  // out = acc / l, bf16, straight from the registers (a quad writes 16
  // bytes of a row); a row that saw no allowed key writes 0
  __nv_bfloat16* og = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int s = q0 + wrow + g + 8 * hh;
    if (s >= sq) continue;
    const bool seen = m_run[hh] != kMinusInf;
    const float den = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = og + (long)s * a.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t4;
      const float v0 = seen ? __fdiv_rn(o[n][2 * hh], den) : 0.f;
      const float v1 = seen ? __fdiv_rn(o[n][2 * hh + 1], den) : 0.f;
      if ((a.vec & 8) && c + 1 < a.dv) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < a.dv) orow[c] = __float2bfloat16(v0);
        if (c + 1 < a.dv) orow[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DQP, int DVP, bool PV8>
int launch(const Args& a, int batch, int smem, cudaStream_t stream) {
  if (smem != smem_fixed(DQP, DVP, PV8) + 16 * ((a.skv + kBK - 1) / kBK))
    return (int)cudaErrorInvalidValue;  // the wrapper's plan and this build disagree
  const int err = raise_smem_cap<attn_kernel<DQP, DVP, PV8>>(smem);
  if (err != 0) return err;
  constexpr int BQ = 16 * warps_for(DQP);
  dim3 grid((a.sq + BQ - 1) / BQ, a.heads_q, batch);
  attn_kernel<DQP, DVP, PV8><<<grid, 32 * warps_for(DQP), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The padded head-dim pairs the kernel is built for (ops/cuda/flash_attention.py
// I8_DIMS lists the same).
int dispatch(const Args& a, int batch, int dqp, int dvp, bool pv8, int smem,
             cudaStream_t stream) {
#define GP_I8_CASE(DQP, DVP)                                                       \
  if (dqp == DQP && dvp == DVP)                                                    \
    return pv8 ? launch<DQP, DVP, true>(a, batch, smem, stream)                    \
               : launch<DQP, DVP, false>(a, batch, smem, stream);
  GP_I8_CASE(32, 16)
  GP_I8_CASE(64, 64)
  GP_I8_CASE(96, 80)
  GP_I8_CASE(128, 128)
  GP_I8_CASE(256, 128)
#undef GP_I8_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace i8

}  // namespace

// K2, K2-lse, K9, K9-lse: q, k, v bf16 [B, H, S, D] with the given element
// strides; o bf16 [B, Hq, Sq, Dv] strided; lse f32 [B, Hq, Sq] or null. The
// ints come as one array p: batch, heads_q, heads_kv, sq, skv, dqk, dv, the
// padded dqk and dv and the shared-memory bytes of the wrapper's plan, the
// batch, head and sequence strides of q, k, v and o, causal, and vec (which
// rows may move as 16-byte chunks).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* qseg, const void* kseg,
                                    const void* qpos, const int* p, void* stream) {
  const int batch = p[0], heads_q = p[1], heads_kv = p[2], sq = p[3], skv = p[4];
  const int dqk = p[5], dv = p[6], dqk_pad = p[7], dv_pad = p[8], smem = p[9];
  const int* st = p + 10;
  const int causal = p[22], vec = p[23];
  if (heads_kv <= 0 || heads_q % heads_kv != 0 || dv <= 0 || dv > dv_pad || dqk <= 0 ||
      dqk > dqk_pad || (qseg == nullptr) != (kseg == nullptr) ||
      (qpos != nullptr && !causal) || (qpos == nullptr && causal && sq != skv))
    return (int)cudaErrorInvalidValue;
  fwd::Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.o = (__nv_bfloat16*)o;
  a.lse = (float*)lse;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.qpos = (const int*)qpos;
  a.heads_q = heads_q;
  a.group = heads_q / heads_kv;
  a.sq = sq;
  a.skv = skv;
  a.dqk = dqk;
  a.dv = dv;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)dqk);
  a.causal = causal;
  a.vec = vec;
  return fwd::dispatch(a, batch, dqk_pad, dv_pad, smem, stream);
}

// K7, and K9-int8 with qpos (causal only): q, k, v bf16 [B, H, S, D] with
// the given element strides, o bf16 [B, Hq, Sq, Dv] strided. One call
// launches the prep kernel, which writes the int8 operands into the
// wrapper's buffers q8 [B, Hq, Sq, dqk_pad], qsc [B, Hq, Sq], k8, ksc and,
// with pv_int8, v8t [B, Hkv, tiles, dv_pad, 64] and vsc [B, Hkv, tiles,
// dv_pad] (null otherwise), then the attention kernel. The ints come as one
// array p: batch, heads_q, heads_kv, sq, skv, dqk, dv, the padded dqk and
// dv and the attention's shared-memory bytes of the wrapper's plan,
// pv_int8, causal, vec (which rows of q, k, v may move as 16-byte chunks,
// and whether o takes 4-byte pairs), the prep's q and k row blocks, then
// the batch, head and sequence strides of q, k, v and o. A plan that
// disagrees with this file's formulas is refused.
extern "C" int flash_attention_i8(const void* q, const void* k, const void* v, void* o,
                                  void* q8, void* qsc, void* k8, void* ksc, void* v8t,
                                  void* vsc, const void* qseg, const void* kseg,
                                  const void* qpos, const int* p, void* stream) {
  const int batch = p[0], heads_q = p[1], heads_kv = p[2], sq = p[3], skv = p[4];
  const int dqk = p[5], dv = p[6], dqp = p[7], dvp = p[8], smem = p[9];
  const int pv8 = p[10], causal = p[11], vec = p[12], q_blocks = p[13], k_blocks = p[14];
  const int* st = p + 15;
  const int n_kt = (skv + i8::kBK - 1) / i8::kBK;
  const int rows_q = batch * heads_q * sq, rows_k = batch * heads_kv * skv;
  if (batch <= 0 || sq <= 0 || skv < 0 || heads_kv <= 0 || heads_q % heads_kv != 0 ||
      dv <= 0 || dv > dvp || dvp > i8::kMaxDvp || dvp % 16 != 0 || dqk <= 0 || dqk > dqp ||
      dqp > 256 || dqp % 32 != 0 || (qseg == nullptr) != (kseg == nullptr) ||
      (qpos != nullptr && !causal) || (qpos == nullptr && causal && sq != skv) ||
      q_blocks != (rows_q + i8::prep_rows(dqp) - 1) / i8::prep_rows(dqp) ||
      k_blocks != (rows_k + i8::prep_rows(dqp) - 1) / i8::prep_rows(dqp) ||
      (pv8 && (v8t == nullptr || vsc == nullptr)) ||
      (((uintptr_t)q8 | (uintptr_t)k8 | (uintptr_t)v8t | (uintptr_t)vsc) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream_ = (cudaStream_t)stream;
  i8::PrepArgs pa;
  pa.q = (const __nv_bfloat16*)q;
  pa.k = (const __nv_bfloat16*)k;
  pa.v = (const __nv_bfloat16*)v;
  pa.q8 = (int8_t*)q8;
  pa.qsc = (float*)qsc;
  pa.k8 = (int8_t*)k8;
  pa.ksc = (float*)ksc;
  pa.v8t = (int8_t*)v8t;
  pa.vsc = (float*)vsc;
  pa.batch = batch;
  pa.heads_q = heads_q;
  pa.heads_kv = heads_kv;
  pa.sq = sq;
  pa.skv = skv;
  pa.dqk = dqk;
  pa.dv = dv;
  pa.dqp = dqp;
  pa.dvp = dvp;
  pa.n_kt = n_kt;
  pa.q_sb = st[0]; pa.q_sh = st[1]; pa.q_ss = st[2];
  pa.k_sb = st[3]; pa.k_sh = st[4]; pa.k_ss = st[5];
  pa.v_sb = st[6]; pa.v_sh = st[7]; pa.v_ss = st[8];
  pa.q_blocks = q_blocks;
  pa.k_blocks = k_blocks;
  pa.vec = vec;
  const int v_blocks = pv8 ? batch * heads_kv * n_kt : 0;
  i8::prep_kernel<<<q_blocks + k_blocks + v_blocks, i8::kPrepThreads, 0, stream_>>>(pa);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  i8::Args a;
  a.q8 = (const int8_t*)q8;
  a.qsc = (const float*)qsc;
  a.k8 = (const int8_t*)k8;
  a.ksc = (const float*)ksc;
  a.v8t = (const int8_t*)v8t;
  a.vsc = (const float*)vsc;
  a.v = (const __nv_bfloat16*)v;
  a.o = (__nv_bfloat16*)o;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.qpos = (const int*)qpos;
  a.heads_q = heads_q;
  a.heads_kv = heads_kv;
  a.group = heads_q / heads_kv;
  a.sq = sq;
  a.skv = skv;
  a.dv = dv;
  a.n_kt = n_kt;
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  // sm_scale * log2(e) as the plain version forms it, in double, then fp32
  a.scale_log2 = (float)(1.0 / sqrt((double)dqk) * 1.4426950408889634);
  a.causal = causal;
  a.vec = vec;
  return i8::dispatch(a, batch, dqp, dvp, pv8 != 0, smem, stream_);
}
