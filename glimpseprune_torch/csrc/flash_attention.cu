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
// K7, the int8 serving flavour (entry `flash_attention_i8`, not redesigned:
// its own scalar kernel on CUDA cores), replaces the Pallas adapters
// `_i8_kernel_adapter` (flash_attention.py:175) and `_i8_dense_kernel_adapter`
// (:200) with the per-row quantization `_quant_rows_i8` (:232) done outside by
// the wrapper, as in JAX. q and k arrive as int8 with f32 per-row scales;
// QK^T is an int32 product (__dp4a over 4 bytes at a time; the head dim is
// zero-padded to a multiple of 4 in shared memory) rescaled by
// q_scale * sm_scale * log2(e) * k_scale (the Pallas kernel's :103-111). With
// `pv_int8` the probabilities are quantized with the static scale 1/127 and
// each kv tile's v per column (amax / 127 over the tile's rows, :139-155);
// the PV product is then an int32 sum per tile, rescaled by v_scale / 127.
// So the numbers depend on the kv tile length, 64 here: the plain version
// takes it as an argument. With `qpos` it is K9-int8. It runs on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

  if (tid == 0) {
    red[0] = 0x7fffffff;
    red[1] = -1;
    red[2] = -1;
    red[3] = 0x7fffffff;
    red[4] = 1;
  }
  if (a.dqk < DQK) {
    zero_pad<DQK, LDQ>(ks, kStages * kBK, a.dqk, tid, kThreads);
    if (!kQAlias) zero_pad<DQK, LDQ>(qs, BQ, a.dqk, tid, kThreads);
  }
  if (a.dv < DV) zero_pad<DV, LDV>(vs, kStages * kBK, a.dv, tid, kThreads);
  load_rows<DQK, LDQ>(qs, qg, a.q_ss, q0, sq, BQ, a.dqk, a.vec & 1, tid, kThreads);
  // The q rows' segments and positions, and each k tile's key segments
  // (smallest and largest id of its valid keys, and whether all 64 keys
  // are valid with one id), are read together: the tile test below needs
  // both, and one round trip to memory is cheaper than two.
  int seg = -1, pos = -1;  // a row past Sq allows no key and never raises a limit
  if (tid < BQ && q0 + tid < sq) {
    seg = dense ? 0 : a.qseg[(long)b * sq + q0 + tid];
    pos = a.qpos != nullptr ? a.qpos[(long)b * sq + q0 + tid] : q0 + tid;
  }
  const int n_all = (skv + kBK - 1) / kBK;
  int* tlo = tiles + n_all;  // [n k tiles] each
  int* thi = tlo + n_all;
  int* tone = thi + n_all;
  if (!dense) {
    for (int kt = warp; kt < n_all; kt += kWarps) {
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
  if (warp == 0) {  // the visited tiles in order, each marked full or not
    const int qlo = red[0], qhi = red[1], pmax = red[2], pmin = red[3];
    const bool qall = red[4] != 0 && qlo == qhi;  // every row of the tile has one segment
    int n_kt = n_all;
    if (a.causal) n_kt = min(n_kt, pmax < 0 ? 0 : pmax / kBK + 1);
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
               (!a.causal || k0 + kBK - 1 <= pmin);
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) tiles[count + __popc(m & ((1u << lane) - 1u))] = kt * 2 + (full ? 1 : 0);
      count += __popc(m);
    }
    if (lane == 0) red[5] = count;
  }
  __syncthreads();
  const int n_tiles = red[5];

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

    // mask: a key no row of the tile may see is -inf (a full tile has none)
    if (!full) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * t4 + (e & 1);
          const int t = k0 + j;
          const int hh = e >> 1;
          bool ok = t < skv;
          if (!dense) ok = ok && rseg[hh] >= 0 && rseg[hh] == kss[j];
          if (a.causal) ok = ok && t <= rpos[hh];
          if (!ok) s[n][e] = kMinusInf;
        }
    }

    // online softmax in the log2 domain, a row's 64 scores over its quad:
    // p = 2^(s * scale - m) as one fma, so a masked key gives exactly 0
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kMinusInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx * a.scale_log2);
      // a row that has seen no key keeps m = -inf and p = 0 (alpha 0 wipes nothing)
      m_use[hh] = m_new == kMinusInf ? 0.f : m_new;
      alpha[hh] = fast_exp2(m_run[hh] - m_use[hh]);
      m_run[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * hh] *= alpha[hh];
        o[n][2 * hh + 1] *= alpha[hh];
      }
    }

    // O += P V, 16 keys at a time: the exponentials of the next 16 keys
    // overlap this step's products; P goes from the score registers to
    // bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int n = 2 * kk; n < 2 * kk + 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[n][e], a.scale_log2, -m_use[e >> 1]));
          s[n][e] = p;
          sum[e >> 1] += p;
        }
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + np * 16 +
                              (lane >> 4) * 8);
        mma_16816(o[2 * np], pa, bf[0], bf[1]);
        mma_16816(o[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
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

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 micro-tiles
constexpr int kMaxDv = 128;
constexpr int kMaxNv = kMaxDv / 16;  // output columns per thread: tx + 16 * n
constexpr int kMaxDqk = 256;

struct Args {
  const int8_t* q;
  const int8_t* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* qseg;  // [B, Sq] or null when dense
  const int* kseg;  // [B, Skv] or null when dense
  const int* qpos;  // [B, Sq] global q slots (K9) or null: q row s is slot s
  const float* qsc;  // [B, Hq, Sq] per-row q scales
  const float* ksc;  // [B, Hkv, Skv] per-row k scales
  int group, sq, skv, dqk, dv;
  int q_sb, q_sh, q_ss;  // element strides of batch, head, sequence
  int k_sb, k_sh, k_ss;
  int v_sb, v_sh, v_ss;
  int o_sb, o_sh, o_ss;
  float scale_log2;  // log2(e) / sqrt(dqk)
  int causal;
};

// int8 q/k row stride in shared memory: the head dim rounded up to 4 bytes,
// plus 4, an odd number of 32-bit words for dqk = 0 mod 8
__host__ __device__ constexpr int ld_i8(int dqk) { return (dqk + 3) / 4 * 4 + 4; }

template <bool PV8>
__global__ void __launch_bounds__(kThreads) flash_attention_i8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q, k tiles [kBQ|kBK][ld_i8(dqk)] int8
  const int ldq = ld_i8(a.dqk);
  int8_t* qs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* ks = qs + kBQ * ldq;
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(ks + kBK * ldq);  // [kBK][dv]
  float* ps = reinterpret_cast<float*>(vs + kBK * a.dv);            // [kBQ][kBK + 1]
  float* m_s = ps + kBQ * (kBK + 1);                                // [kBQ] running max
  float* l_s = m_s + kBQ;                                           // [kBQ] running sum
  float* al_s = l_s + kBQ;                                          // [kBQ] rescale
  int* qseg_s = reinterpret_cast<int*>(al_s + kBQ);                 // [kBQ]
  int* kseg_s = qseg_s + kBQ;                                       // [kBK]
  int* qrange = kseg_s + kBK;                                       // [4] min, max seg, max pos
  int* qpos_s = qrange + 4;                                         // [kBQ] causal slot
  float* qsc_s = reinterpret_cast<float*>(qpos_s + kBQ);            // [kBQ]
  float* ksc_s = qsc_s + kBQ;                                       // [kBK]
  float* vsc_s = ksc_s + kBK;                                       // [kMaxDv] (PV8)
  int8_t* vq = reinterpret_cast<int8_t*>(vsc_s + kMaxDv);           // [kBK][dv] (PV8)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const bool dense = a.qseg == nullptr;

  const long q_off = (long)b * a.q_sb + (long)h * a.q_sh;
  const long k_off = (long)b * a.k_sb + (long)kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + (long)b * a.v_sb + (long)kvh * a.v_sh;

  {
    const int8_t* qg = a.q + q_off;
    for (int idx = tid; idx < kBQ * ldq; idx += kThreads) {
      const int r = idx / ldq, c = idx - r * ldq;
      const int s = q0 + r;
      qs[idx] = (s < a.sq && c < a.dqk) ? qg[(long)s * a.q_ss + c] : (int8_t)0;
    }
  }
  if (tid < kBQ) {
    const int s = q0 + tid;
    int seg = -1;
    if (s < a.sq) seg = dense ? 0 : a.qseg[(long)b * a.sq + s];
    qseg_s[tid] = seg;
    // a row past Sq gets -1: it allows no key and never raises the tile's limit
    qpos_s[tid] = s < a.sq ? (a.qpos != nullptr ? a.qpos[(long)b * a.sq + s] : s) : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    // q_scale * sm_scale * log2(e), the product JAX forms first (:111)
    qsc_s[tid] = s < a.sq ? a.qsc[((long)b * gridDim.y + h) * a.sq + s] * a.scale_log2 : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = -1, pmax = -1;
    for (int r = 0; r < kBQ; ++r) {
      const int seg = qseg_s[r];
      if (seg >= 0) {
        lo = min(lo, seg);
        hi = max(hi, seg);
      }
      pmax = max(pmax, qpos_s[r]);
    }
    qrange[0] = lo;
    qrange[1] = hi;
    qrange[2] = pmax;
  }
  __syncthreads();
  const int qlo = qrange[0], qhi = qrange[1];

  float acc[4][kMaxNv];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < kMaxNv; ++n) acc[r][n] = 0.f;

  int n_kt = (a.skv + kBK - 1) / kBK;
  // causal: no k tile past the tile's largest q slot (-1: no row, no tile)
  if (a.causal) n_kt = min(n_kt, qrange[2] < 0 ? 0 : qrange[2] / kBK + 1);
  if (qhi < 0) n_kt = 0;  // every row of the tile is padding: all zeros

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's smem is no longer read
    bool hit = false;
    if (tid < kBK) {
      const int t = k0 + tid;
      int seg = -2;
      if (t < a.skv) seg = dense ? 0 : a.kseg[(long)b * a.skv + t];
      kseg_s[tid] = seg;
      hit = seg >= 0 && seg >= qlo && seg <= qhi;
    }
    if (!__syncthreads_or(hit)) continue;  // no key segment meets this q tile

    {
      const int8_t* kg = a.k + k_off;
      for (int idx = tid; idx < kBK * ldq; idx += kThreads) {
        const int r = idx / ldq, c = idx - r * ldq;
        const int t = k0 + r;
        ks[idx] = (t < a.skv && c < a.dqk) ? kg[(long)t * a.k_ss + c] : (int8_t)0;
      }
      if (tid < kBK) {
        const int t = k0 + tid;
        ksc_s[tid] = t < a.skv ? a.ksc[((long)b * (gridDim.y / a.group) + kvh) * a.skv + t] : 0.f;
      }
    }
    for (int idx = tid; idx < kBK * a.dv; idx += kThreads) {
      const int r = idx / a.dv, c = idx - r * a.dv;
      const int t = k0 + r;
      vs[r * a.dv + c] = t < a.skv ? vg[(long)t * a.v_ss + c] : __float2bfloat16(0.f);
    }
    __syncthreads();

    if constexpr (PV8) {
      // v per column over this tile's rows (zero rows past Skv change no
      // amax), then v quantized to int8 (JAX :147-150)
      for (int c = tid; c < a.dv; c += kThreads) {
        float amax = 0.f;
        for (int j = 0; j < kBK; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(vs[j * a.dv + c])));
        vsc_s[c] = fmaxf(amax, 1e-8f) / 127.f;
      }
      __syncthreads();
      for (int idx = tid; idx < kBK * a.dv; idx += kThreads) {
        const int c = idx % a.dv;
        const float q = rintf(__bfloat162float(vs[idx]) / vsc_s[c]);
        vq[idx] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
      }
    }

    float s[4][4];
    {
      int si[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) si[r][c] = 0;
      for (int d = 0; d < ldq - 4; d += 4) {
        int qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const int*>(qs + (ty + 16 * r) * ldq + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const int*>(ks + (tx + 16 * c) * ldq + d);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) si[r][c] = __dp4a(qv[r], kv[c], si[r][c]);
      }
      // the rank-1 rescale, in JAX's order: (s * (q_scale * scale2)) * k_scale
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] = (float)si[r][c] * qsc_s[ty + 16 * r] * ksc_s[tx + 16 * c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const int qseg = qseg_s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kseg = kseg_s[j];
        bool allowed = k0 + j < a.skv;
        if (!dense) allowed = allowed && qseg >= 0 && qseg == kseg;
        if (a.causal) allowed = allowed && k0 + j <= qpos_s[i];
        ps[i * (kBK + 1) + j] = allowed ? s[r][c] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax in the log2 domain, one warp per row
    for (int i = warp; i < kBQ; i += kThreads / 32) {
      float* row = ps + i * (kBK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        al_s[i] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = al_s[ty + 16 * r];
#pragma unroll
      for (int n = 0; n < kMaxNv; ++n) acc[r][n] *= alpha;
    }
    if constexpr (PV8) {
      // p in [0, 1] at the static scale 1/127, an int32 sum over the tile
      int pacc[4][kMaxNv];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < kMaxNv; ++n) pacc[r][n] = 0;
      for (int j = 0; j < kBK; ++j) {
        int pr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = (int)rintf(ps[(ty + 16 * r) * (kBK + 1) + j] * 127.f);
#pragma unroll
        for (int n = 0; n < kMaxNv; ++n) {
          const int c = tx + 16 * n;
          if (c < a.dv) {
            const int vv = vq[j * a.dv + c];
#pragma unroll
            for (int r = 0; r < 4; ++r) pacc[r][n] += pr[r] * vv;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxNv; ++n) {
        const int c = tx + 16 * n;
        if (c < a.dv) {
          const float vscale = vsc_s[c] * (1.f / 127.f);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][n] += (float)pacc[r][n] * vscale;
        }
      }
    } else {
      for (int j = 0; j < kBK; ++j) {
        float pr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = ps[(ty + 16 * r) * (kBK + 1) + j];
#pragma unroll
        for (int n = 0; n < kMaxNv; ++n) {
          const int c = tx + 16 * n;
          if (c < a.dv) {
            const float vv = __bfloat162float(vs[j * a.dv + c]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][n] += pr[r] * vv;
          }
        }
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* og = a.o + (long)b * a.o_sb + (long)h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const int s = q0 + i;
    if (s >= a.sq) continue;
    const float inv = 1.f / fmaxf(l_s[i], 1e-30f);
    const bool seen = m_s[i] > kNegInf * 0.5f;  // a row that saw no allowed key writes 0
#pragma unroll
    for (int n = 0; n < kMaxNv; ++n) {
      const int c = tx + 16 * n;
      if (c < a.dv) og[(long)s * a.o_ss + c] = __float2bfloat16(seen ? acc[r][n] * inv : 0.f);
    }
  }
}

size_t smem_bytes_i8(bool pv8, int dqk, int dv) {
  size_t n = (size_t)(kBQ + kBK) * ld_i8(dqk) + (size_t)kBK * dv * 2 +
             (size_t)kBQ * (kBK + 1) * 4 + 3 * kBQ * 4 + (kBQ + kBK + 4 + kBQ) * 4 +
             (size_t)(kBQ + kBK + kMaxDv) * 4;
  if (pv8) n += (size_t)kBK * dv;
  return n;
}

template <bool PV8>
int launch_i8(const Args& a, int batch, int heads_q, int sq, void* stream) {
  const size_t smem = smem_bytes_i8(PV8, a.dqk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_i8_kernel<PV8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads_q, batch);
  flash_attention_i8_kernel<PV8><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

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

// K7: q, k int8 [B, H, S, Dqk] (strided like q, k above) with f32 per-row
// scales q_scale [B, Hq, Sq] and k_scale [B, Hkv, Skv] (contiguous); v, o bf16.
// With qpos (causal only) it is K9-int8.
extern "C" int flash_attention_i8(const void* q, const void* k, const void* v, void* o,
                                  const void* q_scale, const void* k_scale, const void* qseg,
                                  const void* kseg, const void* qpos, int batch, int heads_q, int heads_kv,
                                  int sq, int skv, int dqk, int dv, int q_sb, int q_sh,
                                  int q_ss, int k_sb, int k_sh, int k_ss, int v_sb, int v_sh,
                                  int v_ss, int o_sb, int o_sh, int o_ss, int causal,
                                  int pv_int8, void* stream) {
  if (q_scale == nullptr || k_scale == nullptr || heads_kv <= 0 || heads_q % heads_kv != 0 ||
      dv <= 0 || dv > kMaxDv || dqk <= 0 || dqk > kMaxDqk ||
      (qseg == nullptr) != (kseg == nullptr) || (qpos != nullptr && !causal) ||
      (qpos == nullptr && causal && sq != skv))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const int8_t*)q;
  a.k = (const int8_t*)k;
  a.v = (const __nv_bfloat16*)v;
  a.o = (__nv_bfloat16*)o;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.qpos = (const int*)qpos;
  a.qsc = (const float*)q_scale;
  a.ksc = (const float*)k_scale;
  a.group = heads_q / heads_kv;
  a.sq = sq;
  a.skv = skv;
  a.dqk = dqk;
  a.dv = dv;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)dqk);
  a.causal = causal;
  return pv_int8 ? launch_i8<true>(a, batch, heads_q, sq, stream)
                 : launch_i8<false>(a, batch, heads_q, sq, stream);
}
