// Flash attention forward (bf16 in and out, fp32 softmax and accumulators).
//
// Replaces the forward of the Pallas kernel `flash_attention`
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
// head dim may differ (the fuser runs 192/64), so v is never padded.
//
// What bounds it on the H100: at the main-path shapes (ViT full attention
// over a few thousand patches, the LLM's causal prefill, the fuser) the
// products dominate: 4*S^2*D FLOP per head against O(S*D) bytes, far above
// the card's ridge point, so this is a compute-bound kernel. The design is
// the simple online-softmax schedule: one block per (batch, q head, 64-row
// q tile) loops over 64-row k/v tiles held in shared memory (bf16, padded
// rows so the column walks hit distinct banks), each thread keeps a 4x4
// score micro-tile and a 4 x ceil(Dv/16) output tile in registers, and whole k
// tiles are skipped when they are above the causal diagonal or when no key
// segment falls inside the q tile's segment range. The products run on
// CUDA cores in fp32; mma.sync / wgmma tiles and TMA loads are later work.
//
// K7, the int8 serving flavour (entry `flash_attention_i8`), replaces the
// Pallas adapters `_i8_kernel_adapter` (flash_attention.py:175) and
// `_i8_dense_kernel_adapter` (:200) with the per-row quantization
// `_quant_rows_i8` (:232) done outside by the wrapper, as in JAX. q and k
// arrive as int8 with f32 per-row scales; QK^T is an int32 product
// (__dp4a over 4 bytes at a time; the head dim is zero-padded to a multiple
// of 4 in shared memory) rescaled by q_scale * sm_scale * log2(e) * k_scale
// (the Pallas kernel's :103-111). With `pv_int8` the probabilities are
// quantized with the static scale 1/127 and each kv tile's v per column
// (amax / 127 over the tile's rows, :139-155); the PV product is then an
// int32 sum per tile, rescaled by v_scale / 127. So the numbers depend on
// the kv tile length, 64 here: the plain version takes it as an argument.
// The rest (online softmax, tile skipping, zeroed empty rows) is K2's.
//
// K9, the `q_positions` flavour (entries' `qpos` argument, [B, Sq] int32 or
// null), replaces the Pallas adapters `_qpos_kernel_adapter` (:183),
// `_i8_qpos_kernel_adapter` (:191) and `_qpos_lse_kernel_adapter` (:216):
// the q rows are a shard of a longer sequence (sequence parallelism), k and
// v are the whole sequence in slot order, and causal allows key t for query
// s iff t <= qpos[b, s], the row's global slot. The causal tile limit then
// comes from the largest position in the q tile (JAX :71-72), not from q0;
// each row's k tiles are visited in the same order as in a monolithic call
// over the whole sequence, so a shard's rows equal the monolithic call's
// bit for bit (the tiles past a row's diagonal add exact zeros). It is
// bounded like K2: a q shard of Sq/n rows against Skv keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 micro-tiles
constexpr int kMaxDv = 128;
constexpr int kMaxNv = kMaxDv / 16;  // output columns per thread: tx + 16 * n
constexpr int kMaxDqk = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;        // bf16, or int8 in the int8 flavour
  const void* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;       // [B, Hq, Sq] or null
  const int* qseg;  // [B, Sq] or null when dense
  const int* kseg;  // [B, Skv] or null when dense
  const int* qpos;  // [B, Sq] global q slots (K9) or null: q row s is slot s
  const float* qsc;  // [B, Hq, Sq] per-row q scales (int8 flavour)
  const float* ksc;  // [B, Hkv, Skv] per-row k scales (int8 flavour)
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

template <bool QK8, bool PV8>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16: q, k tiles [kBQ|kBK][dqk + 2] bf16 (an odd number of 32-bit
  // words); int8: [kBQ|kBK][ld_i8(dqk)] int8
  const int ldq = QK8 ? ld_i8(a.dqk) : a.dqk + 2;
  const int esz = QK8 ? 1 : 2;
  unsigned char* qs_raw = smem_raw;
  unsigned char* ks_raw = qs_raw + kBQ * ldq * esz;
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(ks_raw + kBK * ldq * esz);  // [kBK][dv]
  float* ps = reinterpret_cast<float*>(vs + kBK * a.dv);            // [kBQ][kBK + 1]
  float* m_s = ps + kBQ * (kBK + 1);                                // [kBQ] running max
  float* l_s = m_s + kBQ;                                           // [kBQ] running sum
  float* al_s = l_s + kBQ;                                          // [kBQ] rescale
  int* qseg_s = reinterpret_cast<int*>(al_s + kBQ);                 // [kBQ]
  int* kseg_s = qseg_s + kBQ;                                       // [kBK]
  int* qrange = kseg_s + kBK;                                       // [4] min, max seg, max pos
  int* qpos_s = qrange + 4;                                         // [kBQ] causal slot
  float* qsc_s = reinterpret_cast<float*>(qpos_s + kBQ);            // [kBQ] (QK8)
  float* ksc_s = qsc_s + kBQ;                                       // [kBK] (QK8)
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

  if constexpr (QK8) {
    const int8_t* qg = reinterpret_cast<const int8_t*>(a.q) + q_off;
    int8_t* qs = reinterpret_cast<int8_t*>(qs_raw);
    for (int idx = tid; idx < kBQ * ldq; idx += kThreads) {
      const int r = idx / ldq, c = idx - r * ldq;
      const int s = q0 + r;
      qs[idx] = (s < a.sq && c < a.dqk) ? qg[(long)s * a.q_ss + c] : (int8_t)0;
    }
  } else {
    const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(a.q) + q_off;
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(qs_raw);
    for (int idx = tid; idx < kBQ * a.dqk; idx += kThreads) {
      const int r = idx / a.dqk, c = idx - r * a.dqk;
      const int s = q0 + r;
      qs[r * ldq + c] = s < a.sq ? qg[(long)s * a.q_ss + c] : __float2bfloat16(0.f);
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
    if constexpr (QK8)
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

    if constexpr (QK8) {
      const int8_t* kg = reinterpret_cast<const int8_t*>(a.k) + k_off;
      int8_t* ks = reinterpret_cast<int8_t*>(ks_raw);
      for (int idx = tid; idx < kBK * ldq; idx += kThreads) {
        const int r = idx / ldq, c = idx - r * ldq;
        const int t = k0 + r;
        ks[idx] = (t < a.skv && c < a.dqk) ? kg[(long)t * a.k_ss + c] : (int8_t)0;
      }
      if (tid < kBK) {
        const int t = k0 + tid;
        ksc_s[tid] = t < a.skv ? a.ksc[((long)b * (gridDim.y / a.group) + kvh) * a.skv + t] : 0.f;
      }
    } else {
      const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(a.k) + k_off;
      __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ks_raw);
      for (int idx = tid; idx < kBK * a.dqk; idx += kThreads) {
        const int r = idx / a.dqk, c = idx - r * a.dqk;
        const int t = k0 + r;
        ks[r * ldq + c] = t < a.skv ? kg[(long)t * a.k_ss + c] : __float2bfloat16(0.f);
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
    if constexpr (QK8) {
      const int8_t* qs = reinterpret_cast<const int8_t*>(qs_raw);
      const int8_t* ks = reinterpret_cast<const int8_t*>(ks_raw);
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
    } else {
      const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(qs_raw);
      const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(ks_raw);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      for (int d = 0; d < a.dqk; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = __bfloat162float(qs[(ty + 16 * r) * ldq + d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = __bfloat162float(ks[(tx + 16 * c) * ldq + d]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] *= a.scale_log2;
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
    const float m = m_s[i];
    const float inv = 1.f / fmaxf(l_s[i], 1e-30f);
    const bool seen = m > kNegInf * 0.5f;  // a row that saw no allowed key writes 0
#pragma unroll
    for (int n = 0; n < kMaxNv; ++n) {
      const int c = tx + 16 * n;
      if (c < a.dv) og[(long)s * a.o_ss + c] = __float2bfloat16(seen ? acc[r][n] * inv : 0.f);
    }
    if (a.lse != nullptr && tx == 0)
      a.lse[((long)b * gridDim.y + h) * a.sq + s] =
          seen ? m + log2f(fmaxf(l_s[i], 1e-30f)) : kNegInf;
  }
}

size_t smem_bytes(bool qk8, bool pv8, int dqk, int dv) {
  const size_t qk = qk8 ? (size_t)(kBQ + kBK) * ld_i8(dqk) : (size_t)(kBQ + kBK) * (dqk + 2) * 2;
  size_t n = qk + (size_t)kBK * dv * 2 + (size_t)kBQ * (kBK + 1) * 4 + 3 * kBQ * 4 +
             (kBQ + kBK + 4 + kBQ) * 4 + (size_t)(kBQ + kBK + kMaxDv) * 4;
  if (pv8) n += (size_t)kBK * dv;
  return n;
}

template <bool QK8, bool PV8>
int launch(const Args& a, int batch, int heads_q, int sq, void* stream) {
  const size_t smem = smem_bytes(QK8, PV8, a.dqk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<QK8, PV8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads_q, batch);
  flash_attention_kernel<QK8, PV8><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int fill_args(Args& a, const void* q, const void* k, const void* v, void* o, void* lse,
              const void* qseg, const void* kseg, const void* qpos, const void* qsc,
              const void* ksc, int heads_q, int heads_kv, int sq, int skv, int dqk, int dv, int q_sb,
              int q_sh, int q_ss, int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
              int o_sb, int o_sh, int o_ss, int causal) {
  if (heads_kv <= 0 || heads_q % heads_kv != 0 || dv <= 0 || dv > kMaxDv ||
      dqk <= 0 || dqk > kMaxDqk || (qseg == nullptr) != (kseg == nullptr) ||
      (qpos != nullptr && !causal) || (qpos == nullptr && causal && sq != skv))
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = (const __nv_bfloat16*)v;
  a.o = (__nv_bfloat16*)o;
  a.lse = (float*)lse;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.qpos = (const int*)qpos;
  a.qsc = (const float*)qsc;
  a.ksc = (const float*)ksc;
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
  return 0;
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* qseg, const void* kseg,
                                    const void* qpos, int batch,
                                    int heads_q, int heads_kv, int sq, int skv, int dqk,
                                    int dv, int q_sb, int q_sh, int q_ss, int k_sb,
                                    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
                                    int o_sb, int o_sh, int o_ss, int causal,
                                    void* stream) {
  Args a;
  const int rc = fill_args(a, q, k, v, o, lse, qseg, kseg, qpos, nullptr, nullptr, heads_q,
                           heads_kv, sq, skv, dqk, dv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                           v_sh, v_ss, o_sb, o_sh, o_ss, causal);
  if (rc != 0) return rc;
  return launch<false, false>(a, batch, heads_q, sq, stream);
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
  if (q_scale == nullptr || k_scale == nullptr) return (int)cudaErrorInvalidValue;
  Args a;
  const int rc = fill_args(a, q, k, v, o, nullptr, qseg, kseg, qpos, q_scale, k_scale, heads_q,
                           heads_kv, sq, skv, dqk, dv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal);
  if (rc != 0) return rc;
  return pv_int8 ? launch<true, true>(a, batch, heads_q, sq, stream)
                 : launch<true, false>(a, batch, heads_q, sq, stream);
}
