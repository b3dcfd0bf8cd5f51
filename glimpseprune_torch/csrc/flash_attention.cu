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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;       // [B, Hq, Sq] or null
  const int* qseg;  // [B, Sq] or null when dense
  const int* kseg;  // [B, Skv] or null when dense
  int group, sq, skv, dqk, dv;
  int q_sb, q_sh, q_ss;  // element strides of batch, head, sequence
  int k_sb, k_sh, k_ss;
  int v_sb, v_sh, v_ss;
  int o_sb, o_sh, o_ss;
  float scale_log2;  // log2(e) / sqrt(dqk)
  int causal;
};

__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = a.dqk + 2;  // bf16 row stride: an odd number of 32-bit words
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][ldq]
  __nv_bfloat16* ks = qs + kBQ * ldq;                               // [kBK][ldq]
  __nv_bfloat16* vs = ks + kBK * ldq;                               // [kBK][dv]
  float* ps = reinterpret_cast<float*>(vs + kBK * a.dv);            // [kBQ][kBK + 1]
  float* m_s = ps + kBQ * (kBK + 1);                                // [kBQ] running max
  float* l_s = m_s + kBQ;                                           // [kBQ] running sum
  float* al_s = l_s + kBQ;                                          // [kBQ] rescale
  int* qseg_s = reinterpret_cast<int*>(al_s + kBQ);                 // [kBQ]
  int* kseg_s = qseg_s + kBQ;                                       // [kBK]
  int* qrange = kseg_s + kBK;                                       // [2] min, max

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const bool dense = a.qseg == nullptr;

  const __nv_bfloat16* qg = a.q + (long)b * a.q_sb + (long)h * a.q_sh;
  const __nv_bfloat16* kg = a.k + (long)b * a.k_sb + (long)kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + (long)b * a.v_sb + (long)kvh * a.v_sh;

  for (int idx = tid; idx < kBQ * a.dqk; idx += kThreads) {
    const int r = idx / a.dqk, c = idx - r * a.dqk;
    const int s = q0 + r;
    qs[r * ldq + c] = s < a.sq ? qg[(long)s * a.q_ss + c] : __float2bfloat16(0.f);
  }
  if (tid < kBQ) {
    const int s = q0 + tid;
    int seg = -1;
    if (s < a.sq) seg = dense ? 0 : a.qseg[(long)b * a.sq + s];
    qseg_s[tid] = seg;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = -1;
    for (int r = 0; r < kBQ; ++r) {
      const int seg = qseg_s[r];
      if (seg >= 0) {
        lo = min(lo, seg);
        hi = max(hi, seg);
      }
    }
    qrange[0] = lo;
    qrange[1] = hi;
  }
  __syncthreads();
  const int qlo = qrange[0], qhi = qrange[1];

  float acc[4][kMaxNv];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < kMaxNv; ++n) acc[r][n] = 0.f;

  int n_kt = (a.skv + kBK - 1) / kBK;
  if (a.causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
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

    for (int idx = tid; idx < kBK * a.dqk; idx += kThreads) {
      const int r = idx / a.dqk, c = idx - r * a.dqk;
      const int t = k0 + r;
      ks[r * ldq + c] = t < a.skv ? kg[(long)t * a.k_ss + c] : __float2bfloat16(0.f);
    }
    for (int idx = tid; idx < kBK * a.dv; idx += kThreads) {
      const int r = idx / a.dv, c = idx - r * a.dv;
      const int t = k0 + r;
      vs[r * a.dv + c] = t < a.skv ? vg[(long)t * a.v_ss + c] : __float2bfloat16(0.f);
    }
    __syncthreads();

    float s[4][4];
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
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const int qseg = qseg_s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kseg = kseg_s[j];
        bool allowed = k0 + j < a.skv;
        if (!dense) allowed = allowed && qseg >= 0 && qseg == kseg;
        if (a.causal) allowed = allowed && k0 + j <= q0 + i;
        ps[i * (kBK + 1) + j] = allowed ? s[r][c] * a.scale_log2 : kNegInf;
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

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* qseg, const void* kseg, int batch,
                                    int heads_q, int heads_kv, int sq, int skv, int dqk,
                                    int dv, int q_sb, int q_sh, int q_ss, int k_sb,
                                    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
                                    int o_sb, int o_sh, int o_ss, int causal,
                                    void* stream) {
  if (heads_kv <= 0 || heads_q % heads_kv != 0 || dv <= 0 || dv > kMaxDv ||
      dqk <= 0 || dqk > kMaxDqk || (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.o = (__nv_bfloat16*)o;
  a.lse = (float*)lse;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
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
  const size_t smem = (size_t)(kBQ + kBK) * (dqk + 2) * 2 + (size_t)kBK * dv * 2 +
                      (size_t)kBQ * (kBK + 1) * 4 + 3 * kBQ * 4 + (kBQ + kBK + 2) * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads_q, batch);
  flash_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
