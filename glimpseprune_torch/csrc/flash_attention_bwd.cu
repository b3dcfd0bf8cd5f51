// Flash attention backward (bf16 in and out, fp32 accumulators): K3.
//
// Replaces the Pallas backward `_flash_bwd_impl`
// (glimpseprune_tpu/ops/pallas/flash_attention.py:808, kernels `_bwd_dq_kernel`
// :697 and `_bwd_dkv_kernel` :739, shared tile `_bwd_tile` :665).
//
// Semantics, as in the Pallas kernels: the probability tile is recomputed
// from q, k and the forward's log2-domain LSE (csrc/flash_attention.cu),
// p = exp2(s * log2(e) / sqrt(Dqk) - lse), with the forward's masks (segment
// ids, or none when dense; causal slot order), and a row whose LSE is -1e30
// (it saw no allowed key) has p = 0. With dsum = rowsum(dO * O) (computed by
// the caller) and ds = p * (dO V^T - dsum):
//   dq = ds K / sqrt(Dqk),  dk = ds^T Q / sqrt(Dqk),  dv = p^T dO,
// dk and dv summed over the q heads of each GQA group.
//
// Two kernels. `dq`: one block per (batch, q head, 64-row q tile) walks the
// k tiles. `dkv`: one block per (batch, kv head, 64-row k tile) walks every q
// head of its GQA group and every q tile, so dk and dv of a key row are
// summed inside one block in a fixed order: no atomics, no per-q-head buffers
// summed afterwards (the Pallas design at :908-911), and the result does not
// change from run to run. Tiles above the causal diagonal, and tiles whose
// q and k segment ranges do not meet, are skipped in both kernels. The qk
// and v head dims are separate arguments, so the fuser's 192/64 is read as
// it is, and q, k, v, dO, dq, dk, dv are strided [B, S, H, D] views.
//
// What bounds it on the H100: at the main-path shapes (the LLM's causal GQA
// layers, q [2, 28, ~830, 128]; the fuser's [2, 4, ~770, 192/64]) the work
// is 2 * (3*Dqk + 2*Dv) FLOPs per allowed (q, k) pair per q head against
// O(S * D) bytes, far above the card's ridge point: it is compute-bound.
// This first version multiplies on CUDA cores in fp32 (16 x 16 threads, each
// with 4 x 4 score micro-tiles and 4 x ceil(D/16) accumulators in
// registers), recomputing the score tile in both kernels as the Pallas
// design does; mma.sync / wgmma tiles are later work. The dkv grid is small
// at the LLM shape (13 k tiles x 4 kv heads x 2 rows = 104 blocks for 132
// SMs), the price of summing the GQA group without atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kB = 64;          // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 micro-tiles
constexpr int kLdP = kB + 1;    // fp32 row stride of the p / ds tiles
constexpr int kMaxDqk = 256;
constexpr int kMaxDv = 128;

using bf16 = __nv_bfloat16;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;   // [B, Hq, Sq]
  const float* dsum;  // [B, Hq, Sq]
  const int* qseg;    // [B, Sq] or null when dense
  const int* kseg;    // [B, Skv] or null when dense
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int heads_q, group, sq, skv, dqk, dvd;
  int q_sb, q_sh, q_ss;  // element strides of batch, head, sequence
  int k_sb, k_sh, k_ss;
  int v_sb, v_sh, v_ss;
  int do_sb, do_sh, do_ss;
  int dq_sb, dq_sh, dq_ss;
  int dk_sb, dk_sh, dk_ss;
  int dv_sb, dv_sh, dv_ss;
  float scale;       // 1 / sqrt(dqk)
  float scale_log2;  // log2(e) / sqrt(dqk)
  int causal;
};

// rows [r0, r0 + kB) of a strided [S, cols] matrix into smem [kB][ld], zero past n
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int row_stride,
                                          int r0, int n, int cols) {
  for (int idx = threadIdx.x; idx < kB * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    const int s = r0 + r;
    dst[r * ld + c] = s < n ? src[(long)s * row_stride + c] : __float2bfloat16(0.f);
  }
}

// acc[r][c] = sum_d A[ty + 16r][d] * B[tx + 16c][d]
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int depth, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int d = 0; d < depth; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = __bfloat162float(a[(ty + 16 * r) * lda + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = __bfloat162float(b[(tx + 16 * c) * ldb + d]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
  }
}

// segment id of row s of batch b: -1 past the q end, -2 past the k end, 0 when dense
__device__ __forceinline__ int seg_at(const int* seg, int b, int s, int n, int pad) {
  if (s >= n) return pad;
  return seg == nullptr ? 0 : seg[(long)b * n + s];
}

// p and ds of one 64 x 64 (q, k) tile pair, from the score micro-tile s and
// dp = dO V^T; rows i = ty + 16r are q rows, columns j = tx + 16c are k rows
__device__ __forceinline__ void p_ds_tile(const BwdArgs& a, const float (&s)[4][4],
                                          const float (&dp)[4][4], const int* qseg_s,
                                          const int* kseg_s, const float* lse_s,
                                          const float* dsum_s, int q0, int k0, int ty, int tx,
                                          float* p_s, float* ds_s) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const int qs = qseg_s[i];
    const float lse = lse_s[i];
    const float dsum = dsum_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      bool allowed = qs >= 0 && qs == kseg_s[j] && lse > kNegInf * 0.5f;
      if (a.causal) allowed = allowed && k0 + j <= q0 + i;
      const float p = allowed ? exp2f(s[r][c] * a.scale_log2 - lse) : 0.f;
      if (p_s != nullptr) p_s[i * kLdP + j] = p;
      ds_s[i * kLdP + j] = p * (dp[r][c] - dsum);
    }
  }
}

template <int NQK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = a.dqk + 2, ldv = a.dvd + 2;  // odd 32-bit word strides for even D % 4 == 0
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kB][ldq]
  bf16* dos = qs + kB * ldq;                      // [kB][ldv]
  bf16* ks = dos + kB * ldv;                      // [kB][ldq]
  bf16* vs = ks + kB * ldq;                       // [kB][ldv]
  float* ds_s = reinterpret_cast<float*>(vs + kB * ldv);  // [kB][kLdP]
  float* lse_s = ds_s + kB * kLdP;
  float* dsum_s = lse_s + kB;
  int* qseg_s = reinterpret_cast<int*>(dsum_s + kB);
  int* kseg_s = qseg_s + kB;
  int* qrange = kseg_s + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const long row = ((long)b * a.heads_q + h) * a.sq;

  load_tile(qs, ldq, a.q + (long)b * a.q_sb + (long)h * a.q_sh, a.q_ss, q0, a.sq, a.dqk);
  load_tile(dos, ldv, a.dout + (long)b * a.do_sb + (long)h * a.do_sh, a.do_ss, q0, a.sq, a.dvd);
  if (tid < kB) {
    const int s = q0 + tid;
    qseg_s[tid] = seg_at(a.qseg, b, s, a.sq, -1);
    lse_s[tid] = s < a.sq ? a.lse[row + s] : kNegInf;
    dsum_s[tid] = s < a.sq ? a.dsum[row + s] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = -1;
    for (int r = 0; r < kB; ++r) {
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

  float acc[4][NQK];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < NQK; ++n) acc[r][n] = 0.f;

  int n_kt = (a.skv + kB - 1) / kB;
  if (a.causal) n_kt = min(n_kt, (q0 + kB - 1) / kB + 1);
  if (qhi < 0) n_kt = 0;  // every row of the tile is padding: dq = 0

  const bf16* kg = a.k + (long)b * a.k_sb + (long)kvh * a.k_sh;
  const bf16* vg = a.v + (long)b * a.v_sb + (long)kvh * a.v_sh;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's smem is no longer read
    bool hit = false;
    if (tid < kB) {
      const int seg = seg_at(a.kseg, b, k0 + tid, a.skv, -2);
      kseg_s[tid] = seg;
      hit = seg >= 0 && seg >= qlo && seg <= qhi;
    }
    if (!__syncthreads_or(hit)) continue;  // no key segment meets this q tile
    load_tile(ks, ldq, kg, a.k_ss, k0, a.skv, a.dqk);
    load_tile(vs, ldv, vg, a.v_ss, k0, a.skv, a.dvd);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(s, qs, ldq, ks, ldq, a.dqk, ty, tx);
    tile_dot(dp, dos, ldv, vs, ldv, a.dvd, ty, tx);
    p_ds_tile(a, s, dp, qseg_s, kseg_s, lse_s, dsum_s, q0, k0, ty, tx, nullptr, ds_s);
    __syncthreads();

    for (int j = 0; j < kB; ++j) {
      float dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dr[r] = ds_s[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int n = 0; n < NQK; ++n) {
        const int c = tx + 16 * n;
        if (c < a.dqk) {
          const float kv = __bfloat162float(ks[j * ldq + c]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][n] += dr[r] * kv;
        }
      }
    }
  }

  bf16* dqg = a.dq + (long)b * a.dq_sb + (long)h * a.dq_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + ty + 16 * r;
    if (s >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < NQK; ++n) {
      const int c = tx + 16 * n;
      if (c < a.dqk) dqg[(long)s * a.dq_ss + c] = __float2bfloat16(acc[r][n] * a.scale);
    }
  }
}

template <int NQK, int NV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = a.dqk + 2, ldv = a.dvd + 2;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kB][ldq]
  bf16* vs = ks + kB * ldq;                       // [kB][ldv]
  bf16* qs = vs + kB * ldv;                       // [kB][ldq]
  bf16* dos = qs + kB * ldq;                      // [kB][ldv]
  float* p_s = reinterpret_cast<float*>(dos + kB * ldv);  // [kB][kLdP]
  float* ds_s = p_s + kB * kLdP;                                            // [kB][kLdP]
  float* lse_s = ds_s + kB * kLdP;
  float* dsum_s = lse_s + kB;
  int* qseg_s = reinterpret_cast<int*>(dsum_s + kB);
  int* kseg_s = qseg_s + kB;
  int* krange = kseg_s + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;

  load_tile(ks, ldq, a.k + (long)b * a.k_sb + (long)kvh * a.k_sh, a.k_ss, k0, a.skv, a.dqk);
  load_tile(vs, ldv, a.v + (long)b * a.v_sb + (long)kvh * a.v_sh, a.v_ss, k0, a.skv, a.dvd);
  if (tid < kB) kseg_s[tid] = seg_at(a.kseg, b, k0 + tid, a.skv, -2);
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = -1;
    for (int r = 0; r < kB; ++r) {
      const int seg = kseg_s[r];
      if (seg >= 0) {
        lo = min(lo, seg);
        hi = max(hi, seg);
      }
    }
    krange[0] = lo;
    krange[1] = hi;
  }
  __syncthreads();
  const int klo = krange[0], khi = krange[1];

  float acc_k[4][NQK], acc_v[4][NV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int n = 0; n < NQK; ++n) acc_k[r][n] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc_v[r][n] = 0.f;
  }

  const int n_qt = khi < 0 ? 0 : (a.sq + kB - 1) / kB;  // all-padding keys: dk = dv = 0
  const int qt0 = a.causal ? k0 / kB : 0;  // q tiles wholly above the diagonal see none of these keys
  for (int g = 0; g < a.group; ++g) {
    const int h = kvh * a.group + g;
    const long row = ((long)b * a.heads_q + h) * a.sq;
    const bf16* qg = a.q + (long)b * a.q_sb + (long)h * a.q_sh;
    const bf16* dog = a.dout + (long)b * a.do_sb + (long)h * a.do_sh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's smem is no longer read
      bool hit = false;
      if (tid < kB) {
        const int s = q0 + tid;
        const int seg = seg_at(a.qseg, b, s, a.sq, -1);
        qseg_s[tid] = seg;
        lse_s[tid] = s < a.sq ? a.lse[row + s] : kNegInf;
        dsum_s[tid] = s < a.sq ? a.dsum[row + s] : 0.f;
        hit = seg >= 0 && seg >= klo && seg <= khi;
      }
      if (!__syncthreads_or(hit)) continue;  // no query segment meets this k tile
      load_tile(qs, ldq, qg, a.q_ss, q0, a.sq, a.dqk);
      load_tile(dos, ldv, dog, a.do_ss, q0, a.sq, a.dvd);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot(s, qs, ldq, ks, ldq, a.dqk, ty, tx);
      tile_dot(dp, dos, ldv, vs, ldv, a.dvd, ty, tx);
      p_ds_tile(a, s, dp, qseg_s, kseg_s, lse_s, dsum_s, q0, k0, ty, tx, p_s, ds_s);
      __syncthreads();

      // this thread's key rows j = ty + 16r, columns c = tx + 16n
      for (int i = 0; i < kB; ++i) {
        float pr[4], dr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = p_s[i * kLdP + ty + 16 * r];
          dr[r] = ds_s[i * kLdP + ty + 16 * r];
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int c = tx + 16 * n;
          if (c < a.dvd) {
            const float dov = __bfloat162float(dos[i * ldv + c]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc_v[r][n] += pr[r] * dov;
          }
        }
#pragma unroll
        for (int n = 0; n < NQK; ++n) {
          const int c = tx + 16 * n;
          if (c < a.dqk) {
            const float qv = __bfloat162float(qs[i * ldq + c]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc_k[r][n] += dr[r] * qv;
          }
        }
      }
    }
  }

  bf16* dkg = a.dk + (long)b * a.dk_sb + (long)kvh * a.dk_sh;
  bf16* dvg = a.dv + (long)b * a.dv_sb + (long)kvh * a.dv_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = k0 + ty + 16 * r;
    if (t >= a.skv) continue;
#pragma unroll
    for (int n = 0; n < NQK; ++n) {
      const int c = tx + 16 * n;
      if (c < a.dqk) dkg[(long)t * a.dk_ss + c] = __float2bfloat16(acc_k[r][n] * a.scale);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int c = tx + 16 * n;
      if (c < a.dvd) dvg[(long)t * a.dv_ss + c] = __float2bfloat16(acc_v[r][n]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const BwdArgs& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* dsum, const void* qseg, const void* kseg, void* dq, void* dk, void* dv,
    int batch, int heads_q, int heads_kv, int sq, int skv, int dqk, int dvd,
    int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
    int do_sb, int do_sh, int do_ss, int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh,
    int dk_ss, int dv_sb, int dv_sh, int dv_ss, int causal, void* stream) {
  if (heads_kv <= 0 || heads_q % heads_kv != 0 || dvd <= 0 || dvd > kMaxDv || dqk <= 0 ||
      dqk > kMaxDqk || (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.dsum = (const float*)dsum;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.heads_q = heads_q;
  a.group = heads_q / heads_kv;
  a.sq = sq;
  a.skv = skv;
  a.dqk = dqk;
  a.dvd = dvd;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.do_sb = do_sb; a.do_sh = do_sh; a.do_ss = do_ss;
  a.dq_sb = dq_sb; a.dq_sh = dq_sh; a.dq_ss = dq_ss;
  a.dk_sb = dk_sb; a.dk_sh = dk_sh; a.dk_ss = dk_ss;
  a.dv_sb = dv_sb; a.dv_sh = dv_sh; a.dv_ss = dv_ss;
  a.scale = 1.f / sqrtf((float)dqk);
  a.scale_log2 = 1.4426950408889634f * a.scale;
  a.causal = causal;
  cudaStream_t st = (cudaStream_t)stream;

  // four bf16 tiles (an even element count, as kB is even), fp32 tiles, row vectors
  const size_t bf16_bytes = ((size_t)2 * kB * (dqk + 2) + (size_t)2 * kB * (dvd + 2)) * 2;
  const size_t rows = (size_t)2 * kB * 4 + (size_t)(2 * kB + 2) * 4;
  const size_t smem_dq = bf16_bytes + (size_t)kB * kLdP * 4 + rows;
  const size_t smem_dkv = bf16_bytes + (size_t)2 * kB * kLdP * 4 + rows;

  const bool wide_qk = dqk > 128, wide_v = dvd > 64;
  dim3 grid_dq((sq + kB - 1) / kB, heads_q, batch);
  int rc = wide_qk ? launch(flash_bwd_dq_kernel<16>, grid_dq, smem_dq, st, a)
                   : launch(flash_bwd_dq_kernel<8>, grid_dq, smem_dq, st, a);
  if (rc != 0) return rc;
  dim3 grid_dkv((skv + kB - 1) / kB, heads_kv, batch);
  if (wide_qk)
    return wide_v ? launch(flash_bwd_dkv_kernel<16, 8>, grid_dkv, smem_dkv, st, a)
                  : launch(flash_bwd_dkv_kernel<16, 4>, grid_dkv, smem_dkv, st, a);
  return wide_v ? launch(flash_bwd_dkv_kernel<8, 8>, grid_dkv, smem_dkv, st, a)
                : launch(flash_bwd_dkv_kernel<8, 4>, grid_dkv, smem_dkv, st, a);
}
