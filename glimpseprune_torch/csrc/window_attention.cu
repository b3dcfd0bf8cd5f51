// Window attention for the ViT's windowed blocks (bf16), two entry points
// over one kernel body:
//
// K1, `window_attention_fused_bf16`: replaces the Pallas kernel
// `window_attention_fused` (glimpseprune_tpu/ops/pallas/window_attention.py:133,
// body `_fused_kernel` :55). For every window of `wp` patches and every head
// it reads q, k and v straight from the qkv projection in its natural
// [P, 3, H, D] layout, applies rope (x*cos + rotate_half(x)*sin) in fp32
// after loading, scores with 1/sqrt(D), masks keys to valid keys plus the
// diagonal, and writes softmax(s) @ v into [P, H, D].
//
// K8, `window_attention_bf16`: replaces the Pallas kernel `window_attention`
// (window_attention.py:198, body `_kernel` :31), the same attention on q, k
// and v that already carry rope, each [P, H, D] with its own pointer. The
// ViT takes it only in a windowed block that emits importance.
//
// What bounds it on the H100: bytes. Per (window, head) the math is two
// [wp, wp, D] products (1.3 MFLOP at wp=64, D=80) against 3*wp*D bf16 reads
// and wp*D writes; over the 7B ViT's 5120 patches that is 52 MB, 16 us at
// the card's 3.35 TB/s, against 13 us of bf16 tensor work. The design:
// - one 128-thread block per (window, group of `hg` heads): 80 windows of the
//   7B's batch (a) in groups of 4 heads give 320 blocks for 132 SMs, and
//   cos and sin are read once per block into shared memory;
// - each head's q, k and v rows arrive by 16-byte cp.async (a patch row of
//   one head is 160 contiguous bytes), rope is applied in fp32 in shared
//   memory and rounded once to bf16 (the Pallas kernel ropes in bf16, :103);
// - QK^T and PV run as mma.sync.m16n8k16 bf16 products with fp32 sums, four
//   warps of 16 query rows each; the softmax stays in registers, p is
//   normalized and cast to bf16 before PV, as the Pallas kernel does (:95-101);
// - the output is staged in the warp's own q rows and written as 16-byte
//   stores of whole head rows.
// Head dims are padded in shared memory to 16 (the tiny config), 64, 80 or
// 128 (zero columns, never stored), windows to 64 rows and keys (zero rows,
// masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace gp_tc;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWP = 64;  // rows and keys of a window tile: wp <= 64

struct Args {
  const __nv_bfloat16* q;  // rows `row_stride` elements apart (3*H*D in the qkv
  const __nv_bfloat16* k;  // projection, H*D for separate tensors)
  const __nv_bfloat16* v;
  long row_stride;
  const __nv_bfloat16* cosv;   // [P, D] (K1 only)
  const __nv_bfloat16* sinv;   // [P, D]
  const unsigned char* valid;  // [P]
  __nv_bfloat16* out;          // [P, H, D]
  int heads, dim, wp, hg;
  float scale_log2;  // log2(e) / sqrt(D)
  int vec;  // bit 0: q/k/v rows, 1: cos/sin rows, 2: out rows may move as 16-byte chunks
};

// Shared-memory bytes of one block; ops/cuda/window_attention.py's
// `plan_window` computes the same number and the launcher checks they agree.
__host__ __device__ constexpr int smem_bytes(int dp, bool rope) {
  return 2 * kWP * (dp + 8) * (rope ? 5 : 3) + 4 * kWP;
}

// x[c] * cos[c] - x[c + half] * sin[c] and x[c + half] * cos[c + half] +
// x[c] * sin[c + half] in fp32, written back in bf16
__device__ __forceinline__ void rope_pair(__nv_bfloat16* x, const __nv_bfloat16* cs,
                                          const __nv_bfloat16* sn, int c, int half) {
  const float lo = __bfloat162float(x[c]), hi = __bfloat162float(x[c + half]);
  x[c] = __float2bfloat16(lo * __bfloat162float(cs[c]) - hi * __bfloat162float(sn[c]));
  x[c + half] =
      __float2bfloat16(hi * __bfloat162float(cs[c + half]) + lo * __bfloat162float(sn[c + half]));
}

template <int DP, bool kRope>
__global__ void __launch_bounds__(kThreads) window_attention_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int NKS = DP / 16;  // k-steps of QK^T
  constexpr int NT = kWP / 8;   // n-tiles of a score row block
  constexpr int NO = DP / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kWP][LD]
  __nv_bfloat16* ks = qs + kWP * LD;
  __nv_bfloat16* vs = ks + kWP * LD;
  __nv_bfloat16* cs = vs + kWP * LD;  // [kWP][LD] cos, then sin (kRope)
  __nv_bfloat16* sn = cs + kWP * LD;
  int* valid_s = reinterpret_cast<int*>(kRope ? sn + kWP * LD : cs);  // [kWP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wp = a.wp, dim = a.dim;
  const long row0 = (long)blockIdx.x * wp;
  const bool vec = a.vec & 1;

  // rows past wp and pad columns stay zero for every head
  for (int idx = tid; idx < kWP * (DP / 8); idx += kThreads) {
    const int r = idx / (DP / 8), c = (idx - r * (DP / 8)) * 8;
    if (r >= wp || c >= dim) {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(qs + r * LD + c) = z;
      *reinterpret_cast<uint4*>(ks + r * LD + c) = z;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = z;
    }
  }
  if (tid < kWP) valid_s[tid] = tid < wp ? a.valid[row0 + tid] : 0;
  if constexpr (kRope) {
    load_rows<DP, LD>(cs, a.cosv + row0 * dim, dim, 0, wp, wp, dim, a.vec & 2, tid, kThreads);
    load_rows<DP, LD>(sn, a.sinv + row0 * dim, dim, 0, wp, wp, dim, a.vec & 2, tid, kThreads);
  }

  const int r0 = warp * 16;  // this warp's rows
  const int n_kt = (wp + 15) / 16;  // 16-key steps that hold a key
  for (int hh = 0; hh < a.hg; ++hh) {
    const int h = blockIdx.y * a.hg + hh;
    const long off = row0 * a.row_stride + (long)h * dim;
    load_rows<DP, LD>(qs, a.q + off, a.row_stride, 0, wp, wp, dim, vec, tid, kThreads);
    load_rows<DP, LD>(ks, a.k + off, a.row_stride, 0, wp, wp, dim, vec, tid, kThreads);
    load_rows<DP, LD>(vs, a.v + off, a.row_stride, 0, wp, wp, dim, vec, tid, kThreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kRope) {
      const int half = dim / 2;
      for (int idx = tid; idx < wp * half; idx += kThreads) {
        const int r = idx / half, c = idx - r * half;
        rope_pair(qs + r * LD, cs + r * LD, sn + r * LD, c, half);
        rope_pair(ks + r * LD, cs + r * LD, sn + r * LD, c, half);
      }
      __syncthreads();
    }

    if (r0 < wp) {
      // S = Q K^T over the keys the window holds
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, qs + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (np < n_kt) {
            uint32_t bf[4];
            ldsm_x4(bf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
            mma_16816(s[2 * np], af, bf[0], bf[1]);
            mma_16816(s[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
      // softmax over valid keys and the diagonal, normalized before PV
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r0 + g + 8 * hf;
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const int j = n * 8 + 2 * t4 + (e & 1);
            const bool ok = j < wp && (valid_s[j] != 0 || j == i);
            s[n][e] = ok ? s[n][e] * a.scale_log2 : kNegInf;
            mx = fmaxf(mx, s[n][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            s[n][e] = fast_exp2(s[n][e] - mx);
            sum += s[n][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) s[n][e] *= inv;
      }
      // O = P V
      float o[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kWP / 16; ++kk) {
        if (kk < n_kt) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                                  (lane >> 4) * 8);
            mma_16816(o[2 * np], pa, bf[0], bf[1]);
            mma_16816(o[2 * np + 1], pa, bf[2], bf[3]);
          }
        }
      }
      // stage in this warp's q rows, then whole head rows to [P, H, D]
      __syncwarp();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < NO; ++n)
          *reinterpret_cast<uint32_t*>(qs + (r0 + g + 8 * hf) * LD + n * 8 + 2 * t4) =
              pack_bf16(o[n][2 * hf], o[n][2 * hf + 1]);
      __syncwarp();
      for (int idx = lane; idx < 16 * (DP / 8); idx += 32) {
        const int r = r0 + idx / (DP / 8), c = (idx % (DP / 8)) * 8;
        if (r >= wp || c >= dim) continue;
        const __nv_bfloat16* src = qs + r * LD + c;
        __nv_bfloat16* dst = a.out + ((row0 + r) * a.heads + h) * dim + c;
        if ((a.vec & 4) && c + 8 <= dim) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && c + e < dim; ++e) dst[e] = src[e];
        }
      }
    }
    __syncthreads();  // the next head's copies overwrite q, k and v
  }
}

template <int DP, bool kRope>
int launch_dp(const Args& a, int n_windows, int smem, void* stream) {
  if (smem != smem_bytes(DP, kRope)) return (int)cudaErrorInvalidValue;
  const int err = raise_smem_cap<window_attention_kernel<DP, kRope>>(smem);
  if (err != 0) return err;
  dim3 grid(n_windows, a.heads / a.hg);
  window_attention_kernel<DP, kRope><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The padded head dims the kernel is built for (ops/cuda/window_attention.py
// WINDOW_DIMS lists the same).
template <bool kRope>
int launch(const void* q, const void* k, const void* v, long row_stride, const void* cosv,
           const void* sinv, const void* valid, void* out, int n_patches, int heads, int dim,
           int wp, int dim_pad, int hg, int smem, int vec, void* stream) {
  if (wp <= 0 || wp > kWP || n_patches % wp != 0 || dim <= 0 || dim > dim_pad ||
      (kRope && dim % 2 != 0) || hg <= 0 || heads % hg != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.row_stride = row_stride;
  a.cosv = (const __nv_bfloat16*)cosv;
  a.sinv = (const __nv_bfloat16*)sinv;
  a.valid = (const unsigned char*)valid;
  a.out = (__nv_bfloat16*)out;
  a.heads = heads;
  a.dim = dim;
  a.wp = wp;
  a.hg = hg;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)dim);
  a.vec = vec;
  const int nw = n_patches / wp;
  switch (dim_pad) {
    case 16: return launch_dp<16, kRope>(a, nw, smem, stream);
    case 64: return launch_dp<64, kRope>(a, nw, smem, stream);
    case 80: return launch_dp<80, kRope>(a, nw, smem, stream);
    case 128: return launch_dp<128, kRope>(a, nw, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1: qkv [P, 3, H, D] before rope, cos/sin [P, D].
extern "C" int window_attention_fused_bf16(const void* qkv, const void* cosv,
                                           const void* sinv, const void* valid,
                                           void* out, int n_patches, int heads,
                                           int dim, int wp, int dim_pad, int hg, int smem,
                                           int vec, void* stream) {
  const long hd = (long)heads * dim;
  const __nv_bfloat16* base = (const __nv_bfloat16*)qkv;
  return launch<true>(base, base + hd, base + 2 * hd, 3 * hd, cosv, sinv, valid, out,
                      n_patches, heads, dim, wp, dim_pad, hg, smem, vec, stream);
}

// K8: q, k, v [P, H, D] each, rope already applied.
extern "C" int window_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, int n_patches, int heads,
                                     int dim, int wp, int dim_pad, int hg, int smem, int vec,
                                     void* stream) {
  return launch<false>(q, k, v, (long)heads * dim, nullptr, nullptr, valid, out, n_patches,
                       heads, dim, wp, dim_pad, hg, smem, vec, stream);
}
