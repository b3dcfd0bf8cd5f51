// Window attention for the ViT's windowed blocks (bf16), two entry points
// over one kernel body:
//
// K1, `window_attention_fused_bf16`: replaces the Pallas kernel
// `window_attention_fused` (glimpseprune_tpu/ops/pallas/window_attention.py:133,
// body `_fused_kernel` :55). For every window of `wp` patches and every head
// it reads q, k and v straight from the qkv projection in its natural
// [P, 3, H, D] layout, applies rope (x*cos + rotate_half(x)*sin) while
// loading, scores with 1/sqrt(D), masks keys to valid keys plus the
// diagonal, and writes softmax(s) @ v into [P, H, D].
//
// K8, `window_attention_bf16`: replaces the Pallas kernel `window_attention`
// (window_attention.py:198, body `_kernel` :31), the same attention on q, k
// and v that already carry rope, each [P, H, D] with its own pointer. The
// ViT takes it only in a windowed block that emits importance.
//
// What bounds it on the H100: per (window, head) the math is two
// [wp, wp, D] products (about 1.3 MFLOP at wp=64, D=80) against 3*wp*D
// bf16 reads and wp*D writes, so the whole pass is small and latency- and
// shared-memory-bound, not HBM-bound. The design keeps one window-head in
// shared memory in fp32 (rope, where asked, applied once on load), runs the
// products on CUDA cores with a padded row stride (no bank conflicts on the
// column walks), and launches one block per (window, head) so that a ViT
// image of a few thousand patches fills the 132 SMs. Tensor-core tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q, k, v rows are `row_stride` elements apart (3*H*D inside the qkv
// projection, H*D for separate tensors); cos and sin are read only with kRope.
template <bool kRope>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const __nv_bfloat16* __restrict__ qg,
                        const __nv_bfloat16* __restrict__ kg,
                        const __nv_bfloat16* __restrict__ vg,
                        long row_stride,
                        const __nv_bfloat16* __restrict__ cosv,  // [P, D]
                        const __nv_bfloat16* __restrict__ sinv,  // [P, D]
                        const unsigned char* __restrict__ valid, // [P]
                        __nv_bfloat16* __restrict__ out,         // [P, H, D]
                        int heads, int dim, int wp, float scale) {
  extern __shared__ float smem[];
  const int ld = dim + 1;  // odd row stride: column walks hit distinct banks
  const int lds = wp + 1;
  float* qs = smem;          // [wp][ld] q (roped under kRope)
  float* ks = qs + wp * ld;  // [wp][ld] k (roped under kRope)
  float* vs = ks + wp * ld;  // [wp][ld]
  float* ps = vs + wp * ld;  // [wp][lds] scores, then probabilities

  const int h = blockIdx.y;
  const long row0 = (long)blockIdx.x * wp;
  const int half = dim / 2;

  for (int idx = threadIdx.x; idx < wp * dim; idx += blockDim.x) {
    const int r = idx / dim, c = idx - (idx / dim) * dim;
    const long p = row0 + r;
    const long off = p * row_stride + (long)h * dim;
    const float q = __bfloat162float(qg[off + c]);
    const float k = __bfloat162float(kg[off + c]);
    if constexpr (kRope) {
      const float cs = __bfloat162float(cosv[p * dim + c]);
      const float sn = __bfloat162float(sinv[p * dim + c]);
      // rotate_half(x)[c] = -x[c + D/2] for c < D/2, x[c - D/2] otherwise
      const int c2 = c < half ? c + half : c - half;
      const float sg = c < half ? -1.f : 1.f;
      qs[r * ld + c] = q * cs + sg * __bfloat162float(qg[off + c2]) * sn;
      ks[r * ld + c] = k * cs + sg * __bfloat162float(kg[off + c2]) * sn;
    } else {
      qs[r * ld + c] = q;
      ks[r * ld + c] = k;
    }
    vs[r * ld + c] = __bfloat162float(vg[off + c]);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < wp * wp; idx += blockDim.x) {
    const int i = idx / wp, j = idx - (idx / wp) * wp;
    float acc = 0.f;
    for (int d = 0; d < dim; ++d) acc += qs[i * ld + d] * ks[j * ld + d];
    const bool allowed = valid[row0 + j] != 0 || i == j;
    ps[i * lds + j] = allowed ? acc * scale : kNegInf;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < wp; i += nwarps) {
    float* row = ps + i * lds;
    float m = kNegInf;
    for (int j = lane; j < wp; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < wp; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    const float inv = 1.f / warp_sum(s);
    for (int j = lane; j < wp; j += 32) row[j] *= inv;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < wp * dim; idx += blockDim.x) {
    const int i = idx / dim, c = idx - (idx / dim) * dim;
    float acc = 0.f;
    for (int j = 0; j < wp; ++j) acc += ps[i * lds + j] * vs[j * ld + c];
    out[((row0 + i) * heads + h) * dim + c] = __float2bfloat16(acc);
  }
}

template <bool kRope>
int launch(const void* q, const void* k, const void* v, long row_stride, const void* cosv,
           const void* sinv, const void* valid, void* out, int n_patches, int heads, int dim,
           int wp, void* stream) {
  if (wp <= 0 || n_patches % wp != 0 || dim % 2 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * wp * (dim + 1) + wp * (wp + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<kRope>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)dim);
  dim3 grid(n_patches / wp, heads);
  window_attention_kernel<kRope><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, row_stride,
      (const __nv_bfloat16*)cosv, (const __nv_bfloat16*)sinv, (const unsigned char*)valid,
      (__nv_bfloat16*)out, heads, dim, wp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: qkv [P, 3, H, D] before rope, cos/sin [P, D].
extern "C" int window_attention_fused_bf16(const void* qkv, const void* cosv,
                                           const void* sinv, const void* valid,
                                           void* out, int n_patches, int heads,
                                           int dim, int wp, void* stream) {
  const long hd = (long)heads * dim;
  const __nv_bfloat16* base = (const __nv_bfloat16*)qkv;
  return launch<true>(base, base + hd, base + 2 * hd, 3 * hd, cosv, sinv, valid, out,
                      n_patches, heads, dim, wp, stream);
}

// K8: q, k, v [P, H, D] each, rope already applied.
extern "C" int window_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, int n_patches, int heads,
                                     int dim, int wp, void* stream) {
  return launch<false>(q, k, v, (long)heads * dim, nullptr, nullptr, valid, out, n_patches,
                       heads, dim, wp, stream);
}
