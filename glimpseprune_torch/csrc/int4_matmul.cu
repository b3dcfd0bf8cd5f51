// int4-weight matrix products: K4 (decode), K5 (W4A16 prefill) and K6 (W4A8
// prefill).
//
// Replaces the Pallas kernels of glimpseprune_tpu/ops/pallas/int4_matmul.py:
// - K4, `matmul_int4` :103 (body `_kernel` :51): x [M, K] bf16 (M <= 128) @
//   int4 weights, each 64-row group's partial dot scaled on the result;
// - K5, `matmul_int4_prefill(a8=False)` :283 (body `_kernel_prefill_a16`
//   :191): each weight scaled by its group scale in fp32, rounded to bf16,
//   then a bf16 product with an fp32 accumulator;
// - K6, `matmul_int4_prefill(a8=True)` (body `_kernel_prefill_a8` :219):
//   int8 activations (quantized per row outside, as in JAX :336-344)
//   against weights requantized to per-column int8, q8 = rint(q4 * r) with
//   r = s_group / s8_col computed outside in fp32 as JAX does, an int32
//   accumulator, and out = acc * x_scale[row] * s8[col].
// Weights are packed as quantization.quantize_int4 packs them: int8
// [K/2, N], row r in the low nibble and row r + K/2 in the high nibble; the
// scales (or ratios) are f32 [K/g, N], lo groups first.
//
// What bounds them on the H100. K4 reads 0.5 byte per weight for 2 * M
// flops: at decode batch it is bound by bytes, like a GEMV. Threads own 4
// neighbouring columns, so a warp reads 128 contiguous packed bytes per row;
// the nibbles are sign-extended in registers; the block's slice of x sits
// in shared memory as fp32. Narrow outputs (the k/v projections, N = 512)
// give few column blocks, so K is split across blocks in whole groups, and
// a second pass sums the splits in a fixed order (no atomics: runs repeat
// bit for bit). K5 and K6 at prefill M (a few thousand rows) are bound by
// operations. Both unpack the nibble tile into shared memory at each 64-row
// k step (scaled to bf16 for K5, requantized to int8 for K6). K5, which no
// path routes to, is the simple version: 64 x 64 output tiles and fp32
// FMAs on CUDA cores. K6 multiplies on the int8 tensor cores with legacy
// mma.sync (m16n8k32) on 128 x 128 tiles; loads are not pipelined yet, and
// wgmma with TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- K4
constexpr int kVThreads = 128;
constexpr int kVCols = 4;  // columns per thread: one 4-byte load per packed row
constexpr int kVRows = 8;  // x rows per pass over the weights

struct GemvArgs {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* w;         // [K/2, N]
  const float* s;          // [K/g, N]
  float* part;             // [ksplit, M, N]
  int m, k, n, g, groups_per_split;
};

__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)((int8_t)(b << 4) >> 4);
}

__device__ __forceinline__ float hi_nibble(int8_t b) { return (float)(b >> 4); }

__global__ void __launch_bounds__(kVThreads) int4_gemv_kernel(GemvArgs a) {
  extern __shared__ float xsm[];  // [kVRows][2 * span]: the lo slice, then the hi slice
  const int col0 = (blockIdx.x * kVThreads + threadIdx.x) * kVCols;
  const int kh = a.k / 2;
  const int half_groups = kh / a.g;
  const int g0 = blockIdx.y * a.groups_per_split;
  const int g1 = min(half_groups, g0 + a.groups_per_split);
  const int r0 = g0 * a.g;
  const int span = (g1 - g0) * a.g;
  const bool active = col0 < a.n;

  for (int m0 = 0; m0 < a.m; m0 += kVRows) {
    const int mr = min(kVRows, a.m - m0);
    __syncthreads();  // the previous pass no longer reads xsm
    for (int idx = threadIdx.x; idx < kVRows * 2 * span; idx += kVThreads) {
      const int i = idx / (2 * span), j = idx - i * 2 * span;
      const int kk = j < span ? r0 + j : kh + r0 + (j - span);
      xsm[idx] = i < mr ? __bfloat162float(a.x[(long)(m0 + i) * a.k + kk]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float acc[kVRows][kVCols];
#pragma unroll
    for (int i = 0; i < kVRows; ++i)
#pragma unroll
      for (int c = 0; c < kVCols; ++c) acc[i][c] = 0.f;

    for (int gi = g0; gi < g1; ++gi) {
      float plo[kVRows][kVCols], phi[kVRows][kVCols];
#pragma unroll
      for (int i = 0; i < kVRows; ++i)
#pragma unroll
        for (int c = 0; c < kVCols; ++c) plo[i][c] = phi[i][c] = 0.f;
#pragma unroll 4
      for (int rr = 0; rr < a.g; ++rr) {
        const int r = gi * a.g + rr;
        const char4 b = *reinterpret_cast<const char4*>(a.w + (long)r * a.n + col0);
        const float lo[kVCols] = {lo_nibble(b.x), lo_nibble(b.y), lo_nibble(b.z),
                                  lo_nibble(b.w)};
        const float hi[kVCols] = {hi_nibble(b.x), hi_nibble(b.y), hi_nibble(b.z),
                                  hi_nibble(b.w)};
        const int j = r - r0;
#pragma unroll
        for (int i = 0; i < kVRows; ++i) {
          const float xl = xsm[i * 2 * span + j];
          const float xh = xsm[i * 2 * span + span + j];
#pragma unroll
          for (int c = 0; c < kVCols; ++c) {
            plo[i][c] += xl * lo[c];
            phi[i][c] += xh * hi[c];
          }
        }
      }
      // the group scales multiply the partial dots, not the weights (:81-83)
      const float4 slo = *reinterpret_cast<const float4*>(a.s + (long)gi * a.n + col0);
      const float4 shi =
          *reinterpret_cast<const float4*>(a.s + (long)(half_groups + gi) * a.n + col0);
      const float sl[kVCols] = {slo.x, slo.y, slo.z, slo.w};
      const float sh[kVCols] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
      for (int i = 0; i < kVRows; ++i)
#pragma unroll
        for (int c = 0; c < kVCols; ++c) acc[i][c] += plo[i][c] * sl[c] + phi[i][c] * sh[c];
    }
    for (int i = 0; i < mr; ++i) {
      float* dst = a.part + ((long)blockIdx.y * a.m + m0 + i) * a.n + col0;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// the splits summed in split order -> bf16
__global__ void int4_gemv_reduce_kernel(const float* part, __nv_bfloat16* out, long mn,
                                        int ksplit) {
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < mn;
       idx += (long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int sp = 0; sp < ksplit; ++sp) sum += part[sp * mn + idx];
    out[idx] = __float2bfloat16(sum);
  }
}

// ------------------------------------------------------------- K5, K6
// Both walk K in steps of 32 packed rows (64 unpacked rows: 32 lo, 32 hi),
// unpacking the nibble tile into shared memory k-contiguous per column. A
// step lies inside one group on each half (32 divides g), so each half
// needs one row of s (or r) per column.
constexpr int kBKP = 32;
constexpr int kBK = 2 * kBKP;

struct GemmArgs {
  const void* x;          // [M, K]: bf16 (K5) or int8 (K6)
  const float* xs;        // [M] row scales (K6)
  const int8_t* w;        // [K/2, N]
  const float* s;         // [K/g, N]: group scales (K5) or requant ratios r (K6)
  const float* s8;        // [N] per-column int8 scale (K6)
  __nv_bfloat16* out;     // [M, N]
  int m, k, n, g;
};

// K5: 64 x 64 output tiles, 256 threads with 4 x 4 micro-tiles, fp32 FMAs
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFThreads = 256;
constexpr int kLdF = kBK + 1;  // fp32 row stride

__global__ void __launch_bounds__(kFThreads) int4_gemm_a16_kernel(GemmArgs a) {
  __shared__ float as[kFBM * kLdF];
  __shared__ float bs[kFBN * kLdF];
  __shared__ float sc[2][kFBN];  // this step's lo and hi group rows of s
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int kh = a.k / 2;
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(a.x);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kp = 0; kp < kh; kp += kBKP) {
    __syncthreads();  // the previous step's tiles are no longer read
    if (tid < 2 * kFBN) {
      const int half = tid / kFBN, c = tid % kFBN;
      sc[half][c] = a.s[(long)((half * kh + kp) / a.g) * a.n + n0 + c];
    }
    for (int idx = tid; idx < kFBM * kBK; idx += kFThreads) {
      const int r = idx / kBK, j = idx % kBK;
      const int kk = j < kBKP ? kp + j : kh + kp + (j - kBKP);
      const int row = m0 + r;
      as[r * kLdF + j] = row < a.m ? __bfloat162float(xb[(long)row * a.k + kk]) : 0.f;
    }
    __syncthreads();  // sc is ready
    for (int idx = tid; idx < kBKP * kFBN; idx += kFThreads) {
      const int r = idx / kFBN, c = idx % kFBN;
      const int8_t b = a.w[(long)(kp + r) * a.n + n0 + c];
      // the weight times its group scale in fp32, rounded to bf16 (JAX :204-206)
      bs[c * kLdF + r] = __bfloat162float(__float2bfloat16(lo_nibble(b) * sc[0][c]));
      bs[c * kLdF + kBKP + r] = __bfloat162float(__float2bfloat16(hi_nibble(b) * sc[1][c]));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * kLdF + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * kLdF + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a.out[(long)row * a.n + n0 + tx + 16 * j] = __float2bfloat16(acc[i][j]);
  }
}

// K6: 128 x 128 output tiles, 8 warps of 64 x 32, int8 tensor-core products
// (mma.sync m16n8k32 s8, int32 accumulators). Fragments are read from
// shared memory as 32-bit words; a row stride of 80 bytes (20 words) puts
// the 8 rows x 4 words of one fragment load on 32 distinct banks.
constexpr int kMBM = 128;
constexpr int kMBN = 128;
constexpr int kMThreads = 256;
constexpr int kLd8 = kBK + 16;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kMThreads) int4_gemm_a8_kernel(GemmArgs a) {
  __shared__ __align__(16) int8_t as[kMBM * kLd8];  // x rows, k contiguous
  __shared__ __align__(16) int8_t bs[kMBN * kLd8];  // weight columns, k contiguous
  __shared__ float sc[2][kMBN];                     // this step's lo and hi rows of r
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;    // mma fragment coordinates
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kMBM, n0 = blockIdx.x * kMBN;
  const int kh = a.k / 2;
  const int8_t* xq = reinterpret_cast<const int8_t*>(a.x);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kp = 0; kp < kh; kp += kBKP) {
    __syncthreads();  // the previous step's tiles are no longer read
    {
      const int half = tid / kMBN, c = tid % kMBN;  // 256 threads: both halves
      sc[half][c] = a.s[(long)((half * kh + kp) / a.g) * a.n + n0 + c];
    }
    // x tile: 128 rows x (32 lo + 32 hi) int8 in 16-byte chunks
    for (int idx = tid; idx < kMBM * 4; idx += kMThreads) {
      const int r = idx >> 2, ch = idx & 3;
      const int kk = ch < 2 ? kp + 16 * ch : kh + kp + 16 * (ch - 2);
      const int row = m0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (row < a.m) v = *reinterpret_cast<const int4*>(xq + (long)row * a.k + kk);
      *reinterpret_cast<int4*>(as + r * kLd8 + 16 * ch) = v;
    }
    __syncthreads();  // sc is ready
    for (int idx = tid; idx < kBKP * kMBN; idx += kMThreads) {
      const int r = idx / kMBN, c = idx % kMBN;
      const int8_t b = a.w[(long)(kp + r) * a.n + n0 + c];
      // requantized to per-column int8: |q4 * r| <= 7 * s_max / s8 = 127
      // by construction (JAX :232-237); rint rounds half to even as jnp.round
      bs[c * kLd8 + r] = (int8_t)__float2int_rn(lo_nibble(b) * sc[0][c]);
      bs[c * kLd8 + kBKP + r] = (int8_t)__float2int_rn(hi_nibble(b) * sc[1][c]);
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 32) {
      unsigned af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (wm + 16 * i + grp) * kLd8 + k0 + 4 * tig;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kLd8);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kLd8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + 8 * j + grp) * kLd8 + k0 + 4 * tig;
        const unsigned bf[2] = {*reinterpret_cast<const unsigned*>(p),
                                *reinterpret_cast<const unsigned*>(p + 16)};
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], af[i], bf);
      }
    }
  }

  // out = acc * x_scale[row] * s8[col] in fp32, then bf16 (JAX :247-248)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + grp + 8 * h;
      if (row >= a.m) continue;
      const float xs = a.xs[row];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + 8 * j + 2 * tig + e;
          a.out[(long)row * a.n + col] =
              __float2bfloat16((float)acc[i][j][2 * h + e] * xs * a.s8[col]);
        }
    }
}

bool gemm_shapes_ok(int m, int k, int n, int g, int bn) {
  return m > 0 && g > 0 && g % kBKP == 0 && k % (2 * g) == 0 && n % bn == 0;
}

}  // namespace

extern "C" int int4_gemv_bf16(const void* x, const void* w, const void* s, void* part,
                              void* out, int m, int k, int n, int g, int ksplit,
                              int groups_per_split, void* stream) {
  if (m <= 0 || g <= 0 || k % (2 * g) != 0 || n % kVCols != 0 || ksplit <= 0 ||
      groups_per_split <= 0 ||
      (long)ksplit * groups_per_split < (k / 2) / g)
    return (int)cudaErrorInvalidValue;
  GemvArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.w = (const int8_t*)w;
  a.s = (const float*)s;
  a.part = (float*)part;
  a.m = m;
  a.k = k;
  a.n = n;
  a.g = g;
  a.groups_per_split = groups_per_split;
  const size_t smem = (size_t)kVRows * 2 * groups_per_split * g * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(int4_gemv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cols_per_block = kVThreads * kVCols;
  dim3 grid((n + cols_per_block - 1) / cols_per_block, ksplit);
  int4_gemv_kernel<<<grid, kVThreads, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long mn = (long)m * n;
  const int blocks = (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  int4_gemv_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (__nv_bfloat16*)out, mn, ksplit);
  return (int)cudaGetLastError();
}

extern "C" int int4_gemm_a16_bf16(const void* x, const void* w, const void* s, void* out,
                                  int m, int k, int n, int g, void* stream) {
  if (!gemm_shapes_ok(m, k, n, g, kFBN)) return (int)cudaErrorInvalidValue;
  GemmArgs a{x, nullptr, (const int8_t*)w, (const float*)s, nullptr, (__nv_bfloat16*)out,
             m, k, n, g};
  dim3 grid(n / kFBN, (m + kFBM - 1) / kFBM);
  int4_gemm_a16_kernel<<<grid, kFThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int int4_gemm_a8_bf16(const void* xq, const void* xs, const void* w,
                                 const void* r, const void* s8, void* out, int m, int k,
                                 int n, int g, void* stream) {
  // 16-byte loads of x rows: K a multiple of 16 (the routing gate gives 512)
  if (!gemm_shapes_ok(m, k, n, g, kMBN) || k % 16 != 0) return (int)cudaErrorInvalidValue;
  GemmArgs a{xq, (const float*)xs, (const int8_t*)w, (const float*)r, (const float*)s8,
             (__nv_bfloat16*)out, m, k, n, g};
  dim3 grid(n / kMBN, (m + kMBM - 1) / kMBM);
  int4_gemm_a8_kernel<<<grid, kMThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
