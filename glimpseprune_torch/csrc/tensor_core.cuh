// Tensor-core and asynchronous-copy helpers shared by the kernels
// (flash_attention.cu, window_attention.cu, int4_matmul.cu): cp.async copies
// into shared memory, ldmatrix loads, the mma.sync.m16n8k16 bf16 product
// with fp32 accumulators, the mma.sync.m16n8k32 s8 product with int32
// accumulators, and row copies into padded shared-memory tiles. sm_80 PTX,
// built for sm_90a.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4): A (16x16,
// row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..); B (16x8, k by n) b0 = (2t..2t+1, g), b1 = (2t+8.., g);
// C (16x8) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// mma.m16n8k32 s8 holds four k per register: A (16x32) a0 = (g, 4t..4t+3),
// a1 = (g+8, 4t..), a2 = (g, 16+4t..), a3 = (g+8, 16+4t..); B (32x8)
// b0 = (4t..4t+3, g), b1 = (16+4t.., g); C as above, in int32. So an
// ldmatrix (b16) 8x8 matrix read from 8 rows of 16 int8 bytes gives each
// lane the 4 bytes (g, 4t..4t+3): the A or B fragment of rows stored
// k-contiguous.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gp_tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[4] += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[4] += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators, as
// mma_16816 but not volatile: the scheduler may interleave the next k
// step's ldmatrix with these.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), int32 accumulators. Not
// volatile: the scheduler may interleave the next k step's ldmatrix with
// these.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Zero the pad chunks (columns >= dreal, 8 at a time) of `rows` rows.
template <int DP, int LD>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* dst, int rows, int dreal, int tid,
                                         int nthreads) {
  constexpr int kChunks = DP / 8;
  for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    if (c >= dreal) *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
}

// Copy `rows` rows starting at global row `row0` (rows >= `limit` read as
// zeros) of `dreal` columns into a [rows][LD] tile: 16-byte cp.async chunks
// where `vec`, else element by element (synchronous). Pad chunks are left
// alone (zero_pad wrote them once).
template <int DP, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long row_stride, int row0, int limit, int rows,
                                          int dreal, bool vec, int tid, int nthreads) {
  constexpr int kChunks = DP / 8;
  for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    if (c >= dreal) continue;
    const int g = row0 + r;
    const bool in = g < limit;
    __nv_bfloat16* d = dst + r * LD + c;
    if (vec && c + 8 <= dreal) {
      cp_async16(d, src + (in ? (long)g * row_stride + c : 0), in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (in && c + e < dreal) ? src[(long)g * row_stride + c + e] : __float2bfloat16(0.f);
    }
  }
}

// Let `Kernel` take `smem` bytes of dynamic shared memory on the current
// device. The CUDA runtime is asked once per kernel, device and larger
// size, not on every launch (a launch is host-bound at the attention's
// small shapes); the cap is remembered per instantiation of this template,
// so per kernel.
template <auto Kernel>
int raise_smem_cap(int smem) {
  constexpr int kDevices = 16;
  static int cap[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kDevices && smem <= cap[dev]) return 0;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < kDevices) cap[dev] = smem;
  return 0;
}

}  // namespace gp_tc
