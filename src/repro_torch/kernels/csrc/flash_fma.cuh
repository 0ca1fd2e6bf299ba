// Helpers of the flash kernels that run on the float32 FMA pipe: the
// forward's FMA route (flash_attention.cu) and the backward
// (flash_attention_bwd.cu). Each includes this header into its own
// translation unit; the names live in an anonymous namespace there. A block
// is 256 threads as 16 (tx) x 16 (ty); tiles are staged into shared memory
// as float32 whatever the operands' type.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 (tx) x 16 (ty)

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Row stride (floats) of a staged (rows, d) tile: d rounded up to 4, padded
// so that stride / 4 is odd (float4 reads of 8 consecutive rows are then
// conflict-free).
__host__ __device__ inline int padded_stride(int d) {
  const int d4 = (d + 3) / 4 * 4;
  return ((d4 / 4) % 2 == 0) ? d4 + 4 : d4;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}

// Stage n_rows rows of `len` elements into dst[r * stride + c] as float32;
// row r starts at src + row_off(r). Rows >= n_valid and columns in
// [len, width) are zero. Chunks of 4; consecutive threads take consecutive
// chunks of a row, so global reads coalesce. `vec`: every row start is
// aligned for one 4-element load.
template <typename T, typename RowOff>
__device__ __forceinline__ void stage(float* dst, int stride, const T* __restrict__ src,
                                      RowOff row_off, int n_rows, int n_valid, int len,
                                      int width, bool vec) {
  const int chunks = width / 4;
  for (int e = threadIdx.x; e < n_rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_valid && c < len) {
      const T* p = src + row_off(r) + c;
      if (vec && c + 4 <= len) {
        load4(p, x);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i < len) x[i] = to_float(p[i]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace
