// IMG mixture log-weights, paper Eq. 3.5, for P candidate components.
//
// Replaces the TPU kernel src/repro/kernels/img_weights/kernel.py:54
// (img_log_weights_kernel, body _img_weights_kernel at :33, wrapper ops.py:27).
//
//   out[p] = -SSE_p / (2 h^2) - M * (d/2) * log(2 pi h^2),
//   SSE_p  = sum_m || theta[p, m, :] - mean_m theta[p, m, :] ||^2
//
// theta (P, M, d) float32 contiguous, h a one-element float32 device buffer
// (read on the device, so the caller never waits for it), out (P,) float32.
//
// Bound on an H100: launch overhead. At the path's shapes (P=160, M=10,
// d=50) the kernel reads 320 KB, ~0.1 us at 3.35 TB/s, and does ~0.3 MFLOP;
// a launch costs several microseconds. So the design is the simplest one that
// reads theta once from device memory: one warp per candidate p, its lanes
// striding d; each lane forms the mean over M of its columns and then their
// squared deviations (the second read of the column hits L1), and a shuffle
// tree sums the lanes. The ragged edges of P and d are masked here and the
// normalizer uses the true d, so the TPU wrapper's zero-pad-and-correct step
// has no counterpart.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
img_log_weights_kernel(const float* __restrict__ theta, const float* __restrict__ h,
                       float* __restrict__ out, int P, int M, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // the whole warp leaves together
  const float* t = theta + (size_t)p * M * d;
  float sse = 0.f;
  for (int j = lane; j < d; j += 32) {
    float sum = 0.f;
    for (int m = 0; m < M; ++m) sum += t[(size_t)m * d + j];
    const float mean = sum / (float)M;
    for (int m = 0; m < M; ++m) {
      const float dv = t[(size_t)m * d + j] - mean;
      sse += dv * dv;
    }
  }
  sse = warp_sum(sse);
  if (lane == 0) {
    const float hh = h[0] * h[0];
    const float log_norm = (float)M * ((float)d / 2.f) * logf(2.f * 3.14159265358979f * hh);
    out[p] = -0.5f * sse / hh - log_norm;
  }
}

}  // namespace

extern "C" int img_log_weights_f32(int device, const float* theta, const float* h, float* out,
                                   int P, int M, int d, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int blocks = (P + kWarps - 1) / kWarps;
  img_log_weights_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      theta, h, out, P, M, d);
  return cudaGetLastError();
}

extern "C" const char* img_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
