// Fused logistic log-likelihood and gradient for G independent problems.
//
// Replaces the TPU kernel src/repro/kernels/logreg_loglik/kernel.py:62
// (logreg_loglik_grad_kernel, body _logreg_kernel at :33, wrapper ops.py:21).
//
//   ll[g, c]      = scale * sum_i log sigmoid(y[g,i] * x[g,i] . beta[g,:,c])
//   grad[g, :, c] = scale * sum_i y[g,i] * sigmoid(-y[g,i] * x[g,i] . beta[g,:,c]) * x[g,i]
//
// X (G, N, d), y (G, N) in {-1, +1}, beta (G, d, C), all float32 and
// contiguous. The output is one (G, C + d*C) buffer: ll in columns [0, C),
// grad in [C, C + d*C) laid out as (d, C).
//
// Bound on an H100: memory. Every element of X is read once and used for 4*C
// flops, so at the sampling shapes (G=10, N=5000, d=50, C=1: 10 MB of X) the
// HBM bound is ~3 us at 3.35 TB/s against ~0.15 us of f32 arithmetic at
// 67 TFLOP/s. X is re-read by every MCMC step and fits in the 50 MB L2, so in
// the chain loop it is served warm from L2 more often than from HBM.
//
// Design: the value and the gradient come from ONE pass over X (the TPU
// kernel's point too). Pass 1 gives each block `rows_per_block` rows of one
// problem; each warp takes a row, its lanes stride d, a warp shuffle reduces
// the dot product, and each lane adds coeff * x into its own columns of a
// per-warp gradient row in shared memory. The block then sums its warps in a
// fixed order and writes one partial per block. Pass 2 sums the partials of
// each output in a fixed order (lanes over blocks, then a shuffle tree). No
// float atomics, so a fixed input gives bitwise the same output run to run,
// which keeps fixed-seed chains reproducible. Rows >= N are masked here; the
// TPU kernel's padding row mask is not needed.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// log sigmoid(z) = min(z, 0) - log1p(exp(-|z|)), stable for every z.
__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.f) - log1pf(expf(-fabsf(z)));
}

// sigmoid(-z) without overflow for either sign of z.
__device__ __forceinline__ float sigmoid_neg(float z) {
  const float e = expf(-fabsf(z));
  return z >= 0.f ? e / (1.f + e) : 1.f / (1.f + e);
}

__global__ void __launch_bounds__(kThreads)
logreg_partials(const float* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ beta, float* __restrict__ part,
                int N, int d, int C, int rows_per_block) {
  extern __shared__ float smem[];
  const int dC = d * C;
  const int R = C + dC;  // outputs per problem: C log-likelihoods, then d*C gradient
  float* s_beta = smem;                  // (d, C)
  float* s_acc = s_beta + dC;            // (kWarps, R)

  const int g = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int j = threadIdx.x; j < dC; j += kThreads) s_beta[j] = beta[(size_t)g * dC + j];
  for (int j = threadIdx.x; j < kWarps * R; j += kThreads) s_acc[j] = 0.f;
  __syncthreads();

  const float* Xg = X + (size_t)g * N * d;
  const float* yg = y + (size_t)g * N;
  float* acc = s_acc + warp * R;
  const int row0 = blk * rows_per_block;
  const int row1 = min(row0 + rows_per_block, N);
  for (int i = row0 + warp; i < row1; i += kWarps) {
    const float* xi = Xg + (size_t)i * d;
    const float yi = yg[i];
    for (int c = 0; c < C; ++c) {
      float z = 0.f;
      for (int j = lane; j < d; j += 32) z += xi[j] * s_beta[j * C + c];
      z = yi * warp_sum(z);
      const float coeff = yi * sigmoid_neg(z);
      for (int j = lane; j < d; j += 32) acc[C + j * C + c] += coeff * xi[j];
      if (lane == 0) acc[c] += log_sigmoid(z);
    }
  }
  __syncthreads();

  // fixed-order sum over the block's warps; partials laid out (G, R, nblk)
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_acc[w * R + r];
    part[((size_t)g * R + r) * nblk + blk] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
logreg_reduce(const float* __restrict__ part, float* __restrict__ out, int R,
              int nblk, float scale) {
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp leaves together
  const float* p = part + ((size_t)g * R + r) * nblk;
  float s = 0.f;
  for (int b = lane; b < nblk; b += 32) s += p[b];
  s = warp_sum(s);
  if (lane == 0) out[(size_t)g * R + r] = scale * s;
}

}  // namespace

extern "C" int logreg_rows_per_block() { return 64; }

// part: (G, C + d*C, ceil(N / rows_per_block)) float32 scratch.
// out:  (G, C + d*C) float32.
extern "C" int logreg_loglik_grad_f32(int device, const float* X, const float* y,
                                      const float* beta, float* part, float* out,
                                      int G, int N, int d, int C, float scale,
                                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int rpb = logreg_rows_per_block();
  const int nblk = (N + rpb - 1) / rpb;
  const int R = C + d * C;
  const size_t smem = (size_t)(d * C + kWarps * R) * sizeof(float);
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(logreg_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  logreg_partials<<<dim3(nblk, G), kThreads, smem, s>>>(X, y, beta, part, N, d, C, rpb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  logreg_reduce<<<dim3((R + kWarps - 1) / kWarps, G), kThreads, 0, s>>>(part, out, R, nblk,
                                                                      scale);
  return cudaGetLastError();
}

extern "C" const char* logreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
