// Fused Welford/Chan-merge update of streaming moments, all M machines in one launch.
//
// Replaces the TPU kernel src/repro/kernels/online_update/kernel.py:69
// (online_update_kernel, body _online_update_body at :36, wrapper ops.py:36).
//
// Per machine m, with chunk x (C, d), valid rows r < nv = min(cc, C), cc the
// machine's chunk count (all C when no counts are given), n_b = cc:
//
//   mean_b = sum_{r<nv} x[r] / max(n_b, 1)
//   m2_b   = sum_{r<nv} (x[r] - mean_b)(x[r] - mean_b)^T
//   n      = n_a + n_b,  delta = mean_b - mean
//   mean'  = mean + delta * n_b / max(n, 1)
//   m2'    = m2 + m2_b + delta delta^T * n_a n_b / max(n, 1)
//
// and count' = n. A machine with n_b <= 0 gets its mean and m2 back as they
// were, bit for bit. Rows at or beyond nv are never read, so NaN there stays
// out (the TPU kernel selects them to zero; no mask is ever multiplied).
//
// Operands: chunk (M, C, d) with contiguous rows and machine m starting at
// m * stride_m (a (M, C, d) slice of a longer (M, T, d) draw buffer needs no
// copy), count (M,), mean (M, d), m2 (M, d, d), all float32, the last three
// contiguous; chunk_counts (M,) int32 or null. Outputs are separate buffers
// of the state's shapes.
//
// Bound on an H100: at the streaming path's shape (M=10, C=120, d=50) the
// fold reads ~0.34 MB and writes ~0.1 MB (0.13 us at 3.35 TB/s) and does
// 2*M*C*d^2 = 6 MFLOP (0.09 us at 67 TFLOP/s), so a launch (several us)
// is the real cost and the design is the simplest deterministic one. The TPU
// kernel ran one grid step per machine with the whole (C, d) tile and the
// (d, d) state in VMEM; here a block owns one 32x32 tile of one machine's m2
// (grid: column tile, row tile, machine), so d of any size needs no padding:
//   1. the block sums its 64 columns (the tile's row and column sets) over
//      the valid rows, four fixed strided partial sums per column combined in
//      a fixed order, so every block that needs a column gets the same bits;
//   2. it stages 32 centred rows at a time in shared memory and each thread
//      accumulates four entries of the tile's Gram over the valid rows;
//   3. it writes m2' for its tile; diagonal tiles write mean', one block the
//      count.
// No float atomics anywhere: a fixed input gives the same bits on every run,
// and m2' is exactly symmetric (each pair's products summed in row order).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;                      // m2 tile edge; threads in x
constexpr int kRowsPerPass = 8;                // threads in y
constexpr int kThreads = kTile * kRowsPerPass; // 256
constexpr int kCols = 2 * kTile;               // the tile's row and column sets
constexpr int kParts = kThreads / kCols;       // partial sums per column (4)
constexpr int kPerThread = kTile / kRowsPerPass;

__global__ void __launch_bounds__(kThreads)
online_update_kernel(const float* __restrict__ chunk, const int* __restrict__ chunk_counts,
                     const float* __restrict__ count, const float* __restrict__ mean,
                     const float* __restrict__ m2, float* __restrict__ count_out,
                     float* __restrict__ mean_out, float* __restrict__ m2_out, int C, int d,
                     long long stride_m) {
  __shared__ float part[kParts][kCols];
  __shared__ float mu_b[kCols];  // chunk means: [0, 32) the row set, [32, 64) the column set
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];

  const int m = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;

  const int cc = chunk_counts ? chunk_counts[m] : C;
  const int nv = cc <= 0 ? 0 : (cc < C ? cc : C);
  const float n_b = (float)cc;
  const float* x = chunk + (size_t)m * (size_t)stride_m;

  {  // 1. chunk means of the 64 columns, in a fixed order
    const int c = tid % kCols, p = tid / kCols;
    const int col = c < kTile ? i0 + c : j0 + (c - kTile);
    float s = 0.f;
    if (col < d)
      for (int r = p; r < nv; r += kParts) s += x[(size_t)r * d + col];
    part[p][c] = s;
  }
  __syncthreads();
  if (tid < kCols)
    mu_b[tid] = ((part[0][tid] + part[1][tid]) + (part[2][tid] + part[3][tid])) / fmaxf(n_b, 1.f);
  __syncthreads();

  // 2. the tile of sum_r cent[r, i] cent[r, j] over the valid rows
  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;
  const int ci = i0 + tx, cj = j0 + tx;
  const float mi = mu_b[tx], mj = mu_b[kTile + tx];
  for (int r0 = 0; r0 < nv; r0 += kTile) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int rr = ty + k * kRowsPerPass;
      const int r = r0 + rr;
      const bool row_ok = r < nv;
      As[rr][tx] = (row_ok && ci < d) ? x[(size_t)r * d + ci] - mi : 0.f;
      Bs[rr][tx] = (row_ok && cj < d) ? x[(size_t)r * d + cj] - mj : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTile; ++rr) {
      const float b = Bs[rr][tx];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) acc[k] += As[rr][ty + k * kRowsPerPass] * b;
    }
    __syncthreads();
  }

  // 3. the Chan merge
  const float n_a = count[m];
  const float n = n_a + n_b;
  const float n_safe = fmaxf(n, 1.f);
  const bool upd = n_b > 0.f;
  const float coef = n_a * n_b / n_safe;
  const float* mean_m = mean + (size_t)m * d;
  const int j = j0 + tx;
  if (j < d) {
    const float dj = mu_b[kTile + tx] - mean_m[j];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int ii = ty + k * kRowsPerPass;
      const int i = i0 + ii;
      if (i < d) {
        const size_t o = ((size_t)m * d + i) * d + j;
        const float old = m2[o];
        if (upd) {
          const float di = mu_b[ii] - mean_m[i];
          m2_out[o] = (old + acc[k]) + (di * dj) * coef;
        } else {
          m2_out[o] = old;
        }
      }
    }
    if (blockIdx.x == blockIdx.y && ty == 0) {
      const float mv = mean_m[j];
      mean_out[(size_t)m * d + j] = upd ? mv + dj * (n_b / n_safe) : mv;
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) count_out[m] = n;
}

}  // namespace

extern "C" int online_update_f32(int device, const float* chunk, const int* chunk_counts,
                                 const float* count, const float* mean, const float* m2,
                                 float* count_out, float* mean_out, float* m2_out, int M, int C,
                                 int d, long long stride_m, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int tiles = (d + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, M);
  const dim3 block(kTile, kRowsPerPass);
  online_update_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      chunk, chunk_counts, count, mean, m2, count_out, mean_out, m2_out, C, d, stride_m);
  return cudaGetLastError();
}

extern "C" const char* online_update_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
