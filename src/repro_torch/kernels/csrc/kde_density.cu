// Batched all-machines Gaussian-KDE log density, with fused reductions.
//
// Replaces the TPU kernels src/repro/kernels/kde_density/kernel.py:166
// (machine_kde_log_density_kernel, body _machine_kde_kernel at :80, wrapper
// ops.py:35) and kernel.py:239 (kde_log_density_kernel, body _kde_kernel at
// :33, wrapper ops.py:109). The single-cloud form is this kernel with M = 1,
// counts = [ns] and no reduction: its normalizer log ns is log max(counts, 1).
//
// For queries q (Q, d), samples s (M, T, d), bandwidths h (M,) and valid
// prefixes counts (M,):
//
//   lp[m, q] = logsumexp_{t < counts[m]} ( -||q - s[m,t]||^2 / (2 h_m^2) )
//              - log max(counts[m], 1) - (d/2) log(2 pi h_m^2)
//
// and, for the reduced modes, prod[q] = sum_m lp[m, q] and
// mix[q] = logsumexp_m (logw[m] + lp[m, q]). An empty machine gives -inf and
// enters the mixture as no mass. Rows at index >= counts[m] are never loaded,
// so NaN there stays inert.
//
// Distances are formed directly, sum_k (q_k - s_k)^2, not as the TPU
// kernel's MXU identity ||q||^2 + ||s||^2 - 2 q.s: on the logreg path the
// draws sit ~sqrt(50) from the origin with a spread of 0.02-0.05, and the
// identity cancels there to errors of ~1e-2 in a log-kernel term in float32.
// On the card's float32 cores the direct form costs the same (one subtract,
// one FMA per element). No TF32, no tensor cores.
//
// Bound on an H100: operations. At the path's shape (Q = 12,000 pooled
// draws, M = 10, T = 1,200, d = 50) the kernel does 1.44e8 query-sample
// pairs, ~1.4e10 float32 flops and 1.44e8 exp, on 4.8 MB of inputs. Design:
//
// Pass 1, grid (query tile, machine, row split): 64 threads, each holding 2
// queries (kBlockQ = 128 queries per block). The block's queries are staged
// once in shared memory, transposed, in windows of kQueryWindow dims (a
// larger d reloads its windows per row tile), so each thread reads its two
// queries' dims as one conflict-free 8-byte load. Machine m's valid rows of
// this split stream through shared memory in tiles of kTileT rows by kChunkD
// dims; every thread reads the tile by broadcast float4 loads, so one
// shared-memory load feeds 16 float32 operations. Each query keeps a running
// (max, sum) online logsumexp in registers and writes it to the partials
// (S, M, Q). The rows of a machine are split S ways when the query tiles
// times the machines alone would not fill the card (S from
// kde_machine_splits: at the path's Q = 12,000, 94 x 10 blocks and S = 2; at
// the init_pool's Q = 1,000, 8 x 10 blocks and S = 14).
//
// Pass 2: one thread per query folds, for each machine in order, its S
// partials into lp[m, q], and then m = 0..M-1 in order into the product and
// the mixture. No float atomics anywhere, so a fixed input on a fixed card
// gives the same bits on every run (the JAX contract that a fixed seed gives
// the same chain).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kQueriesPerThread = 2;
constexpr int kBlockQ = kThreads * kQueriesPerThread;
constexpr int kTileT = 32;
constexpr int kChunkD = 32;
constexpr int kQueryWindow = 2 * kChunkD;  // query dims staged at once
constexpr int kQueryStride = kBlockQ + 2;  // padded row of the transposed queries
constexpr int kBlocksPerSm = 8;            // the split rule's target of blocks per SM
constexpr float kLog2Pi = 1.8378770664093453f;

__device__ __forceinline__ int rows_per_split(int T, int S) {
  const int tiles = (T + kTileT - 1) / kTileT;
  return ((tiles + S - 1) / S) * kTileT;
}

__global__ void __launch_bounds__(kThreads)
kde_machine_pass1(const float* __restrict__ queries, const float* __restrict__ samples,
                  const int* __restrict__ counts, const float* __restrict__ h,
                  float* __restrict__ part_max, float* __restrict__ part_sum, int Q, int M,
                  int T, int d) {
  __shared__ __align__(16) float tile[kTileT][kChunkD];
  __shared__ __align__(16) float qs[kQueryWindow][kQueryStride];  // qs[k][query]
  const int m = blockIdx.y;
  const int split = blockIdx.z;
  const int qb = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, Q - qb);
  const int cnt = counts[m];
  const int n_valid = cnt < T ? (cnt > 0 ? cnt : 0) : T;
  const int span = rows_per_split(T, gridDim.z);
  const int r_begin = split * span;
  const int r_end = min(n_valid, r_begin + span);
  const float hm = h[m];
  const float inv2h2 = 0.5f / (hm * hm);
  const float* sm = samples + (size_t)m * T * d;
  const int lq = threadIdx.x * kQueriesPerThread;  // this thread's first query in the block

  float run_max[kQueriesPerThread];
  float run_sum[kQueriesPerThread];
#pragma unroll
  for (int i = 0; i < kQueriesPerThread; ++i) {
    run_max[i] = -INFINITY;
    run_sum[i] = 0.f;
  }

  bool window_loaded = false;
  for (int t0 = r_begin; t0 < r_end; t0 += kTileT) {
    const int rows = min(kTileT, r_end - t0);
    float acc[kQueriesPerThread][kTileT];
#pragma unroll
    for (int i = 0; i < kQueriesPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kTileT; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kChunkD) {
      const int kw = k0 % kQueryWindow;  // this chunk's offset in the window
      // one window for all of d stays loaded; a wider d reloads per row tile
      const bool load_window = kw == 0 && (d > kQueryWindow || !window_loaded);
      __syncthreads();  // the previous chunk's (and window's) reads are done
      if (load_window) {
        const int w = min(kQueryWindow, d - k0);
        for (int e = threadIdx.x; e < nq * w; e += kThreads) {
          const int r = e / w, k = e % w;
          qs[k][r] = queries[(size_t)(qb + r) * d + k0 + k];
        }
        window_loaded = true;
      }
      for (int e = threadIdx.x; e < kTileT * kChunkD; e += kThreads) {
        const int j = e / kChunkD, k = e % kChunkD;
        // rows past this split's valid rows and dims past d are never loaded
        tile[j][k] = (j < rows && k0 + k < d) ? sm[(size_t)(t0 + j) * d + k0 + k] : 0.f;
      }
      __syncthreads();
      const int kmax = min(kChunkD, d - k0);
#pragma unroll
      for (int k = 0; k < kChunkD; k += 4) {
        if (k < kmax) {  // uniform over the block: skips the tail of the last chunk
          float qv[kQueriesPerThread][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // dims past d meet zeros in the tile; their query entries are
            // whatever the window holds, so zero them too
            const float2 q2 = k + kk < kmax
                                  ? *reinterpret_cast<const float2*>(&qs[kw + k + kk][lq])
                                  : make_float2(0.f, 0.f);
            qv[0][kk] = q2.x;
            qv[1][kk] = q2.y;
          }
#pragma unroll
          for (int j = 0; j < kTileT; ++j) {
            const float4 s4 = *reinterpret_cast<const float4*>(&tile[j][k]);
#pragma unroll
            for (int i = 0; i < kQueriesPerThread; ++i) {
              float a = acc[i][j];
              float diff = qv[i][0] - s4.x;
              a = fmaf(diff, diff, a);
              diff = qv[i][1] - s4.y;
              a = fmaf(diff, diff, a);
              diff = qv[i][2] - s4.z;
              a = fmaf(diff, diff, a);
              diff = qv[i][3] - s4.w;
              a = fmaf(diff, diff, a);
              acc[i][j] = a;
            }
          }
        }
      }
    }

    // online logsumexp over this tile's valid rows
#pragma unroll
    for (int i = 0; i < kQueriesPerThread; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTileT; ++j)
        if (j < rows) tile_max = fmaxf(tile_max, -acc[i][j] * inv2h2);
      const float new_max = fmaxf(run_max[i], tile_max);
      if (new_max == -INFINITY) continue;  // every score so far is -inf
      float s = run_sum[i] * expf(run_max[i] - new_max);
#pragma unroll
      for (int j = 0; j < kTileT; ++j)
        if (j < rows) s += expf(-acc[i][j] * inv2h2 - new_max);
      run_max[i] = new_max;
      run_sum[i] = s;
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerThread; ++i) {
    const int q = qb + lq + i;
    if (q < Q) {
      const size_t o = ((size_t)split * M + m) * Q + q;
      part_max[o] = run_max[i];
      part_sum[o] = run_sum[i];
    }
  }
}

__global__ void kde_machine_pass2(const float* __restrict__ part_max,
                                  const float* __restrict__ part_sum,
                                  const int* __restrict__ counts, const float* __restrict__ h,
                                  const float* __restrict__ logw, float* __restrict__ lp,
                                  float* __restrict__ prod, float* __restrict__ mix, int Q, int M,
                                  int d, int S) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float sum = 0.f, mx = -INFINITY, acc = 0.f;
  for (int m = 0; m < M; ++m) {
    // this machine's S row splits, merged in order
    float pm = -INFINITY, ps = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t o = ((size_t)s * M + m) * Q + q;
      const float sm = part_max[o];
      if (sm == -INFINITY) continue;  // an empty split
      const float nm = fmaxf(pm, sm);
      ps = ps * expf(pm - nm) + part_sum[o] * expf(sm - nm);
      pm = nm;
    }
    const float hm = h[m];
    const float log_norm =
        logf(fmaxf((float)counts[m], 1.f)) + 0.5f * (float)d * (2.f * logf(hm) + kLog2Pi);
    const float v = pm + logf(ps) - log_norm;  // -inf for an empty machine
    lp[(size_t)m * Q + q] = v;
    sum += v;  // -inf propagates: an empty machine has no product mass
    if (mix == nullptr) continue;  // logw is null without a mixture
    const float lw = v + logw[m];
    if (lw == -INFINITY) continue;  // an empty machine enters the mixture as no mass
    const float nm = fmaxf(mx, lw);
    acc = acc * expf(mx - nm) + expf(lw - nm);
    mx = nm;
  }
  if (prod != nullptr) prod[q] = sum;
  if (mix != nullptr) mix[q] = mx + logf(acc);
}

}  // namespace

// The number of row splits S the entry point expects partials for: enough
// blocks for kBlocksPerSm per SM, at least one row tile per split.
extern "C" int kde_machine_splits(int Q, int M, int T, int num_sms) {
  const long blocks = (long)((Q + kBlockQ - 1) / kBlockQ) * M;
  const long target = (long)kBlocksPerSm * num_sms;
  const int tiles = (T + kTileT - 1) / kTileT;
  long s = (target + blocks - 1) / blocks;
  if (s > tiles) s = tiles;
  return s < 1 ? 1 : (int)s;
}

// part_max, part_sum (S, M, Q) scratch; lp (M, Q) is always written; prod
// and mix (Q,) are written when not null; logw (M,) is read only for the
// mixture.
extern "C" int kde_machine_log_density_f32(int device, const float* queries, const float* samples,
                                           const float* h, const int* counts, const float* logw,
                                           float* part_max, float* part_sum, float* lp,
                                           float* prod, float* mix, int Q, int M, int T, int d,
                                           int S, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kBlockQ - 1) / kBlockQ, M, S);
  kde_machine_pass1<<<grid, kThreads, 0, st>>>(queries, samples, counts, h, part_max, part_sum,
                                               Q, M, T, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kde_machine_pass2<<<(Q + 255) / 256, 256, 0, st>>>(part_max, part_sum, counts, h, logw, lp,
                                                     prod, mix, Q, M, d, S);
  return cudaGetLastError();
}

extern "C" const char* kde_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
