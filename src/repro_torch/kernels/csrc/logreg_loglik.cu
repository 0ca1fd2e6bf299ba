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
// the chain loop it is served warm from L2. At C = 1 the work is two
// matrix-vector products (X.beta, then X^T.coeff): tensor cores buy nothing
// there, and the kernel uses none.
//
// Design, one launch and no float atomics:
// - A block takes one tile of `Cfg<KC>::TILE` consecutive rows of one problem
//   (a contiguous span of X) and copies it into shared memory with cp.async:
//   16-byte copies for the aligned body, 4-byte ones for the ragged ends. The
//   tile is two slabs, each its own copy group, so the block computes on the
//   first while the second lands. Several blocks share an SM (the sampling
//   shape makes 400 blocks of 256 threads, all resident at once), so one
//   block's copies overlap another's arithmetic too.
// - A warp takes RG rows of a slab at once; lane l holds columns l, l+32, ...
//   of each (KC = ceil(d / 32) rounded up to a power of two), reading shared
//   memory at consecutive addresses (no bank conflicts for any d). The RG dot
//   products reduce together through one shuffle butterfly; lane r then
//   computes row r's log sigmoid and coefficient once, and the coefficients
//   are broadcast to every lane, which adds coeff * x into its own columns'
//   gradient in registers, from the same registers that held x for the dot
//   product. X is read from shared memory once per chain.
// - The block sums its 8 warps in a fixed order and writes one partial per
//   output. An integer ticket per problem (an acquire-release atomic add)
//   picks the last block to finish; it sums every block's partial in a fixed
//   order (float4 loads through L2) and resets the ticket to 0, so the next
//   launch, or the next replay of a captured graph, starts from 0. The
//   ticket buffer is shared by all launches on a device: launches must be
//   stream-ordered, as PyTorch's current stream makes them.
// - The sums are in a fixed order, so a fixed input gives the same bits on
//   every run, which keeps fixed-seed chains reproducible. Rows >= N are
//   masked here; the TPU kernel's padding row mask is not needed.
// What holds it above its bound is latency, not bandwidth or arithmetic:
// the launch of its grid, the copy-in, and the serial epilogue (the ticket,
// then the last block's loads), each a trip through L2 (logreg_probe times
// each phase). In a comparison on an H100, 8 lanes a row instead of 32 (a
// sixth of the shuffles), and tiles of one or four slabs, were no faster;
// the acquire-release ticket in place of a fence in every thread was.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// LOGREG_CUT is 0 in the port. A probe (python -m
// repro_torch.launch.logreg_probe) builds copies with phases cut out, to time
// the rest: bit 1 the arithmetic (x is only summed), 2 the ticket and the
// last block's sum, 4 the copies in, 8 everything (blocks return at entry).
#ifndef LOGREG_CUT
#define LOGREG_CUT 0
#endif

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;  // slabs a tile is copied in
constexpr int kMaxD = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448 - 1024;  // 227 KB a block, less room for static shared

// KC columns a lane; RG rows a warp takes at once (RG*KC <= 16 values of x in
// registers, 32 at KC = 32); a slab is one group of RG rows per warp.
template <int KC>
struct Cfg {
  static constexpr int RG = KC >= 16 ? 1 : 16 / KC;
  static constexpr int SLAB = kWarps * RG;
  static constexpr int TILE = kStages * SLAB;
};

// Shared memory of one block, in floats: the tile (+3 for the 16-byte
// alignment shift), its labels, and the warps' sums, which the last block
// reuses for its reduction of the partials.
size_t smem_floats(int tile, int d, int C) {
  const size_t R = (size_t)C + (size_t)d * C;
  const size_t Rp = (R + 3) & ~(size_t)3;
  size_t acc = kWarps * R;
  if (acc < 1024) acc = 1024;
  if (acc < Rp) acc = Rp;
  return (((size_t)tile * d + 3 + 3) & ~(size_t)3) + tile + acc;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` copy groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
logreg_fused(const float* __restrict__ X, const float* __restrict__ y,
             const float* __restrict__ beta, float* __restrict__ part,
             float* __restrict__ out, unsigned* __restrict__ tickets,
             int N, int d, int C, int Rp, float scale) {
  constexpr int RG = Cfg<KC>::RG;
  constexpr int SLAB = Cfg<KC>::SLAB;
  constexpr int TILE = Cfg<KC>::TILE;
  static_assert(kStages == 2, "cp_async_wait covers two slabs");
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_ticket;
  if constexpr ((LOGREG_CUT & 8) != 0) return;

  const int R = C + d * C;  // outputs per problem: C log-likelihoods, then d*C gradient
  const int g = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blk * TILE;
  const int rows = min(TILE, N - row0);

  float* s_x = smem;                                  // the tile, shifted by `a`
  float* s_y = s_x + (((size_t)TILE * d + 3 + 3) & ~(size_t)3);
  float* s_acc = s_y + TILE;                          // (kWarps, R), then the reduction

  // copy the tile in, one group per slab; global element e of the tile lands
  // at s_x[a + e], so 16-byte aligned addresses meet 16-byte aligned ones
  const float* xt = X + ((size_t)g * N + row0) * d;
  const int a = (int)(((uintptr_t)xt >> 2) & 3);
  for (int s = 0; s < kStages; ++s) {
    const int r_lo = s * SLAB;
    const int r_hi = min((s + 1) * SLAB, rows);
    if (r_lo < r_hi && (LOGREG_CUT & 4) == 0) {
      const int es = r_lo * d;
      const int ee = r_hi * d;
      const int b0 = min(es + ((4 - ((a + es) & 3)) & 3), ee);
      const int b1 = b0 + ((ee - b0) & ~3);
      for (int e = es + tid; e < b0; e += kThreads) cp_async4(s_x + a + e, xt + e);
      for (int e = b0 + 4 * tid; e < b1; e += 4 * kThreads) cp_async16(s_x + a + e, xt + e);
      for (int e = b1 + tid; e < ee; e += kThreads) cp_async4(s_x + a + e, xt + e);
      for (int r = r_lo + tid; r < r_hi; r += kThreads)
        cp_async4(s_y + r, y + (size_t)g * N + row0 + r);
    }
    cp_async_commit();
  }

  for (int c = 0; c < C; ++c) {
    float bv[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = lane + 32 * k;
      bv[k] = j < d ? beta[((size_t)g * d + j) * C + c] : 0.f;
    }
    float acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    float ll = 0.f;

    for (int s = 0; s < kStages; ++s) {
      if (c == 0) {  // the slab's copies have landed, everyone's
        cp_async_wait(kStages - 1 - s);
        __syncthreads();
      }
      const int lr0 = s * SLAB + warp * RG;  // this warp's first row in the tile
      float xv[RG][KC];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const bool ok = lr0 + r < rows;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int j = lane + 32 * k;
          xv[r][k] = (ok && j < d) ? s_x[a + (lr0 + r) * d + j] : 0.f;
        }
      }
      if constexpr ((LOGREG_CUT & 1) != 0) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int k = 0; k < KC; ++k) acc[k] += xv[r][k];
        continue;
      }
      float p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) t = fmaf(xv[r][k], bv[k], t);
        p[r] = t;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < RG; ++r) p[r] += __shfl_xor_sync(0xffffffffu, p[r], o);
      }
      // lane r takes row r: its log sigmoid and coefficient, computed once
      float z = p[0];
#pragma unroll
      for (int r = 1; r < RG; ++r) z = lane == r ? p[r] : z;
      const bool mine = lane < RG && lr0 + lane < rows;
      float coeff = 0.f;
      if (mine) {
        const float yz = s_y[lr0 + lane] * z;
        const float e = expf(-fabsf(yz));
        // y * sigmoid(-yz) without overflow, and log sigmoid(yz) = min(yz, 0) - log1p(e)
        coeff = s_y[lr0 + lane] * (yz >= 0.f ? e / (1.f + e) : 1.f / (1.f + e));
        ll += fminf(yz, 0.f) - log1pf(e);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float cr = __shfl_sync(0xffffffffu, coeff, r);
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] = fmaf(cr, xv[r][k], acc[k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, o);
    if (lane == 0) s_acc[warp * R + c] = ll;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = lane + 32 * k;
      if (j < d) s_acc[warp * R + C + j * C + c] = acc[k];
    }
  }
  __syncthreads();

  // the block's partial: its warps summed in a fixed order; (G, nblk, Rp)
  float* pb = part + ((size_t)g * nblk + blk) * Rp;
  for (int o = tid; o < Rp; o += kThreads) {
    float v = 0.f;
    if (o < R) {
      for (int w = 0; w < kWarps; ++w) v += s_acc[w * R + o];
    }
    pb[o] = v;
  }
  if constexpr ((LOGREG_CUT & 2) != 0) return;
  // The barrier orders the block's partial before thread 0's ticket, an
  // acquire-release add at GPU scope: it publishes the partial (release), and
  // in the last block it makes every earlier block's partial visible
  // (acquire); the second barrier orders the last block's loads after it.
  __syncthreads();
  if (tid == 0) {
    unsigned t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(tickets + g) : "memory");
    s_ticket = t;
  }
  __syncthreads();
  if (s_ticket != (unsigned)(nblk - 1)) return;

  // the last block: NQ groups of blocks (block b in group b mod NQ), each
  // summed in block order per float4 of outputs, then the groups in order
  const int R4 = Rp >> 2;
  const int NQ = max(1, kThreads / R4);
  const float4* p4 = reinterpret_cast<const float4*>(part + (size_t)g * nblk * Rp);
  float4* s_red = reinterpret_cast<float4*>(s_acc);
  for (int i = tid; i < NQ * R4; i += kThreads) {
    const int q = i / R4;
    const int col = i - q * R4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int b = q; b < nblk; b += NQ) {
      const float4 v = __ldcg(p4 + (size_t)b * R4 + col);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    s_red[i] = t;
  }
  __syncthreads();
  for (int o = tid; o < R; o += kThreads) {
    float v = 0.f;
    for (int q = 0; q < NQ; ++q) v += s_acc[q * Rp + o];
    out[(size_t)g * R + o] = scale * v;
  }
  if (tid == 0) tickets[g] = 0u;
}

// KC for d: ceil(d / 32) rounded up to a power of two (d <= kMaxD)
int cols_per_lane(int d) {
  int kc = 1;
  while (32 * kc < d) kc *= 2;
  return kc;
}

int tile_rows(int kc) {
  switch (kc) {
    case 1: return Cfg<1>::TILE;
    case 2: return Cfg<2>::TILE;
    case 4: return Cfg<4>::TILE;
    case 8: return Cfg<8>::TILE;
    case 16: return Cfg<16>::TILE;
    default: return Cfg<32>::TILE;
  }
}

template <int KC>
cudaError_t launch(const float* X, const float* y, const float* beta, float* part, float* out,
                   unsigned* tickets, int G, int N, int d, int C, float scale, cudaStream_t s) {
  constexpr int TILE = Cfg<KC>::TILE;
  const size_t smem = smem_floats(TILE, d, C) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(logreg_fused<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nblk = (N + TILE - 1) / TILE;
  const int Rp = ((C + d * C) + 3) & ~3;
  logreg_fused<KC><<<dim3(nblk, G), kThreads, smem, s>>>(X, y, beta, part, out, tickets, N, d,
                                                          C, Rp, scale);
  return cudaGetLastError();
}

}  // namespace

// Rows of X one block takes at width d (the partials are (G, ceil(N / rows), Rp)).
extern "C" int logreg_tile_rows(int d) { return tile_rows(cols_per_lane(d)); }

// Dynamic shared memory one block needs, in bytes; 0 when d is beyond the
// kernel or the block would need more than an SM can give.
extern "C" long long logreg_smem_bytes(int d, int C) {
  if (d < 1 || d > kMaxD || C < 1) return 0;
  const size_t b = smem_floats(tile_rows(cols_per_lane(d)), d, C) * sizeof(float);
  return b > kMaxSmem ? 0 : (long long)b;
}

// part:    (G, ceil(N / logreg_tile_rows(d)), Rp) float32 scratch, Rp = C + d*C rounded up to 4.
// out:     (G, C + d*C) float32.
// tickets: >= G unsigned ints, zero before the first launch; every launch leaves them zero.
extern "C" int logreg_loglik_grad_f32(int device, const float* X, const float* y,
                                      const float* beta, float* part, float* out,
                                      unsigned* tickets, int G, int N, int d, int C,
                                      float scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (logreg_smem_bytes(d, C) == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols_per_lane(d)) {
    case 1: return launch<1>(X, y, beta, part, out, tickets, G, N, d, C, scale, s);
    case 2: return launch<2>(X, y, beta, part, out, tickets, G, N, d, C, scale, s);
    case 4: return launch<4>(X, y, beta, part, out, tickets, G, N, d, C, scale, s);
    case 8: return launch<8>(X, y, beta, part, out, tickets, G, N, d, C, scale, s);
    case 16: return launch<16>(X, y, beta, part, out, tickets, G, N, d, C, scale, s);
    default: return launch<32>(X, y, beta, part, out, tickets, G, N, d, C, scale, s);
  }
}

extern "C" const char* logreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
