// Batched all-machines Gaussian-KDE log density, with fused reductions, on
// Hopper's tensor cores.
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
// Distances by the TPU kernel's identity ||q||^2 + ||s||^2 - 2 q.s, made
// safe for float32 by two steps. On the logreg path the draws sit ~sqrt(50)
// from the origin with a spread of 0.02-0.05 and h ~0.025; there the identity
// cancels in float32 to errors of ~1e-2 in log p, and forming sum (q - s)^2
// directly costs two float32 instructions a query-sample-dim on the FMA
// pipe. (1) Centre: both operands are taken relative to a mean
// mu_m of the machine's valid rows, which leaves every distance as it is and
// shrinks the norms the identity cancels to the spread. (2) Split:
// the centred cross term goes to the tensor cores as 3xTF32 (tf32x3.cuh):
// hi.hi + hi.lo + lo.hi in one float32 accumulator, about float32's
// accuracy. A PyTorch model of this arithmetic (ref.py,
// machine_kde_log_density_split; tests/test_torch_kde_split.py) is within
// 5e-5 of float64 at the path's scale; one TF32 pass or the uncentred
// float32 identity are not within 1e-3.
//
// Bound on an H100: the tensor cores. At the path's shape (Q = 12,000 pooled
// draws, M = 10, T = 1,200, d = 50) the three passes are 3 x 2.Q.M.T.d =
// 4.3e10 flop (87 us at 495 TFLOP/s dense TF32), the 1.44e8 exps 34 us on the
// MUFU, the inputs 4.8 MB. Design:
//
// Pre-pass (two small kernels): kde_centre takes mu_m as the mean of up to
// 256 of machine m's valid rows, evenly spaced (any point among the draws
// keeps the identity exact and the norms small); kde_split writes the centred
// rows as TF32 hi and lo into scratch (M, Tp, dp), dp = d + 1 rounded up to
// 8: column d holds the row's term -||s_c||^2 / 2 and the queries carry 1
// there, so one product gives q_c.s_c - ||s_c||^2 / 2 and no per-column term
// is loaded or added; zeros past it and past counts[m] up to Tp (T rounded
// up to the tile).
//
// Main kernel, kde_tc_kernel: one persistent block an SM (227 KB of shared
// memory) walks work items (query block of 192, machine, row split) with
// the grid's stride. A producer warpgroup gives its registers away
// (setmaxnreg) and one of its threads keeps a two-stage ring of sample tiles
// full (128 rows x 64 dims, TF32 hi and lo, by TMA in the 128-byte swizzle
// wgmma reads), across work items, so a new item starts on tiles already in
// flight. Three consumer warpgroups own 64 queries each: a warpgroup centres
// its rows by mu_m, splits them and stores them swizzled (64 dims a chunk; a
// wider d restages its chunk for every chunk of every tile), then for each
// tile computes its 64 x 128 product S = q_c.s_c - ||s_c||^2 / 2 with wgmma
// m64n128k8 TF32 (both operands from shared memory): the hi.lo and lo.hi
// passes, then hi.hi, dp/8 k steps each. The warpgroups take turns on the
// tensor cores (named barriers, in a ring): while one runs its products the
// others score their last tiles, so the exps hide behind the products; 192
// queries a tile cut the tiles' trips from L2 by a third against 128.
// Epilogue on the accumulator fragment in base 2: x = 2c.S (c =
// log2(e)/2h^2; the row's -c||q_c||^2 is added at the end), columns past
// counts[m] selected to -inf, then an online (max, sum) per row (four chains
// a row, then quad shuffles) and ex2.approx. Rows of a machine are split S
// ways when query blocks times machines would leave SMs idle
// (kde_machine_splits).
//
// Merge: kde_merge_splits folds, for each (machine, query), its S partials in
// split order into lp[m, q]; kde_merge_machines folds m = 0..M-1 in order
// into the product and the mixture. Each thread loads a batch of its inputs
// before it folds them. No float atomics anywhere, so a fixed input on a
// fixed card gives the same bits on every run (the JAX contract that a fixed
// seed gives the same chain).
//
// On an H100 SXM (700 W) at the path's shape: 178 us (Q = 12,000) and 39 us
// (Q = 1,000) through the wrapper (chip_smoke.py phase 5).
//
// KDE_CUT (probe builds only, python -m repro_torch.launch.kde_probe): 1 stops
// after the pre-pass; 2 runs the main kernel's copies, staging and turns but
// no product; 3 adds the three product passes (the epilogue reads one value
// of each accumulator: ptxas deletes a wgmma whose result is never read); 4
// the epilogue's scores and max, no exps; 5 everything but the merge.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pipeline.cuh"
#include "tf32x3.cuh"

#ifndef KDE_CUT
#define KDE_CUT 0
#endif

namespace {

using namespace tf32x3;
using namespace sm90;

constexpr int kCut = KDE_CUT;
constexpr int kCons = 3;                            // consumer warpgroups, 64 queries each (wgmma's M)
constexpr int kThreads = 128 * (kCons + 1);         // and one producer warpgroup
constexpr int kBQ = 64 * kCons;                     // queries a work item
constexpr int kN = 128;                             // sample rows a tile (wgmma's N)
constexpr int kKC = 64;                             // dims a chunk: two swizzled column blocks
constexpr int kStages = 2;                          // the ring of sample tiles
constexpr int kQBlk = 64 * kRowBytes;               // 64 query rows of a column block
constexpr int kSBlk = kN * kRowBytes;               // a tile's rows of a column block: a TMA box
constexpr int kSlab = 2 * kQBlk;                    // a warpgroup's queries, one chunk, hi or lo
constexpr int kQHalf = kCons * kSlab;               // every warpgroup's hi (then every lo)
constexpr int kStage = 4 * kSBlk;                   // both column blocks' hi, then their lo
constexpr int kOffStage = 2 * kQHalf;
constexpr int kOffQn = kOffStage + kStages * kStage;    // the work item's query terms
constexpr int kOffBar = kOffQn + kBQ * 4;               // full[kStages], empty[kStages]
constexpr int kSmem = kOffBar + 16 * kStages + 1024;    // + slack to align the base to 1,024
constexpr int kConsumerRegs = 160, kProducerRegs = 24;  // 384 x 160 + 128 x 24 <= 65,536
constexpr int kBarTurn = 1;          // named barrier kBarTurn + w: warpgroup w's turn on the tensor cores
constexpr int kBarOwn = 1 + kCons;   // named barrier kBarOwn + w: warpgroup w's own 128 threads
constexpr int kTurn = 128 * 2;       // a turn's barrier: its warpgroup and the one handing over
constexpr int kRowsPerWarp = 16;                    // query rows a consumer warp stages
constexpr int kCentreRows = 256;                    // rows the centre is the mean of, at most
constexpr int kCentreThreads = 1024;
constexpr int kSplitRows = 32;                      // sample rows a block of kde_split
constexpr int kMergeBatch = 16;                     // partials a merge thread loads at once
constexpr int kMaxDevices = 64;                     // devices whose launch set-up is kept
constexpr int kTensorMapError = 100000;             // + the CUresult of a failed encode
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2Pi = 1.8378770664093453f;

// d rounded up to 8 past column d, which carries the sample term
__host__ __device__ inline int padded_d(int d) { return (d + 8) / 8 * 8; }
__host__ __device__ inline int padded_t(int T) { return (T + kN - 1) / kN * kN; }

// log2(e) / 2h^2: the factor of a squared distance in a base-2 score.
__device__ __forceinline__ float score_scale(float h) { return kLog2e * 0.5f / (h * h); }

// mu[m] = the mean of up to kCentreRows of machine m's valid rows, evenly
// spaced (all of them when it has fewer); zero for an empty machine. The
// identity is exact for any centre: it needs only to lie among the draws.
__global__ void __launch_bounds__(kCentreThreads)
kde_centre(const float* __restrict__ samples, const int* __restrict__ counts,
           float* __restrict__ mu, int T, int d, int dp) {
  constexpr int kW = kCentreThreads / 32;
  __shared__ float part[kW][33];
  const int m = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const int n = min(max(counts[m], 0), T);
  const int rows = min(n, kCentreRows);
  float v[kCentreRows / kW];
#pragma unroll
  for (int i = 0; i < kCentreRows / kW; ++i) {
    const int j = w + kW * i;
    const long long t = j < rows ? (long long)j * n / rows : 0;  // evenly spaced rows
    v[i] = (k < d && j < rows) ? samples[((size_t)m * T + t) * d + k] : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kCentreRows / kW; ++i) s += v[i];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && k < dp) {
    float tot = 0.f;
    for (int i = 0; i < kW; ++i) tot += part[i][lane];
    mu[(size_t)m * dp + k] = (k < d && rows > 0) ? tot / (float)rows : 0.f;
  }
}

// Row t of machine m, centred and split: columns k < d hold (s - mu)[k],
// column d the row's term -||s_c||^2 / 2 (the queries carry 1 there, so the
// product adds it to q_c.s_c), the rest zeros; rows past counts[m] are zeros.
// A warp owns kSplitRows / 8 consecutive rows and loads all of them, 64 dims
// at a time, before it stores any.
__global__ void __launch_bounds__(256)
kde_split(const float* __restrict__ samples, const int* __restrict__ counts,
          const float* __restrict__ mu, float* __restrict__ s_hi, float* __restrict__ s_lo, int T,
          int Tp, int d, int dp) {
  constexpr int kR = kSplitRows / 8;
  const int m = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = min(max(counts[m], 0), T);
  const float* mum = mu + (size_t)m * dp;
  const int t0 = blockIdx.x * kSplitRows + w * kR;  // < Tp: the grid covers Tp rows
  float nrm[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) nrm[r] = 0.f;
  for (int k0 = 0; k0 < dp; k0 += 64) {
    float x[kR][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = k0 + 32 * hh + lane;
      const float muk = k < d ? mum[k] : 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int t = t0 + r;
        x[r][hh] = (t < n && k < d) ? samples[((size_t)m * T + t) * d + k] - muk : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const size_t o = ((size_t)m * Tp + t0 + r) * dp;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = k0 + 32 * hh + lane;
        if (k < dp && k != d) {
          float hi, lo;
          split(x[r][hh], hi, lo);
          s_hi[o + k] = hi;
          s_lo[o + k] = lo;
        }
      }
      nrm[r] = fmaf(x[r][1], x[r][1], fmaf(x[r][0], x[r][0], nrm[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) nrm[r] += __shfl_xor_sync(0xffffffffu, nrm[r], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float hi, lo;
      split(-0.5f * nrm[r], hi, lo);
      const size_t o = ((size_t)m * Tp + t0 + r) * dp + d;
      s_hi[o] = hi;
      s_lo[o] = lo;
    }
  }
}

struct Args {
  const float* queries;  // (Q, d)
  const float* mu;       // (M, dp)
  const int* counts;
  const float* h;
  float* part_max;  // (S, M, Q), natural log units
  float* part_sum;  // (S, M, Q)
  float* probe;     // kProbe only: (Q, kN) product of the first tile
  int Q, M, T, Tp, d, dp, S, n_qblk, n_items;
};

// Work item w: rows [tile0, tile0 + n_tiles) x kN of machine m, for query
// block qblk, as split `split` of S.
struct Item {
  int m, qblk, split, tile0, n_tiles;
};

__device__ __forceinline__ Item item(const Args& a, int w) {
  Item it;
  it.split = w % a.S;
  const int rest = w / a.S;
  it.qblk = rest % a.n_qblk;
  it.m = rest / a.n_qblk;
  const int n_valid = min(max(a.counts[it.m], 0), a.T);
  const int span = ((a.T + kN - 1) / kN + a.S - 1) / a.S;  // tiles a split
  it.tile0 = it.split * span;
  it.n_tiles = max(0, min(it.tile0 + span, (n_valid + kN - 1) / kN) - it.tile0);
  return it;
}

// The three passes of one chunk, KS k steps each: hi.lo, lo.hi, then hi.hi.
// A tile's first chunk overwrites acc (its old values are not read, so they
// need not be live); later chunks add to it.
template <int KS, bool kFirst>
__device__ __forceinline__ void passes(float (&acc)[64], uint32_t qa, uint32_t sb) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const uint32_t a = qa + (p == 1 ? kQHalf : 0);     // lo of the queries in pass 1
    const uint32_t b = sb + (p == 0 ? 2 * kSBlk : 0);  // lo of the samples in pass 0
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t da = desc(a + (kk >> 2) * kQBlk + (kk & 3) * 32);
      const uint64_t db = desc(b + (kk >> 2) * kSBlk + (kk & 3) * 32);
      if (kFirst && p == 0 && kk == 0) mma_m64n128k8_set(acc, da, db);
      else mma_m64n128k8(acc, da, db);
    }
  }
}

template <bool kFirst>
__device__ __forceinline__ void chunk_passes(int ks, float (&acc)[64], uint32_t qa, uint32_t sb) {
  switch (ks) {
    case 1: passes<1, kFirst>(acc, qa, sb); break;
    case 2: passes<2, kFirst>(acc, qa, sb); break;
    case 3: passes<3, kFirst>(acc, qa, sb); break;
    case 4: passes<4, kFirst>(acc, qa, sb); break;
    case 5: passes<5, kFirst>(acc, qa, sb); break;
    case 6: passes<6, kFirst>(acc, qa, sb); break;
    case 7: passes<7, kFirst>(acc, qa, sb); break;
    default: passes<8, kFirst>(acc, qa, sb); break;
  }
}

template <bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
kde_tc_kernel(const __grid_constant__ CUtensorMap t_hi, const __grid_constant__ CUtensorMap t_lo,
       const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* const q_term = reinterpret_cast<float*>(smem + kOffQn);  // [kBQ]
  auto full = [&](int st) { return base + kOffBar + 8 * st; };
  auto empty = [&](int st) { return base + kOffBar + 8 * (kStages + st); };
  const int n_chunks = (a.dp + kKC - 1) / kKC;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kCons);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kCons) {  // producer: one thread issues every copy, item after item
    regs_dec<kProducerRegs>();
    if (threadIdx.x != kCons * 128) return;
    int u = 0;  // units (tile, chunk) so far: unit u fills stage u % kStages
    for (int w = blockIdx.x; w < a.n_items; w += gridDim.x) {
      const Item it = item(a, w);
      for (int i = 0; i < it.n_tiles; ++i) {
        const int row = (it.tile0 + i) * kN;
        for (int ch = 0; ch < n_chunks; ++ch, ++u) {
          const int st = u % kStages;
          if (u >= kStages) mbar_wait(empty(st), ((u / kStages) & 1) ^ 1);  // u - kStages is done
          const int ncb = a.dp - ch * kKC > 32 ? 2 : 1;  // column blocks this chunk has
          mbar_expect_tx(full(st), ncb * 2 * kSBlk);
          const uint32_t sb = base + kOffStage + st * kStage;
          for (int cb = 0; cb < ncb; ++cb) {
            tma_load(sb + cb * kSBlk, &t_hi, full(st), ch * kKC + cb * 32, row, it.m);
            tma_load(sb + (2 + cb) * kSBlk, &t_lo, full(st), ch * kKC + cb * 32, row, it.m);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: queries wg * 64 .. + 63 of each work item
  regs_inc<kConsumerRegs>();
  const int t = threadIdx.x & 127, lane = t & 31, wq = t >> 5;
  const int r0 = wq * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the warpgroup's 64
  const int cq = 2 * (lane & 3);         // its first column in each group of 8
  const uint32_t qa = base + wg * kSlab;
  constexpr bool kProducts = kCut == 0 || kCut >= 3;
  constexpr bool kScores = kCut == 0 || kCut >= 4;

  // chunk ch of this warpgroup's query rows centred by mu, split and stored
  // swizzled (1 in column d, zeros past it and in rows past Q); with `norms`
  // each row's squares are added to nrm. A warp owns rows wq + 4i and loads all of
  // them before it stores any.
  auto stage_queries = [&](int q0, const float* mum, int ch, float (&nrm)[kRowsPerWarp],
                           bool norms) {
    const int k0 = ch * kKC + lane, k1 = k0 + 32;
    const float mu0 = k0 < a.d ? mum[k0] : 0.f, mu1 = k1 < a.d ? mum[k1] : 0.f;
    float x[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int q = q0 + wq + 4 * i;
      const float* src = a.queries + (size_t)q * a.d;
      x[i][0] = (q < a.Q && k0 < a.d) ? src[k0] - mu0 : 0.f;
      x[i][1] = (q < a.Q && k1 < a.d) ? src[k1] - mu1 : 0.f;
    }
    if (norms) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        nrm[i] = fmaf(x[i][1], x[i][1], fmaf(x[i][0], x[i][0], nrm[i]));
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = wq + 4 * i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float hi, lo;
        split(half ? (k1 == a.d ? 1.f : x[i][1]) : (k0 == a.d ? 1.f : x[i][0]), hi, lo);
        const int off = wg * kSlab + half * kQBlk + swizzled(r, lane);
        *reinterpret_cast<float*>(smem + off) = hi;
        *reinterpret_cast<float*>(smem + kQHalf + off) = lo;
      }
    }
  };

  float acc[64];

  if (wg == kCons - 1) bar_arrive(kBarTurn, kTurn);  // warpgroup 0 takes the tensor cores first
  int u = 0;
  for (int w = blockIdx.x; w < a.n_items; w += gridDim.x) {
    const Item it = item(a, w);
    const int units = it.n_tiles * n_chunks;  // (tile, chunk) pairs, tile-major
    const int n_valid = min(max(a.counts[it.m], 0), a.T);
    const float c = score_scale(a.h[it.m]), c2 = 2.f * c;
    const float* const mum = a.mu + (size_t)it.m * a.dp;
    const int q0 = it.qblk * kBQ + wg * 64;  // this warpgroup's first query
    // online (max, sum) of rows r0 and r0 + 8, base 2, without the row's own term
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    if (units > 0) {
      float nrm[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) nrm[i] = 0.f;
      // every chunk for the norms; the last one staged stays when it is the only one
      for (int ch = 0; ch < n_chunks; ++ch) stage_queries(q0, mum, ch, nrm, true);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) nrm[i] += __shfl_xor_sync(0xffffffffu, nrm[i], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) q_term[wg * 64 + wq + 4 * i] = -nrm[i] * c;
      }
      fence_proxy();
      bar_sync(kBarOwn + wg, 128);
    }

    for (int k = 0; k < units; ++k, ++u) {
      const int i = k / n_chunks, ch = k - i * n_chunks;
      const int st = u % kStages;
      if (n_chunks > 1) {  // this warpgroup's products of the unit before are done
        float unused[kRowsPerWarp];
        stage_queries(q0, mum, ch, unused, false);
        fence_proxy();
        bar_sync(kBarOwn + wg, 128);
      }
      mbar_wait(full(st), (u / kStages) & 1);
      const bool last = ch == n_chunks - 1;
      bar_sync(kBarTurn + wg, kTurn);  // this warpgroup's turn on the tensor cores
      if (kProducts) {
        const uint32_t sb = base + kOffStage + st * kStage;
        const int ks = min(kKC, a.dp - ch * kKC) / kKStep;
        wg_fence();
        if (ch == 0) chunk_passes<true>(ks, acc, qa, sb);
        else chunk_passes<false>(ks, acc, qa, sb);
        wg_commit();
      }
      bar_arrive(kBarTurn + (wg + 1) % kCons, kTurn);  // the next warpgroup's turn
      wg_wait();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty(st));  // this warpgroup is done with stage st
      if (kProbe) {  // the raw cross term of the first tile, then nothing else
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q0 + r0 + 8 * (e >> 1) < a.Q)
              a.probe[(wg * 64 + r0 + 8 * (e >> 1)) * kN + 8 * j + cq + (e & 1)] = acc[4 * j + e];
        continue;
      }
      if (!last) continue;
      if (!kScores) {  // probe cuts: keep the products alive, skip the epilogue
        l0 += acc[0];
        continue;
      }

      // tile i's scores, folded into (m, l); the max and the sum over a row's
      // 32 columns of this thread go by pairwise trees
      const int lim = n_valid - (it.tile0 + i) * kN;  // valid columns of this tile
      if (lim < kN) {                                  // the machine's last tile
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + cq + (e & 1) >= lim) acc[4 * j + e] = -INFINITY;
      }
      float t0v[4], t1v[4];  // four chains a row
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= c2;  // -inf stays -inf
        const float p0 = fmaxf(acc[4 * j], acc[4 * j + 1]), p1 = fmaxf(acc[4 * j + 2], acc[4 * j + 3]);
        t0v[j & 3] = j < 4 ? p0 : fmaxf(t0v[j & 3], p0);
        t1v[j & 3] = j < 4 ? p1 : fmaxf(t1v[j & 3], p1);
      }
      const float mx0 = fmaxf(fmaxf(t0v[0], t0v[1]), fmaxf(t0v[2], t0v[3]));
      const float mx1 = fmaxf(fmaxf(t1v[0], t1v[1]), fmaxf(t1v[2], t1v[3]));
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // a row with nothing valid yet subtracts 0, so its -inf terms weigh 0
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0, ms1 = mn1 == -INFINITY ? 0.f : mn1;
      if (kCut == 4) {
        m0 = ms0;
        m1 = ms1;
        continue;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = ex2(acc[4 * j] - ms0) + ex2(acc[4 * j + 1] - ms0);
        const float p1 = ex2(acc[4 * j + 2] - ms1) + ex2(acc[4 * j + 3] - ms1);
        t0v[j & 3] = j < 4 ? p0 : t0v[j & 3] + p0;
        t1v[j & 3] = j < 4 ? p1 : t1v[j & 3] + p1;
      }
      const float s0 = (t0v[0] + t0v[1]) + (t0v[2] + t0v[3]);
      const float s1 = (t1v[0] + t1v[1]) + (t1v[2] + t1v[3]);
      l0 = fmaf(l0, ex2(m0 - ms0), s0);  // this thread's columns; the quad's are summed below
      l1 = fmaf(l1, ex2(m1 - ms1), s1);
      m0 = mn0;
      m1 = mn1;
    }

    if (!kProbe) {
      const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 8 * hh;
          const int q = q0 + r;
          if (q < a.Q) {
            const float mm = hh ? m1 : m0;
            const size_t o = ((size_t)it.split * a.M + it.m) * a.Q + q;
            a.part_max[o] = mm == -INFINITY ? -INFINITY : (mm + q_term[wg * 64 + r]) * kLn2;
            a.part_sum[o] = hh ? sum1 : sum0;
          }
        }
      }
    }
    bar_sync(kBarOwn + wg, 128);  // q_term and the query slab are free for the next item
  }
  if (wg == 0) bar_sync(kBarTurn, kTurn);  // the last warpgroup's last turn handed over
}

// lp[m, q] from machine m's S partials, merged in split order; loads a
// batch of partials before it folds them.
__global__ void kde_merge_splits(const float* __restrict__ part_max,
                                 const float* __restrict__ part_sum,
                                 const int* __restrict__ counts, const float* __restrict__ h,
                                 float* __restrict__ lp, int Q, int M, int d, int S) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x, m = blockIdx.y;
  if (q >= Q) return;
  float pm = -INFINITY, ps = 0.f;
  for (int s0 = 0; s0 < S; s0 += kMergeBatch) {
    float vm[kMergeBatch], vs[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const size_t o = ((size_t)(s0 + j) * M + m) * Q + q;
      vm[j] = s0 + j < S ? part_max[o] : -INFINITY;
      vs[j] = s0 + j < S ? part_sum[o] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      if (vm[j] == -INFINITY) continue;  // an empty split
      const float nm = fmaxf(pm, vm[j]);
      ps = ps * expf(pm - nm) + vs[j] * expf(vm[j] - nm);
      pm = nm;
    }
  }
  const float hm = h[m];
  const float log_norm =
      logf(fmaxf((float)counts[m], 1.f)) + 0.5f * (float)d * (2.f * logf(hm) + kLog2Pi);
  lp[(size_t)m * Q + q] = pm + logf(ps) - log_norm;  // -inf for an empty machine
}

// prod[q] = sum_m lp[m, q] and mix[q] = logsumexp_m (logw[m] + lp[m, q]), in
// machine order; either may be null (logw is read only for the mixture).
__global__ void kde_merge_machines(const float* __restrict__ lp, const float* __restrict__ logw,
                                   float* __restrict__ prod, float* __restrict__ mix, int Q,
                                   int M) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float sum = 0.f, mx = -INFINITY, acc = 0.f;
  for (int m0 = 0; m0 < M; m0 += kMergeBatch) {
    float v[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) v[j] = m0 + j < M ? lp[(size_t)(m0 + j) * Q + q] : 0.f;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      if (m0 + j >= M) break;
      sum += v[j];  // -inf propagates: an empty machine has no product mass
      if (mix == nullptr) continue;
      const float lw = v[j] + logw[m0 + j];
      if (lw == -INFINITY) continue;  // an empty machine enters the mixture as no mass
      const float nm = fmaxf(mx, lw);
      acc = acc * expf(mx - nm) + expf(lw - nm);
      mx = nm;
    }
  }
  if (prod != nullptr) prod[q] = sum;
  if (mix != nullptr) mix[q] = mx + logf(acc);
}

struct Scratch {
  float *mu, *s_hi, *s_lo;
};

// scratch = [mu (M, dp) | s_hi (M, Tp, dp) | s_lo (M, Tp, dp)]
Scratch carve(float* scratch, int M, int T, int d) {
  const size_t dp = padded_d(d), Tp = padded_t(T);
  Scratch s;
  s.mu = scratch;
  s.s_hi = s.mu + (size_t)M * dp;
  s.s_lo = s.s_hi + (size_t)M * Tp * dp;
  return s;
}

cudaError_t prepass(const float* samples, const int* counts, const Scratch& s, int M, int T,
                    int d, cudaStream_t st) {
  const int dp = padded_d(d), Tp = padded_t(T);
  kde_centre<<<dim3((dp + 31) / 32, M), kCentreThreads, 0, st>>>(samples, counts, s.mu, T, d, dp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kde_split<<<dim3(Tp / kSplitRows, M), 256, 0, st>>>(samples, counts, s.mu, s.s_hi, s.s_lo, T,
                                                       Tp, d, dp);
  return cudaGetLastError();
}


// A float32 (dp, Tp, M) tensor map of one scratch half: a box of 32 values
// (128 bytes, the swizzle's width) by kN rows of one machine.
CUresult encode(EncodeTiled enc, CUtensorMap* map, const float* base, int M, int Tp, int dp) {
  const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)Tp, (cuuint64_t)M};
  const cuuint64_t strides[2] = {(cuuint64_t)dp * 4, (cuuint64_t)Tp * dp * 4};
  const cuuint32_t box[3] = {32, kN, 1}, unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The main kernel over every work item, one persistent block an SM.
template <bool kProbe>
cudaError_t launch_tc(const Scratch& s, Args a, int device, cudaStream_t st) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap t_hi, t_lo;
  CUresult r = encode(enc, &t_hi, s.s_hi, a.M, a.Tp, a.dp);
  if (r == CUDA_SUCCESS) r = encode(enc, &t_lo, s.s_lo, a.M, a.Tp, a.dp);
  if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(kTensorMapError + (int)r);
  // the SM count and the kernel's shared-memory attribute, once a device
  static int sms_of[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = sms_of[device];
  if (sms == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kde_tc_kernel<kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (e != cudaSuccess) return e;
    sms_of[device] = sms;
  }
  const int grid = a.n_items < sms ? a.n_items : sms;
  if (grid > 0) kde_tc_kernel<kProbe><<<grid, kThreads, kSmem, st>>>(t_hi, t_lo, a);
  return cudaGetLastError();
}

Args args(const float* queries, const Scratch& s, const int* counts, const float* h,
          float* part_max, float* part_sum, float* probe, int Q, int M, int T, int d, int S) {
  Args a{queries, s.mu, counts, h, part_max, part_sum, probe,
         Q, M, T, padded_t(T), d, padded_d(d), S, (Q + kBQ - 1) / kBQ, 0};
  a.n_items = a.n_qblk * M * S;
  return a;
}

}  // namespace

// Floats of scratch the entry points need for M machines of T rows of d dims.
extern "C" long long kde_scratch_floats(int M, int T, int d) {
  const long long dp = padded_d(d), Tp = padded_t(T);
  return (long long)M * dp + 2LL * M * Tp * dp;
}

// The number of row splits S the entry point expects partials for. A work
// item takes an SM; its time is ~ its tiles plus about half a tile of
// set-up, so S minimises waves x (tiles a split + 1/2), the smallest S of
// the least.
extern "C" int kde_machine_splits(int Q, int M, int T, int num_sms) {
  const long long items = (long long)((Q + kBQ - 1) / kBQ) * M;
  const int tiles = (T + kN - 1) / kN;
  int best = 1;
  double best_cost = INFINITY;
  for (int s = 1; s <= tiles && s <= 65535; ++s) {
    const long long waves = (items * s + num_sms - 1) / num_sms;
    const double cost = (double)waves * ((tiles + s - 1) / s + 0.5);
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// scratch: kde_scratch_floats(M, T, d) floats; part_max, part_sum (S, M, Q);
// lp (M, Q) is always written; prod and mix (Q,) are written when not null;
// logw (M,) is read only for the mixture. Returns a cudaError_t, or 100000 +
// the CUresult of a tensor map that would not encode.
extern "C" int kde_machine_log_density_f32(int device, const float* queries, const float* samples,
                                           const float* h, const int* counts, const float* logw,
                                           float* scratch, float* part_max, float* part_sum,
                                           float* lp, float* prod, float* mix, int Q, int M, int T,
                                           int d, int S, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, M, T, d);
  e = prepass(samples, counts, s, M, T, d, st);
  if (e != cudaSuccess || kCut == 1) return e;
  e = launch_tc<false>(s, args(queries, s, counts, h, part_max, part_sum, nullptr, Q, M, T, d, S),
                       device, st);
  if (e != cudaSuccess || kCut != 0) return e;
  kde_merge_splits<<<dim3((Q + 127) / 128, M), 128, 0, st>>>(part_max, part_sum, counts, h, lp,
                                                             Q, M, d, S);
  e = cudaGetLastError();
  if (e != cudaSuccess || (prod == nullptr && mix == nullptr)) return e;
  kde_merge_machines<<<(Q + 127) / 128, 128, 0, st>>>(lp, logw, prod, mix, Q, M);
  return cudaGetLastError();
}

// The probe's first check: machine 0's centring and split, then the first
// tile (queries 0..127, sample rows 0..127, d <= 64) through the main
// kernel's staging, copies and three wgmma passes; cross (Q, 128) receives
// the raw product q_c.s_c^T - ||s_c||^2 / 2 (float32 accumulator, nothing
// masked).
extern "C" int kde_probe_cross_f32(int device, const float* queries, const float* samples,
                                   const float* h, const int* counts, float* scratch,
                                   float* cross, int Q, int T, int d, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (d > kKC || T < 1 || T > kN || Q < 1 || Q > kBQ) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, 1, T, d);
  e = prepass(samples, counts, s, 1, T, d, st);
  if (e != cudaSuccess) return e;
  return launch_tc<true>(s, args(queries, s, counts, h, nullptr, nullptr, cross, Q, 1, T, d, 1),
                         device, st);
}

extern "C" const char* kde_error_string(int e) {
  if (e >= kTensorMapError) return "a tensor map of the scratch would not encode";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
