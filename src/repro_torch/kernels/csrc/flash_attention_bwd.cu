// GQA flash-attention backward: dq, dk, dv of out = softmax(q·kᵀ·hd^-½,
// masked)·v from the forward's saved out and lse, FlashAttention-2's two
// passes, two kernels a call on one stream:
//   flash_bwd_dq_kernel   — one block a (b, kv head, q tile): it writes
//     D = rowsum(dout∘out) for its rows, then loops the visible kv tiles,
//     recomputes P = exp(s − lse) and dS = P∘(dP − D), and sums dq += dS·k
//     in registers;
//   flash_bwd_dkdv_kernel — one block a (b, kv head, kv tile): it loops the
//     G heads of the group and the visible q tiles of each, recomputes P and
//     dS (reading D from the first kernel), and sums dv += Pᵀ·dout and
//     dk += dSᵀ·q in registers.
//
// Replaces no Pallas kernel: the TPU side has none for the backward. It is
// the port of the pure-JAX `_flash_bwd` (src/repro/models/lm/flash.py:122),
// the custom_vjp's backward that the reference's training step runs, with
// its cast points: P (for dv) and dS are rounded to the input type before
// their products, dS from the unrounded P (bf16 inputs: bf16; float32: no
// rounding); scores, dP, D and every sum are float32; dq and dk are scaled
// by hd^-½ at the end.
//
// Operands: q (B, S, K, G, hd), k (B, T, K, hd), v (B, T, K, hd_v), out and
// dout (B, S, K, G, hd_v), read in place through their strides (last axis
// contiguous), all float32 or all bfloat16; lse (B, S, K, G) float32
// contiguous, natural log, +inf on a row with nothing visible (the
// forward's sentinel: its P is 0, so are its gradients). Query position s
// sees kv position t when t < kv_len and, if causal, s >= t (no offset), as
// in the forward. Outputs dq (B, S, K, G, hd), dk (B, T, K, hd), dv (B, T,
// K, hd_v) contiguous in the input type; kv rows in [kv_len, T) get zeros.
// D (B, S, K, G) float32 is scratch the wrapper allocates. No float atomics:
// each output element is summed by one thread in a fixed order, so a fixed
// input gives the same bits on every run.
//
// What bounds it on an H100. At the training path's shape (B=1, K=8, G=3,
// S=T=4096, hd=hd_v=128, causal) the backward's products are 2.5 times the
// forward's 1.03e11 flop (FlashAttention-2's count: four products against
// two, one recomputed): 2.6e11 flop on 0.16 GB of bf16 operands and
// outputs, bound by operations: 0.26 ms on the bf16 tensor cores, 3.8 ms
// at the 67 TFLOP/s float32 FMA rate, which is the rate this design runs
// at (its recomputed S makes it 3.5 times the forward's products, 5.4 ms).
// This first design is the simple one: float32 FMAs from shared memory,
// the FMA forward's thread layout (256 threads as 16 × 16; a thread owns 4
// rows and the columns tx + 16j of a score tile, and 4 rows × the columns
// c·64 + 4tx + e of an accumulator), no overlap of staging with arithmetic.
// Tiles: the dq kernel's rows are floor(64 / G) query positions × the G
// heads (every staged kv tile serves the group), its kv tile 64 wide, 32
// when hd or hd_v exceeds 128; the dkdv kernel's 64 kv rows against q
// tiles of 64 positions of one head, 32 above hd 128 (shared memory:
// ≤ 217,344 bytes at hd = hd_v = 256). wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fma.cuh"

namespace {

constexpr int kRows = 64;       // dq: (query position, head) rows; dkdv: kv rows
constexpr int kRP = kRows + 4;  // row stride of a transposed P or dS tile (floats)

// x rounded to T and back: the reference's casts of P and dS
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Params {
  int S, T, K, G, hd, hd_v, kv_lim, causal, vec;
  int bq, n_qtiles, n_kvtiles;  // dq kernel: positions a block, q tiles; dkdv: kv tiles
  float scale;
  // strides in elements: q, out, dout (b, s, k, g); k, v (b, t, k)
  long long q_sb, q_ss, q_sk, q_sg, k_sb, k_st, k_sk, v_sb, v_st, v_sk;
  long long o_sb, o_ss, o_sk, o_sg, d_sb, d_ss, d_sk, d_sg;
};

// The product s[i][j] += a_row(i) · b_row(j) over `len4` (a multiple of 4)
// floats: rows ty·4 + i of A (stride sa), rows tx + 16j of B (stride sb).
template <int NJ>
__device__ __forceinline__ void tile_product(float (&s)[4][NJ], const float* A, int sa,
                                             const float* B, int sb, int len4, int tx, int ty) {
  for (int d = 0; d < len4; d += 4) {
    float4 c[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * sb + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * sa + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float t = s[i][j];
        t = fmaf(a.x, c[j].x, t);
        t = fmaf(a.y, c[j].y, t);
        t = fmaf(a.z, c[j].z, t);
        t = fmaf(a.w, c[j].w, t);
        s[i][j] = t;
      }
    }
  }
}

// acc[i][4c + e] += Σ_t W[t][ty·4 + i] · X[t][c·64 + 4tx + e], t < n: W a
// transposed (n, kRP) tile, X an (n, sx) tile.
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[4][4 * NC], const float* W,
                                           const float* X, int sx, int n, int tx, int ty) {
  for (int t = 0; t < n; ++t) {
    const float4 w = *reinterpret_cast<const float4*>(W + t * kRP + ty * 4);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(X + t * sx + c * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * c + 0] = fmaf(wv[i], x.x, acc[i][4 * c + 0]);
        acc[i][4 * c + 1] = fmaf(wv[i], x.y, acc[i][4 * c + 1]);
        acc[i][4 * c + 2] = fmaf(wv[i], x.z, acc[i][4 * c + 2]);
        acc[i][4 * c + 3] = fmaf(wv[i], x.w, acc[i][4 * c + 3]);
      }
    }
  }
}

// dq kernel: NCQ column groups of 64 cover hd; BN kv positions a tile.
template <int NCQ, int BN>
struct DqCfg {
  static int smem_floats(int hd, int hd_v) {
    const int QP = padded_stride(hd), VP = padded_stride(hd_v), KS = padded_stride(64 * NCQ);
    return kRows * QP + kRows * VP + BN * KS + BN * VP + BN * kRP;
  }
};

template <typename T, int NCQ, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum, T* __restrict__ dq,
                    const Params p) {
  constexpr int NJ = BN / 16;
  constexpr int HDQ = 64 * NCQ;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int QP = padded_stride(p.hd), VP = padded_stride(p.hd_v), KS = padded_stride(HDQ);
  const int hd4 = (p.hd + 3) / 4 * 4, hdv4 = (p.hd_v + 3) / 4 * 4;
  float* const Qs = smem;                // kRows x QP
  float* const dOs = Qs + kRows * QP;    // kRows x VP
  float* const Ks = dOs + kRows * VP;    // BN x KS (zeros past hd up to HDQ)
  float* const Vs = Ks + BN * KS;        // BN x VP
  float* const dSs = Vs + BN * VP;       // BN x kRP, transposed: dSs[t * kRP + row]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = p.n_qtiles - 1 - blockIdx.x;  // longest causal blocks first
  const int b = blockIdx.y / p.K, kh = blockIdx.y - b * p.K;
  const int G = p.G;
  const int q0 = qt * p.bq;
  const int n_q = imin(p.bq, p.S - q0);
  const int rows = n_q * G;  // valid rows: row r is position q0 + r / G, head r % G

  {
    const long long ss = p.q_ss, sg = p.q_sg;
    stage(Qs, QP, q + b * p.q_sb + kh * p.q_sk + q0 * ss,
          [=](int r) { const int i = r / G; return i * ss + (r - i * G) * sg; }, kRows, rows,
          p.hd, hd4, p.vec & 1);
    const long long ds = p.d_ss, dg = p.d_sg;
    stage(dOs, VP, dout + b * p.d_sb + kh * p.d_sk + q0 * ds,
          [=](int r) { const int i = r / G; return i * ds + (r - i * G) * dg; }, kRows, rows,
          p.hd_v, hdv4, p.vec & 16);
  }
  __syncthreads();

  // D = rowsum(dout ∘ out) and lse of this thread's rows
  int qpos[4];
  bool rv[4];
  float D[4], L[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    rv[i] = r < rows;
    const int qi = r / G, g = r - qi * G;
    qpos[i] = q0 + qi;
    float part = 0.f;
    if (rv[i]) {
      const T* o = out + b * p.o_sb + (long long)(q0 + qi) * p.o_ss + kh * p.o_sk + g * p.o_sg;
      for (int e = tx; e < p.hd_v; e += 16) part = fmaf(dOs[r * VP + e], to_float(o[e]), part);
    }
    D[i] = row_sum16(part);
    const long long row = rv[i] ? (((long long)b * p.S + q0 + qi) * p.K + kh) * G + g : 0;
    L[i] = rv[i] ? lse[row] : INFINITY;
    if (rv[i] && tx == 0) dsum[row] = D[i];
  }

  float acc[4][4 * NCQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NCQ; ++c) acc[i][c] = 0.f;

  int kv_end = p.kv_lim;
  if (p.causal) kv_end = imin(kv_end, q0 + n_q);  // tiles past the last row's reach
  const int n_tiles = (kv_end + BN - 1) / BN;
  const long long kst = p.k_st, vst = p.v_st;
  const T* kb = k + b * p.k_sb + kh * p.k_sk;
  const T* vb = v + b * p.v_sb + kh * p.v_sk;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int kv0 = jt * BN;
    const int n_kv = imin(BN, kv_end - kv0);
    __syncthreads();  // the previous tile's K and dS are read
    stage(Ks, KS, kb + kv0 * kst, [=](int r) { return r * kst; }, BN, n_kv, p.hd, HDQ,
          p.vec & 2);
    stage(Vs, VP, vb + kv0 * vst, [=](int r) { return r * vst; }, BN, n_kv, p.hd_v, hdv4,
          p.vec & 4);
    __syncthreads();

    float s[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<NJ>(s, Qs, QP, Ks, KS, hd4, tx, ty);
    tile_product<NJ>(dp, dOs, VP, Vs, VP, hdv4, tx, ty);

#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + tx + 16 * j;
        const bool ok = rv[i] && col < p.kv_lim && (!p.causal || qpos[i] >= col);
        const float pr = ok ? expf(s[i][j] * p.scale - L[i]) : 0.f;
        d[i] = round_to<T>(pr * (dp[i][j] - D[i]));
      }
      *reinterpret_cast<float4*>(dSs + (tx + 16 * j) * kRP + ty * 4) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();
    accumulate<NCQ>(acc, dSs, Ks, KS, n_kv, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rv[i]) continue;
    const int r = ty * 4 + i, qi = r / G;
    const long long base = ((((long long)b * p.S + q0 + qi) * p.K + kh) * G + (r - qi * G)) * p.hd;
#pragma unroll
    for (int c = 0; c < NCQ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (col < p.hd) store(dq + base + col, acc[i][4 * c + e] * p.scale);
      }
  }
}

// dkdv kernel: NCK, NCV column groups of 64 cover hd, hd_v; BQ q positions
// (of one head) a tile.
template <int NCK, int NCV>
struct DkdvCfg {
  static constexpr int BQ = (NCK > 2 || NCV > 2) ? 32 : 64;
  static int smem_floats(int hd, int hd_v) {
    const int KP = padded_stride(hd), VP = padded_stride(hd_v);
    const int QS = padded_stride(64 * NCK), OS = padded_stride(64 * NCV);
    return kRows * KP + kRows * VP + BQ * QS + BQ * OS + 2 * BQ * kRP + 2 * BQ;
  }
};

template <typename T, int NCK, int NCV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                      const Params p) {
  constexpr int BQ = DkdvCfg<NCK, NCV>::BQ;
  constexpr int NJ = BQ / 16;
  constexpr int HDK = 64 * NCK, HDV = 64 * NCV;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int KP = padded_stride(p.hd), VP = padded_stride(p.hd_v);
  const int QS = padded_stride(HDK), OS = padded_stride(HDV);
  const int hd4 = (p.hd + 3) / 4 * 4, hdv4 = (p.hd_v + 3) / 4 * 4;
  float* const Ks = smem;               // kRows x KP
  float* const Vs = Ks + kRows * KP;    // kRows x VP
  float* const Qs = Vs + kRows * VP;    // BQ x QS (zeros past hd up to HDK)
  float* const dOs = Qs + BQ * QS;      // BQ x OS (zeros past hd_v up to HDV)
  float* const Ps = dOs + BQ * OS;      // BQ x kRP, transposed: Ps[q row * kRP + kv row]
  float* const dSs = Ps + BQ * kRP;     // BQ x kRP
  float* const Ls = dSs + BQ * kRP;     // BQ
  float* const Ds = Ls + BQ;            // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x;  // kv tile 0 first: the longest causal reach
  const int b = blockIdx.y / p.K, kh = blockIdx.y - b * p.K;
  const int kv0 = kt * kRows;
  const int n_kv = imax(0, imin(kRows, p.kv_lim - kv0));  // visible kv rows of this tile

  float ak[4][4 * NCK], av[4][4 * NCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NCK; ++c) ak[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NCV; ++c) av[i][c] = 0.f;
  }

  if (n_kv > 0) {
    const long long kst = p.k_st, vst = p.v_st;
    stage(Ks, KP, k + b * p.k_sb + kh * p.k_sk + kv0 * kst, [=](int r) { return r * kst; },
          kRows, n_kv, p.hd, hd4, p.vec & 2);
    stage(Vs, VP, v + b * p.v_sb + kh * p.v_sk + kv0 * vst, [=](int r) { return r * vst; },
          kRows, n_kv, p.hd_v, hdv4, p.vec & 4);
    const int qt0 = p.causal ? kv0 / BQ : 0;  // the first q tile with a position >= kv0
    const int n_qt = (p.S + BQ - 1) / BQ;
    for (int g = 0; g < p.G; ++g) {
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        const int n_q = imin(BQ, p.S - q0);
        __syncthreads();  // the previous tile's q, dout, P and dS are read
        const long long qs = p.q_ss, ds = p.d_ss;
        stage(Qs, QS, q + b * p.q_sb + kh * p.q_sk + g * p.q_sg + q0 * qs,
              [=](int r) { return r * qs; }, BQ, n_q, p.hd, HDK, p.vec & 1);
        stage(dOs, OS, dout + b * p.d_sb + kh * p.d_sk + g * p.d_sg + q0 * ds,
              [=](int r) { return r * ds; }, BQ, n_q, p.hd_v, HDV, p.vec & 16);
        for (int r = threadIdx.x; r < BQ; r += kThreads) {
          const long long row = (((long long)b * p.S + q0 + r) * p.K + kh) * p.G + g;
          Ls[r] = r < n_q ? lse[row] : INFINITY;
          Ds[r] = r < n_q ? dsum[row] : 0.f;
        }
        __syncthreads();

        float s[4][NJ], dp[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
        tile_product<NJ>(s, Ks, KP, Qs, QS, hd4, tx, ty);
        tile_product<NJ>(dp, Vs, VP, dOs, OS, hdv4, tx, ty);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int qr = tx + 16 * j, pos = q0 + qr;
          const float l = Ls[qr], dd = Ds[qr];
          float pr[4], d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = kv0 + ty * 4 + i;
            const bool ok = qr < n_q && col < p.kv_lim && (!p.causal || pos >= col);
            const float p32 = ok ? expf(s[i][j] * p.scale - l) : 0.f;
            pr[i] = round_to<T>(p32);
            d[i] = round_to<T>(p32 * (dp[i][j] - dd));
          }
          *reinterpret_cast<float4*>(Ps + qr * kRP + ty * 4) = make_float4(pr[0], pr[1], pr[2], pr[3]);
          *reinterpret_cast<float4*>(dSs + qr * kRP + ty * 4) = make_float4(d[0], d[1], d[2], d[3]);
        }
        __syncthreads();
        accumulate<NCV>(av, Ps, dOs, OS, n_q, tx, ty);
        accumulate<NCK>(ak, dSs, Qs, QS, n_q, tx, ty);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = kv0 + ty * 4 + i;
    if (t >= p.T) continue;
    const long long row = ((long long)b * p.T + t) * p.K + kh;
#pragma unroll
    for (int c = 0; c < NCK; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (col < p.hd) store(dk + row * p.hd + col, ak[i][4 * c + e] * p.scale);
      }
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (col < p.hd_v) store(dv + row * p.hd_v + col, av[i][4 * c + e]);
      }
  }
}

struct Buffers {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
};

template <typename T, int NCQ, int BN>
cudaError_t launch_dq(const Buffers& x, const Params& p, int BK, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (size_t)DqCfg<NCQ, BN>::smem_floats(p.hd, p.hd_v);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NCQ, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, NCQ, BN><<<dim3(p.n_qtiles, BK), kThreads, bytes, st>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
      static_cast<const T*>(x.out), static_cast<const T*>(x.dout), x.lse, x.dsum,
      static_cast<T*>(x.dq), p);
  return cudaGetLastError();
}

template <typename T, int NCK, int NCV>
cudaError_t launch_dkdv(const Buffers& x, const Params& p, int BK, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (size_t)DkdvCfg<NCK, NCV>::smem_floats(p.hd, p.hd_v);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NCK, NCV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<T, NCK, NCV><<<dim3(p.n_kvtiles, BK), kThreads, bytes, st>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
      static_cast<const T*>(x.dout), x.lse, x.dsum, static_cast<T*>(x.dk),
      static_cast<T*>(x.dv), p);
  return cudaGetLastError();
}

template <typename T, int NCK>
cudaError_t dkdv_by_v(int ncv, const Buffers& x, const Params& p, int BK, cudaStream_t st) {
  switch (ncv) {
    case 1: return launch_dkdv<T, NCK, 1>(x, p, BK, st);
    case 2: return launch_dkdv<T, NCK, 2>(x, p, BK, st);
    case 3: return launch_dkdv<T, NCK, 3>(x, p, BK, st);
    case 4: return launch_dkdv<T, NCK, 4>(x, p, BK, st);
    default: return cudaErrorInvalidValue;
  }
}

// The two kernels in order (dkdv reads the dq kernel's D).
template <typename T>
cudaError_t run(const Buffers& x, const Params& p, int BK, cudaStream_t st) {
  const int ncq = (p.hd + 63) / 64, ncv = (p.hd_v + 63) / 64;
  const bool wide = ncq > 2 || ncv > 2;  // a 32-wide kv tile keeps shared memory in bounds
  cudaError_t e;
  switch (ncq) {
    case 1: e = wide ? launch_dq<T, 1, 32>(x, p, BK, st) : launch_dq<T, 1, 64>(x, p, BK, st); break;
    case 2: e = wide ? launch_dq<T, 2, 32>(x, p, BK, st) : launch_dq<T, 2, 64>(x, p, BK, st); break;
    case 3: e = launch_dq<T, 3, 32>(x, p, BK, st); break;
    case 4: e = launch_dq<T, 4, 32>(x, p, BK, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  switch (ncq) {
    case 1: return dkdv_by_v<T, 1>(ncv, x, p, BK, st);
    case 2: return dkdv_by_v<T, 2>(ncv, x, p, BK, st);
    case 3: return dkdv_by_v<T, 3>(ncv, x, p, BK, st);
    case 4: return dkdv_by_v<T, 4>(ncv, x, p, BK, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. scale: hd^-1/2 as the caller rounds it.
// vec: bit 0/1/2/4 set when every row of q/k/v/dout starts aligned for one
// 4-element load. strides (elements): q (b, s, k, g), k (b, t, k), v (b, t,
// k), out (b, s, k, g), dout (b, s, k, g): 18 values. dsum: B·S·K·G floats
// of scratch. dq, dk, dv contiguous. Returns a cudaError_t.
extern "C" int flash_attention_bwd(int device, int dtype, const void* q, const void* k,
                                   const void* v, const void* out, const void* dout,
                                   const void* lse, void* dsum, void* dq, void* dk, void* dv,
                                   int B, int S, int T, int K, int G, int hd, int hd_v,
                                   int kv_len, int causal, float scale, int vec,
                                   const long long* strides, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (hd < 1 || hd > 256 || hd_v < 1 || hd_v > 256 || G < 1 || G > kRows || B < 1 || S < 1 ||
      T < 1 || K < 1 || (long long)B * K > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.S = S; p.T = T; p.K = K; p.G = G; p.hd = hd; p.hd_v = hd_v;
  p.kv_lim = imax(0, imin(kv_len, T));
  p.causal = causal; p.vec = vec;
  p.bq = kRows / G;
  p.n_qtiles = (S + p.bq - 1) / p.bq;
  p.n_kvtiles = (T + kRows - 1) / kRows;
  p.scale = scale;
  const long long* s = strides;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sk = s[2]; p.q_sg = s[3];
  p.k_sb = s[4]; p.k_st = s[5]; p.k_sk = s[6];
  p.v_sb = s[7]; p.v_st = s[8]; p.v_sk = s[9];
  p.o_sb = s[10]; p.o_ss = s[11]; p.o_sk = s[12]; p.o_sg = s[13];
  p.d_sb = s[14]; p.d_ss = s[15]; p.d_sk = s[16]; p.d_sg = s[17];
  const Buffers x{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
                  dq, dk, dv};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, p, B * K, st);
  if (dtype == 1) return run<__nv_bfloat16>(x, p, B * K, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
