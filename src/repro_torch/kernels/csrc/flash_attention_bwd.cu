// GQA flash-attention backward: dq, dk, dv of out = softmax(q·kᵀ·hd^-½,
// masked)·v from the forward's saved out and lse, FlashAttention-2's two
// passes as two kernels a call on one stream. Two routes, chosen by the
// wrapper before the launch (kernels/flash_attention/ops.py, _route_bwd):
//   flash_attention_bwd_tc — bf16 on Hopper's tensor cores (wgmma + TMA,
//     namespace tc), for bf16 q, k, v, out and dout with (hd, hd_v) in
//     {64, 128}² or (192, 128) (MLA's) that TMA can take (16-byte aligned
//     bases, strides of 16-byte multiples);
//   flash_attention_bwd    — float32 FMAs from shared memory, every other
//     call (float32 included).
// Each route is a dq kernel then a dkdv kernel:
//   dq   — one block a (b, kv head) and a few (query slab, head) rows: it
//     writes D = rowsum(dout∘out) for its rows, then loops the visible kv
//     tiles, recomputes P = exp(s − lse) and dS = P∘(dP − D), and sums
//     dq += dS·k;
//   dkdv — one block a (b, kv head, kv tile): it loops the G heads of the
//     group and the visible q tiles of each, recomputes P and dS (reading D
//     from the dq kernel), and sums dv += Pᵀ·dout and dk += dSᵀ·q.
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
// Scratch the wrapper allocates: the FMA route's D (B, S, K, G) float32; the
// tensor-core route's lse·log2(e) and D, each (B·K, G, S rounded up to 64)
// float32, +inf and 0 past S.
//
// No atomics. FlashAttention-2 sums dq across the kv tiles of every block
// with float atomics, in an order that changes from run to run; here every
// output element is summed by one thread (one wgmma accumulator) in a fixed
// order, so a fixed input gives the same bits on every run. The price is
// the dq kernel's recomputed S and dP: 7 products a (q tile, kv tile) pair
// where FlashAttention-2 does 5.
//
// What bounds it on an H100. At the training path's shape (B=1, K=8, G=3,
// S=T=4096, hd=hd_v=128, causal) the work's products are 2.5 times the
// forward's 1.03e11 flop (FlashAttention-2's count, five products against
// two): 2.58e11 flop on 0.13 GB of bf16 operands and outputs, bound by
// operations: 260.63 us on the bf16 tensor cores (bytes: 40 us). The design
// does 7/5 of those products, so its own bound is 364.9 us. At MLA's
// training shape (deepseek-v2-236b: B=1, K=128, G=1, hd=192, hd_v=128) the
// five products are 2·(3·192 + 2·128) flop a visible pair, 1.79e12 flop:
// 1,807 us; the design's seven 2,502 us.
//
// bf16 tensor-core route (namespace tc). Both kernels are the forward's
// tensor-core shape: a producer warpgroup (24 registers by setmaxnreg) whose
// one thread issues every TMA copy into 128-byte-swizzled tiles and a ring
// of two stages with full/empty mbarriers, and two consumer warpgroups (240
// registers) that run wgmma m64n64k16 from shared memory for the scores and
// dP, and m64n{hd}k16 with the A operand from registers (the score
// fragment packed to bf16, the forward's P·V) for the sums; the tensor maps
// (wgmma_bf16.cuh's encode) are built per call, and their kv axis ends at
// kv_len so that TMA reads zeros past it. P = 2^(s·hd^-½·log2 e − lse·log2
// e) with ex2 (a +inf lse gives exactly 0); the mask is applied only on
// diagonal and edge tiles; causal tiles above the diagonal are never loaded,
// and blocks go longest causal reach first.
// - dq kernel: a block is (b, kv head) and two consecutive (position slab of
//   64, head) slabs, one a consumer warpgroup; the producer loads each
//   slab's q, dout and out once, then streams K and V tiles of 64 kv
//   positions, each serving both slabs. A consumer first forms D from its
//   out and dout tiles and writes D and lse·log2 e to the scratch, then per
//   kv tile issues S = q·Kᵀ and dP = dout·Vᵀ together, forms P while dP
//   runs, then dS = P∘(dP − D) rounded to bf16 as the A fragment of dq +=
//   dS·K (K kv-major, the B-transpose bit set). dq·hd^-½ leaves through the
//   slab's q tile, as bf16 rows of 16-byte stores.
// - dkdv kernel: a block is (b, kv head, 128 kv rows), 64 a consumer
//   warpgroup; K and V are loaded once; the producer streams, for each of
//   the G heads and each q tile of 64 positions from the diagonal on, q,
//   dout and the tile's lse·log2 e and D slices (bulk copies from the
//   scratch). A consumer issues Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ, forms Pᵀ from
//   the lse slice while dPᵀ runs, dSᵀ = Pᵀ∘(dPᵀ − D), and sums dv +=
//   bf16(Pᵀ)·dout and dk += bf16(dSᵀ)·q (dout and q position-major, the
//   B-transpose bit set). A thread holds dk 64 + dv 64 + Sᵀ 32 + dPᵀ 32
//   floats at hd = hd_v = 128. At MLA's (192, 128) dk's last 64 columns are
//   summed a tile at a time into a zeroed fragment and added to a float32
//   accumulator in shared memory (DkdvCfg::kDkSh), so a thread holds the
//   same 192 accumulator floats as at (128, 128). dk·hd^-½ and dv leave
//   through the warpgroup's K and V tiles.
// Untried: one fused kernel with a deterministic dq reduction (per-block dq
// partials summed in a fixed order by a second pass), ping-pong turns of the
// two warpgroups on the tensor cores, issuing the next tile's products
// before this tile's sums, and a float32 route on the tensor cores (3×TF32,
// as the forward's tf32x3).
//
// FMA route (the first design). Its bound is the float32 FMA rate, 3.8 ms
// at the training shape (the recomputed S makes its products 3.5 times the
// forward's, 5.4 ms); staging does not overlap the arithmetic. The FMA
// forward's thread layout (256 threads as 16 × 16; a thread owns 4 rows and
// the columns tx + 16j of a score tile, and 4 rows × the columns c·64 + 4tx
// + e of an accumulator). Tiles: the dq kernel's rows are floor(64 / G)
// query positions × the G heads (every staged kv tile serves the group), its
// kv tile 64 wide, 32 when hd or hd_v exceeds 128; the dkdv kernel's 64 kv
// rows against q tiles of 64 positions of one head, 32 above hd 128 (shared
// memory: ≤ 217,344 bytes at hd = hd_v = 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "flash_fma.cuh"
#include "wgmma_bf16.cuh"

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
  if (e >= tc::kTensorMapError) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             e - tc::kTensorMapError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16): wgmma fed by TMA, see the note at the top.

namespace tc {

constexpr int kT = 64;               // positions a tile: a q slab or q tile, a kv tile
constexpr int kStages = 2;           // ring depth of both kernels (3 measured slower)
constexpr int kNW = 2;               // consumer warpgroups a block, in both kernels
constexpr int kThreadsTc = (kNW + 1) * 128;
constexpr int kConsumerRegs = 240;   // kNW·128·240 + 128·24 <= 65,536
constexpr int kProducerRegs = 24;
constexpr int kVec = kT * 4;         // bytes of a q tile's lse·log2(e) or D slice
constexpr float kLog2e = 1.4426950408889634f;

// {64, 128}², and (192, 128): MLA's nope ⊕ rope q·k head against its v head
__host__ __device__ inline bool dims_ok(int hd, int hd_v) {
  return ((hd == 64 || hd == 128) && (hd_v == 64 || hd_v == 128)) || (hd == 192 && hd_v == 128);
}

template <int HD, int HDV>
struct DqCfg {
  static constexpr int kQ = HD / 64 * kBlock;   // a q slab or a K tile
  static constexpr int kO = HDV / 64 * kBlock;  // a dout or out slab, a V tile
  static constexpr int kSlab = kQ + 2 * kO;     // q, dout and out of one slab
  static constexpr int kBarOff = kNW * kSlab + kStages * (kQ + kO);
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int HD, int HDV>
struct DkdvCfg {
  static constexpr int kQ = HD / 64 * kBlock;   // a K tile (64 kv rows) or a q tile
  static constexpr int kO = HDV / 64 * kBlock;  // a V tile or a dout tile
  // dk's columns past 128 (MLA's rope 64 at hd 192) are summed a q tile at a
  // time into a zeroed register fragment and added to a float32 accumulator
  // in shared memory, each thread its own slots: held in registers with the
  // rest, dk 96 + dv 64 + Sᵀ 32 + dPᵀ 32 spilled 156 bytes (ptxas, H100 run)
  static constexpr int kDkReg = HD > 128 ? 128 : HD;  // dk columns in registers
  static constexpr int kDkSh = HD - kDkReg;           // dk columns in shared memory
  static constexpr int kVecOff = (kNW + kStages) * (kQ + kO);
  static constexpr int kAccOff = kVecOff + kStages * 2 * kVec;
  static constexpr int kBarOff = kAccOff + kNW * 128 * (kDkSh / 2) * 4;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

struct Params {
  int S, T, K, G, BK, kv_lim, causal, s_pad;
  int n_slabs, n_groups;  // dq: (position slab, head) slabs and blocks a (b, kv head)
  int n_qt, n_kvb;        // dkdv: q tiles of one head, kv blocks of kNW·kT rows
  float scale, scale_log2;
  const float* lse;       // (B, S, K, G)
  float* lse2;            // (BK, G, s_pad): lse·log2(e), +inf past S (the dq kernel writes it)
  float* dsum;            // (BK, G, s_pad): D = rowsum(dout∘out), 0 past S
  __nv_bfloat16 *dq, *dk, *dv;
};

// kv tiles that position slab ps sees.
__host__ __device__ inline int dq_tiles(int ps, int S, int kv_lim, int causal) {
  int end = kv_lim;
  if (causal) end = imin(end, imin((ps + 1) * kT, S));
  return (end + kT - 1) / kT;
}

// Σ over this lane's columns of a∘b in row r of two (64, HDV) bf16 tiles as
// TMA writes them (64-column blocks kBlock bytes apart; 16-byte chunk c of a
// row at c ^ (r % 8)): lane l takes chunks l % 4 and l % 4 + 4 of a block.
template <int HDV>
__device__ __forceinline__ float row_dot(const uint8_t* a, const uint8_t* b, int r, int q4) {
  float acc = 0.f;
#pragma unroll
  for (int cb = 0; cb < HDV / 64; ++cb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = cb * kBlock + r * kRowBytes + (((q4 + 4 * h) ^ (r & 7)) * 16);
      const uint4 x = *reinterpret_cast<const uint4*>(a + off);
      const uint4 y = *reinterpret_cast<const uint4*>(b + off);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(xs[e]), w = __bfloat1622float2(ys[e]);
        acc = fmaf(u.x, w.x, acc);
        acc = fmaf(u.y, w.y, acc);
      }
    }
  return acc;
}

// An m64nN accumulator times `mul`, as bf16, into a (64, N) row-major tile
// at `dst` whose 16-byte chunk c of row r sits at c ^ (r % 8) (no bank
// conflicts for the fragment's writes or the rows' reads).
template <int N>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const float (&d)[N / 2], float mul,
                                           int r0, int lane) {
  constexpr int kRow = N * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(dst + r * kRow + ((j ^ (r & 7)) * 16) + (lane & 3) * 4) =
          __floats2bfloat162_rn(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
    }
}

// Rows r < n of a stage_rows tile to `out + r·stride` (elements), 16 bytes a
// thread a step over the warpgroup's 128 threads.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long stride,
                                           const uint8_t* src, int n, int t) {
  constexpr int kChunks = N / 8, kRow = N * 2;
  for (int e = t; e < kT * kChunks; e += 128) {
    const int r = e / kChunks, c = e - r * kChunks;
    if (r < n)
      *reinterpret_cast<uint4*>(out + r * stride + c * 8) =
          *reinterpret_cast<const uint4*>(src + r * kRow + ((c ^ (r & 7)) * 16));
  }
}

// S = A·Bᵀ over `depth` columns (a multiple of 16) of two K-major tiles.
template <int DEPTH>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk)  // 16 columns = 32 bytes a k step
    wgmma_ss(s, desc(a + (kk >> 2) * kBlock + (kk & 3) * 32),
             desc(b + (kk >> 2) * kBlock + (kk & 3) * 32), kk > 0);
}

// d += A·B, A the four k steps of a 64-column register fragment, B a 64-row
// position-major tile (the B-transpose bit set).
template <int N>
__device__ __forceinline__ void sums(float (&d)[N / 2], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 rows of 128 bytes a k step
    wgmma_rs<N>(d, a[kk], desc(b + kk * 16 * kRowBytes));
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = DqCfg<HD, HDV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t slab_s = smem_u32(smem);          // kNW × (q, dout, out)
  const uint32_t k_s = slab_s + kNW * C::kSlab;    // kStages K tiles
  const uint32_t v_s = k_s + kStages * C::kQ;      // kStages V tiles
  const uint32_t slab_full = slab_s + C::kBarOff;  // then full[], empty[]
  auto full = [&](int st) { return slab_full + 8 * (1 + st); };
  auto empty = [&](int st) { return slab_full + 8 * (1 + kStages + st); };

  const int bk = blockIdx.x % p.BK;
  const int grp = p.n_groups - 1 - blockIdx.x / p.BK;  // longest causal reach first
  const int b = bk / p.K, kh = bk - b * p.K;
  const int slab0 = grp * kNW;  // slab = position slab · G + head
  const int last = imin(slab0 + kNW, p.n_slabs) - 1;
  const int n_tiles = dq_tiles(last / p.G, p.S, p.kv_lim, p.causal);  // the last slab's reach

  if (threadIdx.x == 0) {
    mbar_init(slab_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kNW * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kNW) {  // producer: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kNW * 128) {
      mbar_expect_tx(slab_full, (last - slab0 + 1) * C::kSlab);
      for (int j = slab0; j <= last; ++j) {
        const int ps = j / p.G, g = j - ps * p.G;
        const uint32_t s0 = slab_s + (j - slab0) * C::kSlab;
        for (int c = 0; c < HD / 64; ++c)
          tma_load(s0 + c * kBlock, &tq, slab_full, c * 64, ps * kT, g, kh, b);
        for (int c = 0; c < HDV / 64; ++c) {
          tma_load(s0 + C::kQ + c * kBlock, &tdo, slab_full, c * 64, ps * kT, g, kh, b);
          tma_load(s0 + C::kQ + C::kO + c * kBlock, &tout, slab_full, c * 64, ps * kT, g, kh, b);
        }
      }
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % kStages;
        if (jt >= kStages) mbar_wait(empty(st), ((jt / kStages) & 1) ^ 1);  // jt - kStages released
        mbar_expect_tx(full(st), C::kQ + C::kO);
        for (int c = 0; c < HD / 64; ++c)
          tma_load(k_s + st * C::kQ + c * kBlock, &tk, full(st), c * 64, jt * kT, kh, b);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(v_s + st * C::kO + c * kBlock, &tv, full(st), c * 64, jt * kT, kh, b);
      }
    }
  } else {  // consumer warpgroup wg: slab slab0 + wg
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127, lane = t & 31;
    const int slab = slab0 + wg;
    const bool valid = slab <= last;
    const int ps = slab / p.G, g = slab - ps * p.G;
    const int my_tiles = valid ? dq_tiles(ps, p.S, p.kv_lim, p.causal) : 0;
    const int r0 = (t >> 5) * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int pos0 = ps * kT + r0, pos1 = pos0 + 8;
    const int c0 = 2 * (lane & 3);               // its first column in each group of 8
    const uint32_t my_q = slab_s + wg * C::kSlab, my_do = my_q + C::kQ;
    uint8_t* const my_slab = smem + wg * C::kSlab;
    const float sl = p.scale_log2;

    float L0 = INFINITY, L1 = INFINITY, D0 = 0.f, D1 = 0.f;  // lse·log2(e) and D of r0, r0 + 8
    if (valid) {
      mbar_wait(slab_full, 0);
      const uint8_t* const dO = my_slab + C::kQ;
      D0 = quad_sum(row_dot<HDV>(dO, dO + C::kO, r0, lane & 3));
      D1 = quad_sum(row_dot<HDV>(dO, dO + C::kO, r0 + 8, lane & 3));
      const long long row0 = (((long long)b * p.S + pos0) * p.K + kh) * p.G + g;
      if (pos0 < p.S) L0 = p.lse[row0] * kLog2e;
      if (pos1 < p.S) L1 = p.lse[row0 + 8LL * p.K * p.G] * kLog2e;
      if ((lane & 3) == 0) {  // for the dkdv kernel, by (b·K + kv head, head, position)
        const long long at = ((long long)bk * p.G + g) * p.s_pad + pos0;
        p.lse2[at] = L0;
        p.lse2[at + 8] = L1;
        p.dsum[at] = D0;
        p.dsum[at + 8] = D1;
      }
    }

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int st = jt % kStages;
      mbar_wait(full(st), (jt / kStages) & 1);
      if (jt < my_tiles) {
        const uint32_t k_t = k_s + st * C::kQ, v_t = v_s + st * C::kO;
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        wg_fence();
        scores<HD>(s, my_q, k_t);
        wg_commit();
        scores<HDV>(dp, my_do, v_t);
        wg_commit();
        wg_wait_n<1>();
        fence_regs(s);

        const int kv0 = jt * kT;
        const bool edge = kv0 + kT > p.kv_lim || (p.causal && kv0 + kT - 1 > ps * kT);
#pragma unroll
        for (int i = 0; i < 32; ++i) {  // P, unrounded
          const float pr = ex2(fmaf(s[i], sl, (i & 2) ? -L1 : -L0));
          const int col = kv0 + 8 * (i >> 2) + c0 + (i & 1);
          const bool hide = edge && (col >= p.kv_lim || (p.causal && col > ((i & 2) ? pos1 : pos0)));
          s[i] = hide ? 0.f : pr;
        }
        wg_wait_n<0>();
        fence_regs(dp);
        uint32_t da[4][4];  // dS = P∘(dP − D) as bf16: the A fragment of dq += dS·K
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r;
            const float d = (r & 1) ? D1 : D0;
            da[kk][r] = pack_bf16(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d));
          }
        wg_fence();
        sums<HD>(dq, da, k_t);
        wg_commit();
        wg_wait();  // waiting at the next tile instead measured no faster
        fence_regs(dq);
      }
      mbar_arrive(empty(st));  // after full: the arrival belongs to tile jt
    }

    if (valid) {  // dq·hd^-½ as bf16 through this slab's q tile, then rows < S out
      fence_proxy();
      stage_rows<HD>(my_slab, dq, p.scale, r0, lane);
      bar_sync(1 + wg, 128);
      store_rows<HD>(p.dq + ((((long long)b * p.S + ps * kT) * p.K + kh) * p.G + g) * HD,
                     (long long)p.K * p.G * HD, my_slab, imin(kT, p.S - ps * kT), t);
    }
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const Params p) {
  using C = DkdvCfg<HD, HDV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t k_s = smem_u32(smem);        // kNW K tiles of 64 kv rows
  const uint32_t v_s = k_s + kNW * C::kQ;     // kNW V tiles
  const uint32_t q_s = v_s + kNW * C::kO;     // kStages q tiles
  const uint32_t o_s = q_s + kStages * C::kQ; // kStages dout tiles
  const uint32_t vec_s = k_s + C::kVecOff;    // kStages × (lse·log2(e), D) slices
  const uint32_t kv_full = k_s + C::kBarOff;  // then full[], empty[]
  auto full = [&](int st) { return kv_full + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8 * (1 + kStages + st); };

  const int bk = blockIdx.x % p.BK;
  const int kvb = blockIdx.x / p.BK;  // kv block 0 first: the longest causal reach
  const int b = bk / p.K, kh = bk - b * p.K;
  const int kv0b = kvb * kNW * kT;
  const int qt0 = p.causal ? kvb * kNW : 0;  // causal: the q tile that holds position kv0b
  const int n_q = kv0b < p.kv_lim ? imax(0, p.n_qt - qt0) : 0;  // q tiles a head
  const int n_tiles = p.G * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kNW * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kNW) {  // producer: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kNW * 128 && n_tiles > 0) {
      mbar_expect_tx(kv_full, kNW * (C::kQ + C::kO));
      for (int w = 0; w < kNW; ++w) {
        for (int c = 0; c < HD / 64; ++c)
          tma_load(k_s + w * C::kQ + c * kBlock, &tk, kv_full, c * 64, kv0b + w * kT, kh, b);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(v_s + w * C::kO + c * kBlock, &tv, kv_full, c * 64, kv0b + w * kT, kh, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int g = i / n_q, qt = qt0 + (i - g * n_q);
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);  // i - kStages released
        mbar_expect_tx(full(st), C::kQ + C::kO + 2 * kVec);
        for (int c = 0; c < HD / 64; ++c)
          tma_load(q_s + st * C::kQ + c * kBlock, &tq, full(st), c * 64, qt * kT, g, kh, b);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(o_s + st * C::kO + c * kBlock, &tdo, full(st), c * 64, qt * kT, g, kh, b);
        const long long at = ((long long)bk * p.G + g) * p.s_pad + qt * kT;
        bulk_load(vec_s + st * 2 * kVec, p.lse2 + at, kVec, full(st));
        bulk_load(vec_s + st * 2 * kVec + kVec, p.dsum + at, kVec, full(st));
      }
    }
  } else {  // consumer warpgroup wg: kv rows kv0b + 64·wg ...
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127, lane = t & 31;
    const int kvw = kv0b + wg * kT;
    const bool active = kvw < p.kv_lim;
    const int r0 = (t >> 5) * 16 + (lane >> 2);  // this thread's kv rows: kvw + r0, + 8
    const int row0 = kvw + r0, row1 = row0 + 8;
    const int c0 = 2 * (lane & 3);               // its first q column in each group of 8
    const uint32_t my_k = k_s + wg * C::kQ, my_v = v_s + wg * C::kO;
    const float sl = p.scale_log2;

    float dk[C::kDkReg / 2], dv[HDV / 2];
#pragma unroll
    for (int i = 0; i < C::kDkReg / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) dv[i] = 0.f;
    // dk's columns kDkReg.. : slot i of this thread at acc[i·128 + t]
    float* const acc = reinterpret_cast<float*>(smem + C::kAccOff) + wg * 128 * (C::kDkSh / 2);
#pragma unroll
    for (int i = 0; i < C::kDkSh / 2; ++i) acc[i * 128 + t] = 0.f;
    if (n_tiles > 0) mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int g = i / n_q, q0 = (qt0 + i - g * n_q) * kT;
      const int st = i % kStages;
      mbar_wait(full(st), (i / kStages) & 1);
      if (active && (!p.causal || imin(q0 + kT, p.S) - 1 >= kvw)) {  // a visible pair
        const uint32_t q_t = q_s + st * C::kQ, o_t = o_s + st * C::kO;
        const float* const vec = reinterpret_cast<const float*>(smem + C::kVecOff + st * 2 * kVec);
        float s[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
        wg_fence();
        scores<HD>(s, my_k, q_t);  // Sᵀ: kv rows × q columns
        wg_commit();
        scores<HDV>(dp, my_v, o_t);
        wg_commit();
        wg_wait_n<1>();
        fence_regs(s);

        const bool edge = kvw + kT > p.kv_lim || (p.causal && q0 < kvw + kT - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // Pᵀ, unrounded, from the columns' lse·log2(e)
          const float2 l = *reinterpret_cast<const float2*>(vec + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            const float pr = ex2(fmaf(s[x], sl, (e & 1) ? -l.y : -l.x));
            const int qpos = q0 + 8 * j + c0 + (e & 1), kv = (e & 2) ? row1 : row0;
            const bool hide = edge && (kv >= p.kv_lim || (p.causal && qpos < kv));
            s[x] = hide ? 0.f : pr;
          }
        }
        uint32_t pa[4][4], da[4][4];  // bf16(Pᵀ) and bf16(dSᵀ), dSᵀ = Pᵀ∘(dPᵀ − D)
        wg_wait_n<0>();
        fence_regs(dp);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int x = 8 * kk + 2 * r;  // q columns 16kk + 8(r / 2) + c0, + 1
            const float2 d = *reinterpret_cast<const float2*>(vec + kT + 16 * kk + 8 * (r >> 1) + c0);
            pa[kk][r] = pack_bf16(s[x], s[x + 1]);
            da[kk][r] = pack_bf16(s[x] * (dp[x] - d.x), s[x + 1] * (dp[x + 1] - d.y));
          }
        float dks[C::kDkSh > 0 ? C::kDkSh / 2 : 1];  // this tile's dk columns kDkReg..
#pragma unroll
        for (int j = 0; j < C::kDkSh / 2; ++j) dks[j] = 0.f;
        wg_fence();
        sums<HDV>(dv, pa, o_t);
        sums<C::kDkReg>(dk, da, q_t);
        if constexpr (C::kDkSh > 0) sums<C::kDkSh>(dks, da, q_t + C::kDkReg / 64 * kBlock);
        wg_commit();
        wg_wait();
        fence_regs(dv);
        fence_regs(dk);
        if constexpr (C::kDkSh > 0) {
          fence_regs(dks);
#pragma unroll
          for (int j = 0; j < C::kDkSh / 2; ++j) acc[j * 128 + t] += dks[j];
        }
      }
      mbar_arrive(empty(st));
    }

    // dk·hd^-½ and dv as bf16 through this warpgroup's K and V tiles, then kv rows < T out
    uint8_t* const k_tile = smem + wg * C::kQ;
    uint8_t* const v_tile = smem + kNW * C::kQ + wg * C::kO;
    float dk_all[HD / 2];  // the register columns, then those from acc
#pragma unroll
    for (int i = 0; i < C::kDkReg / 2; ++i) dk_all[i] = dk[i];
#pragma unroll
    for (int i = 0; i < C::kDkSh / 2; ++i) dk_all[C::kDkReg / 2 + i] = acc[i * 128 + t];
    fence_proxy();
    stage_rows<HD>(k_tile, dk_all, p.scale, r0, lane);
    stage_rows<HDV>(v_tile, dv, 1.f, r0, lane);
    bar_sync(1 + wg, 128);
    const int n = imin(kT, p.T - kvw);
    if (n > 0) {
      const long long row = ((long long)b * p.T + kvw) * p.K + kh;
      store_rows<HD>(p.dk + row * HD, (long long)p.K * HD, k_tile, n, t);
      store_rows<HDV>(p.dv + row * HDV, (long long)p.K * HDV, v_tile, n, t);
    }
  }
}

struct Maps {
  CUtensorMap q, dout, out, k, v;
};

template <int HD, int HDV>
cudaError_t launch(const Maps& m, const Params& p, cudaStream_t stream) {
  using Q = DqCfg<HD, HDV>;
  using KV = DkdvCfg<HD, HDV>;
  const long long dq_blocks = (long long)p.n_groups * p.BK, kv_blocks = (long long)p.n_kvb * p.BK;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD, HDV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_tc_kernel<HD, HDV><<<(unsigned)dq_blocks, kThreadsTc, Q::kSmem, stream>>>(
      m.q, m.dout, m.out, m.k, m.v, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<HD, HDV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, KV::kSmem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_tc_kernel<HD, HDV><<<(unsigned)kv_blocks, kThreadsTc, KV::kSmem, stream>>>(
      m.q, m.dout, m.k, m.v, p);
  return cudaGetLastError();
}

// Dynamic shared memory of kernel 0 (dq) or 1 (dkdv); 0 for a shape the
// route does not take.
inline int instance(int hd, int hd_v) {  // launch<>'s index: 0..3 the {64, 128}², 4 (192, 128)
  return hd == 192 ? 4 : (hd == 128) * 2 + (hd_v == 128);
}

inline int smem_bytes(int kernel, int hd, int hd_v) {
  if (!dims_ok(hd, hd_v)) return 0;
  const int dq[5] = {DqCfg<64, 64>::kSmem, DqCfg<64, 128>::kSmem, DqCfg<128, 64>::kSmem,
                     DqCfg<128, 128>::kSmem, DqCfg<192, 128>::kSmem};
  const int kv[5] = {DkdvCfg<64, 64>::kSmem, DkdvCfg<64, 128>::kSmem, DkdvCfg<128, 64>::kSmem,
                     DkdvCfg<128, 128>::kSmem, DkdvCfg<192, 128>::kSmem};
  return kernel == 0 ? dq[instance(hd, hd_v)] : kv[instance(hd, hd_v)];
}

}  // namespace tc

// The tensor-core route's plan, as the launch takes it: kernel 0 the dq
// kernel, 1 the dkdv kernel; out = {blocks, threads a block, dynamic shared
// bytes, scratch floats (lse·log2(e) and D)}. Returns 0, or
// cudaErrorInvalidValue (out untouched) for a shape the route does not take.
extern "C" int flash_attention_bwd_tc_plan(int kernel, int B, int S, int T, int K, int G, int hd,
                                           int hd_v, long long* out) {
  if (!tc::dims_ok(hd, hd_v) || (kernel != 0 && kernel != 1) || B < 1 || S < 1 || T < 1 ||
      K < 1 || G < 1)
    return cudaErrorInvalidValue;
  const long long bk = (long long)B * K, s_pad = (S + tc::kT - 1) / tc::kT * tc::kT;
  const long long slabs = s_pad / tc::kT * G;
  const long long per_bk = kernel == 0 ? (slabs + tc::kNW - 1) / tc::kNW
                                       : (T + tc::kNW * tc::kT - 1) / (tc::kNW * tc::kT);
  out[0] = per_bk * bk;
  out[1] = tc::kThreadsTc;
  out[2] = tc::smem_bytes(kernel, hd, hd_v);
  out[3] = 2 * bk * G * s_pad;
  return cudaSuccess;
}

// bf16 only, (hd, hd_v) in {64, 128}² or (192, 128); every base 16-byte aligned and every
// stride of an axis longer than 1 a multiple of 8 elements (the wrapper's
// route rule). strides (elements): q (b, s, k, g), k (b, t, k), v (b, t, k),
// out (b, s, k, g), dout (b, s, k, g): 18 values, a length-1 axis's set to
// the row length. scratch: flash_attention_bwd_tc_plan's floats. Returns a
// cudaError_t, or 100000 + the CUresult of a tensor map that would not
// encode.
extern "C" int flash_attention_bwd_tc(int device, const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* scratch, void* dq, void* dk, void* dv, int B, int S,
                                      int T, int K, int G, int hd, int hd_v, int kv_len,
                                      int causal, float scale, const long long* strides,
                                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (!tc::dims_ok(hd, hd_v) || G < 1 || K < 1 || B < 1 || S < 1 || T < 1)
    return cudaErrorInvalidValue;
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return tc::kTensorMapError + CUDA_ERROR_NOT_FOUND;
  tc::Params p;
  p.S = S; p.T = T; p.K = K; p.G = G; p.BK = B * K;
  p.kv_lim = imax(0, imin(kv_len, T));
  p.causal = causal;
  p.n_qt = (S + tc::kT - 1) / tc::kT;
  p.s_pad = p.n_qt * tc::kT;
  p.n_slabs = p.n_qt * G;
  p.n_groups = (p.n_slabs + tc::kNW - 1) / tc::kNW;
  p.n_kvb = (T + tc::kNW * tc::kT - 1) / (tc::kNW * tc::kT);
  p.scale = scale;
  p.scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(scratch);
  p.dsum = p.lse2 + (long long)p.BK * G * p.s_pad;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const long long* s = strides;
  // the kv axis ends at kv_len, so TMA reads zeros past it (at least one row
  // for the encoder; with kv_len = 0 no kv tile is loaded)
  const cuuint64_t tm = (cuuint64_t)imax(p.kv_lim, 1);
  const cuuint64_t q_dims[5] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)G, (cuuint64_t)K,
                                (cuuint64_t)B};
  const cuuint64_t o_dims[5] = {(cuuint64_t)hd_v, (cuuint64_t)S, (cuuint64_t)G, (cuuint64_t)K,
                                (cuuint64_t)B};
  auto rows5 = [](const long long* x, cuuint64_t* str) {  // (b, s, k, g) -> s, g, k, b in bytes
    str[0] = (cuuint64_t)x[1] * 2; str[1] = (cuuint64_t)x[3] * 2;
    str[2] = (cuuint64_t)x[2] * 2; str[3] = (cuuint64_t)x[0] * 2;
  };
  auto rows4 = [](const long long* x, cuuint64_t* str) {  // (b, t, k) -> t, k, b in bytes
    str[0] = (cuuint64_t)x[1] * 2; str[1] = (cuuint64_t)x[2] * 2; str[2] = (cuuint64_t)x[0] * 2;
  };
  cuuint64_t q_str[4], o_str[4], d_str[4], k_str[3], v_str[3];
  rows5(s, q_str);
  rows4(s + 4, k_str);
  rows4(s + 7, v_str);
  rows5(s + 10, o_str);
  rows5(s + 14, d_str);
  const cuuint64_t k_dims[4] = {(cuuint64_t)hd, tm, (cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t v_dims[4] = {(cuuint64_t)hd_v, tm, (cuuint64_t)K, (cuuint64_t)B};
  const cuuint32_t box[5] = {64, 64, 1, 1, 1};  // 64 bf16 values = 128 bytes, by 64 rows
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  tc::Maps m;
  CUresult r = tc::encode(enc, &m.q, kBf16, q, 5, q_dims, q_str, box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.out, kBf16, out, 5, o_dims, o_str, box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.dout, kBf16, dout, 5, o_dims, d_str, box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.k, kBf16, k, 4, k_dims, k_str, box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.v, kBf16, v, 4, v_dims, v_str, box);
  if (r != CUDA_SUCCESS) return tc::kTensorMapError + (int)r;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::instance(hd, hd_v)) {
    case 0: return tc::launch<64, 64>(m, p, st);
    case 1: return tc::launch<64, 128>(m, p, st);
    case 2: return tc::launch<128, 64>(m, p, st);
    case 3: return tc::launch<128, 128>(m, p, st);
    default: return tc::launch<192, 128>(m, p, st);
  }
}
