// GQA flash-attention forward: softmax(q·kᵀ·hd^-½, masked)·v with an online
// softmax over kv tiles, one launch per attention call. Three routes, each a
// kernel of its own, chosen by the wrapper before the launch
// (kernels/flash_attention/ops.py, _route):
//   flash_attention_fwd_tc     — bf16 on Hopper's tensor cores (wgmma + TMA),
//     for bf16 q, k, v with hd and hd_v multiples of 64 up to 256;
//   flash_attention_fwd_tf32x3 — float32 on the tensor cores as 3xTF32 wgmma
//     (tf32x3.cuh), for float32 q, k, v with hd and hd_v in {64, 128};
//   flash_attention_fwd        — float32 FMAs, for every other shape.
// Both tensor-core routes need what TMA takes: 16-byte aligned bases and
// strides of 16-byte multiples.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:113
// (flash_attention_fwd_kernel, pallas_call at :135, body _flash_fwd_kernel
// at :39, wrapper ops.py:22).
//
// Operands: q (B, S, K, G, hd), k (B, T, K, hd), v (B, T, K, hd_v), read in
// place through their strides (the last axis contiguous; no transposes, no
// padding copies); out (B, S, K, G, hd_v) contiguous in q's type. Statistics
// and accumulators are float32. Query position s sees kv position t when
// t < kv_len and, if causal, s >= t (no offset). Masked scores get weight
// exactly 0, so a row with no visible position gives 0 (its denominator, 0,
// is clamped at 1e-30) and no NaN. No float atomics on any route: a fixed
// input gives the same bits on every run.
//
// lse. Given a non-null `lse` (B, S, K, G) float32, contiguous, every route
// also writes each row's log-sum-exp of its scaled scores, natural log,
// m + ln l with m the row max of q·kᵀ·hd^-½ and l the sum of the weights:
// what the backward (flash_attention_bwd.cu) recomputes P = exp(s − lse)
// from. The tensor-core routes keep m in raw score units and the weights in
// base 2 (scale_log2), so there lse = ln 2 · (m·scale_log2 + log2 l). A row
// with no visible position gets +inf, so that the backward's P, and with it
// every gradient of the row, is exactly 0. A null `lse` (serving) writes
// nothing.
//
// What bounds each route on an H100. At the serving path's shape (B=2, K=8,
// G=3, S=T=4096, hd=hd_v=128, causal) the causal work is 2·B·K·G·S·T·hd =
// 2.06e11 flop against 0.13 GB of bf16 operands (0.27 GB in float32): bound
// by operations, 0.21 ms on the bf16 tensor cores, 1.25 ms for the three
// TF32 passes at 495 TFLOP/s, 3.1 ms at the 67 TFLOP/s float32 FMA rate.
//
// bf16 tensor-core route (FlashAttention-3's shape, kept simple). Its bound
// is the tensor cores' rate; what keeps it from that rate is the softmax and
// the waits between the two products. A block owns one (b, kv head) pair and
// NW slabs of 64 query positions × one head (NW = 3 consumer warpgroups at
// hd_v <= 128, 2 above). The slabs are consecutive in (position slab, head)
// order, so at G = 3 a block is one position slab × the group's three heads
// and each K/V tile in shared memory serves all of them (the TPU kernel's
// GQA grouping); G = 1 gives a block three position slabs, G = 7 or 8
// spreads a group's heads over blocks. A fourth warpgroup is the producer:
// one thread loads the block's q slabs once, then keeps K and V tiles (64 kv
// positions) in flight by TMA into a two-stage ring with full/empty
// mbarriers; the warpgroup gives its registers to the consumers (setmaxnreg:
// 24 a thread, the consumers 160 at NW = 3, 240 at NW = 2). Tensor maps
// (128-byte swizzle, a 64-column box per 128 bytes) are encoded per call on
// the host; TMA zero-fills rows past S and kv positions past kv_len (the kv
// axis of the map ends at kv_len), so nothing past them is read, and takes q
// through its strides (the model's reshaped view included). Each consumer
// warpgroup computes S = q·kᵀ with wgmma m64n64k16 (both operands from
// shared memory) and the online softmax on the accumulator fragment in base
// 2, the scale folded into one FFMA a score (row max and sum over the 4
// lanes of a row by xor shuffles; the mask only on edge and diagonal tiles).
// It converts P to bf16 in registers and feeds it as the register A operand
// of one m64n{hd_v}k16 per 16 kv rows for O += P·V (V kv-major, the
// B-transpose bit set), then divides by l and stores O through its q slab's
// shared memory with coalesced 16-byte writes. Tiles above the diagonal or
// past kv_len are never loaded; blocks go longest causal reach first. Not
// done yet: ping-pong between consumer warpgroups, overlap of the softmax
// with the next wgmma, persistent blocks, fp8.
//
// float32 tensor-core route ("tf32x3", namespace tf). Its bound is the three
// TF32 passes a product; float32 accuracy comes from splitting every operand
// into TF32 halves rounded to nearest, hi = tf32(x), lo = tf32(x − hi), and
// summing hi·lo + lo·hi + hi·hi in the float32 accumulator (lo·lo, ~2^-22
// of the product, is dropped; one pass alone errs by ~1e-3 at the serving
// shape). Three things shape it:
// - TF32 wgmma takes K-major operands only, and for O += P·V the k axis is
//   the kv position, which v keeps strided. A pre-pass of two small kernels
//   writes, into a scratch buffer the wrapper allocates, k's halves (B·K,
//   Tp, hd) and vᵀ's halves (B·K, hd_v, Tp), kv-contiguous, Tp = kv_len
//   rounded up to the tile, zeros past kv_len; TMA then loads both like any
//   K-major tile (192 MB moved at the serving shape, ~74 us).
// - Shared memory: float32 tiles are twice bf16's and hi + lo doubles them
//   again. A block has two consumer warpgroups of one 64-row q slab each
//   (32 KB of float32 q) and a two-stage ring of 32 kv positions (k's
//   halves 2 x 16 KB, vᵀ's 2 x 16 KB: one 128-byte swizzled row of 32
//   values a hd_v row), 192 KB in all; slabs, producer, ordering and masks
//   as the bf16 route's. TMA zero-fills q rows past S.
// - Where the halves of q and P live. Each consumer splits its q slab once:
//   q's hi as register A fragments (64 registers at hd = 128, kept for every
//   tile), q's lo written back over q in shared memory. A tile's S = q·kᵀ
//   is then 3·hd/8 wgmma m64n32k8 with no per-tile split: hi·lo and hi·hi
//   with A from registers, lo·hi with both operands in shared memory.
//   Splitting q again every tile (from float32 q in shared memory) made the
//   products latency-bound (2.2 ms on the H100 below, even with three
//   warpgroups, against 2.0 ms). For O += P·V the S fragment's columns 2t
//   and 2t + 1 of each group of 8 are taken as the A columns t and t + 4 of
//   a k step (the register fragment's layout), and the pre-pass stores vᵀ's
//   kv positions in that order (perm), so P is split in registers with no
//   shuffle: 3·kN/8 wgmma m64n{hd_v}k8 with A from registers. The consumers take 240 registers,
//   the producer 24. O / l goes straight to global memory as float2 pairs
//   (whole 32-byte sectors of a row).
// Issuing the next tile's S before this tile's P·V, with or without
// ping-pong turns between the warpgroups, measured slower on the H100
// below (2.7–4.6 ms), so each warpgroup waits for each product.
// python -m repro_torch.launch.flash_probe holds one tile's products to
// float64 and times the route's phases (FLASH_CUT, probe builds only: 1 the
// pre-pass; 2 + the main kernel's copies; 3 + the products with P taken from
// the raw scores; 4 + the softmax; 5 everything but the tile copies).
//
// FMA route. Its bound is the float32 rate of its FMAs; K/V staging does not
// overlap the arithmetic. A loop inside the block walks the kv tiles (the TPU
// kernel's sequential grid axis). A block owns one (b, kv head) pair and 64
// rows, each row a (query position, head) pair: floor(64 / G) query
// positions times all G heads of the group, so every K/V tile staged in
// shared memory serves G heads. 256 threads as 16 x 16: a thread owns 4
// consecutive rows and the kv columns tx + 16j (j < 4) of each tile for
// q·kᵀ, and the same 4 rows times columns c·64 + 4tx + j of the output for
// P·v, so its rows' softmax statistics and accumulators live in its
// registers. Per kv tile of 64: stage K and V (float32, zero beyond the
// valid rows and columns); scores by float4 reads of q and k rows; online
// softmax per row over the 16 lanes of the row (xor butterflies); P into the
// K tile's shared memory, then acc += P·V. Shared memory: q (64 x hd), one
// K-or-P tile and a V tile, float32, row strides padded so that float4 reads
// of 8 rows hit distinct banks: 100 KB at hd = hd_v = 128 (two blocks per
// SM).
//
// On the card nvidia-smi names "NVIDIA H100 80GB HBM3, 700.00 W", at the
// serving path's shape (chip_smoke.py phase 5): 0.40 ms on the bf16
// tensor-core route (PyTorch's scaled_dot_product_attention in bf16: 0.35
// ms), 1.97–2.14 ms on the float32 tensor-core route (1.6–1.7x its 1.25 ms
// bound; float32 SDPA: 19.9 ms) and 7.79–7.87 ms on the FMA route.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "flash_fma.cuh"
#include "pipeline.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

#ifndef FLASH_CUT
#define FLASH_CUT 0
#endif

namespace {

constexpr int kRows = 64;       // (query position, head) rows per block
constexpr int kBK = 64;         // kv positions per tile
constexpr int kRP = kRows + 4;  // row stride of the P tile (floats), /4 odd
constexpr float kNegInf = -1e30f;

struct Params {
  int S, K, G, hd, hd_v, kv_lim, causal, bq, n_qtiles, vec;
  float scale;
  long long q_sb, q_ss, q_sk, q_sg, k_sb, k_st, k_sk, v_sb, v_st, v_sk;
  float* lse;  // (B, S, K, G) or null
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int NC>  // NC: output column groups of 64 (hd_v <= 64·NC)
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, const Params p) {
  constexpr int HDV = 64 * NC;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int QP = padded_stride(p.hd);
  const int hd4 = (p.hd + 3) / 4 * 4;
  float* const Qs = smem;                         // kRows x QP
  float* const KPs = Qs + kRows * QP;             // kBK x QP (K), then kBK x kRP (P)
  float* const Vs = KPs + kBK * imax(QP, kRP);    // kBK x HDV

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = p.n_qtiles - 1 - blockIdx.x;  // longest causal blocks first
  const int b = blockIdx.y / p.K, kh = blockIdx.y - b * p.K;
  const int q0 = qt * p.bq;
  const int n_q = imin(p.bq, p.S - q0);
  const int G = p.G;
  const int rows = n_q * G;  // valid rows of this block

  {  // q rows: row r is query position q0 + r / G, head r % G
    const long long ss = p.q_ss, sg = p.q_sg;
    const T* qb = q + b * p.q_sb + kh * p.q_sk + q0 * ss;
    stage(Qs, QP, qb, [=](int r) { const int i = r / G; return i * ss + (r - i * G) * sg; },
          kRows, rows, p.hd, hd4, p.vec & 1);
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (ty * 4 + i) / G;
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  int kv_end = p.kv_lim;
  if (p.causal) kv_end = imin(kv_end, q0 + n_q);  // tiles past the last row's reach
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const long long kst = p.k_st, vst = p.v_st;
  const T* kb = k + b * p.k_sb + kh * p.k_sk;
  const T* vb = v + b * p.v_sb + kh * p.v_sk;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int kv0 = jt * kBK;
    const int n_kv = imin(kBK, kv_end - kv0);
    __syncthreads();  // the previous tile's P and V are read
    stage(KPs, QP, kb + kv0 * kst, [=](int r) { return r * kst; }, kBK, n_kv, p.hd, hd4,
          p.vec & 2);
    stage(Vs, HDV, vb + kv0 * vst, [=](int r) { return r * vst; }, kBK, n_kv, p.hd_v, HDV,
          p.vec & 4);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd4; d += 4) {
      float4 c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(KPs + (tx + 16 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * QP + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a.x, c[j].x, t);
          t = fmaf(a.y, c[j].y, t);
          t = fmaf(a.z, c[j].z, t);
          t = fmaf(a.w, c[j].w, t);
          s[i][j] = t;
        }
      }
    }
    __syncthreads();  // the K tile is read; its shared memory takes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        ok[j] = col < p.kv_lim && (!p.causal || qpos[i] >= col);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(KPs + (tx + 16 * j) * kRP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int t = 0; t < n_kv; ++t) {
      const float4 pr = *reinterpret_cast<const float4*>(KPs + t * kRP + ty * 4);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(Vs + t * HDV + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] = fmaf(pv[i], w.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pv[i], w.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pv[i], w.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pv[i], w.w, acc[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const int qi = r / G;
    const long long row = (((long long)b * p.S + q0 + qi) * p.K + kh) * G + (r - qi * G);
    const long long base = row * p.hd_v;
    const float denom = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0) p.lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * 64 + tx * 4 + j;
        if (col < p.hd_v) store(out + base + col, acc[i][4 * c + j] / denom);
      }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const Params& p,
                   int BK, cudaStream_t stream) {
  const int QP = padded_stride(p.hd);
  const size_t bytes =
      sizeof(float) * (size_t)(kRows * QP + kBK * imax(QP, kRP) + kBK * 64 * NC);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.n_qtiles, BK);
  flash_fwd_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, const Params& p,
                     int BK, cudaStream_t stream) {
  switch ((p.hd_v + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, out, p, BK, stream);
    case 2: return launch<T, 2>(q, k, v, out, p, BK, stream);
    case 3: return launch<T, 3>(q, k, v, out, p, BK, stream);
    case 4: return launch<T, 4>(q, k, v, out, p, BK, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. scale: hd^-1/2 as the caller rounds it. vec: bit 0/1/2 set when every row of q/k/v
// starts aligned for one 4-element load. Strides are in elements.
extern "C" int flash_attention_fwd(int device, int dtype, const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B, int S, int T, int K, int G,
                                   int hd, int hd_v, int kv_len, int causal, float scale,
                                   int vec,
                                   long long q_sb, long long q_ss, long long q_sk,
                                   long long q_sg, long long k_sb, long long k_st,
                                   long long k_sk, long long v_sb, long long v_st,
                                   long long v_sk, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (hd < 1 || hd > 256 || hd_v < 1 || hd_v > 256 || G < 1 || G > kRows || B < 0 || S < 0 ||
      T < 0 || K < 1 || (long long)B * K > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  Params p;
  p.S = S; p.K = K; p.G = G; p.hd = hd; p.hd_v = hd_v;
  p.kv_lim = imax(0, imin(kv_len, T));
  p.causal = causal; p.vec = vec;
  p.bq = kRows / G;
  p.n_qtiles = (S + p.bq - 1) / p.bq;
  p.scale = scale;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sk = q_sk; p.q_sg = q_sg;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sk = k_sk;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sk = v_sk;
  p.lse = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, p, B * K, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, out, p, B * K, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16): wgmma fed by TMA, see the note at the top.

namespace tc {

using namespace sm90;

constexpr int kM = 64;                   // query positions per slab (wgmma's M)
constexpr int kN = 64;                   // kv positions per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr float kNegInf = -1e30f;

template <int HD, int HDV>
struct Cfg {
  // consumer warpgroups, one slab each: three while S (32 floats), O
  // (HDV/2) and P (16) fit 160 registers a thread, else two at 240
  static constexpr int NW = HDV <= 128 ? 3 : 2;
  static constexpr int kThreads = (NW + 1) * 128;
  // NW·128·consumer + 128·producer registers <= 65,536
  static constexpr int kConsumerRegs = NW == 3 ? 160 : 240;
  static constexpr int kProducerRegs = 24;
  static constexpr int kSlab = (HD > HDV ? HD : HDV) / 64 * kBlock;  // q slab, later the O tile
  static constexpr int kK = HD / 64 * kBlock;
  static constexpr int kV = HDV / 64 * kBlock;
  static constexpr int kBarOff = NW * kSlab + kStages * (kK + kV);
  static constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

struct Params {
  int S, K, G, BK, kv_lim, causal, n_slabs, n_groups;
  float scale_log2;  // the caller's hd^-1/2 times log2(e)
  float* lse;        // (B, S, K, G) or null
};

// A row's natural-log lse from its running max m (raw score units) and its
// weight sum l (weights 2^(s·sl − m·sl)); +inf for a row with nothing visible.
__device__ __forceinline__ float lse_of(float m, float l, float sl) {
  return l > 0.f ? fmaf(m, sl, log2f(l)) * 0.6931471805599453f : INFINITY;
}

// Accumulator fragment of m64nN (thread t of the warpgroup, warp w = t / 32,
// lane l): d[4j + e] is row 16w + l/4 + 8·(e >= 2), column 8j + 2(l % 4) +
// (e & 1). The same pairs, packed to bf16, are the register A fragment of the
// next product, 16 columns (two j) per k step.
template <int HD, int HDV>
__global__ void __launch_bounds__(Cfg<HD, HDV>::kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                    const Params p) {
  using C = Cfg<HD, HDV>;
  constexpr int NW = C::NW;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem);          // NW q slabs
  const uint32_t k_s = q_s + NW * C::kSlab;     // kStages K tiles
  const uint32_t v_s = k_s + kStages * C::kK;   // kStages V tiles
  const uint32_t q_full = q_s + C::kBarOff;     // then k_full[], v_full[], empty[]
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };

  const int bk = blockIdx.x % p.BK;
  const int grp = p.n_groups - 1 - blockIdx.x / p.BK;  // longest causal reach first
  const int b = bk / p.K, kh = bk - b * p.K;
  const int slab0 = grp * NW;  // slab = position slab · G + head
  const int last = min(slab0 + NW, p.n_slabs) - 1;
  auto tiles_of = [&](int ps) {  // kv tiles a position slab sees
    int end = p.kv_lim;
    if (p.causal) end = min(end, min((ps + 1) * kM, p.S));
    return (end + kN - 1) / kN;
  };
  const int n_tiles = tiles_of(last / p.G);  // the block's last slab reaches furthest

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), NW * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NW) {  // producer: one thread issues every copy
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x == NW * 128) {
      mbar_expect_tx(q_full, (last - slab0 + 1) * (HD / 64) * kBlock);
      for (int j = slab0; j <= last; ++j) {
        const int ps = j / p.G, g = j - ps * p.G;
        for (int c = 0; c < HD / 64; ++c)
          tma_load(q_s + (j - slab0) * C::kSlab + c * kBlock, &tq, q_full, c * 64, ps * kM, g, kh,
                   b);
      }
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % kStages;
        if (jt >= kStages) mbar_wait(empty(st), ((jt / kStages) & 1) ^ 1);  // jt - kStages released
        mbar_expect_tx(k_full(st), C::kK);
        for (int c = 0; c < HD / 64; ++c)
          tma_load(k_s + st * C::kK + c * kBlock, &tk, k_full(st), c * 64, jt * kN, kh, b);
        mbar_expect_tx(v_full(st), C::kV);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(v_s + st * C::kV + c * kBlock, &tv, v_full(st), c * 64, jt * kN, kh, b);
      }
    }
  } else {  // consumer warpgroup wg: slab slab0 + wg
    regs_inc<C::kConsumerRegs>();
    const int t = threadIdx.x & 127, lane = t & 31;
    const int slab = slab0 + wg;
    const bool valid = slab <= last;
    const int ps = slab / p.G, g = slab - ps * p.G;
    const int my_tiles = valid ? tiles_of(ps) : 0;
    const int r0 = (t >> 5) * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int pos0 = ps * kM + r0, pos1 = pos0 + 8;
    const int c0 = 2 * (lane & 3);               // its first column in each group of 8
    const uint32_t my_q = q_s + wg * C::kSlab;
    const float sl = p.scale_log2;

    float o[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in raw score units
    if (valid) mbar_wait(q_full, 0);

    for (int jt = 0; jt < n_tiles; ++jt) {
      const int st = jt % kStages;
      const uint32_t ph = (jt / kStages) & 1;
      mbar_wait(k_full(st), ph);
      if (jt < my_tiles) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)  // 16 columns = 32 bytes per k step
          wgmma_ss(s, desc(my_q + (kk >> 2) * kBlock + (kk & 3) * 32),
                   desc(k_s + st * C::kK + (kk >> 2) * kBlock + (kk & 3) * 32), kk > 0);
        wg_commit();
        wg_wait();
        fence_regs(s);

        const int kv0 = jt * kN;
        float mx0 = kNegInf, mx1 = kNegInf;
        if (kv0 + kN > p.kv_lim || (p.causal && kv0 + kN - 1 > ps * kM)) {  // edge or diagonal
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = kv0 + 8 * (i >> 2) + c0 + (i & 1);
            if (col >= p.kv_lim || (p.causal && col > ((i & 2) ? pos1 : pos0))) s[i] = kNegInf;
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        // weights are 2^(s·sl − m·sl); a row with nothing visible yet subtracts
        // 0, so its masked scores (−1e30) still weigh exactly 0
        const float ms0 = mn0 == kNegInf ? 0.f : mn0 * sl, ms1 = mn1 == kNegInf ? 0.f : mn1 * sl;
        const float a0 = ex2(fmaf(m0, sl, -ms0)), a1 = ex2(fmaf(m1, sl, -ms1));
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = ex2(fmaf(s[i], sl, (i & 2) ? -ms1 : -ms0));
          if (i & 2) sum1 += s[i]; else sum0 += s[i];
        }
        l0 = fmaf(l0, a0, sum0);  // this thread's columns; the quad's are summed at the end
        l1 = fmaf(l1, a1, sum1);
#pragma unroll
        for (int i = 0; i < HDV / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

        mbar_wait(v_full(st), ph);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 kv rows of 128 bytes per k step
          wgmma_rs<HDV>(o, pa[kk], desc(v_s + st * C::kV + kk * 16 * kRowBytes));
        wg_commit();
        wg_wait();
        fence_regs(o);
      }
      mbar_arrive(empty(st));  // after k_full: the arrival belongs to tile jt
    }

    if (valid) {  // O / l as bf16 into this slab's shared memory, then rows < S out
      const float ls0 = quad_sum(l0), ls1 = quad_sum(l1);
      const float inv0 = 1.f / fmaxf(ls0, 1e-30f);
      const float inv1 = 1.f / fmaxf(ls1, 1e-30f);
      if (p.lse != nullptr && (lane & 3) == 0) {
        const long long row0 = (((long long)b * p.S + pos0) * p.K + kh) * p.G + g;
        if (pos0 < p.S) p.lse[row0] = lse_of(m0, ls0, sl);
        if (pos1 < p.S) p.lse[row0 + 8LL * p.K * p.G] = lse_of(m1, ls1, sl);
      }
      constexpr int kRow = HDV * 2;  // bytes; 16-byte chunk c of row r sits at c ^ (r % 8)
      uint8_t* const o_s = smem + wg * C::kSlab;
      fence_proxy();
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const float inv = h ? inv1 : inv0;
          *reinterpret_cast<__nv_bfloat162*>(o_s + r * kRow + ((j ^ (r & 7)) * 16) + (lane & 3) * 4) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
        }
      bar_sync(1 + wg, 128);
      constexpr int kChunks = HDV / 8;
      for (int e = t; e < kM * kChunks; e += 128) {
        const int r = e / kChunks, c = e - r * kChunks;
        const int pos = ps * kM + r;
        if (pos < p.S)
          *reinterpret_cast<uint4*>(out + ((((long long)b * p.S + pos) * p.K + kh) * p.G + g) * HDV +
                                    c * 8) =
              *reinterpret_cast<const uint4*>(o_s + r * kRow + ((c ^ (r & 7)) * 16));
      }
    }
  }
}


template <int HD, int HDV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* out,
                   Params p, cudaStream_t stream) {
  using C = Cfg<HD, HDV>;
  p.n_groups = (p.n_slabs + C::NW - 1) / C::NW;
  const long long blocks = (long long)p.n_groups * p.BK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  flash_fwd_tc_kernel<HD, HDV><<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_hd_v(int hd_v, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                    void* out, const Params& p, cudaStream_t stream) {
  switch (hd_v) {
    case 64: return launch<HD, 64>(tq, tk, tv, out, p, stream);
    case 128: return launch<HD, 128>(tq, tk, tv, out, p, stream);
    case 192: return launch<HD, 192>(tq, tk, tv, out, p, stream);
    case 256: return launch<HD, 256>(tq, tk, tv, out, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// bf16 only. hd, hd_v in {64, 128, 192, 256}; every base 16-byte aligned and
// every stride of an axis longer than 1 a multiple of 8 elements (the
// wrapper's route rule). Strides are in elements. Returns a cudaError_t, or
// 100000 + the CUresult of a tensor map that would not encode.
extern "C" int flash_attention_fwd_tc(int device, const void* q, const void* k, const void* v,
                                      void* out, void* lse, int B, int S, int T, int K, int G, int hd,
                                      int hd_v, int kv_len, int causal, float scale,
                                      long long q_sb, long long q_ss, long long q_sk,
                                      long long q_sg, long long k_sb, long long k_st,
                                      long long k_sk, long long v_sb, long long v_st,
                                      long long v_sk, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool dims_ok = hd % 64 == 0 && hd >= 64 && hd <= 256 && hd_v % 64 == 0 && hd_v >= 64 &&
                       hd_v <= 256;
  if (!dims_ok || G < 1 || K < 1 || B < 0 || S < 0 || T < 0) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return tc::kTensorMapError + CUDA_ERROR_NOT_FOUND;
  tc::Params p;
  p.S = S; p.K = K; p.G = G; p.BK = B * K;
  p.kv_lim = imax(0, imin(kv_len, T));
  p.causal = causal;
  p.n_slabs = (S + tc::kM - 1) / tc::kM * G;
  p.n_groups = 0;  // set per instantiation
  p.scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  p.lse = static_cast<float*>(lse);
  // the kv axis ends at kv_len, so TMA reads zeros past it (at least one row
  // for the encoder; with kv_len = 0 no kv tile is loaded)
  const cuuint64_t tm = (cuuint64_t)imax(p.kv_lim, 1);
  const cuuint64_t q_dims[5] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)G, (cuuint64_t)K,
                                (cuuint64_t)B};
  const cuuint64_t q_str[4] = {(cuuint64_t)q_ss * 2, (cuuint64_t)q_sg * 2, (cuuint64_t)q_sk * 2,
                               (cuuint64_t)q_sb * 2};
  const cuuint64_t k_dims[4] = {(cuuint64_t)hd, tm, (cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t k_str[3] = {(cuuint64_t)k_st * 2, (cuuint64_t)k_sk * 2, (cuuint64_t)k_sb * 2};
  const cuuint64_t v_dims[4] = {(cuuint64_t)hd_v, tm, (cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t v_str[3] = {(cuuint64_t)v_st * 2, (cuuint64_t)v_sk * 2, (cuuint64_t)v_sb * 2};
  CUtensorMap tq, tk, tv;
  const cuuint32_t box[5] = {64, 64, 1, 1, 1};  // 64 bf16 values = 128 bytes, by 64 rows
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = tc::encode(enc, &tq, kBf16, q, 5, q_dims, q_str, box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &tk, kBf16, k, 4, k_dims, k_str, box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &tv, kBf16, v, 4, v_dims, v_str, box);
  if (r != CUDA_SUCCESS) return tc::kTensorMapError + (int)r;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return tc::by_hd_v<64>(hd_v, tq, tk, tv, out, p, st);
    case 128: return tc::by_hd_v<128>(hd_v, tq, tk, tv, out, p, st);
    case 192: return tc::by_hd_v<192>(hd_v, tq, tk, tv, out, p, st);
    case 256: return tc::by_hd_v<256>(hd_v, tq, tk, tv, out, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Float32 route on the tensor cores: 3xTF32 wgmma, see the note at the top.

namespace tf {

using namespace sm90;
using tf32x3::desc;
using tf32x3::mma_rs;
using tf32x3::split;
using tf32x3::swizzled;

constexpr int kCut = FLASH_CUT;
constexpr int kM = 64;                    // query positions per slab (wgmma's M)
constexpr int kN = 32;                    // kv positions a stage: one swizzled row of vT
constexpr int kStages = 2;                // K/vT ring depth
constexpr int kNW = 2;                    // consumer warpgroups, one slab each
constexpr int kThreads = (kNW + 1) * 128;
constexpr int kConsumerRegs = 240;        // 2·128·240 + 128·24 <= 65,536
constexpr int kBarOwn = 1;                // named barrier 1 + w: warpgroup w's own 128 threads
constexpr int kProducerRegs = 24;
constexpr int kRow = tf32x3::kRowBytes;   // a swizzled row: 32 float32 / TF32 values
constexpr int kBlk = kM * kRow;           // a 32-column block of a slab (one TMA box)
constexpr int kKBlk = kN * kRow;          // a 32-column block of a K tile (one TMA box)
constexpr float kNegInf = -1e30f;

template <int HD, int HDV>
struct Cfg {
  static constexpr int kSlab = HD / 32 * kBlk;          // q, float32
  static constexpr int kKHalf = HD / 32 * kKBlk;        // K tile, hi or lo
  static constexpr int kVHalf = HDV * kRow;             // vT tile (HDV rows of kN), hi or lo
  static constexpr int kStage = 2 * kKHalf + 2 * kVHalf;  // K hi, K lo, vT hi, vT lo
  static constexpr int kBarOff = kNW * kSlab + kStages * kStage;
  static constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

// kv positions of the scratch: kv_lim rounded up to the tile, at least one tile.
__host__ __device__ inline int padded_t(int kv_lim) {
  return kv_lim < kN ? kN : (kv_lim + kN - 1) / kN * kN;
}

// The A column c of a P·V k step is kv position 8·(step) + perm(c): the
// columns 2t and 2t + 1 that thread t holds in the S fragment are its A
// columns t and t + 4, so P needs no shuffle; vT is stored in that order.
__host__ __device__ inline int perm(int c) { return c < 4 ? 2 * c : 2 * c - 7; }

// Pre-pass 1: k (B, T, K, HD) read through its strides -> k_hi, k_lo (BK,
// Tp, HD), TF32 halves; rows past kv_lim are zeros. Four values a thread.
__global__ void __launch_bounds__(256)
split_k(const float* __restrict__ k, float* __restrict__ hi, float* __restrict__ lo, int K,
        int hd, int kv_lim, int Tp, long long sb, long long st, long long sk) {
  const int bk = blockIdx.y, b = bk / K, kh = bk - b * K;
  const int chunks = hd / 4;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= Tp * chunks) return;
  const int t = e / chunks, c = (e - t * chunks) * 4;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < kv_lim) x = *reinterpret_cast<const float4*>(k + b * sb + t * st + kh * sk + c);
  float4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  const size_t o = ((size_t)bk * Tp + t) * hd + c;
  *reinterpret_cast<float4*>(hi + o) = h;
  *reinterpret_cast<float4*>(lo + o) = l;
}

// Pre-pass 2: v (B, T, K, HDV) through its strides -> vT_hi, vT_lo (BK, HDV,
// Tp), kv-contiguous (the K-major B operand of P·V), with the kv positions of
// each group of 8 in perm's order; zeros past kv_lim. A block transposes 32
// kv rows by 32 columns through shared memory.
__global__ void __launch_bounds__(256)
split_vt(const float* __restrict__ v, float* __restrict__ hi, float* __restrict__ lo, int K,
         int hdv, int kv_lim, int Tp, long long sb, long long st, long long sk) {
  __shared__ float tile[32][33];
  const int bk = blockIdx.z, b = bk / K, kh = bk - b * K;
  const int t0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + i;
    tile[i][tx] = t < kv_lim ? v[b * sb + t * st + kh * sk + n0 + tx] : 0.f;
  }
  __syncthreads();
  const int src = (tx & ~7) + perm(tx & 7);
  for (int i = ty; i < 32; i += 8) {
    float h, l;
    split(tile[src][i], h, l);
    const size_t o = ((size_t)bk * hdv + n0 + i) * Tp + t0 + tx;
    hi[o] = h;
    lo[o] = l;
  }
}

struct Params {
  int S, K, G, BK, kv_lim, causal, n_slabs, n_groups;
  float scale_log2;  // the caller's hd^-1/2 times log2(e)
  float* probe;      // kProbe: the first tile's raw S (n_slabs, 64, kN), then S·V
  float* lse;        // (B, S, K, G) or null
};

// S = q·kᵀ from TF32 halves, three passes a k step: q's hi from registers
// (q_hi[kk], the A fragment of k step kk), q's lo and K's halves from shared
// memory (K-major, swizzled 32-column blocks: k step kk at block kk / 4,
// 32 bytes × (kk % 4) into it).
template <int HD>
__device__ __forceinline__ void s_product(float (&s)[kN / 2], const uint32_t (&q_hi)[HD / 8][4],
                                          uint32_t q_lo, uint32_t k_hi, uint32_t k_lo) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint32_t kq = (kk >> 2) * kBlk + (kk & 3) * 32, kb = (kk >> 2) * kKBlk + (kk & 3) * 32;
    mma_rs<kN>(s, q_hi[kk], desc(k_lo + kb), kk > 0);             // hi·lo
    tf32x3::mma_m64n32k8(s, desc(q_lo + kq), desc(k_hi + kb), 1);  // lo·hi
    mma_rs<kN>(s, q_hi[kk], desc(k_hi + kb), 1);                  // hi·hi
  }
}

// Accumulator fragment of m64nN (thread t of the warpgroup, warp w = t / 32,
// lane l): d[4j + e] is row 16w + l/4 + 8·(e >= 2), column 8j + 2(l % 4) +
// (e & 1). A fragment (mma_rs): row 16w + l/4 (+8), column l % 4 (+4).
template <int HD, int HDV, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk_hi,
                      const __grid_constant__ CUtensorMap tk_lo,
                      const __grid_constant__ CUtensorMap tv_hi,
                      const __grid_constant__ CUtensorMap tv_lo, float* __restrict__ out,
                      const Params p) {
  using C = Cfg<HD, HDV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem);               // kNW q slabs
  const uint32_t st_s = q_s + kNW * C::kSlab;        // kStages stages
  const uint32_t q_full = q_s + C::kBarOff;          // then k_full[], v_full[], empty[]
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };

  const int bk = blockIdx.x % p.BK;
  const int grp = p.n_groups - 1 - blockIdx.x / p.BK;  // longest causal reach first
  const int b = bk / p.K, kh = bk - b * p.K;
  const int slab0 = grp * kNW;  // slab = position slab · G + head
  const int last = min(slab0 + kNW, p.n_slabs) - 1;
  auto tiles_of = [&](int ps) {  // kv tiles a position slab sees
    int end = p.kv_lim;
    if (p.causal) end = min(end, min((ps + 1) * kM, p.S));
    return (end + kN - 1) / kN;
  };
  const int n_tiles = kProbe ? 1 : tiles_of(last / p.G);  // the last slab reaches furthest

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kNW * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kNW) {  // producer: one thread starts every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kNW * 128) {
      mbar_expect_tx(q_full, (last - slab0 + 1) * C::kSlab);
      for (int j = slab0; j <= last; ++j) {
        const int ps = j / p.G, g = j - ps * p.G;
        for (int c = 0; c < HD / 32; ++c)
          tma_load(q_s + (j - slab0) * C::kSlab + c * kBlk, &tq, q_full, c * 32, ps * kM, g, kh, b);
      }
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % kStages;
        const uint32_t base = st_s + st * C::kStage;
        if (jt >= kStages) mbar_wait(empty(st), ((jt / kStages) & 1) ^ 1);  // jt - kStages released
        if (kCut == 5) {  // no tile copies: the stages are computed on as they stand
          mbar_arrive(k_full(st));
          mbar_arrive(v_full(st));
          continue;
        }
        mbar_expect_tx(k_full(st), 2 * C::kKHalf);
        for (int c = 0; c < HD / 32; ++c) {
          tma_load(base + c * kKBlk, &tk_hi, k_full(st), c * 32, jt * kN, bk);
          tma_load(base + C::kKHalf + c * kKBlk, &tk_lo, k_full(st), c * 32, jt * kN, bk);
        }
        mbar_expect_tx(v_full(st), 2 * C::kVHalf);
        tma_load(base + 2 * C::kKHalf, &tv_hi, v_full(st), jt * kN, 0, bk);
        tma_load(base + 2 * C::kKHalf + C::kVHalf, &tv_lo, v_full(st), jt * kN, 0, bk);
      }
    }
  } else {  // consumer warpgroup wg: slab slab0 + wg
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127, lane = t & 31;
    const int slab = slab0 + wg;
    const bool valid = slab <= last;
    const int ps = slab / p.G, g = slab - ps * p.G;
    const int my_tiles = valid ? (kProbe ? 1 : tiles_of(ps)) : 0;
    const int r0 = (t >> 5) * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int pos0 = ps * kM + r0, pos1 = pos0 + 8;
    const int c0 = 2 * (lane & 3);               // its first column in each group of 8
    uint8_t* const my_q = smem + wg * C::kSlab;
    const float sl = p.scale_log2;
    constexpr bool kProducts = kCut == 0 || kCut >= 3;
    constexpr bool kSoftmax = kCut == 0 || kCut >= 4;

    float o[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in raw score units

    // q split once a block: its TF32 hi as this thread's A fragments (k step
    // kk, element e: row r0 + 8(e & 1), column 8kk + l % 4 + 4(e >> 1)), its
    // lo written back over q in the slab, where the lo·hi pass reads it as a
    // shared-memory A operand. The fragments cover the slab once, so each
    // value is read and rewritten by one thread.
    uint32_t q_hi[HD / 8][4];
    if (valid) {
      mbar_wait(q_full, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* const x = reinterpret_cast<float*>(
              my_q + (kk >> 2) * kBlk +
              swizzled(r0 + 8 * (e & 1), 8 * (kk & 3) + (lane & 3) + 4 * (e >> 1)));
          float hi, lo;
          split(*x, hi, lo);
          q_hi[kk][e] = __float_as_uint(hi);
          *x = lo;
        }
      fence_proxy();  // the lo halves, written by threads, are read by wgmma
      bar_sync(kBarOwn + wg, 128);
    }

    // A tile: S (three passes), the online softmax on its fragment, P·V
    // (three passes). The two consumer warpgroups run unsynchronised, so one
    // takes its softmax while the other's products run.
    const uint32_t q_lo = q_s + wg * C::kSlab;
    auto stage_base = [&](int jt) { return st_s + (jt % kStages) * C::kStage; };
    float s[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
    uint32_t pa[kN / 8][2][4];
    // tile jt's scores in s become its weights, in base 2 against the new
    // running max; l takes them in and (a0, a1) is what O must be scaled by
    auto softmax = [&](int jt, float& a0, float& a1) {
      const int kv0 = jt * kN;
      float mx0 = kNegInf, mx1 = kNegInf;
      if (kv0 + kN > p.kv_lim || (p.causal && kv0 + kN - 1 > ps * kM)) {  // edge or diagonal
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int col = kv0 + 8 * (i >> 2) + c0 + (i & 1);
          if (col >= p.kv_lim || (p.causal && col > ((i & 2) ? pos1 : pos0))) s[i] = kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // weights are 2^(s·sl − m·sl); a row with nothing visible yet
      // subtracts 0, so its masked scores (−1e30) still weigh exactly 0
      const float ms0 = mn0 == kNegInf ? 0.f : mn0 * sl, ms1 = mn1 == kNegInf ? 0.f : mn1 * sl;
      a0 = ex2(fmaf(m0, sl, -ms0));
      a1 = ex2(fmaf(m1, sl, -ms1));
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        s[i] = ex2(fmaf(s[i], sl, (i & 2) ? -ms1 : -ms0));
        if (i & 2) sum1 += s[i]; else sum0 += s[i];
      }
      l0 = fmaf(l0, a0, sum0);  // this thread's columns; the quad's are summed at the end
      l1 = fmaf(l1, a1, sum1);
    };
    // P's halves as the A fragments of P·V: columns 2t, 2t + 1 of each group
    // of 8 are A columns t, t + 4 (vT holds kv in perm's order)
    auto split_p = [&]() {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float hi, lo;
          split(s[4 * j + ((e & 1) << 1) + (e >> 1)], hi, lo);
          pa[j][0][e] = __float_as_uint(hi);
          pa[j][1][e] = __float_as_uint(lo);
        }
    };

    for (int jt = 0; jt < n_tiles; ++jt) {
      const int st = jt % kStages;
      const uint32_t ph = (jt / kStages) & 1;
      mbar_wait(k_full(st), ph);
      if (jt < my_tiles && kProducts) {
        wg_fence();
        s_product<HD>(s, q_hi, q_lo, stage_base(jt), stage_base(jt) + C::kKHalf);
        wg_commit();
        wg_wait();
        fence_regs(s);
        if (kProbe) {  // the raw product, then P := S
#pragma unroll
          for (int i = 0; i < kN / 2; ++i)
            p.probe[(wg * kM + r0 + 8 * ((i >> 1) & 1)) * kN + 8 * (i >> 2) + c0 + (i & 1)] = s[i];
        } else if (kSoftmax) {
          float a0, a1;
          softmax(jt, a0, a1);
#pragma unroll
          for (int i = 0; i < HDV / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
        }
        split_p();
        mbar_wait(v_full(st), ph);
        const uint32_t v_hi = stage_base(jt) + 2 * C::kKHalf, v_lo = v_hi + C::kVHalf;
        wg_fence();
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {  // 8 kv positions = 32 bytes a k step
          mma_rs<HDV>(o, pa[j][0], desc(v_lo + j * 32), 1);  // hi·lo
          mma_rs<HDV>(o, pa[j][1], desc(v_hi + j * 32), 1);  // lo·hi
          mma_rs<HDV>(o, pa[j][0], desc(v_hi + j * 32), 1);  // hi·hi
        }
        wg_commit();
        wg_wait();
        fence_regs(o);
      } else if (jt < my_tiles) {  // FLASH_CUT=2: the copies alone
        mbar_wait(v_full(st), ph);
      }
      mbar_arrive(empty(st));  // after k_full: the arrival belongs to tile jt
    }
    if (kProbe) {
#pragma unroll
      for (int i = 0; i < HDV / 2; ++i)
        p.probe[p.n_slabs * kM * kN + (wg * kM + r0 + 8 * ((i >> 1) & 1)) * HDV + 8 * (i >> 2) +
                c0 + (i & 1)] = o[i];
    }

    if (valid && !kProbe) {  // O / l, float2 a thread and row: 32-byte sectors of a row
      const float ls0 = quad_sum(l0), ls1 = quad_sum(l1);
      const float inv0 = 1.f / fmaxf(ls0, 1e-30f);
      const float inv1 = 1.f / fmaxf(ls1, 1e-30f);
      if (kCut == 0 && p.lse != nullptr && (lane & 3) == 0) {
        const long long row0 = (((long long)b * p.S + pos0) * p.K + kh) * p.G + g;
        if (pos0 < p.S) p.lse[row0] = tc::lse_of(m0, ls0, sl);
        if (pos1 < p.S) p.lse[row0 + 8LL * p.K * p.G] = tc::lse_of(m1, ls1, sl);
      }
      if (kCut == 0 || kCut == 5) {
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pos = h ? pos1 : pos0;
            const float inv = h ? inv1 : inv0;
            if (pos < p.S)
              *reinterpret_cast<float2*>(
                  out + ((((long long)b * p.S + pos) * p.K + kh) * p.G + g) * HDV + 8 * j + c0) =
                  make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
          }
      } else if (o[0] * inv0 == 1234.5f) {  // probe cuts: keep the products alive
        out[0] = o[1];
      }
    }
  }
}

struct Maps {
  CUtensorMap q, k_hi, k_lo, v_hi, v_lo;
};

template <int HD, int HDV, bool kProbe>
cudaError_t launch(const Maps& m, float* out, Params p, cudaStream_t stream) {
  using C = Cfg<HD, HDV>;
  p.n_groups = kProbe ? 1 : (p.n_slabs + kNW - 1) / kNW;
  const long long blocks = kProbe ? 1 : (long long)p.n_groups * p.BK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tf32_kernel<HD, HDV, kProbe>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  flash_fwd_tf32_kernel<HD, HDV, kProbe><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      m.q, m.k_hi, m.k_lo, m.v_hi, m.v_lo, out, p);
  return cudaGetLastError();
}

template <bool kProbe>
cudaError_t by_dims(int hd, int hd_v, const Maps& m, float* out, const Params& p,
                    cudaStream_t stream) {
  if (hd == 128 && hd_v == 128) return launch<128, 128, kProbe>(m, out, p, stream);
  if (hd == 128 && hd_v == 64) return launch<128, 64, kProbe>(m, out, p, stream);
  if (hd == 64 && hd_v == 128) return launch<64, 128, kProbe>(m, out, p, stream);
  if (hd == 64 && hd_v == 64) return launch<64, 64, kProbe>(m, out, p, stream);
  return cudaErrorInvalidValue;
}

struct Call {
  const float *q, *k, *v;
  float *out, *scratch, *probe, *lse;
  int B, S, T, K, G, hd, hd_v, kv_len, causal;
  float scale;
  long long q_sb, q_ss, q_sk, q_sg, k_sb, k_st, k_sk, v_sb, v_st, v_sk;
};

// Pre-pass, tensor maps, main kernel.
template <bool kProbe>
int run(const Call& c, cudaStream_t st) {
  const bool dims_ok = (c.hd == 64 || c.hd == 128) && (c.hd_v == 64 || c.hd_v == 128);
  if (!dims_ok || c.G < 1 || c.K < 1 || c.B < 0 || c.S < 0 || c.T < 0) return cudaErrorInvalidValue;
  if (c.B == 0 || c.S == 0) return cudaSuccess;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return tc::kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const int BK = c.B * c.K;
  const int kv_lim = imax(0, imin(c.kv_len, c.T));
  const int Tp = padded_t(kv_lim);
  float* const k_hi = c.scratch;
  float* const k_lo = k_hi + (size_t)BK * Tp * c.hd;
  float* const v_hi = k_lo + (size_t)BK * Tp * c.hd;
  float* const v_lo = v_hi + (size_t)BK * c.hd_v * Tp;
  if (kv_lim > 0) {
    split_k<<<dim3((Tp * (c.hd / 4) + 255) / 256, BK), 256, 0, st>>>(
        c.k, k_hi, k_lo, c.K, c.hd, kv_lim, Tp, c.k_sb, c.k_st, c.k_sk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    split_vt<<<dim3(Tp / 32, c.hd_v / 32, BK), 256, 0, st>>>(
        c.v, v_hi, v_lo, c.K, c.hd_v, kv_lim, Tp, c.v_sb, c.v_st, c.v_sk);
    e = cudaGetLastError();
    if (e != cudaSuccess || kCut == 1) return e;
  }
  Params p;
  p.S = c.S; p.K = c.K; p.G = c.G; p.BK = BK;
  p.kv_lim = kv_lim;
  p.causal = c.causal;
  p.n_slabs = (c.S + kM - 1) / kM * c.G;
  p.n_groups = 0;  // set per instantiation
  p.scale_log2 = static_cast<float>(static_cast<double>(c.scale) * 1.4426950408889634);
  p.probe = c.probe;
  p.lse = c.lse;
  const cuuint64_t q_dims[5] = {(cuuint64_t)c.hd, (cuuint64_t)c.S, (cuuint64_t)c.G,
                                (cuuint64_t)c.K, (cuuint64_t)c.B};
  const cuuint64_t q_str[4] = {(cuuint64_t)c.q_ss * 4, (cuuint64_t)c.q_sg * 4,
                               (cuuint64_t)c.q_sk * 4, (cuuint64_t)c.q_sb * 4};
  const cuuint32_t q_box[5] = {32, kM, 1, 1, 1};
  const cuuint64_t k_dims[3] = {(cuuint64_t)c.hd, (cuuint64_t)Tp, (cuuint64_t)BK};
  const cuuint64_t k_str[2] = {(cuuint64_t)c.hd * 4, (cuuint64_t)Tp * c.hd * 4};
  const cuuint32_t k_box[3] = {32, kN, 1};
  const cuuint64_t v_dims[3] = {(cuuint64_t)Tp, (cuuint64_t)c.hd_v, (cuuint64_t)BK};
  const cuuint64_t v_str[2] = {(cuuint64_t)Tp * 4, (cuuint64_t)c.hd_v * Tp * 4};
  const cuuint32_t v_box[3] = {kN, (cuuint32_t)c.hd_v, 1};
  Maps m;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUresult r = tc::encode(enc, &m.q, kF32, c.q, 5, q_dims, q_str, q_box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.k_hi, kF32, k_hi, 3, k_dims, k_str, k_box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.k_lo, kF32, k_lo, 3, k_dims, k_str, k_box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.v_hi, kF32, v_hi, 3, v_dims, v_str, v_box);
  if (r == CUDA_SUCCESS) r = tc::encode(enc, &m.v_lo, kF32, v_lo, 3, v_dims, v_str, v_box);
  if (r != CUDA_SUCCESS) return tc::kTensorMapError + (int)r;
  return by_dims<kProbe>(c.hd, c.hd_v, m, c.out, p, st);
}

}  // namespace tf

// Floats of scratch flash_attention_fwd_tf32x3 needs: k's TF32 halves (B·K,
// Tp, hd) and vᵀ's (B·K, hd_v, Tp), Tp = min(kv_len, T) rounded up to 32
// (at least 32).
extern "C" long long flash_tf32x3_scratch_floats(int B, int T, int K, int hd, int hd_v,
                                                 int kv_len) {
  const long long tp = tf::padded_t(imax(0, imin(kv_len, T)));
  return (long long)B * K * tp * 2 * (hd + hd_v);
}

// float32 only. hd, hd_v in {64, 128}; every base 16-byte aligned and every
// stride of q of an axis longer than 1 a multiple of 4 elements (the
// wrapper's route rule, which holds k and v to it as well). Strides are in
// elements. scratch: flash_tf32x3_scratch_floats floats. Returns a
// cudaError_t, or 100000 + the CUresult of a tensor map that would not
// encode.
extern "C" int flash_attention_fwd_tf32x3(int device, const void* q, const void* k, const void* v,
                                          void* out, void* lse, void* scratch, int B, int S, int T, int K,
                                          int G, int hd, int hd_v, int kv_len, int causal,
                                          float scale, long long q_sb, long long q_ss,
                                          long long q_sk, long long q_sg, long long k_sb,
                                          long long k_st, long long k_sk, long long v_sb,
                                          long long v_st, long long v_sk, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const tf::Call c{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out),
                   static_cast<float*>(scratch), nullptr, static_cast<float*>(lse), B, S, T, K, G,
                   hd, hd_v, kv_len, causal,
                   scale, q_sb, q_ss, q_sk, q_sg, k_sb, k_st, k_sk, v_sb, v_st, v_sk};
  return tf::run<false>(c, static_cast<cudaStream_t>(stream));
}

// The probe's first check: one block's first tile through the float32
// route's pre-pass, copies and products, nothing masked, no softmax. q (1,
// 64, 1, G, hd), k (1, 32, 1, hd), v (1, 32, 1, hd_v) contiguous, G in 1..3
// (one slab a consumer warpgroup); probe receives the raw q·kᵀ of each slab
// (G, 64, 32), then S·v (G, 64, hd_v) with S through the TF32 split as P is.
extern "C" int flash_tf32x3_probe(int device, const void* q, const void* k, const void* v,
                                  void* scratch, void* probe, int G, int hd, int hd_v,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (G < 1 || G > tf::kNW) return cudaErrorInvalidValue;
  const long long s_row = (long long)G * hd, kv_row = hd, v_row = hd_v;
  const tf::Call c{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), nullptr, static_cast<float*>(scratch),
                   static_cast<float*>(probe), nullptr, 1, tf::kM, tf::kN, 1, G, hd, hd_v, tf::kN, 0, 1.f,
                   tf::kM * s_row, s_row, s_row, hd, tf::kN * kv_row, kv_row, kv_row,
                   tf::kN * v_row, v_row, v_row};
  return tf::run<true>(c, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int e) {
  if (e >= tc::kTensorMapError) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             e - tc::kTensorMapError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
