// GQA flash-attention forward: softmax(q·kᵀ·hd^-½, masked)·v with an online
// softmax over kv tiles, one launch per attention call.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:113
// (flash_attention_fwd_kernel, pallas_call at :135, body _flash_fwd_kernel
// at :39, wrapper ops.py:22).
//
// Operands: q (B, S, K, G, hd), k (B, T, K, hd), v (B, T, K, hd_v), read in
// place through their strides (the last axis contiguous; no transposes, no
// padding copies), float32 or bfloat16; out (B, S, K, G, hd_v) contiguous in
// the same type. hd, hd_v <= 256, G <= 64. Statistics and accumulators are
// float32. Query position s sees kv position t when t < kv_len and, if
// causal, s >= t (no offset). Masked scores are -1e30 and get weight exactly
// 0, so a row with no visible position gives 0 (its denominator, 0, is
// clamped at 1e-30) and no NaN.
//
// Bound on an H100: at the serving path's shape (B=2, K=8, G=3,
// S=T=4096, hd=hd_v=128, causal, bf16) the causal work is
// 2·B·K·G·S·T·hd = 2.06e11 flop against 0.13 GB of operands, so it is
// bound by operations: 0.21 ms on the bf16 tensor cores, 3.1 ms at the
// 67 TFLOP/s float32 rate of this kernel, which does its arithmetic in
// float32 FMAs outside the tensor cores (wgmma tiles are later work).
//
// Design. The TPU kernel runs one sequential grid step per (q tile, kv
// tile) with its (m, l, acc) in VMEM scratch; here a loop inside the block
// walks the kv tiles. A block owns one (b, kv head) pair and 64 rows, each
// row a (query position, head) pair: floor(64 / G) query positions times
// all G heads of the group, so every K/V tile staged in shared memory
// serves G heads (the TPU kernel's GQA grouping). 256 threads as 16 x 16:
// a thread owns 4 consecutive rows and the kv columns tx + 16j (j < 4) of
// each tile for q·kᵀ, and the same 4 rows times columns c·64 + 4tx + j of
// the output for P·v, so its rows' softmax statistics and accumulators
// live in its registers (4·hd_v/16 accumulators; hd is never held in
// registers: q stays in shared memory). Per kv tile of 64:
//   1. stage K and V (float32, zero beyond the valid rows and columns);
//   2. scores: float4 reads of q and k rows, 64 FMAs per 8 float4 reads;
//   3. online softmax per row, row max and sum over the 16 lanes of the
//      row (xor butterflies: every lane gets the same bits);
//   4. P into the K tile's shared memory, then acc += P·V.
// Causal tiles wholly above the block's last query position, and tiles at
// or beyond kv_len, are never visited; blocks are scheduled longest first.
// Shared memory: q (64 x hd), one K-or-P tile and a V tile, float32, row
// strides padded so that float4 reads of 8 rows hit distinct banks: 100 KB
// at hd = hd_v = 128 (two blocks per SM). Registers (ptxas, sm_90a): 128
// at hd_v <= 128 (capped by the two-blocks launch bound), 150 and 164 at
// hd_v <= 192 and 256; no spills. No float atomics: a fixed input gives the
// same bits on every run. On an H100 SXM (700 W) the serving path's shape
// takes 7.96 ms, 39 % of the float32 rate (chip_smoke.py phase 5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 (tx: kv columns) x 16 (ty: rows)
constexpr int kRows = 64;       // (query position, head) rows per block
constexpr int kBK = 64;         // kv positions per tile
constexpr int kRP = kRows + 4;  // row stride of the P tile (floats), /4 odd
constexpr float kNegInf = -1e30f;

// Row stride (floats) of a staged (rows, d) tile: d rounded up to 4, padded
// so that stride / 4 is odd (float4 reads of 8 consecutive rows are then
// conflict-free).
__host__ __device__ inline int padded_stride(int d) {
  const int d4 = (d + 3) / 4 * 4;
  return ((d4 / 4) % 2 == 0) ? d4 + 4 : d4;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

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

struct Params {
  int S, K, G, hd, hd_v, kv_lim, causal, bq, n_qtiles, vec;
  float scale;
  long long q_sb, q_ss, q_sk, q_sg, k_sb, k_st, k_sk, v_sb, v_st, v_sk;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
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
    const long long base =
        ((((long long)b * p.S + q0 + qi) * p.K + kh) * G + (r - qi * G)) * p.hd_v;
    const float denom = fmaxf(l[i], 1e-30f);
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
                                   const void* v, void* out, int B, int S, int T, int K, int G,
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, p, B * K, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, out, p, B * K, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
