// IMG mixture log-weights, paper Eq. 3.5: two routes of one kernel.
//
// Replaces the TPU kernel src/repro/kernels/img_weights/kernel.py:54
// (img_log_weights_kernel, body _img_weights_kernel at :33, wrapper ops.py:27),
// and on the IMG engine's kernel-mode sweep also the site recursion around it
// (src/repro/core/combiners/img.py:227, _img_kernel_sweep).
//
// Route "generic", img_log_weights_f32: P candidate components,
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
//
// Route "sweep", img_sweep_f32: one whole kernel-mode IMG sweep of B index
// chains (Algorithm 1 lines 4-11 with every site's proposal drawn up front).
// One block per chain b:
//   1. copies the chain's state theta_sel[b] (M x d), its mean and its M
//      candidate rows samples[m, c[b, m]] into shared memory with cp.async
//      (the gather happens here: no (B, M, d) candidate tensor and no
//      (B*M, M, d) stack of single-site states exists in device memory);
//      for W_t a second copy group brings the factor L transposed;
//   2. scores every single-site state "row m replaced by candidate m" with
//      the generic route's arithmetic (Eq. 3.5, two-pass centred SSE over
//      rows read from shared memory, the same lane order, the same
//      normalizer): LW_m, one warp per site;
//   3. forms the sweep's scalars from the same tiles: nsq_m = |cand_m|^2 -
//      |theta_m|^2, b_m = mean . Delta_m and the Gram Delta_j . Delta_m
//      (M x M in shared memory, one thread an entry), Delta_m = cand_m -
//      theta_m;
//   4. for W_t (the semiparametric state term log N(mean | mu_M, Sigma_M +
//      h^2/M I), one Cholesky factor L a sweep since h is one scalar): M + 1
//      forward substitutions, one per warp, y_0 = L^-1 (mean - mu_M) and
//      y_m = L^-1 Delta_m, and their Gram. A site's candidate mean is
//      mean + (S + Delta_m)/M with S the accepted deltas' sum, so by
//      linearity its solve is u + y_m / M with u = y_0 + (sum_accepted y_j)
//      / M, and its square |u|^2 + 2 u.y_m / M + |y_m|^2 / M^2 comes from
//      the Gram in O(1) a site. This differs from a fresh solve of the
//      candidate mean, squared, in rounding only;
//   5. runs the site recursion m = 0..M-1 on one warp (every lane holds the
//      same scalars: g, acc_nsq, s_b, s_g, lw_cur, and for W_t |u|^2 and
//      u.y_m), the exact rank-one correction of the engine's docstring, in
//      the plain version's order of operations, accepting where
//      log u[b, m] < lw_prop - lw_cur;
//   6. writes the new carry (t_idx, theta_sel with the accepted rows, mean,
//      sumsq, extra, n_accept) and, per site, LW_m, lw_prop - lw_cur and the
//      accept flag.
// Bound: latency. At B=16, M=10, d=50 the sweep moves ~120 KB (~0.04 us at
// 3.35 TB/s) and does ~1 MFLOP; its floor is the launch, the copy-in
// latency and the serial chain of M sites (and, for W_t, the d-step
// triangular solves), all inside one block per chain. So every phase but
// those two chains is spread over the block's threads, and the chains keep
// their steps short: the solves divide by nothing (the diagonal's
// reciprocals are formed once) and take y_i from a register by a shuffle;
// the sites read only scalars. Nothing is atomic: a fixed input gives the
// same bits on every launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// IMG_CUT is 0 in the port. A probe (python -m repro_torch.launch.img_probe)
// builds copies that leave the sweep kernel after one of its phases, to time
// each: 1 at entry (an empty launch of the grid), 2 after the copies in, 3
// after the single-site weights, 4 after the Gram, 5 after the triangular
// solves. A copy with IMG_CUT set writes no results.
#ifndef IMG_CUT
#define IMG_CUT 0
#endif
#define IMG_LEAVE_AFTER(phase)                               \
  if constexpr (IMG_CUT == (phase)) {                        \
    asm volatile("cp.async.wait_all;\n" ::: "memory");      \
    return;                                                  \
  }

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSweepWarps = 16;
constexpr int kSweepThreads = kSweepWarps * 32;
constexpr size_t kMaxSmem = 232448;       // what one H100 block may take
constexpr size_t kDefaultSmem = 48 * 1024;  // above it only by opt-in
constexpr float kTwoPi = 2.f * 3.14159265358979f;
constexpr double kLog2Pi = 1.8378770664093453;
// most rows a lane holds in a triangular solve: d <= 256 (the shared-memory
// limit keeps a W_t chain below d = 240)
constexpr int kSolveSlots = 8;

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
    const float log_norm = (float)M * ((float)d / 2.f) * logf(kTwoPi * hh);
    out[p] = -0.5f * sse / hh - log_norm;
  }
}

// ---------------------------------------------------------------------------
// the sweep route
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Shared memory of one block, in floats: the state and the candidates
// (2*M*d), the mean (d), the Gram (M*M), seven per-site vectors (7*M) and, for
// W_t, L transposed (d*d), the reciprocals of its diagonal (d), the M + 1
// solves ((M+1)*d), their Gram ((M+1)^2) and one more per-site vector (M).
// Offsets are in floats from the start.
struct Layout {
  long long th, cd, mn, gram, lw, nsq, bd, daux, gacc, flag, lu, lt, rdg, y, yg, uy, total;
};

__host__ __device__ inline Layout sweep_layout(long long M, long long d, int wt) {
  Layout s;
  long long o = 0;
  s.th = o; o += M * d;
  s.cd = o; o += M * d;
  s.mn = o; o += d;
  s.gram = o; o += M * M;
  s.lw = o; o += M;
  s.nsq = o; o += M;
  s.bd = o; o += M;
  s.daux = o; o += M;
  s.gacc = o; o += M;
  s.flag = o; o += M;
  s.lu = o; o += M;
  s.lt = o; o += wt ? d * d : 0;
  s.rdg = o; o += wt ? d : 0;
  s.y = o; o += wt ? (M + 1) * d : 0;
  s.yg = o; o += wt ? (M + 1) * (M + 1) : 0;
  s.uy = o; o += wt ? M : 0;
  s.total = o;
  return s;
}

struct SweepArgs {
  const float* samples; long long s_m, s_t;  // (M, T, d), last axis contiguous
  const long long* t_idx;                    // (B, M)
  const float* theta_sel;                    // (B, M, d)
  const float* mean;                         // (B, d)
  const float* sumsq;                        // (B,)
  const float* extra;                        // (B,)
  const float* n_accept;                     // (B,)
  const long long* c;                        // (B, M) index proposals
  const float* u;                            // (B, M) uniforms
  const float* h_ptr; float h_val;           // h on the device, or by value when h_ptr is null
  const float* aux; long long aux_s;         // (M, T) rows aux_s apart, or null (W_t only)
  const float* L; long long l_s0, l_s1;      // (d, d) lower factor, any strides (W_t only)
  const float* logdet;                       // one float (W_t only)
  const float* mu;                           // (d,) (W_t only)
  long long* t_out;                          // (B, M)
  float* theta_out;                          // (B, M, d)
  float* mean_out;                           // (B, d)
  float* sumsq_out;                          // (B,)
  float* extra_out;                          // (B,)
  float* nacc_out;                           // (B,)
  float* lw_out;                             // (B, M) LW_m
  float* ratio_out;                          // (B, M) lw_prop - lw_cur at site m
  unsigned char* acc_out;                    // (B, M) accept flags
  int M, d, wt;
};

// SLOTS = ceil(d / 32) rows a lane holds in a triangular solve (1 for w_t)
template <int SLOTS>
__global__ void __launch_bounds__(kSweepThreads) img_sweep_kernel(const SweepArgs a) {
  extern __shared__ float sm[];
  const int M = a.M, d = a.d, wt = a.wt;
  const Layout lay = sweep_layout(M, d, wt);
  float* th = sm + lay.th;      // theta_sel[b], M x d
  float* cd = sm + lay.cd;      // candidates, M x d
  float* mn = sm + lay.mn;      // mean[b]
  float* gram = sm + lay.gram;  // Delta_j . Delta_m
  float* lw = sm + lay.lw;      // LW_m
  float* nsq = sm + lay.nsq;
  float* bd = sm + lay.bd;      // mean . Delta_m
  float* daux = sm + lay.daux;  // aux[m, c] - aux[m, t_idx]
  float* gacc = sm + lay.gacc;  // g = sum over accepted j of Gram row j
  float* flag = sm + lay.flag;  // 1 accepted, 0 not
  float* lu = sm + lay.lu;      // log u[b, m]
  float* lt = sm + lay.lt;      // lt[i*d + k] = L[k][i]
  float* rdg = sm + lay.rdg;    // 1 / L[i][i]
  float* Y = sm + lay.y;        // row 0: y_0, row 1 + m: y_m
  float* yg = sm + lay.yg;      // y_p . y_q, (M+1) x (M+1)
  float* uy = sm + lay.uy;      // u . y_m, u = y_0 + (sum over accepted j of y_j) / M

  IMG_LEAVE_AFTER(1)
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Md = M * d;
  const size_t bM = (size_t)b * M;
  // the block's scalars, loaded while the copies below are in flight
  const float h = a.h_ptr != nullptr ? a.h_ptr[0] : a.h_val;
  const float sumsq0 = a.sumsq[b], extra0 = a.extra[b], nacc0 = a.n_accept[b];
  const float logdet = wt ? a.logdet[0] : 0.f;

  // copy group 0: the chain's state, its candidates and its mean
  const float* ts = a.theta_sel + (size_t)b * Md;
  for (int i = tid; i < Md; i += kSweepThreads) {
    const int m = i / d, k = i - m * d;
    cp_async4(th + i, ts + i);
    cp_async4(cd + i, a.samples + m * a.s_m + a.c[bM + m] * a.s_t + k);
  }
  for (int k = tid; k < d; k += kSweepThreads) cp_async4(mn + k, a.mean + (size_t)b * d + k);
  cp_async_commit();
  // copy group 1 (W_t): L transposed, so a solve's lanes read along a row
  if (wt) {
    for (int i = tid; i < d * d; i += kSweepThreads) {
      const int col = i / d, row = i - col * d;
      cp_async4(lt + i, a.L + row * a.l_s0 + col * a.l_s1);
    }
  }
  cp_async_commit();
  for (int m = tid; m < M; m += kSweepThreads) {
    gacc[m] = 0.f;
    lu[m] = logf(a.u[bM + m]);
    daux[m] = a.aux != nullptr
                  ? a.aux[m * a.aux_s + a.c[bM + m]] - a.aux[m * a.aux_s + a.t_idx[bM + m]]
                  : 0.f;
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  IMG_LEAVE_AFTER(2)

  const float hh = h * h;
  const float log_norm = (float)M * ((float)d / 2.f) * logf(kTwoPi * hh);

  // LW_m, nsq_m and b_m: one warp a site, the generic route's lane order
  for (int m = warp; m < M; m += kSweepWarps) {
    float sse = 0.f, ncand = 0.f, nth = 0.f, bdot = 0.f;
    for (int k = lane; k < d; k += 32) {
      float sum = 0.f;
#pragma unroll 4
      for (int j = 0; j < M; ++j) sum += (j == m ? cd : th)[j * d + k];
      const float mean = sum / (float)M;
#pragma unroll 4
      for (int j = 0; j < M; ++j) {
        const float dv = (j == m ? cd : th)[j * d + k] - mean;
        sse += dv * dv;
      }
      const float cv = cd[m * d + k], tv = th[m * d + k];
      ncand += cv * cv;
      nth += tv * tv;
      bdot += mn[k] * (cv - tv);
    }
    sse = warp_sum(sse);
    ncand = warp_sum(ncand);
    nth = warp_sum(nth);
    bdot = warp_sum(bdot);
    if (lane == 0) {
      lw[m] = -0.5f * sse / hh - log_norm;
      nsq[m] = ncand - nth;
      bd[m] = bdot;
    }
  }
  IMG_LEAVE_AFTER(3)
  // the Gram of the deltas: one thread an entry of its upper triangle, its
  // products summed over k in order (no shuffles on the way)
  for (int p = tid; p < M * (M + 1) / 2; p += kSweepThreads) {
    int j = 0, r = p;
    while (r >= M - j) r -= M - j++;
    const int m = j + r;
    const float* cj = cd + j * d;
    const float* tj = th + j * d;
    const float* cm = cd + m * d;
    const float* tm = th + m * d;
    float s = 0.f;
#pragma unroll 4
    for (int k = 0; k < d; ++k) s += (cj[k] - tj[k]) * (cm[k] - tm[k]);
    gram[j * M + m] = gram[m * M + j] = s;
  }
  IMG_LEAVE_AFTER(4)
  if (wt) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // L has landed in every thread's copies
    for (int i = tid; i < d; i += kSweepThreads) rdg[i] = 1.f / lt[i * d + i];
    __syncthreads();
    // y_0 = L^-1 (mean - mu), y_m = L^-1 Delta_m: one warp a right-hand
    // side, forward substitution by columns in registers. Lane l holds rows
    // l, l + 32, ... (slot s: row 32 s + l); step i takes y_i from its
    // owner's slot by a shuffle, scales it by 1 / L_ii, and every lane takes
    // L_ki y_i off its rows k > i.
    for (int p = warp; p <= M; p += kSweepWarps) {
      float yr[SLOTS];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int k = s * 32 + lane;
        yr[s] = k >= d ? 0.f
                : p == 0 ? mn[k] - a.mu[k] : cd[(p - 1) * d + k] - th[(p - 1) * d + k];
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int rows = min(32, d - s * 32);
        const int ks = min(s * 32 + lane, d - 1);  // this lane's row in slot s
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const int i = s * 32 + r;
          const float yi = __shfl_sync(0xffffffffu, yr[s], r) * rdg[i];
          const float* col = lt + (size_t)i * d;
          // selects, not branches: the warp never splits on the chain
          const float taken = yr[s] - col[ks] * yi;
          yr[s] = lane == r ? yi : (lane > r && lane < rows ? taken : yr[s]);
#pragma unroll
          for (int t = s + 1; t < SLOTS; ++t) {
            const int k = t * 32 + lane;
            if (k < d) yr[t] = yr[t] - col[k] * yi;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int k = s * 32 + lane;
        if (k < d) Y[(size_t)p * d + k] = yr[s];
      }
    }
    __syncthreads();
    IMG_LEAVE_AFTER(5)
    // the Gram of the solves, one thread an entry of its upper triangle
    for (int p = tid; p < (M + 1) * (M + 2) / 2; p += kSweepThreads) {
      int j = 0, r = p;
      while (r >= M + 1 - j) r -= M + 1 - j++;
      const int q = j + r;
      float s = 0.f;
#pragma unroll 4
      for (int k = 0; k < d; ++k) s += Y[j * d + k] * Y[q * d + k];
      yg[j * (M + 1) + q] = yg[q * (M + 1) + j] = s;
    }
  }
  __syncthreads();

  // The site recursion, on warp 0; every lane holds the same scalars. For
  // W_t the candidate mean's solve is u + y_m / M with u = y_0 + (sum over
  // accepted j of y_j) / M, so its square is |u|^2 + 2 (u . y_m) / M +
  // |y_m|^2 / M^2: the recursion carries |u|^2 and u . y_m for every site,
  // from the solves' Gram, as it carries g for the w_t terms (O(1) a site,
  // rounding apart from squaring u + y_m / M itself).
  if (warp == 0) {
    const float inv2h2 = 0.5f / hh;
    const float fM = (float)M;
    float msq = 0.f;
    for (int k = lane; k < d; k += 32) msq += mn[k] * mn[k];
    msq = warp_sum(msq);
    float lw_cur = -(sumsq0 - fM * msq) * inv2h2 - log_norm;
    // the state term -(quad + logdet + d log 2pi)/2 + extra, summed in the
    // plain version's order
    const float d_log2pi = (float)((double)d * kLog2Pi);
    const int M1 = M + 1;
    float uu = 0.f;  // |u|^2
    if (wt) {
      for (int j = lane; j < M; j += 32) uy[j] = yg[j + 1];
      uu = yg[0];
      lw_cur = lw_cur + (-0.5f * (uu + logdet + d_log2pi) + extra0);
      __syncwarp();
    }
    float acc_nsq = 0.f, s_b = 0.f, s_g = 0.f, acc_aux = 0.f, nacc = 0.f;
    for (int m = 0; m < M; ++m) {
      const float g_m = gacc[m];
      const float corr = -(acc_nsq - 2.f * s_b - (s_g + 2.f * g_m) / fM) * inv2h2;
      float lw_prop = lw[m] + corr;
      float q = 0.f;
      if (wt) {
        q = uu + 2.f * uy[m] / fM + yg[(m + 1) * M1 + m + 1] / (fM * fM);
        const float extra_m = extra0 + acc_aux + daux[m];
        lw_prop = lw_prop + (-0.5f * (q + logdet + d_log2pi) + extra_m);
      }
      const float ratio = lw_prop - lw_cur;
      const bool accept = lu[m] < ratio;
      const float af = accept ? 1.f : 0.f;
      lw_cur = accept ? lw_prop : lw_cur;
      acc_nsq = acc_nsq + af * nsq[m];
      s_b = s_b + af * bd[m];
      s_g = s_g + af * (2.f * g_m + gram[m * M + m]);
      for (int j = lane; j < M; j += 32) gacc[j] = gacc[j] + af * gram[m * M + j];
      if (wt && accept) {  // u moves by y_m / M
        uu = q;
        for (int j = lane; j < M; j += 32) uy[j] = uy[j] + yg[(m + 1) * M1 + j + 1] / fM;
      }
      acc_aux = acc_aux + af * daux[m];
      nacc = nacc + af;
      if (lane == 0) {
        flag[m] = af;
        a.lw_out[bM + m] = lw[m];
        a.ratio_out[bM + m] = ratio;
        a.acc_out[bM + m] = accept ? 1 : 0;
      }
      __syncwarp();
    }
    if (lane == 0) {
      a.sumsq_out[b] = sumsq0 + acc_nsq;
      a.extra_out[b] = wt ? extra0 + acc_aux : extra0;
      a.nacc_out[b] = nacc0 + nacc;
    }
  }
  __syncthreads();

  // the new carry: accepted rows and indices, the mean moved by their deltas
  for (int i = tid; i < Md; i += kSweepThreads)
    a.theta_out[(size_t)b * Md + i] = flag[i / d] != 0.f ? cd[i] : th[i];
  for (int k = tid; k < d; k += kSweepThreads) {
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc = acc + flag[m] * (cd[m * d + k] - th[m * d + k]);
    a.mean_out[(size_t)b * d + k] = mn[k] + acc / (float)M;
  }
  for (int m = tid; m < M; m += kSweepThreads)
    a.t_out[bM + m] = flag[m] != 0.f ? a.c[bM + m] : a.t_idx[bM + m];
}

template <int SLOTS>
cudaError_t launch_sweep(const SweepArgs& a, int B, long long smem, cudaStream_t s) {
  if ((size_t)smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(img_sweep_kernel<SLOTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  img_sweep_kernel<SLOTS><<<B, kSweepThreads, smem, s>>>(a);
  return cudaGetLastError();
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

// Dynamic shared memory of one sweep block, in bytes; 0 when it exceeds what
// one block can hold.
extern "C" long long img_sweep_smem_bytes(int M, int d, int wt) {
  if (M < 1 || d < 1) return 0;
  const size_t bytes = (size_t)sweep_layout(M, d, wt).total * sizeof(float);
  return bytes > kMaxSmem ? 0 : (long long)bytes;
}

// One sweep of B chains; W_t when L is not null (then aux, logdet and mu too).
extern "C" int img_sweep_f32(
    int device, const float* samples, long long s_m, long long s_t, const long long* t_idx,
    const float* theta_sel, const float* mean, const float* sumsq, const float* extra,
    const float* n_accept, const long long* c, const float* u, const float* h_ptr, float h_val,
    const float* aux, long long aux_s, const float* L, long long l_s0, long long l_s1,
    const float* logdet, const float* mu, long long* t_out, float* theta_out, float* mean_out,
    float* sumsq_out, float* extra_out, float* nacc_out, float* lw_out, float* ratio_out,
    unsigned char* acc_out, int B, int M, int d, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int wt = L != nullptr;
  const long long smem = img_sweep_smem_bytes(M, d, wt);
  if (smem == 0 || B < 1 || (wt && d > 32 * kSolveSlots)) return cudaErrorInvalidValue;
  const SweepArgs a{samples, s_m, s_t, t_idx, theta_sel, mean, sumsq, extra, n_accept, c, u,
                    h_ptr, h_val, aux, aux_s, L, l_s0, l_s1, logdet, mu, t_out, theta_out,
                    mean_out, sumsq_out, extra_out, nacc_out, lw_out, ratio_out, acc_out,
                    M, d, wt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wt ? (d + 31) / 32 : 1) {
    case 1: return launch_sweep<1>(a, B, smem, s);
    case 2: return launch_sweep<2>(a, B, smem, s);
    case 3: return launch_sweep<3>(a, B, smem, s);
    case 4: return launch_sweep<4>(a, B, smem, s);
    case 5: return launch_sweep<5>(a, B, smem, s);
    case 6: return launch_sweep<6>(a, B, smem, s);
    case 7: return launch_sweep<7>(a, B, smem, s);
    default: return launch_sweep<8>(a, B, smem, s);
  }
}

extern "C" const char* img_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
