// Fused Welford/Chan-merge update of streaming moments, all M machines in one launch.
//
// Replaces the TPU kernel src/repro/kernels/online_update/kernel.py:69
// (online_update_kernel, body _online_update_body at :36, wrapper ops.py:36):
// one grid step a machine with the whole (C, d) tile and the (d, d) state in
// VMEM, a masked mean, the centred Gram as one MXU product and Chan's merge.
//
// Per machine m, with chunk x (C, d), valid rows r < nv = min(max(cc, 0), C),
// cc the machine's chunk count (C when no counts are given), n_b = cc:
//
//   mean_b = sum_{r<nv} x[r] / max(n_b, 1)
//   m2_b   = sum_{r<nv} (x[r] - mean_b)(x[r] - mean_b)^T
//   n      = n_a + n_b,  delta = mean_b - mean
//   mean'  = mean + delta * n_b / max(n, 1)
//   m2'    = (m2 + m2_b) + delta delta^T * n_a n_b / max(n, 1)
//
// and count' = n. A machine with n_b <= 0 gets its mean and m2 back as they
// were, bit for bit. Rows at or beyond nv are never read, so NaN there stays
// out. Operands: chunk (M, C, d) with contiguous rows and machine m starting
// at m * stride_m (a (M, C, d) slice of a longer (M, T, d) draw buffer needs
// no copy), count (M,), mean (M, d), m2 (M, d, d), all float32, the last three
// contiguous; chunk_counts (M,) int32 or null. Outputs are separate buffers.
//
// Bound on an H100: at the streaming path's fold (M=10, C=120, d=50) the
// kernel moves 444 KB (0.133 us at 3.35 TB/s) and does 3.3 MFLOP (the Gram's
// upper triangle, M*C*d*(d+1), with the mean, the centring and the merge:
// 0.05 us of the float32 FMA pipes), so one memory round trip and the launch
// are the floor; the launch floor is timed as `online_update_probe` cut 0, an
// empty body on the same grid. No tensor cores: the products are 0.05 us of
// FMAs across the card, and a block's share of them is under 1 us here.
//
// The first design (a block per 32x32 tile of m2) spent its time in serial
// memory round trips: each thread summed 30 rows of a column straight from
// L2 (a dynamic trip count, few loads in flight), then the Gram read the
// chunk from L2 again in four slabs of 32 rows, a round trip and two
// barriers each, and only then m2 and mean came in; every block repeated
// the column sums of its 64 columns, and tile (1,0) repeated (0,1)'s
// products. This design issues every load of a block at once and then works
// from shared memory only, one block per upper-triangle 16x16 tile of m2 per
// machine (100 blocks at the path's fold, so the Gram is spread over 100
// SMs; the probe measured 32x32 tiles, 30 blocks, and one block a machine
// slower):
//
//   whole route (a machine's valid rows fit the block's shared memory,
//   kWholeBudget bytes at most): the block issues at once the cp.async
//   copies of the span of nv*d floats (contiguous: rows are), then of its
//   tile's m2 and old means, and waits for the first group only (the second
//   before the merge); the span's aligned body goes by 16-byte copies, its
//   head and tail (at most three floats each) by 4-byte ones, the span
//   placed in shared memory at the same offset from a 16-byte boundary as in
//   device memory, which each machine decides for itself, the branch uniform
//   in the block. It sums the tile's columns in a fixed order (kParts
//   partial sums, rows r = p mod kParts, combined in a fixed tree), so every
//   block that needs a column gets the same bits from its own copy, and
//   centres those columns in place.
//
//   slab route (otherwise): the block streams its tile's 32 columns of
//   kSlabRows rows at a time through a two-stage cp.async ring, one pass for
//   the column sums and one for the Gram (a chunk of one slab is copied
//   once), in 77,568 bytes whatever C and d are, two blocks an SM. Where d
//   is large the tiles are many (1,900 blocks at d = 300, C = 120) and this
//   route is slower than the first design there (31 against 28 us on an
//   H100, graph-timed); three or four blocks an SM did not help, and the
//   copies take half the time (online_probe's cuts), so a larger tile where
//   d is large is the next try.
//
// The Gram of a tile: eight groups of 64 threads take the rows r = g mod 8,
// each thread 2x2 entries in registers (FMAs from shared memory, a row's
// loads issued before the previous row's FMAs); the groups' sums meet in
// shared memory in a fixed tree. An off-diagonal tile writes both (i, j)
// and (j, i), each its own old entry plus the one product sum and the one
// delta-delta term; a diagonal tile mirrors its upper half. So m2' is
// exactly symmetric whenever m2 is. Both routes add the same numbers in the
// same order: they give the same bits. No float atomics: a fixed input gives
// the same bits on every run.
//
// The launch plan (the route, the grid) is the caller's; the shared memory
// is this source's: run() derives it from the route and refuses a whole
// route that does not fit kWholeBudget. The probe's cuts 1-3 and 5 are
// compiled only with -DONLINE_PROBE (launch/online_probe.py builds that
// library); a build without it has the empty body and the whole kernel.
//
// Shared memory is addressed by 32-bit shared-window addresses from one base
// kept in a register, with explicit ld/st.shared: through the extern array,
// ptxas rebuilt the base from the CTA's cluster id (S2R SR_CgaCtaId, a slow
// special register) at nearly every access outside the Gram's loop.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 16;                        // m2 tile edge
constexpr int kTileSize = kTile * kTile;
constexpr int kGroups = 8;                       // row groups of the Gram, 64 threads each
constexpr int kParts = 8;                        // partial sums a column of the chunk mean
constexpr int kBatch = 4;                        // rows a thread loads before it adds or stores
constexpr int kSlabRows = 256;                   // rows a slab of the slab route
constexpr int kSlots = 2 * kTile;                // a tile's columns: its row set, its column set
constexpr int kRowPhases = kThreads / kSlots;    // rows r = h mod 16 a thread centres
constexpr int kRedPitch = kTile + 1;             // the groups' sums, padded against bank conflicts
constexpr int kPlane = kTile * kRedPitch;
constexpr int kWholeBudget = 96 * 1024;          // the whole route's shared memory at most (bytes)
constexpr int kMaxDevices = 64;                  // devices whose launch set-up is kept
constexpr int kWhole = 0, kSlab = 1;             // routes
constexpr int kCuts = 5;                         // probe cuts; kCuts - 1 is the whole kernel
constexpr int kStamped = kCuts;                  // the probe's whole kernel with phase stamps
constexpr int kStamps = 8;                       // stamps a block
static_assert(kSlabRows % kParts == 0 && kSlabRows % kGroups == 0 &&
                  kSlabRows % kRowPhases == 0,
              "slabs keep the row phases");
static_assert(kThreads == kGroups * 64 && kThreads == 2 * kTileSize &&
                  kParts * kSlots <= kThreads,
              "thread layout: a Gram group 64 threads of 2x2 entries; a thread an entry of the "
              "tile or of its mirror; a thread a (column, part) of the mean");
static_assert(kParts == 8 && kGroups == 8, "tree8 adds eight");

__host__ __device__ constexpr long long up4(long long n) { return (n + 3) & ~3LL; }

// Floats of chunk rows a block of `route` holds at C rows of d: the whole
// span (shifted to its alignment, and the Gram's reads past its last row),
// or the slab ring.
__host__ __device__ constexpr long long lead_floats(int route, int C, int d) {
  return route == kWhole ? up4((long long)C * d + 3 + kTile) : 2LL * kSlabRows * kSlots;
}

// Floats of dynamic shared memory a block of `route` needs at C rows of d.
__host__ __device__ constexpr long long smem_floats(int route, int C, int d) {
  return lead_floats(route, C, d) + (2 + kParts) * kSlots + 2 * kTileSize +
         (long long)kGroups * kPlane;
}
constexpr int kSlabSmem = (int)(4 * smem_floats(kSlab, 0, 1));  // 77,568 bytes

// A block's dynamic shared memory in bytes; 0 for no route, C < 0, d < 1, or
// a whole route beyond kWholeBudget.
long long smem_bytes(int route, int C, int d) {
  if ((route != kWhole && route != kSlab) || C < 0 || d < 1) return 0;
  const long long bytes = 4 * smem_floats(route, C, d);
  return route == kWhole && bytes > kWholeBudget ? 0 : bytes;
}

// Shared memory by 32-bit shared-window byte addresses; i counts floats.
__device__ __forceinline__ float lds(uint32_t a, int i = 0) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a + 4u * i) : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t a, int i, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a + 4u * i), "f"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

struct Args {
  const float* chunk;
  const int* counts;
  const float* count;
  const float* mean;
  const float* m2;
  float* count_out;
  float* mean_out;
  float* m2_out;
  float* sink;  // probe cuts only
  long long stride_m;
  int C, d, nt;  // nt: tiles along d
};

// The machine's scalars, shared by every block of it: what the copies need
// first, then (merge_terms, after the copies are issued, so that the running
// count's load is not waited for before them) what the merge needs.
struct Machine {
  const float* x;  // its chunk
  int nv;          // rows read
  float n_b, n_a, n, frac, coef;
  bool upd;
};

__device__ __forceinline__ Machine machine(const Args& a, int m) {
  Machine s;
  const int cc = a.counts ? a.counts[m] : a.C;
  s.x = a.chunk + (size_t)m * (size_t)a.stride_m;
  s.nv = cc <= 0 ? 0 : (cc < a.C ? cc : a.C);
  s.n_b = (float)cc;
  s.upd = s.n_b > 0.f;
  s.n_a = a.count[m];
  return s;
}

__device__ __forceinline__ void merge_terms(Machine& s) {
  s.n = s.n_a + s.n_b;
  const float n_safe = fmaxf(s.n, 1.f);
  s.frac = s.n_b / n_safe;
  s.coef = s.n_a * s.n_b / n_safe;
}

// The block's tile: rows i0.., columns j0.. of m2 (i0 <= j0), and its
// kSlots columns, slot s < kTile the row set's i0 + s, the others the column
// set's (a diagonal tile's two sets are the same columns).
struct Tile {
  int i0, j0;
  bool diag;
  __device__ __forceinline__ int column(int slot) const {
    return slot < kTile ? i0 + slot : j0 + slot - kTile;
  }
};

// The upper-triangle tile blockIdx.x (row-major) of nt a side.
__device__ __forceinline__ Tile tile_of_block(int nt) {
  int t = blockIdx.x, ti = 0;
  while (t >= nt - ti) t -= nt - ti++;
  return Tile{ti * kTile, (ti + t) * kTile, t == 0};
}

// A block's dynamic shared memory (byte addresses): `lead` floats of chunk
// rows (the span or the slab ring), then the old and the chunk means of the
// tile's columns, their kParts partial sums, two m2 tiles and the row
// groups' Gram sums. The base is kept in a register (see the note above).
struct Smem {
  uint32_t rows, mo, mu, part, ma, mb, red;
};

__device__ __forceinline__ Smem carve(long long lead) {
  extern __shared__ __align__(16) float smem[];
  uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("" : "+r"(base));
  Smem t;
  t.rows = base;
  t.mo = base + 4u * (uint32_t)lead;
  t.mu = t.mo + 4u * kSlots;
  t.part = t.mu + 4u * kSlots;
  t.ma = t.part + 4u * kParts * kSlots;
  t.mb = t.ma + 4u * kTileSize;
  t.red = t.mb + 4u * kTileSize;
  return t;
}

// The tile's old state: m2's rows i0.., columns j0.. into ma, for an
// off-diagonal tile its mirror (rows j0.., columns i0..) into mb, one entry a
// thread; the old means of the tile's columns into mo. 4-byte copies: a row
// of m2 starts 16-byte aligned only when 4 divides d.
__device__ __forceinline__ void load_state(const Smem& sm, const Args& a, int m, const Tile& t) {
  const int d = a.d, tid = threadIdx.x, e = tid % kTileSize, r = e / kTile, c = e % kTile;
  const float* m2m = a.m2 + (size_t)m * d * d;
  if (tid < kTileSize) {
    if (t.i0 + r < d && t.j0 + c < d)
      cp_async4(sm.ma + 4u * e, m2m + (size_t)(t.i0 + r) * d + t.j0 + c);
  } else if (!t.diag && t.j0 + r < d && t.i0 + c < d) {
    cp_async4(sm.mb + 4u * e, m2m + (size_t)(t.j0 + r) * d + t.i0 + c);
  }
  if (tid < kSlots && t.column(tid) < d)
    cp_async4(sm.mo + 4u * tid, a.mean + (size_t)m * d + t.column(tid));
}

// The fixed tree over eight partial sums w floats apart: a column's kParts
// sums of the chunk mean, an entry's kGroups Gram sums.
__device__ __forceinline__ float tree8(uint32_t a, int w) {
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = lds(a, k * w);
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// s += x[r * pitch] over r = r0, r0 + step, ... < rows, in that order, kBatch
// loads in flight at a time.
__device__ __forceinline__ float column_sum(uint32_t x, int pitch, int r0, int step, int rows,
                                            float s) {
  const int n = r0 < rows ? (rows - r0 + step - 1) / step : 0;
  const uint32_t stride = 4u * step * pitch;
  uint32_t at = x + 4u * r0 * pitch;
  int k = 0;
  for (; k + kBatch <= n; k += kBatch, at += kBatch * stride) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = lds(at + j * stride);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) s += v[j];
  }
  for (; k < n; ++k, at += stride) s += lds(at);
  return s;
}

// x[r * pitch] -= mu over r = r0, r0 + step, ... < rows, kBatch loads before
// their stores.
__device__ __forceinline__ void column_centre(uint32_t x, int pitch, int r0, int step, int rows,
                                              float mu) {
  const int n = r0 < rows ? (rows - r0 + step - 1) / step : 0;
  const uint32_t stride = 4u * step * pitch;
  uint32_t at = x + 4u * r0 * pitch;
  int k = 0;
  for (; k + kBatch <= n; k += kBatch, at += kBatch * stride) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = lds(at + j * stride);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sts(at + j * stride, 0, v[j] - mu);
  }
  for (; k < n; ++k, at += stride) sts(at, 0, lds(at) - mu);
}

// The chunk means of the tile's columns from the threads' partial sums
// (thread tid < kParts * kSlots: column slot tid % kSlots, part tid / kSlots).
__device__ __forceinline__ void finish_mean(const Smem& sm, float sum, const Machine& s) {
  const int tid = threadIdx.x;
  if (tid < kParts * kSlots) sts(sm.part, tid, sum);
  __syncthreads();
  if (tid < kSlots) sts(sm.mu, tid, tree8(sm.part + 4u * tid, kSlots) / fmaxf(s.n_b, 1.f));
  __syncthreads();
}

__device__ __forceinline__ void load2(float (&v)[2], uint32_t at) {
  v[0] = lds(at);
  v[1] = lds(at, 1);
}

__device__ __forceinline__ void fma4(float (&acc)[2][2], const float (&a)[2], const float (&b)[2]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
}

// acc[p][q] += sum_{r = g, g + kGroups, ... < rows} a[r, 2 ta + p] * b[r, 2 tb + q]: this
// thread's row group g and 2x2 entries (2 ta + p, 2 tb + q) of the tile, in
// row order; two register sets in turn, so a row's loads go out before the
// previous row's FMAs.
__device__ __forceinline__ void gram_rows(float (&acc)[2][2], uint32_t a, uint32_t b, int pitch,
                                          int rows) {
  const int g = threadIdx.x >> 6, ta = (threadIdx.x >> 3) & 7, tb = threadIdx.x & 7;
  const int n = g < rows ? (rows - g + kGroups - 1) / kGroups : 0;
  const uint32_t step = 4u * kGroups * pitch;
  uint32_t pa = a + 4u * (2 * ta + g * pitch), pb = b + 4u * (2 * tb + g * pitch);
  float a0[2], b0[2], a1[2], b1[2];
  int k = 0;
  if (n > 0) {
    load2(a0, pa);
    load2(b0, pb);
  }
  for (; k + 2 <= n; k += 2) {
    load2(a1, pa + step);
    load2(b1, pb + step);
    fma4(acc, a0, b0);
    pa += 2 * step;
    pb += 2 * step;
    if (k + 2 < n) {
      load2(a0, pa);
      load2(b0, pb);
    }
    fma4(acc, a1, b1);
  }
  if (k < n) fma4(acc, a0, b0);
}

__device__ __forceinline__ float m2_entry(float old, float g, float di, float dj,
                                          const Machine& s) {
  return s.upd ? (old + g) + (di * dj) * s.coef : old;
}

// The groups' sums of the tile meet in sm.red; then m2' of the tile (threads
// below kTileSize) and of its mirror (the others), mean' of a diagonal
// tile's columns, and count' from tile 0.
__device__ __forceinline__ void merge_tile(const Args& a, int m, const Machine& s,
                                           const float (&acc)[2][2], const Smem& sm,
                                           const Tile& t) {
  const int tid = threadIdx.x, g = tid >> 6, ta = (tid >> 3) & 7, tb = tid & 7;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      sts(sm.red, g * kPlane + (2 * ta + p) * kRedPitch + 2 * tb + q, acc[p][q]);
  __syncthreads();
  const int d = a.d, e = tid % kTileSize, r = e / kTile, c = e % kTile;
  const int ni = min(kTile, d - t.i0), nj = min(kTile, d - t.j0);
  const uint32_t mui = sm.mu, moi = sm.mo, muj = sm.mu + 4u * kTile, moj = sm.mo + 4u * kTile;
  float* out = a.m2_out + (size_t)m * d * d;
  if (tid < kTileSize) {
    if (r < ni && c < nj) {  // (i0 + r, j0 + c); a diagonal tile takes its upper half
      const int u = t.diag ? min(r, c) : r, v = t.diag ? max(r, c) : c;
      const float gv = tree8(sm.red + 4u * (u * kRedPitch + v), kPlane);
      out[(size_t)(t.i0 + r) * d + t.j0 + c] =
          m2_entry(lds(sm.ma, e), gv, lds(mui, u) - lds(moi, u), lds(muj, v) - lds(moj, v), s);
    }
  } else if (!t.diag && r < nj && c < ni) {  // the mirror (j0 + r, i0 + c): the same sum and term
    const float gv = tree8(sm.red + 4u * (c * kRedPitch + r), kPlane);
    out[(size_t)(t.j0 + r) * d + t.i0 + c] =
        m2_entry(lds(sm.mb, e), gv, lds(mui, c) - lds(moi, c), lds(muj, r) - lds(moj, r), s);
  }
  if (t.diag && tid >= kTileSize && tid - kTileSize < nj) {
    const int j = tid - kTileSize;
    const float mv = lds(moj, j);
    a.mean_out[(size_t)m * d + t.j0 + j] = s.upd ? mv + (lds(muj, j) - mv) * s.frac : mv;
  }
  if (blockIdx.x == 0 && tid == 0) a.count_out[m] = s.n;
}

// Probe cuts write one value a thread that depends on what the cut computed,
// so that nothing of it is compiled away.
__device__ __forceinline__ void sink(const Args& a, float v) {
  a.sink[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x] = v;
}

// The probe's stamped kernel: thread 0 of each block writes clock64() and
// the global timer (ns) at phase boundary k into sink, as 2 * kStamps int64
// a block; other instances compile this away.
template <int kCut>
__device__ __forceinline__ void stamp(const Args& a, int k) {
  if constexpr (kCut == kStamped) {
    if (threadIdx.x == 0) {
      long long* out = reinterpret_cast<long long*>(a.sink) +
                       ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * kStamps;
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      out[k] = clock64();
      out[kStamps + k] = (long long)ns;
    }
  }
}

__device__ __forceinline__ float acc_sum(const float (&acc)[2][2]) {
  return (acc[0][0] + acc[0][1]) + (acc[1][0] + acc[1][1]);
}

// Cut 0 of the probe: the launch alone, on the grid and shared memory of
// either route.
__global__ void __launch_bounds__(kThreads) online_empty_kernel(Args) {}

template <int kCut>
__global__ void __launch_bounds__(kThreads) online_whole_kernel(Args a) {
  stamp<kCut>(a, 0);
  const int m = blockIdx.y, tid = threadIdx.x, d = a.d;
  Machine s = machine(a, m);
  const Smem sm = carve(lead_floats(kWhole, a.C, d));
  const Tile t = tile_of_block(a.nt);

  // all copies at once: the span (placed as far past a 16-byte boundary as in
  // device memory), then the tile's m2 and old means, which are only waited
  // for before the merge
  const int mis = (int)(((uintptr_t)s.x >> 2) & 3);
  const uint32_t xs = sm.rows + 4u * mis;
  const int total = s.nv * d;
  const int b0 = min((4 - mis) & 3, total);
  const int b1 = b0 + ((total - b0) & ~3);
  for (int e = tid; e < b0; e += kThreads) cp_async4(xs + 4u * e, s.x + e);
  for (int e = b0 + 4 * tid; e < b1; e += 4 * kThreads) cp_async16(xs + 4u * e, s.x + e);
  for (int e = b1 + tid; e < total; e += kThreads) cp_async4(xs + 4u * e, s.x + e);
  cp_async_commit();
  load_state(sm, a, m, t);
  cp_async_commit();
  merge_terms(s);
  if (tid < kTile) sts(xs, total + tid, 0.f);  // the Gram's reads past the last row
  cp_async_wait<1>();  // the span; the tile's state lands under the work below
  __syncthreads();
  stamp<kCut>(a, 1);
  if constexpr (kCut == 1) {
    cp_async_wait<0>();
    __syncthreads();
    sink(a, (tid < total ? lds(xs, tid) : 0.f) + lds(sm.ma, tid % kTileSize) +
                lds(sm.mo, tid % kSlots));
  } else {
    // the chunk means of the tile's columns, in a fixed order (thread: slot
    // tid % kSlots, rows r = tid / kSlots mod kParts), then those columns
    // centred in place (a diagonal tile's once)
    const int slot = tid % kSlots, col = t.column(slot);
    float sum = 0.f;
    if (tid < kParts * kSlots && col < d)
      sum = column_sum(xs + 4u * col, d, tid / kSlots, kParts, s.nv, 0.f);
    stamp<kCut>(a, 2);
    finish_mean(sm, sum, s);
    stamp<kCut>(a, 3);
    if (col < d && (slot < kTile || !t.diag))
      column_centre(xs + 4u * col, d, tid / kSlots, kRowPhases, s.nv, lds(sm.mu, slot));
    __syncthreads();
    stamp<kCut>(a, 4);
    if constexpr (kCut == 2) {
      cp_async_wait<0>();
      sink(a, (tid < total ? lds(xs, tid) : 0.f) + lds(sm.mu, slot));
    } else {
      float acc[2][2] = {};
      gram_rows(acc, xs + 4u * t.i0, xs + 4u * t.j0, d, s.nv);
      stamp<kCut>(a, 5);
      cp_async_wait<0>();  // the tile's old state
      if constexpr (kCut == 3) {
        sink(a, acc_sum(acc));
      } else {
        merge_tile(a, m, s, acc, sm, t);
        stamp<kCut>(a, 6);
      }
    }
  }
}

// Rows [r0, r0 + rows) of the tile's kSlots columns into a stage (a row of
// kSlots floats); columns at or past d are left as they were.
__device__ __forceinline__ void load_slab(uint32_t st, const float* x, int d, const Tile& t,
                                          int r0, int rows, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kSlots / 4); e += kThreads) {
      const int r = e / (kSlots / 4), slot = 4 * (e % (kSlots / 4)), col = t.column(slot);
      if (col < d) cp_async16(st + 4u * (r * kSlots + slot), x + (size_t)(r0 + r) * d + col);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kSlots; e += kThreads) {
      const int r = e / kSlots, slot = e % kSlots, col = t.column(slot);
      if (col < d) cp_async4(st + 4u * (r * kSlots + slot), x + (size_t)(r0 + r) * d + col);
    }
  }
}

template <int kCut>
__global__ void __launch_bounds__(kThreads, 2) online_slab_kernel(Args a) {
  const int m = blockIdx.y, tid = threadIdx.x, d = a.d;
  Machine s = machine(a, m);
  const Smem sm = carve(lead_floats(kSlab, a.C, d));
  const Tile t = tile_of_block(a.nt);
  constexpr uint32_t kStage = 4u * kSlabRows * kSlots;
  // 16-byte copies when every row's column sets start on a 16-byte boundary
  const bool vec = (((uintptr_t)s.x & 15) == 0) && (d & 3) == 0;
  const int n_slabs = (s.nv + kSlabRows - 1) / kSlabRows;

  // the first group: the tile's old state and slab 0
  load_state(sm, a, m, t);
  if (n_slabs > 0) load_slab(sm.rows, s.x, d, t, 0, min(kSlabRows, s.nv), vec);
  cp_async_commit();
  merge_terms(s);

  // column sums: thread tid < kParts * kSlots takes slot tid % kSlots over the
  // rows r = tid / kSlots mod kParts (a diagonal tile's two slots of a
  // column hold the same values)
  const int slot = tid % kSlots;
  float sum = 0.f;
  float acc[2][2] = {};
  [[maybe_unused]] float probe = 0.f;

  // slabs 0 .. n_slabs - 1: the sums; n_slabs .. 2 n_slabs - 1: the Gram. A
  // chunk of one slab is copied once: the second pass centres it in place.
  const bool once = n_slabs == 1;
  for (int k = 0; k < 2 * n_slabs; ++k) {
    if (k + 1 < 2 * n_slabs && !once) {
      const int r1 = ((k + 1) % n_slabs) * kSlabRows;
      load_slab(sm.rows + ((k + 1) & 1) * kStage, s.x, d, t, r1, min(kSlabRows, s.nv - r1), vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // slab k (and the first group) have landed
    __syncthreads();
    const uint32_t st = sm.rows + (once ? 0 : (k & 1) * kStage);
    const int rows = min(kSlabRows, s.nv - (k % n_slabs) * kSlabRows);
    if constexpr (kCut == 1) {
      probe += lds(st, (tid % rows) * kSlots + slot);
    } else if (k < n_slabs) {
      if (tid < kParts * kSlots)
        sum = column_sum(st + 4u * slot, kSlots, tid / kSlots, kParts, rows, sum);
    } else {
      if (k == n_slabs) finish_mean(sm, sum, s);
      column_centre(st + 4u * slot, kSlots, tid / kSlots, kRowPhases, rows, lds(sm.mu, slot));
      __syncthreads();
      if constexpr (kCut == 2) {
        probe += lds(st, (tid % rows) * kSlots + slot);
      } else {
        gram_rows(acc, st, st + 4u * kTile, kSlots, rows);
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kCut < kCuts - 1) {
    if (n_slabs == 0) probe += lds(sm.ma, tid % kTileSize) + lds(sm.mo, slot);
    sink(a, kCut == 3 ? acc_sum(acc) : probe);
  } else {
    if (n_slabs == 0) finish_mean(sm, sum, s);
    merge_tile(a, m, s, acc, sm, t);
  }
}

template <void (*kKernel)(Args)>
cudaError_t launch(int device, int most, const Args& a, int M, int blocks, int smem,
                   cudaStream_t st) {
  static bool ready[kMaxDevices];  // the shared-memory attribute, once a device
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  kKernel<<<dim3(blocks, M), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int kCut>
cudaError_t launch_cut(int device, int route, const Args& a, int M, int blocks, int smem,
                       cudaStream_t st) {
  return route == kWhole
             ? launch<online_whole_kernel<kCut>>(device, kWholeBudget, a, M, blocks, smem, st)
             : launch<online_slab_kernel<kCut>>(device, kSlabSmem, a, M, blocks, smem, st);
}

int run(int cut, int device, const float* chunk, const int* chunk_counts, const float* count,
        const float* mean, const float* m2, float* count_out, float* mean_out, float* m2_out,
        float* sink, int M, int C, int d, long long stride_m, int route, void* stream) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long smem = smem_bytes(route, C, d);
  if (smem == 0 || M < 1 || M > 65535) return cudaErrorInvalidValue;
  const int nt = (d + kTile - 1) / kTile;
  const int blocks = nt * (nt + 1) / 2;  // a block per upper-triangle tile
  const Args a{chunk, chunk_counts, count, mean, m2, count_out, mean_out, m2_out, sink,
               stride_m, C, d, nt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cut) {
    case 0: return launch<online_empty_kernel>(device, kWholeBudget, a, M, blocks, (int)smem, st);
    case kCuts - 1: return launch_cut<kCuts - 1>(device, route, a, M, blocks, (int)smem, st);
#ifdef ONLINE_PROBE
    case 1: return launch_cut<1>(device, route, a, M, blocks, (int)smem, st);
    case 2: return launch_cut<2>(device, route, a, M, blocks, (int)smem, st);
    case 3: return launch_cut<3>(device, route, a, M, blocks, (int)smem, st);
    case kStamped:  // the whole route only: the slab kernel has no stamps
      return route == kWhole ? launch<online_whole_kernel<kStamped>>(device, kWholeBudget, a, M,
                                                                     blocks, (int)smem, st)
                             : cudaErrorInvalidValue;
#endif
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The route (0 whole, 1 slab) is the caller's (ops._plan); the grid, a block
// per upper-triangle tile of each machine, and the shared memory are this
// source's, and a whole route that does not fit kWholeBudget is refused.
extern "C" int online_update_f32(int device, const float* chunk, const int* chunk_counts,
                                 const float* count, const float* mean, const float* m2,
                                 float* count_out, float* mean_out, float* m2_out, int M, int C,
                                 int d, long long stride_m, int route, void* stream) {
  return run(kCuts - 1, device, chunk, chunk_counts, count, mean, m2, count_out, mean_out, m2_out,
             nullptr, M, C, d, stride_m, route, stream);
}

// The kernel cut after its phases, for timing them: 0 an empty body (the
// launch floor), 1 the copies and their wait, 2 + the chunk mean and the
// centring, 3 + the Gram, 4 the whole kernel. Cuts 1-3 write one float a
// thread to sink ((blocks * M * 512,) floats) and nothing else; cut 5 is the
// whole route's kernel with thread 0 of every block writing clock64() and the
// global timer at its phase boundaries (start, copies landed, column sums,
// means, centred, Gram, merged) to sink as 16 int64 a block. Cuts 1-3 and 5
// are built only with -DONLINE_PROBE.
extern "C" int online_update_probe(int cut, int device, const float* chunk, const int* chunk_counts,
                                   const float* count, const float* mean, const float* m2,
                                   float* count_out, float* mean_out, float* m2_out, float* sink,
                                   int M, int C, int d, long long stride_m, int route,
                                   void* stream) {
  return run(cut, device, chunk, chunk_counts, count, mean, m2, count_out, mean_out, m2_out, sink,
             M, C, d, stride_m, route, stream);
}

// A block's dynamic shared memory in bytes on `route` at C rows of d; 0 when
// the route cannot take them (ops.smem_bytes mirrors it, to plan the route).
extern "C" long long online_update_smem_bytes(int route, int C, int d) {
  return smem_bytes(route, C, d);
}

extern "C" const char* online_update_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
