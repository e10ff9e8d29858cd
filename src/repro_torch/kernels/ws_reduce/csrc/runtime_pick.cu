// A runtime round's weighted picks for Hopper (sm_90a): every candidate set
// of the round prefiltered, normalised and picked on the card, from one C
// call that enqueues two kernels.
//
// Replaces the use the runtime makes of the TPU kernel
// src/repro/kernels/ws_reduce/kernel.py::ws_reduce_pallas (and, for its
// prefilter, src/repro/kernels/pareto_filter/kernel.py::pareto_filter_pallas):
// src/repro/core/tuning/runtime.py::weighted_pick_batch, which the TPU ran
// as numpy normalisation around one pareto_filter launch a set and one
// ws_reduce launch a weight group.  The standalone ws_reduce kernel
// (ws_reduce.cu, built into the same library) stays for HMOOC2's picks.
//
// What it computes, decision for decision as weighted_pick_batch's numpy
// route with the pareto_filter and ws_reduce kernels behind it:
//   per set r of n_r rows (F[off[r] : off[r + 1]], k <= 8 columns):
//     kept  = the rows no finite row dominates (float64 compares; a row
//             with a non-finite entry neither dominates nor survives) when
//             n_r >= kernel_min_n, else every row; every row when that
//             keeps nothing;
//     lo, hi = numpy's min and max over all n_r rows (NaN propagates);
//     span   = hi - lo where hi > lo, else 1;
//     Fn     = (F[kept] - lo) / span, rounded as numpy rounds it;
//   per weight group g (the sets with gid == g, R_g of them, weights W[g]):
//     B_g    = the most kept rows of a set of the group; shorter sets are
//              padded with 1e18;
//     route  = float32 iff R_g * B_g >= ws_min_scores and no column of the
//              group's padded bank holds two finite float64 values that
//              differ but round to one float32 (pareto._f32_tie_hazard);
//     pick   = the first argmin of the weighted sum over the set's kept
//              rows and its padding: in float32 as ws_reduce scores it
//              (each value rounded and put through nan_to_num(posinf=1e30),
//              the weights rounded, products rounded one by one and added
//              left to right), or in float64 as numpy's (Fn * w).sum(-1)
//              (products rounded one by one; added left to right for
//              k < 8, pairwise ((0+1)+(2+3))+((4+5)+(6+7)) at k = 8, the
//              order numpy's pairwise sum takes for 8 terms).  A NaN score
//              counts as the least, as np.argmin and ws_reduce treat it.
//   out[r]     = the picked row's index in set r, -1 if a padding slot won
//                (the host's pick then has no row: the caller raises);
//   out[R + g] = 1 for the float32 route, 0 for float64 below the volume
//                threshold, 2 for float64 because of a float32 tie.
// Dominance in float64 gives the float32 kernel's mask wherever the host
// routes a set to that kernel: rounding to float32 is monotone, so without
// a tie in any column every compare keeps its outcome, and a set with a
// tie takes the host's float64 mask.
//
// What bounds it on this card: latency.  The runtime's largest round (32
// sets of 66 rows, k = 2) is 34 KB of float64 read once and some 0.1 M
// compares: about 10 ns of memory time.  What costs is each set's chain of
// dependent steps (copy, two reductions, the dominance scan, the scores,
// the picks) and the group-wide step after it.
//
// What the design does about it: two kernels from one C call, the kernel
// boundary the only synchronisation between a set's work and its group's
// (a fence and a ticket in one kernel cost more: 4 us at the main path).
// Together they take 9.5 us at the main path's largest round on an H100
// at 700 W.
// * Kernel 1, a block a set.  The set is staged in shared memory with
//   16-byte cp.async copies (1 KB at the main path's 66 rows).  A warp a
//   column reduces its min and max by shuffles while the other warps start
//   the dominance scan, which gives each row as many threads as the block
//   holds (3 at 66 rows), each testing every third dominator, eight at a
//   time.  A thread normalises and scores a kept row in both types and
//   writes the normalised row to a compact scratch slot; warp shuffles
//   with a branch-free `beats` reduce the block's float32 and float64
//   winners.  A set past the shared-memory budget streams its dominators
//   through the same buffer in tiles and reads its rows from device
//   memory: the same answer.
// * Kernel 2, a block a weight group: B_g and the padding from the
//   members' counts; the float32 tie check without a sort, a thread a kept
//   value of the group, each inserted into a hash table keyed by its
//   float32 rounding (atomicCAS, a table a column, in shared memory, or in
//   device memory where the group is too large): a value that meets
//   another of the same rounding but not the same value is a tie.  Then
//   the route and every member's pick.  The host waits once for a round.
// * No tensor cores: the work is k <= 8 dot products and compares, and
//   FP64 is native on the H100.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may use for its set: with the
// static arrays it stays under the default 48 KB, so no opt-in is needed.
constexpr size_t kSetBudget = 40 * 1024;
constexpr double kPad = 1e18;

// Device scratch of one call, carved from one buffer (see scratch_bytes).
struct Scratch {
  double* fn;                // (total, K): each set's kept rows, normalised
  double* v64;               // (R,) float64 winner's score
  unsigned long long* tab;   // (4 K total,) tie tables of large groups
  float* v32;                // (R,) float32 winner's score
  int* i64;                  // (R,) float64 winner's row
  int* i32;                  // (R,) float32 winner's row
  int* nk;                   // (R,) kept rows
  uint8_t* live;             // (total,) row flags of sets past the budget
};

long long scratch_bytes(int R, int k, long long total) {
  return total * (40LL * k + 1) + 24LL * R;
}

Scratch carve(void* base, int R, int k, long long total) {
  Scratch s;
  char* p = static_cast<char*>(base);
  s.fn = reinterpret_cast<double*>(p);
  p += total * k * 8;
  s.v64 = reinterpret_cast<double*>(p);
  p += 8LL * R;
  s.tab = reinterpret_cast<unsigned long long*>(p);
  p += 32LL * k * total;
  s.v32 = reinterpret_cast<float*>(p);
  p += 4LL * R;
  s.i64 = reinterpret_cast<int*>(p);
  p += 4LL * R;
  s.i32 = reinterpret_cast<int*>(p);
  p += 4LL * R;
  s.nk = reinterpret_cast<int*>(p);
  p += 4LL * R;
  s.live = reinterpret_cast<uint8_t*>(p);
  return s;
}

// (va, ia) comes before (vb, ib): NaN first, then by value, ties (and NaN
// against NaN) by index.  Without branches, as in fused_solve.cu.
template <typename T>
__device__ __forceinline__ bool beats(T va, int ia, T vb, int ib) {
  const bool na = isnan(va);
  const bool nb = isnan(vb);
  const bool first = ia < ib;
  return (na & (!nb | first)) |
         (!na & !nb & ((va < vb) | ((va == vb) & first)));
}

// numpy's minimum and maximum: a NaN on either side wins.
__device__ __forceinline__ double np_min(double a, double b) {
  return (isnan(a) | (a < b)) ? a : b;
}
__device__ __forceinline__ double np_max(double a, double b) {
  return (isnan(a) | (a > b)) ? a : b;
}

// x rounded to float32, then nan_to_num(posinf=1e30): ws_reduce's input.
__device__ __forceinline__ float sanitise(double x) {
  const float f = __double2float_rn(x);
  if (isnan(f)) return 0.f;
  if (isinf(f)) return f > 0.f ? 1e30f : -FLT_MAX;
  return f;
}

// numpy's (f * w).sum(-1) for one row: see the header for the order.
template <int K>
__device__ __forceinline__ double score64(const double* w, const double* f) {
  double p[K];
#pragma unroll
  for (int q = 0; q < K; ++q) p[q] = __dmul_rn(f[q], w[q]);
  if constexpr (K == 8) {
    return __dadd_rn(__dadd_rn(__dadd_rn(p[0], p[1]), __dadd_rn(p[2], p[3])),
                     __dadd_rn(__dadd_rn(p[4], p[5]), __dadd_rn(p[6], p[7])));
  } else {
    double s = p[0];
#pragma unroll
    for (int q = 1; q < K; ++q) s = __dadd_rn(s, p[q]);
    return s;
  }
}

// ws_reduce's float32 score of one row.
template <int K>
__device__ __forceinline__ float score32(const float* w, const double* f) {
  float s = __fmul_rn(w[0], sanitise(f[0]));
#pragma unroll
  for (int q = 1; q < K; ++q)
    s = __fadd_rn(s, __fmul_rn(w[q], sanitise(f[q])));
  return s;
}

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copies `cnt` doubles from `src` into shared memory and waits for them
// (fused_solve.cu's helper).  `buf` is 16-byte aligned with one spare
// double; the copy starts at buf + 1 when `src` is not 16-byte aligned, so
// that every pair after the first element moves in one 16-byte copy.
__device__ __forceinline__ double* stage(double* buf, const double* src,
                                         int cnt) {
  const int shift = (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0;
  double* dst = buf + shift;
  const int pairs = (cnt - shift) >> 1;
  if (shift && threadIdx.x == 0) cp_async8(dst, src);
  for (int t = threadIdx.x; t < pairs; t += kThreads)
    cp_async16(dst + shift + 2 * t, src + shift + 2 * t);
  const int tail = shift + 2 * pairs;
  if (tail < cnt && threadIdx.x == 0) cp_async8(dst + tail, src + tail);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  return dst;
}

// True if float64 `a` meets another value of `tab` (a table of `mask` + 1
// slots, 0 empty, a value v held as ~bits(v)) with the same float32
// rounding but another value; else a holds its slot (inserted now or
// before).  Linear probing from a hash of the rounding, +0 and -0 alike:
// two values of one rounding probe the same chain, so the second meets the
// first before an empty slot, whichever thread comes first.
__device__ __forceinline__ bool f32_collides(unsigned long long* tab,
                                             unsigned mask, double a) {
  const float af = __double2float_rn(a);
  unsigned x = af == 0.f ? 0u : __float_as_uint(af);
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  const unsigned long long key =
      ~static_cast<unsigned long long>(__double_as_longlong(a));
  for (unsigned h = x & mask;; h = (h + 1) & mask) {
    const unsigned long long old = atomicCAS(tab + h, 0ull, key);
    if (old == 0ull) return false;
    const double b = __longlong_as_double(static_cast<long long>(~old));
    if (__double2float_rn(b) == af) return b != a;
  }
}

// The two running winners of a thread: float64 and float32 (score, row).
struct Best {
  double v64;
  int i64;
  float v32;
  int i32;
};

// The warp's winners, in every lane.  Not inlined and not unrolled: both
// reduction levels of kernel 1 run this one copy of the code (with the
// other loops rolled, kernel 1 took 1.5 us less on an H100 than with
// unrolled copies).
__device__ __noinline__ Best warp_best(Best b) {
#pragma unroll 1
  for (int d = 16; d > 0; d >>= 1) {
    const double ov = __shfl_xor_sync(kFull, b.v64, d);
    const int oi = __shfl_xor_sync(kFull, b.i64, d);
    const float fv = __shfl_xor_sync(kFull, b.v32, d);
    const int fi = __shfl_xor_sync(kFull, b.i32, d);
    if (beats(ov, oi, b.v64, b.i64)) {
      b.v64 = ov;
      b.i64 = oi;
    }
    if (beats(fv, fi, b.v32, b.i32)) {
      b.v32 = fv;
      b.i32 = fi;
    }
  }
  return b;
}

// One set's work in kernel 1, for a set staged whole in shared memory
// (kWhole) or streamed in tiles.  A template, so that each route's loads
// compile to their own memory space's instructions: a pointer that may
// point to either compiles to generic loads, which cost the staged route
// several times the shared-memory loads' latency.
template <int K, bool kWhole>
__device__ __forceinline__ void pick_set(
    double* smem, const double* Fr, int o, int n, int r, int cap, bool gok,
    long long kernel_min_n, const Scratch& s, int* out, double* lo,
    double* span, const double* w64, const float* w32, Best* best,
    int* s_slot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The set's rows: staged in shared memory, or read from device memory.
  // Every row starts live; the staging's barrier publishes the flags.
  uint8_t* live = kWhole ? reinterpret_cast<uint8_t*>(smem + cap * K + 2)
                         : s.live + o;
  for (int i = tid; i < n; i += kThreads) live[i] = 1;
  const double* src = Fr;
  if constexpr (kWhole)
    src = stage(smem, Fr, n * K);
  else
    __syncthreads();

  // Warp q: lo and span of column q over every row, NaN propagating as
  // in numpy.  The other warps start the dominance scan meanwhile.
  if (warp < K) {
    double mn = INFINITY, mx = -INFINITY;
    for (int i = lane; i < n; i += 32) {
      const double x = src[static_cast<size_t>(i) * K + warp];
      mn = np_min(mn, x);
      mx = np_max(mx, x);
    }
#pragma unroll 1
    for (int d = 16; d > 0; d >>= 1) {
      mn = np_min(mn, __shfl_xor_sync(kFull, mn, d));
      mx = np_max(mx, __shfl_xor_sync(kFull, mx, d));
    }
    if (lane == 0) {
      lo[warp] = mn;
      span[warp] = mx > mn ? __dsub_rn(mx, mn) : 1.0;
    }
  }

  // Dominance: P threads a row, each testing every P-th dominator of the
  // tile, eight at a time; a thread that finds one, or finds its row not
  // finite, clears the row's flag (every writer writes 0).
  const bool filter = static_cast<long long>(n) >= kernel_min_n;
  for (int t0 = 0; t0 < n; t0 += cap) {
    const int nt = min(cap, n - t0);
    if (!filter) break;
    const double* dom = src;
    if constexpr (!kWhole) {
      __syncthreads();  // every thread is done with the previous tile
      dom = stage(smem, Fr + static_cast<size_t>(t0) * K, nt * K);
    }
    const int P = max(1, min(32, kThreads / n));
    for (int it = tid; it < n * P; it += kThreads) {
      const int i = it / P;
      double fi[K];
      bool ok_i = true;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        fi[q] = src[static_cast<size_t>(i) * K + q];
        ok_i = ok_i && isfinite(fi[q]);
      }
      bool hit = !ok_i;
      for (int j = it - i * P; j < nt && !hit; j += 8 * P) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int jj = j + u * P;
          if (jj < nt) {
            bool le = true, lt = false, ok = true;
#pragma unroll
            for (int q = 0; q < K; ++q) {
              const double x = dom[static_cast<size_t>(jj) * K + q];
              ok = ok && isfinite(x);
              le = le && (x <= fi[q]);
              lt = lt || (x < fi[q]);
            }
            hit = hit || (ok && le && lt);
          }
        }
      }
      if (hit) live[i] = 0;
    }
  }
  // The kept rows: all when not filtered or when the mask keeps none.  A
  // barrier first: __syncthreads_count reads its predicate before it
  // waits, and a row's flag may still be cleared by the threads scanning
  // it.
  __syncthreads();
  int kept = 0;
  for (int t0 = 0; t0 < n; t0 += kThreads)
    kept += __syncthreads_count(t0 + tid < n && live[t0 + tid]);
  const bool all = !filter || kept == 0;

  // Normalise and score the kept rows; compact them into the scratch.
  Best b = {INFINITY, INT_MAX, INFINITY, INT_MAX};
  for (int i = tid; i < n; i += kThreads) {
    if (!(all || live[i])) continue;
    double fn[K];
#pragma unroll
    for (int q = 0; q < K; ++q)
      fn[q] = __ddiv_rn(__dsub_rn(src[static_cast<size_t>(i) * K + q], lo[q]),
                        span[q]);
    const int slot = atomicAdd(s_slot, 1);
#pragma unroll
    for (int q = 0; q < K; ++q)
      s.fn[static_cast<size_t>(o + slot) * K + q] = fn[q];
    const double v64 = score64<K>(w64, fn);
    const float v32 = score32<K>(w32, fn);
    if (beats(v64, i, b.v64, b.i64)) {
      b.v64 = v64;
      b.i64 = i;
    }
    if (beats(v32, i, b.v32, b.i32)) {
      b.v32 = v32;
      b.i32 = i;
    }
  }
  b = warp_best(b);
  if (lane == 0) best[warp] = b;
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) b = best[lane];
    b = warp_best(b);
    if (lane == 0) {
      s.v64[r] = b.v64;
      s.i64[r] = b.i64;
      s.v32[r] = b.v32;
      s.i32[r] = b.i32;
      s.nk[r] = all ? n : kept;
      if (!gok) out[r] = -1;  // no weight row: no pick
    }
  }
}

// Kernel 1: a block a set.  `cap` is the most rows a set may have to be
// staged whole (larger sets take the tiled route).
template <int K>
__global__ void __launch_bounds__(kThreads)
pick_sets_kernel(const double* __restrict__ F, const int* __restrict__ off,
                 const int* __restrict__ gid, const double* __restrict__ W,
                 int* __restrict__ out, Scratch s, int G, int cap,
                 long long kernel_min_n) {
  extern __shared__ __align__(16) double smem[];  // cap * K + 2 doubles,
                                                  // then cap live flags
  __shared__ double lo[K], span[K], w64[K];
  __shared__ float w32[K];
  __shared__ Best best[kWarps];
  __shared__ int s_slot;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int o = off[r];
  const int n = off[r + 1] - o;
  const int g = gid[r];
  const bool gok = g >= 0 && g < G;
  if (tid < K) {
    const double x = gok ? W[g * K + tid] : 0.0;
    w64[tid] = x;
    w32[tid] = __double2float_rn(x);
  }
  if (tid == 0) s_slot = 0;
  const double* Fr = F + static_cast<size_t>(o) * K;
  if (n <= cap)
    pick_set<K, true>(smem, Fr, o, n, r, cap, gok, kernel_min_n, s, out, lo,
                      span, w64, w32, best, &s_slot);
  else
    pick_set<K, false>(smem, Fr, o, n, r, cap, gok, kernel_min_n, s, out, lo,
                       span, w64, w32, best, &s_slot);
}

// The float32 tie check of kernel 2 over table `tab` (K tables of T
// slots, in shared memory or, kShared false, in device memory): true in
// the threads that found a tie.  A template, so that each memory's
// atomics compile as such (shared-memory atomicCAS, not generic).
template <int K, bool kShared>
__device__ __forceinline__ bool group_ties(
    unsigned long long* tab, long long T, bool padded,
    const int* __restrict__ off, const int* __restrict__ gid,
    const Scratch& s, int R, int g, int gt, int ot, int mk, int* m_off,
    int* m_end, int* s_nm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (long long e = tid; e < K * T; e += kThreads) tab[e] = 0ull;
  if constexpr (!kShared) __threadfence();  // the zeros before the CASes
  __syncthreads();
  const unsigned mask = static_cast<unsigned>(T - 1);
  bool found = false;
  if (padded && tid < K)
    found = f32_collides(tab + tid * T, mask, kPad);
  // The members' kept values, a thread a value: members are listed with
  // their values' ends, and a thread finds its member by bisection.
#pragma unroll 1
  for (int t0 = 0; t0 < R; t0 += kThreads) {
    if (tid == 0) *s_nm = 0;
    __syncthreads();
    const int t = t0 + tid;
    const bool mine = t0 == 0;
    if (t < R && (mine ? gt : gid[t]) == g) {
      const int slot = atomicAdd(s_nm, 1);
      m_off[slot] = (mine ? ot : off[t]) * K;
      m_end[slot] = (mine ? mk : s.nk[t]) * K;
    }
    __syncthreads();
    const int nm = *s_nm;
    if (warp == 0) {  // the ends: an inclusive scan, 32 members a step
      int carry = 0;
#pragma unroll 1
      for (int u0 = 0; u0 < nm; u0 += 32) {
        int x = u0 + lane < nm ? m_end[u0 + lane] : 0;
#pragma unroll 1
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        if (u0 + lane < nm) m_end[u0 + lane] = x + carry;
        carry += __shfl_sync(kFull, x, 31);
      }
    }
    __syncthreads();
    const int nvals = nm ? m_end[nm - 1] : 0;
    // Two values a thread a step, both loads in flight before either
    // insert.
#pragma unroll 1
    for (int e0 = tid; e0 < nvals; e0 += 2 * kThreads) {
      double a[2];
      int col[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = e0 + u * kThreads;
        a[u] = NAN;
        col[u] = 0;
        if (e < nvals) {
          int lo_m = 0, hi_m = nm - 1;  // the first member whose end > e
          while (lo_m < hi_m) {
            const int mid = (lo_m + hi_m) >> 1;
            if (m_end[mid] > e)
              hi_m = mid;
            else
              lo_m = mid + 1;
          }
          const int local = e - (lo_m ? m_end[lo_m - 1] : 0);
          a[u] = s.fn[m_off[lo_m] + local];
          col[u] = local % K;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (isfinite(a[u]) && f32_collides(tab + col[u] * T, mask, a[u]))
          found = true;
    }
    __syncthreads();
  }
  return found;
}

// Kernel 2: a block a weight group.  B_g and the padding from the members'
// counts, the float32 tie check, the route, every member's pick.
// `smem_bytes` is the dynamic shared memory for the tie tables.
template <int K>
__global__ void __launch_bounds__(kThreads)
pick_groups_kernel(const int* __restrict__ off, const int* __restrict__ gid,
                   const double* __restrict__ W, int* __restrict__ out,
                   Scratch s, int R, int smem_bytes,
                   long long ws_min_scores) {
  extern __shared__ __align__(16) unsigned long long tabs[];
  __shared__ long long stat[kWarps * 4];
  __shared__ int m_off[kThreads], m_end[kThreads];
  __shared__ int s_nm;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Set `tid`'s record, every load of it issued at once (sets past the
  // block's width are read again where they are needed).
  const bool in = tid < R;
  const int gt = in ? gid[tid] : -1;
  const int ot = in ? off[tid] : 0;
  const int nt = in ? off[tid + 1] - ot : 0;
  const int mk = in ? s.nk[tid] : 0;
  const int i32 = in ? s.i32[tid] : 0;
  const float v32 = in ? s.v32[tid] : 0.f;
  const int i64 = in ? s.i64[tid] : 0;
  const double v64 = in ? s.v64[tid] : 0.0;

  // R_g, B_g, N_g (kept values) and the rows of the sets before this
  // group's (its slice of the device tables).
  long long st[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int t = tid; t < R; t += kThreads) {
    const bool mine = t == tid;
    const int gx = mine ? gt : gid[t];
    if (gx == g) {
      const long long m = mine ? mk : s.nk[t];
      st[0] += 1;
      st[1] = max(st[1], m);
      st[2] += m;
    } else if (gx >= 0 && gx < g) {
      st[3] += mine ? nt : off[t + 1] - off[t];
    }
  }
#pragma unroll 1
  for (int d = 16; d > 0; d >>= 1) {
    st[1] = max(st[1], __shfl_xor_sync(kFull, st[1], d));
    st[0] += __shfl_xor_sync(kFull, st[0], d);
    st[2] += __shfl_xor_sync(kFull, st[2], d);
    st[3] += __shfl_xor_sync(kFull, st[3], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) stat[warp * 4 + u] = st[u];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u) st[u] = stat[u];
#pragma unroll 1
  for (int w = 1; w < kWarps; ++w) {
    st[0] += stat[w * 4];
    st[1] = max(st[1], stat[w * 4 + 1]);
    st[2] += stat[w * 4 + 2];
    st[3] += stat[w * 4 + 3];
  }
  const long long Rg = st[0], Bg = st[1], Ng = st[2];
  int route = 0;
  if (Rg > 0 && Rg * Bg >= ws_min_scores) {
    // One table a column of T >= 2 N_g + 1 slots (a power of two, at most
    // 4 N_g): in shared memory if it fits, else in this group's slice of
    // the device scratch (4 K slots a row of the group's sets).
    long long T = 4;
    while (T < 2 * Ng + 1) T <<= 1;
    const bool padded = Ng < Rg * Bg;
    const bool found =
        K * T * 8 <= smem_bytes
            ? group_ties<K, true>(tabs, T, padded, off, gid, s, R, g, gt, ot,
                                  mk, m_off, m_end, &s_nm)
            : group_ties<K, false>(s.tab + 4LL * K * st[3], T, padded, off,
                                   gid, s, R, g, gt, ot, mk, m_off, m_end,
                                   &s_nm);
    route = __syncthreads_or(found) ? 2 : 1;
  }
  double w64[K], pad64[K];
  float w32[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    w64[q] = W[g * K + q];
    w32[q] = __double2float_rn(w64[q]);
    pad64[q] = kPad;
  }
  const double p64 = score64<K>(w64, pad64);
  const float p32 = score32<K>(w32, pad64);
#pragma unroll 1
  for (int t = tid; t < R; t += kThreads) {
    const bool mine = t == tid;
    if ((mine ? gt : gid[t]) != g) continue;
    const bool pad = (mine ? mk : s.nk[t]) < Bg;
    int pick;
    if (route == 1) {
      pick = mine ? i32 : s.i32[t];
      if (pad && beats(p32, INT_MAX, mine ? v32 : s.v32[t], pick)) pick = -1;
    } else {
      pick = mine ? i64 : s.i64[t];
      if (pad && beats(p64, INT_MAX, mine ? v64 : s.v64[t], pick)) pick = -1;
    }
    out[t] = pick;
  }
  if (tid == 0) out[R + g] = route;
}

template <int K>
cudaError_t launch(const double* F, const int* off, const int* gid,
                   const double* W, int* out, const Scratch& s, int R, int G,
                   long long total, int max_n, long long kernel_min_n,
                   long long ws_min_scores, cudaStream_t stream) {
  const int most = static_cast<int>((kSetBudget - 16) / (8 * K + 1));
  const int cap = max_n < 1 ? 1 : (max_n < most ? max_n : most);
  const size_t smem = (static_cast<size_t>(cap) * K + 2) * 8 + cap;
  pick_sets_kernel<K><<<R, kThreads, smem, stream>>>(F, off, gid, W, out, s,
                                                     G, cap, kernel_min_n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // Tie tables for a group of `total` kept rows, within the budget.
  long long tables = 4;
  while (tables < 2 * total + 1) tables <<= 1;
  tables *= 8LL * K;
  const int tsmem =
      static_cast<int>(tables < kSetBudget ? tables : kSetBudget);
  pick_groups_kernel<K><<<G, kThreads, tsmem, stream>>>(
      off, gid, W, out, s, R, tsmem, ws_min_scores);
  return cudaGetLastError();
}

}  // namespace

// F: (total, k) float64, the round's sets one after another; off: (R + 1,)
// int32 row offsets (off[0] = 0, off[R] = total, every set nonempty); gid:
// (R,) int32 weight group of each set; W: (G, k) float64 group weights;
// out: (R + G,) int32, the picks then the groups' routes; scratch: at
// least total * (40k + 1) + 24R bytes (scratch_bytes), 8-byte aligned;
// all on the device.  max_n sizes the staging buffer (a larger set takes
// the tiled route).  Enqueues both kernels on `stream`; returns the first
// CUDA error, 0 if none.
extern "C" int runtime_pick_launch(const void* F, const void* off,
                                   const void* gid, const void* W, void* out,
                                   void* scratch, long long scratch_size,
                                   int R, int G, int k, long long total,
                                   int max_n, long long kernel_min_n,
                                   long long ws_min_scores, void* stream) {
  if (R <= 0) return 0;
  if (G <= 0 || total < R || total > INT_MAX ||
      scratch_size < scratch_bytes(R, k, total))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(scratch, R, k, total);
  const double* f = static_cast<const double*>(F);
  const int* o = static_cast<const int*>(off);
  const int* gi = static_cast<const int*>(gid);
  const double* w = static_cast<const double*>(W);
  int* p = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t (*fn)(const double*, const int*, const int*, const double*,
                    int*, const Scratch&, int, int, long long, int, long long,
                    long long, cudaStream_t);
  switch (k) {
    case 1: fn = launch<1>; break;
    case 2: fn = launch<2>; break;
    case 3: fn = launch<3>; break;
    case 4: fn = launch<4>; break;
    case 5: fn = launch<5>; break;
    case 6: fn = launch<6>; break;
    case 7: fn = launch<7>; break;
    case 8: fn = launch<8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = fn(f, o, gi, w, p, s, R, G, total, max_n,
                           kernel_min_n, ws_min_scores, st);
  return static_cast<int>(e);
}
