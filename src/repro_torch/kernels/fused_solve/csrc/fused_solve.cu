// Fused HMOOC2 aggregation for Hopper (sm_90a): the bank's normalisation,
// the weighted-sum picks, the float64 gather and sum of the picked rows and
// the per-candidate dominance mask in one kernel, then the global Pareto
// filter (pareto_filter.cu, compiled into the same library) enqueued from
// the same C entry point, with no host work between the two launches.
//
// Replaces src/repro/kernels/fused_solve/ops.py::fused_ws_front, which the
// TPU ran as one jit composing the ws_reduce and pareto_filter Pallas
// kernels with XLA's gather, sum and mask (_fused_impl, _local_mask).
//
// What it computes, for candidate c of N (one block each):
//   Fn[c]       = the float32 scores: given by the caller (cast, then NaN
//                 to 0 and +-inf to +1e30 / -FLT_MAX, numpy's nan_to_num),
//                 or, when the caller passes none, the bank normalised per
//                 objective over the candidate's finite entries,
//                 (F - lo) / span with span = hi - lo if hi > lo else 1,
//                 non-finite entries 1e18, rounded to float32 and put
//                 through the same nan_to_num (bit-equal to the solver's
//                 float64 numpy normalisation followed by that cast);
//   jj[c, w, i] = first argmin_b of the float32 score W[w] . Fn[c, i, b]
//                 (products rounded one by one and added left to right, no
//                 fused multiply-adds; NaN counts as least, ties go to the
//                 lowest index: the ws_reduce kernel's rule);
//   P[c, w]     = sum over subQs i, left to right in float64, of the raw
//                 bank rows F_bank[c, i, jj[c, w, i]];
//   ok[c, w]    = every gathered value is finite;
//   valid[c, w] = ok[c, w] and no ok pick u of the same candidate
//                 dominates P[c, w] (float64 compares);
//   P32[c, w]   = P[c, w] rounded to float32, the global filter's input;
//   keep        = pareto_filter over all N * nw points of P32 under valid.
//
// What bounds it on this card: latency, not bytes or operations.  At the
// largest HMOOC2 bank (N = 126 candidates, m = 12 subQs, B = 48, k = 2,
// nw = 11) the kernel reads 1.16 MB of float64 bank once and makes about
// 0.3 Mflop: its bound is 0.37 us (bytes, chip_smoke.py's count).  It
// takes 6.5 us on an H100 80GB HBM3 at 700 W (12.8 us for the earlier
// kernel, which read its bank rows strided from device memory).  Per
// block, in clock cycles (of about 11,400, from clock64() stores after
// each barrier): the bank's copy and the min/max reduction 2,750; the
// scores 2,600 (1,200 of it the float64 divisions); the picks 3,600
// (1,300 of it the shuffle merges, stores and barrier); the gather, sums
// and local mask 2,000.  Each phase is a chain of dependent steps on one
// SM, with one block a candidate.
//
// What the design does about it:
// * A block stages its candidate's whole raw bank in shared memory (9.2 KB
//   at the largest HMOOC2 bank) with coalesced 16-byte cp.async copies, so
//   the normalisation, the scores, the picks, the sums and the local mask
//   read shared memory, and device memory is read once.  The weights are
//   read while the bank is in flight.
// * 256 threads a block, every phase spread over them.  The min/max
//   reduction runs over every thread, then warp shuffles.  A thread scores
//   kWC weights on each score row it loads.  Each (subQ, group of kWC
//   weights) item takes G lanes (a power of two, as many as fill the
//   block: 4 at the largest HMOOC2 bank); the lanes take every G-th row and
//   a shuffle tree merges their minima.  `beats` is a total order on
//   (value, index) pairs, so the tree returns the serial scan's index; it
//   is written without branches (branches there cost half the picks'
//   time).  The score rows are padded by two floats so that the subQs a
//   warp reads sit on other banks.  The picked rows are gathered a pick a
//   thread, summed a weight a thread from shared memory, and the local
//   mask tests a (pick, dominator) pair a thread.
// * A bank larger than the shared-memory budget streams through in tiles
//   of whole subQs (and, where one subQ's bank alone exceeds it, in chunks
//   of bank rows of that subQ, the running pick carried in shared memory).
//   The normalisation then reduces over device memory first, and a sum
//   reads its picked row from device memory where the chunk holding it has
//   gone.  Sums keep their left-to-right order across tiles.
// * No tensor cores: the work is k = 2 dot products and compares.  FP64 is
//   native on the H100, so the float64 half of the reference's precision
//   split stays float64.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// The segmented Pareto filter of pareto_filter.cu, linked into this library.
extern "C" int pareto_filter_launch(const void* F, const void* valid,
                                    void* out, int S, int n, int k,
                                    void* stream);

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a block aims at: the whole of the main path's banks fit
// well inside it, and no opt-in above the default 48 KB is needed.
constexpr size_t kSmemTarget = 48 * 1024;
constexpr int kMinChunkRows = 64;
constexpr int kWC = 4;  // weights a thread scores from each row it loads

// (va, ia) comes before (vb, ib): NaN first, then by value, ties (and
// NaN against NaN) by index.  Written without branches: the picks call it
// once per (row, weight), and a branch there costs more than the test.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  const bool na = isnan(va);
  const bool nb = isnan(vb);
  const bool first = ia < ib;
  return (na & (!nb | first)) |
         (!na & !nb & ((va < vb) | ((va == vb) & first)));
}

// numpy's nan_to_num(x, posinf=1e30) on float32.
__device__ __forceinline__ float sanitise(float x) {
  if (isnan(x)) return 0.f;
  if (isinf(x)) return x > 0.f ? 1e30f : -FLT_MAX;
  return x;
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

// Copies `cnt` doubles from `src` into shared memory and waits for them.
// `buf` is 16-byte aligned with one spare double; the copy starts at
// buf + 1 when `src` is not 16-byte aligned, so that every pair after the
// first element moves in one 16-byte copy.  Returns where it starts.
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

// Per-objective min and max over the finite entries of `rows` rows of K
// doubles, then lo[q] and span[q] for every q.
template <int K>
__device__ void normalisation(const double* src, int rows, double* red,
                              double* lo, double* span) {
  double mn[K], mx[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    mn[q] = INFINITY;
    mx[q] = -INFINITY;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const double x = src[static_cast<size_t>(r) * K + q];
      if (isfinite(x)) {
        mn[q] = x < mn[q] ? x : mn[q];
        mx[q] = x > mx[q] ? x : mx[q];
      }
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    for (int o = 16; o > 0; o >>= 1) {
      const double a = __shfl_xor_sync(kFull, mn[q], o);
      const double b = __shfl_xor_sync(kFull, mx[q], o);
      mn[q] = a < mn[q] ? a : mn[q];
      mx[q] = b > mx[q] ? b : mx[q];
    }
    if (lane == 0) {
      red[(warp * K + q) * 2] = mn[q];
      red[(warp * K + q) * 2 + 1] = mx[q];
    }
  }
  __syncthreads();
  // The warps' partial minima and maxima, reduced by warp 0.
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      double a = lane < kWarps ? red[(lane * K + q) * 2] : INFINITY;
      double b = lane < kWarps ? red[(lane * K + q) * 2 + 1] : -INFINITY;
      for (int o = 16; o > 0; o >>= 1) {
        const double x = __shfl_xor_sync(kFull, a, o);
        const double y = __shfl_xor_sync(kFull, b, o);
        a = x < a ? x : a;
        b = y > b ? y : b;
      }
      if (lane == 0) {
        lo[q] = a;
        span[q] = b > a ? __dsub_rn(b, a) : 1.0;
      }
    }
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
fused_ws_front_kernel(const float* __restrict__ Fn,
                      const double* __restrict__ Fb,
                      const double* __restrict__ W, int* __restrict__ jj,
                      double* __restrict__ P, float* __restrict__ P32,
                      uint8_t* __restrict__ valid, int m, int B, int nw,
                      int mt, int bc) {
  extern __shared__ __align__(16) double smem[];
  // Layout: bank tile (mt * bc * K doubles + 2 spare), the picked rows
  // (mt * nw, K), p_s (nw, K), the reduction's scratch (kWarps, K, 2), lo
  // (K), span (K); then the float32 score tile (mt rows of bc * K + 2: the
  // padding puts the rows of neighbouring subQs on other banks) and best
  // values (mt * nw); then best indices (mt * nw), ok flags (nw) and
  // dominated flags (nw) and the weights rounded to float32 (nw, K).
  // Pick p is subQ p / nw, weight p % nw: the threads of a warp read few
  // score rows, each as a broadcast.
  const int tile_elems = mt * bc * K;
  double* bank_buf = smem;
  double* g_s = bank_buf + tile_elems + 2;
  double* p_s = g_s + nw * mt * K;
  double* red = p_s + nw * K;
  double* lo = red + kWarps * K * 2;
  double* span = lo + K;
  float* score = reinterpret_cast<float*>(span + K);
  float* best_v = score + mt * (bc * K + 2);
  int* best_i = reinterpret_cast<int*>(best_v + nw * mt);
  int* ok_s = best_i + nw * mt;
  int* dom_s = ok_s + nw;
  float* w_s = reinterpret_cast<float*>(dom_s + nw);

  const int c = blockIdx.x;
  const size_t bank0 = static_cast<size_t>(c) * m * B * K;
  const double* Fc = Fb + bank0;
  const float* Fnc = Fn ? Fn + bank0 : nullptr;
  const bool whole = mt == m && bc == B;
  // Read before the first barrier, so its latency hides behind the bank's.
  for (int t = threadIdx.x; t < nw * K; t += kThreads)
    w_s[t] = __double2float_rn(W[t]);

  double* bank = nullptr;
  if (!Fn) {
    if (whole) {
      bank = stage(bank_buf, Fc, m * B * K);
      normalisation<K>(bank, m * B, red, lo, span);
    } else {
      normalisation<K>(Fc, m * B, red, lo, span);
    }
  }

  for (int i0 = 0; i0 < m; i0 += mt) {
    const int ni = min(mt, m - i0);
    const int groups = (nw + kWC - 1) / kWC;
    const int items = ni * groups;
    int G = 1;
    while (G < 32 && 2 * G * items <= kThreads) G *= 2;
    for (int b0 = 0; b0 < B; b0 += bc) {
      const int nb = min(bc, B - b0);
      const int cnt = ni * nb * K;
      const size_t off = (static_cast<size_t>(i0) * B + b0) * K;
      const int row = nb * K;      // a subQ's scores
      const int stride = row + 2;  // and their padded pitch
      if (!(whole && bank)) {
        __syncthreads();  // every warp is done with the previous tile
        bank = stage(bank_buf, Fc + off, cnt);
      }
      // Element e of the tile is score row ri = e / row, column rr; both
      // advance by a fixed step, so no division per element.
      const int step_i = kThreads / row;
      const int step_r = kThreads - step_i * row;
      int ri = threadIdx.x / row;
      int rr = threadIdx.x - ri * row;
#pragma unroll 4
      for (int e = threadIdx.x; e < cnt; e += kThreads) {
        float f;
        if (Fnc) {
          f = Fnc[off + e];
        } else {
          const double x = bank[e];
          const int q = rr % K;
          f = __double2float_rn(
              isfinite(x) ? __ddiv_rn(__dsub_rn(x, lo[q]), span[q]) : 1e18);
        }
        score[ri * stride + rr] = sanitise(f);
        rr += step_r;
        ri += step_i;
        if (rr >= row) {
          rr -= row;
          ++ri;
        }
      }
      __syncthreads();

      // Picks: a thread scores kWC weights on every row it loads.  Each
      // (subQ, group of kWC weights) item takes G lanes (a power of two,
      // as many as fill the block); the lanes scan every G-th row, keep a
      // running minimum a weight, and a shuffle tree merges the G lanes.
      // The loop bound is the same for every thread, so whole warps reach
      // each shuffle.
      for (int t0 = 0; t0 < items * G; t0 += kThreads) {
        const int slot = t0 + threadIdx.x;
        const int it = slot / G;
        const int g = slot - it * G;
        const int ii = it / groups;
        const int w0 = (it - ii * groups) * kWC;
        float bv[kWC];
        int bx[kWC];
#pragma unroll
        for (int u = 0; u < kWC; ++u) {
          bv[u] = INFINITY;
          bx[u] = INT_MAX;  // loses to every real (value, index) pair
        }
        if (it < items) {
          float wk[kWC][K];
#pragma unroll
          for (int u = 0; u < kWC; ++u)
#pragma unroll
            for (int q = 0; q < K; ++q)
              wk[u][q] = w0 + u < nw ? w_s[(w0 + u) * K + q] : 0.f;
          const float* f = score + static_cast<size_t>(ii) * stride;
          for (int b = g; b < nb; b += G) {
            float x[K];
#pragma unroll
            for (int q = 0; q < K; ++q) x[q] = f[b * K + q];
#pragma unroll
            for (int u = 0; u < kWC; ++u) {
              float s = __fmul_rn(wk[u][0], x[0]);
#pragma unroll
              for (int q = 1; q < K; ++q)
                s = __fadd_rn(s, __fmul_rn(wk[u][q], x[q]));
              if (beats(s, b0 + b, bv[u], bx[u])) {
                bv[u] = s;
                bx[u] = b0 + b;
              }
            }
          }
        }
        for (int o = 1; o < G; o <<= 1) {
#pragma unroll
          for (int u = 0; u < kWC; ++u) {
            const float v = __shfl_xor_sync(kFull, bv[u], o);
            const int i = __shfl_xor_sync(kFull, bx[u], o);
            if (beats(v, i, bv[u], bx[u])) {
              bv[u] = v;
              bx[u] = i;
            }
          }
        }
        if (it < items && g == 0) {
#pragma unroll
          for (int u = 0; u < kWC; ++u) {
            const int p = ii * nw + w0 + u;
            if (w0 + u < nw &&
                (b0 == 0 || beats(bv[u], bx[u], best_v[p], best_i[p]))) {
              best_v[p] = bv[u];
              best_i[p] = bx[u];
            }
          }
        }
      }
      __syncthreads();
    }

    // Gather the picked raw rows, a pick a thread.  The row is in the
    // staged tile unless the subQ was chunked (then only its last chunk is
    // staged, and the row comes from device memory).
    for (int p = threadIdx.x; p < nw * ni; p += kThreads) {
      const int ii = p / nw;
      const int w = p - ii * nw;
      const int j = best_i[p];
      jj[(static_cast<size_t>(c) * nw + w) * m + i0 + ii] = j;
      const double* g = bc == B
                            ? bank + (static_cast<size_t>(ii) * B + j) * K
                            : Fc + (static_cast<size_t>(i0 + ii) * B + j) * K;
#pragma unroll
      for (int q = 0; q < K; ++q) g_s[p * K + q] = g[q];
    }
    __syncthreads();
    // Sum in float64, left to right over subQs: a weight a thread.
    for (int w = threadIdx.x; w < nw; w += kThreads) {
      double s[K];
      bool ok = i0 == 0 || ok_s[w] != 0;
#pragma unroll
      for (int q = 0; q < K; ++q) s[q] = i0 == 0 ? 0.0 : p_s[w * K + q];
#pragma unroll 4
      for (int ii = 0; ii < ni; ++ii) {
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const double x = g_s[(ii * nw + w) * K + q];
          ok = ok && isfinite(x);
          s[q] = i0 + ii == 0 ? x : __dadd_rn(s[q], x);
        }
      }
#pragma unroll
      for (int q = 0; q < K; ++q) p_s[w * K + q] = s[q];
      ok_s[w] = ok ? 1 : 0;
      dom_s[w] = 0;
    }
  }
  __syncthreads();

  // Per-candidate non-dominated mask over the nw picks, in float64: a
  // (pick w, dominator u) pair a thread.
  for (int t = threadIdx.x; t < nw * nw; t += kThreads) {
    const int w = t / nw;
    const int u = t - w * nw;
    if (!ok_s[u] || !ok_s[w]) continue;
    bool le = true;
    bool lt = false;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const double a = p_s[u * K + q];
      const double b = p_s[w * K + q];
      le = le && (a <= b);
      lt = lt || (a < b);
    }
    if (le && lt) dom_s[w] = 1;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    const size_t o = (static_cast<size_t>(c) * nw + w) * K;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      P[o + q] = p_s[w * K + q];
      P32[o + q] = static_cast<float>(p_s[w * K + q]);
    }
    valid[static_cast<size_t>(c) * nw + w] = ok_s[w] && !dom_s[w];
  }
}

// Shared memory for tiles of `mt` subQs by `bc` bank rows.
size_t smem_bytes(int K, int nw, long long mt, long long bc) {
  const long long tile = mt * bc * K;
  return static_cast<size_t>(
      (tile + 2 + nw * mt * K + nw * K + kWarps * K * 2 + 2 * K) * 8 +
      (tile + 2 * mt + nw * mt) * 4 + (nw * mt + 2 * nw) * 4 + nw * K * 4);
}

template <int K>
cudaError_t launch(const float* Fn, const double* Fb, const double* W,
                   int* jj, double* P, float* P32, uint8_t* valid, int N,
                   int m, int B, int nw, cudaStream_t stream) {
  // Whole subQs a tile while one fits the target, else one subQ in chunks
  // of bank rows (at least kMinChunkRows; the block then asks for more
  // than the target).
  int mt = m;
  int bc = B;
  while (mt > 1 && smem_bytes(K, nw, mt, B) > kSmemTarget) mt = (mt + 1) / 2;
  if (smem_bytes(K, nw, mt, B) > kSmemTarget) {
    while (bc > kMinChunkRows && smem_bytes(K, nw, 1, bc) > kSmemTarget)
      bc = (bc + 1) / 2;
  }
  const size_t smem = smem_bytes(K, nw, mt, bc);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ws_front_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_ws_front_kernel<K><<<N, kThreads, smem, stream>>>(
      Fn, Fb, W, jj, P, P32, valid, m, B, nw, mt, bc);
  return cudaGetLastError();
}

}  // namespace

// Fn: (N, m, B, k) float32 or null (normalise in the kernel), Fb: (N, m,
// B, k) float64, W: (nw, k) float64 (rounded to float32 in the kernel, as
// the reference casts it); outputs jj: (N, nw, m) int32, P: (N, nw, k)
// float64, P32: (N, nw, k) float32 and valid: (N, nw) uint8 0/1 (the
// global filter's inputs), keep: (N, nw) uint8 0/1; all row-major on the
// device.  Enqueues the fused kernel and then the global filter on
// `stream` and returns the first CUDA error, 0 if none.
extern "C" int fused_ws_front_launch(const void* Fn, const void* Fb,
                                     const void* W, void* jj, void* P,
                                     void* P32, void* valid, void* keep,
                                     int N, int m, int B, int k, int nw,
                                     void* stream) {
  if (N <= 0) return 0;
  if (m <= 0 || B <= 0 || nw <= 0 ||
      static_cast<long long>(N) * nw > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fn = static_cast<const float*>(Fn);
  const double* fb = static_cast<const double*>(Fb);
  const double* w = static_cast<const double*>(W);
  int* j = static_cast<int*>(jj);
  double* p = static_cast<double*>(P);
  float* p32 = static_cast<float*>(P32);
  uint8_t* v = static_cast<uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (k) {
    case 1: e = launch<1>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 2: e = launch<2>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 3: e = launch<3>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 4: e = launch<4>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 5: e = launch<5>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 6: e = launch<6>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 7: e = launch<7>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    case 8: e = launch<8>(fn, fb, w, j, p, p32, v, N, m, B, nw, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return pareto_filter_launch(p32, v, keep, 1, N * nw, k, stream);
}
