// Fused HMOOC2 aggregation for Hopper (sm_90a): weighted-sum picks, the
// float64 gather and sum of the picked rows, and the per-candidate
// dominance mask, in one kernel.  The wrapper (ops.py) follows it with a
// launch of the pareto_filter kernel on the same stream, with no host sync
// between them.
//
// Replaces src/repro/kernels/fused_solve/ops.py::fused_ws_front, which the
// TPU ran as one jit composing the ws_reduce and pareto_filter Pallas
// kernels with XLA's gather, sum and mask (_fused_impl, _local_mask).
//
// What it computes, for candidate c of N (one block each):
//   jj[c, w, i] = first argmin_b of the float32 score W[w] . Fn[c, i, b]
//                 (products rounded one by one and added left to right, no
//                 fused multiply-adds; NaN counts as least, ties go to the
//                 lowest index: the ws_reduce kernel's rule);
//   P[c, w]     = sum over subQs i, left to right in float64, of the raw
//                 bank rows F_bank[c, i, jj[c, w, i]];
//   ok[c, w]    = every gathered value is finite;
//   valid[c, w] = ok[c, w] and no ok pick u of the same candidate
//                 dominates P[c, w] (float64 compares);
//   P32[c, w]   = P[c, w] rounded to float32, the global filter's input.
//
// What bounds it on this card: each candidate reads its m x B score rows
// (float32) and only the m x nw picked raw rows (float64), and writes
// nw x (m + 3k) values.  At the HMOOC2 shape (N = 128 candidates, m <= 32
// subQs, B <= 48, k = 2, nw = 11) that is well under a MB and a few Mflop:
// the launch and each thread's serial walk over its bank bound it, not
// bytes or flops.
//
// What the design does about it: one block per candidate keeps every
// intermediate (picks, sums, validity) in shared memory, so nothing but
// the outputs touches device memory and no second pass is needed.  Each
// thread owns (weight, subQ) pairs for the picks, then one weight row each
// for the sum and the mask, which need all of a candidate's picks: the two
// steps are separated by a block barrier.  FP64 is native on the H100, so
// the float64 half of the reference's precision split stays float64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  const bool na = isnan(va);
  const bool nb = isnan(vb);
  if (na != nb) return na;
  if (na) return ia < ib;
  return va < vb || (va == vb && ia < ib);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
fused_ws_front_kernel(const float* __restrict__ Fn,
                      const double* __restrict__ Fb,
                      const float* __restrict__ W, int* __restrict__ jj,
                      double* __restrict__ P, float* __restrict__ P32,
                      uint8_t* __restrict__ valid, int m, int B, int nw) {
  extern __shared__ double smem[];
  double* p_s = smem;                                   // (nw, K)
  int* jj_s = reinterpret_cast<int*>(p_s + nw * K);     // (nw, m)
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(jj_s + nw * m);  // (nw,)

  const int c = blockIdx.x;
  const size_t bank0 = static_cast<size_t>(c) * m * B;  // first row of c

  // Picks: one (weight, subQ) pair per thread, a serial scan of the bank.
  for (int t = threadIdx.x; t < nw * m; t += blockDim.x) {
    const int w = t / m;
    const int i = t - w * m;
    float wk[K];
#pragma unroll
    for (int q = 0; q < K; ++q) wk[q] = W[w * K + q];
    const float* f = Fn + (bank0 + static_cast<size_t>(i) * B) * K;
    float best = INFINITY;
    int bi = 0;
    for (int b = 0; b < B; ++b) {
      float s = __fmul_rn(wk[0], f[b * K]);
#pragma unroll
      for (int q = 1; q < K; ++q)
        s = __fadd_rn(s, __fmul_rn(wk[q], f[b * K + q]));
      if (beats(s, b, best, bi)) {
        best = s;
        bi = b;
      }
    }
    jj_s[t] = bi;
    jj[static_cast<size_t>(c) * nw * m + t] = bi;
  }
  __syncthreads();

  // Gather and sum in float64: one weight row per thread.
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    double s[K];
    bool ok = true;
    const double* g0 = Fb + (bank0 + jj_s[w * m]) * K;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      s[q] = g0[q];
      ok = ok && isfinite(s[q]);
    }
    for (int i = 1; i < m; ++i) {
      const double* g =
          Fb + (bank0 + static_cast<size_t>(i) * B + jj_s[w * m + i]) * K;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        ok = ok && isfinite(g[q]);
        s[q] = __dadd_rn(s[q], g[q]);
      }
    }
    const size_t o = (static_cast<size_t>(c) * nw + w) * K;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      p_s[w * K + q] = s[q];
      P[o + q] = s[q];
      P32[o + q] = static_cast<float>(s[q]);
    }
    ok_s[w] = ok ? 1 : 0;
  }
  __syncthreads();

  // Per-candidate non-dominated mask over the nw picks, in float64.
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    bool keep = ok_s[w] != 0;
    for (int u = 0; keep && u < nw; ++u) {
      if (!ok_s[u]) continue;
      bool le = true;
      bool lt = false;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const double a = p_s[u * K + q];
        const double b = p_s[w * K + q];
        le = le && (a <= b);
        lt = lt || (a < b);
      }
      keep = !(le && lt);
    }
    valid[static_cast<size_t>(c) * nw + w] = keep ? 1 : 0;
  }
}

template <int K>
cudaError_t launch(const float* Fn, const double* Fb, const float* W, int* jj,
                   double* P, float* P32, uint8_t* valid, int N, int m, int B,
                   int nw, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nw) * K * sizeof(double) +
                      static_cast<size_t>(nw) * m * sizeof(int) + nw;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ws_front_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_ws_front_kernel<K><<<N, kThreads, smem, stream>>>(
      Fn, Fb, W, jj, P, P32, valid, m, B, nw);
  return cudaGetLastError();
}

}  // namespace

// Fn: (N, m, B, k) float32, Fb: (N, m, B, k) float64, W: (nw, k) float32;
// outputs jj: (N, nw, m) int32, P: (N, nw, k) float64, P32: (N, nw, k)
// float32, valid: (N, nw) uint8 0/1; all row-major on the device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int fused_ws_front_launch(const void* Fn, const void* Fb,
                                     const void* W, void* jj, void* P,
                                     void* P32, void* valid, int N, int m,
                                     int B, int k, int nw, void* stream) {
  if (N <= 0) return 0;
  if (m <= 0 || B <= 0 || nw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fn = static_cast<const float*>(Fn);
  const double* fb = static_cast<const double*>(Fb);
  const float* w = static_cast<const float*>(W);
  int* j = static_cast<int*>(jj);
  double* p = static_cast<double*>(P);
  float* p32 = static_cast<float*>(P32);
  uint8_t* v = static_cast<uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 2: return launch<2>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 3: return launch<3>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 4: return launch<4>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 5: return launch<5>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 6: return launch<6>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 7: return launch<7>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    case 8: return launch<8>(fn, fb, w, j, p, p32, v, N, m, B, nw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
