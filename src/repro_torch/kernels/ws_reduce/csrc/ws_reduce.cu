// Weighted-sum bank reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/ws_reduce/kernel.py::ws_reduce_pallas.
//
// What it computes: for banks F (m, B, k <= 8) and weights W (nw, k), both
// float32 or both float64, the score s[w, i, b] = W[w] . F[i, b] in
// float32, and per (weight, bank) the least score vals[w, i] and its first index
// idx[w, i] (ties go to the lowest index, as jnp.argmin; a NaN score
// counts as the least, as jnp.argmin and torch.min treat it).  Each
// element of F is read in its own type, rounded to float32 and sanitised
// as torch.nan_to_num(F.to(float32), posinf=1e30) does it (NaN -> 0,
// +inf and float64 values above the float32 range -> 1e30, -inf and those
// below it -> -FLT_MAX); W is rounded to float32.  The reference wrapper
// does the same before its pallas_call (kernel.py:48), so no cast or
// sanitising pass runs before the launch.  The k products are rounded one
// by one and added left to right without fused multiply-adds, so the
// scores equal the plain PyTorch version's bit for bit.
//
// What bounds it on this card: each bank row is read once and each output
// written once, and a score costs 2k - 1 flops; at the shapes the port
// uses (m <= a few thousand banks, B <= 66, k = 2, nw <= 11) that is at
// most a few MB and a few Mflop, far under a microsecond of memory or ALU
// time, so the launch and the block's latency bound it.  k <= 8 is too
// thin for the tensor cores (the TPU kernel ran it as an MXU matmul padded
// to 128 x 128).
//
// What the design does about it: one warp per (bank, weight), up to four
// weights per block; the lanes stride over the bank's rows keeping their
// own best (value, index), and a shuffle reduction settles the warp's
// winner.  Nothing is padded: the kernel masks the ragged edge itself.
// The cast and the sanitising happen as each element is loaded, so the
// wrapper launches on the caller's float64 banks as they are.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;

// (va, ia) beats (vb, ib): NaN first, then the smaller value, then the
// lower index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  const bool na = isnan(va);
  const bool nb = isnan(vb);
  if (na != nb) return na;
  if (na) return ia < ib;
  return va < vb || (va == vb && ia < ib);
}

// x rounded to float32, then torch.nan_to_num(x, posinf=1e30): the
// rounding sends float64 values beyond the float32 range to +-inf first.
__device__ __forceinline__ float sanitize(float x) {
  if (isnan(x)) return 0.f;
  if (isinf(x)) return x > 0.f ? 1e30f : -FLT_MAX;
  return x;
}
__device__ __forceinline__ float sanitize(double x) {
  return sanitize(__double2float_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) {
  return __double2float_rn(x);
}

template <int K>
__device__ __forceinline__ float score(const float* w, const float* f) {
  float s = __fmul_rn(w[0], f[0]);
#pragma unroll
  for (int c = 1; c < K; ++c) s = __fadd_rn(s, __fmul_rn(w[c], f[c]));
  return s;
}

template <int K, typename TF>
__global__ void __launch_bounds__(kWarps * 32)
ws_reduce_kernel(const TF* __restrict__ F, const TF* __restrict__ W,
                 float* __restrict__ vals, int* __restrict__ idx, int m,
                 int B, int nw) {
  const int bank = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= nw) return;  // the whole warp leaves together
  float wk[K];
#pragma unroll
  for (int c = 0; c < K; ++c) wk[c] = to_f32(W[w * K + c]);
  const TF* f = F + static_cast<size_t>(bank) * B * K;
  float best = INFINITY;
  int bi = 0;
  for (int b = lane; b < B; b += 32) {
    float fb[K];
#pragma unroll
    for (int c = 0; c < K; ++c) fb[c] = sanitize(f[b * K + c]);
    const float s = score<K>(wk, fb);
    if (beats(s, b, best, bi)) {
      best = s;
      bi = b;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (beats(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    vals[w * m + bank] = best;
    idx[w * m + bank] = bi;
  }
}

template <int K, typename TF>
cudaError_t launch(const void* F, const void* W, float* vals, int* idx, int m,
                   int B, int nw, cudaStream_t stream) {
  const int warps = nw < kWarps ? nw : kWarps;
  const dim3 grid(m, (nw + warps - 1) / warps);
  ws_reduce_kernel<K, TF><<<grid, warps * 32, 0, stream>>>(
      static_cast<const TF*>(F), static_cast<const TF*>(W), vals, idx, m, B,
      nw);
  return cudaGetLastError();
}

template <typename TF>
cudaError_t launch_k(const void* F, const void* W, float* v, int* i, int m,
                     int B, int k, int nw, cudaStream_t s) {
  switch (k) {
    case 1: return launch<1, TF>(F, W, v, i, m, B, nw, s);
    case 2: return launch<2, TF>(F, W, v, i, m, B, nw, s);
    case 3: return launch<3, TF>(F, W, v, i, m, B, nw, s);
    case 4: return launch<4, TF>(F, W, v, i, m, B, nw, s);
    case 5: return launch<5, TF>(F, W, v, i, m, B, nw, s);
    case 6: return launch<6, TF>(F, W, v, i, m, B, nw, s);
    case 7: return launch<7, TF>(F, W, v, i, m, B, nw, s);
    case 8: return launch<8, TF>(F, W, v, i, m, B, nw, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// F: (m, B, k), W: (nw, k), both float32 (type 0) or both float64 (type
// 1); vals: (nw, m) float32, idx: (nw, m) int32; all row-major on the
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ws_reduce_launch(const void* F, const void* W, void* vals,
                                void* idx, int m, int B, int k, int nw,
                                int type, void* stream) {
  if (m <= 0) return 0;
  if (B <= 0 || nw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type) {
    case 0: return launch_k<float>(F, W, v, i, m, B, k, nw, s);
    case 1: return launch_k<double>(F, W, v, i, m, B, k, nw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
