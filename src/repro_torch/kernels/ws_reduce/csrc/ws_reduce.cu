// Weighted-sum bank reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/ws_reduce/kernel.py::ws_reduce_pallas.
//
// What it computes: for float32 banks F (m, B, k <= 8) and weights
// W (nw, k), the score s[w, i, b] = W[w] . F[i, b] in float32, and per
// (weight, bank) the least score vals[w, i] and its first index idx[w, i]
// (ties go to the lowest index, as jnp.argmin; a NaN score counts as the
// least, as jnp.argmin and torch.min treat it).  The k products are
// rounded one by one and added left to right without fused multiply-adds,
// so the scores equal the plain PyTorch version's bit for bit.
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
#include <cuda_runtime.h>
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

template <int K>
__device__ __forceinline__ float score(const float* w, const float* f) {
  float s = __fmul_rn(w[0], f[0]);
#pragma unroll
  for (int c = 1; c < K; ++c) s = __fadd_rn(s, __fmul_rn(w[c], f[c]));
  return s;
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
ws_reduce_kernel(const float* __restrict__ F, const float* __restrict__ W,
                 float* __restrict__ vals, int* __restrict__ idx, int m,
                 int B, int nw) {
  const int bank = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= nw) return;  // the whole warp leaves together
  float wk[K];
#pragma unroll
  for (int c = 0; c < K; ++c) wk[c] = W[w * K + c];
  const float* f = F + static_cast<size_t>(bank) * B * K;
  float best = INFINITY;
  int bi = 0;
  for (int b = lane; b < B; b += 32) {
    float fb[K];
#pragma unroll
    for (int c = 0; c < K; ++c) fb[c] = f[b * K + c];
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

template <int K>
cudaError_t launch(const float* F, const float* W, float* vals, int* idx,
                   int m, int B, int nw, cudaStream_t stream) {
  const int warps = nw < kWarps ? nw : kWarps;
  const dim3 grid(m, (nw + warps - 1) / warps);
  ws_reduce_kernel<K><<<grid, warps * 32, 0, stream>>>(F, W, vals, idx, m, B,
                                                       nw);
  return cudaGetLastError();
}

}  // namespace

// F: (m, B, k) float32, W: (nw, k) float32, vals: (nw, m) float32,
// idx: (nw, m) int32, all row-major on the device.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int ws_reduce_launch(const void* F, const void* W, void* vals,
                                void* idx, int m, int B, int k, int nw,
                                void* stream) {
  if (m <= 0) return 0;
  if (B <= 0 || nw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(F);
  const float* w = static_cast<const float*>(W);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(f, w, v, i, m, B, nw, s);
    case 2: return launch<2>(f, w, v, i, m, B, nw, s);
    case 3: return launch<3>(f, w, v, i, m, B, nw, s);
    case 4: return launch<4>(f, w, v, i, m, B, nw, s);
    case 5: return launch<5>(f, w, v, i, m, B, nw, s);
    case 6: return launch<6>(f, w, v, i, m, B, nw, s);
    case 7: return launch<7>(f, w, v, i, m, B, nw, s);
    case 8: return launch<8>(f, w, v, i, m, B, nw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
