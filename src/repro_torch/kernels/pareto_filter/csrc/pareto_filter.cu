// Pareto dominance filter for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/pareto_filter/kernel.py::pareto_filter_pallas.
//
// What it computes: for an (n, k <= 8) float32 minimisation array F and a
// validity vector, out[i] = valid[i] && no valid j has F[j] <= F[i] in every
// column and F[j] < F[i] in at least one.  Invalid rows neither dominate
// nor survive.
//
// What bounds it on this card: at the main-path shape (n = 256, k = 2) the
// work is about 2 KB read and some 65k pair tests (2 compares per column
// each), which the card finishes in well under a microsecond of memory or
// ALU time.  Latency bounds it there: the launch, and each thread's serial
// walk over the dominator rows with only n / 128 blocks in flight (about
// 24 us of device time on an H100 SXM at 700 W).  The pair tests grow as
// n^2, so at n in the thousands the compares would bound a kernel that
// spread the walk over more threads.
//
// What the design does about it: one launch per mask, no second pass and
// no atomics.  One block per tile of 128 candidate rows, one thread per
// row; each thread keeps its row in registers and scans the dominator rows
// tile by tile from shared memory (128 x k floats plus 128 validity bytes
// per tile).  A thread stops comparing once its row is dominated, and the
// whole block stops loading tiles once every row in it is settled.  The
// TPU kernel carried a dominated flag across sequential grid steps; here
// each thread owns its row, so blocks need no ordering between them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;

template <int K>
__global__ void __launch_bounds__(kTile)
pareto_filter_kernel(const float* __restrict__ F,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ out, int n) {
  __shared__ float fj[kTile * K];
  __shared__ uint8_t vj[kTile];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  float fi[K];
  bool vi = false;
  if (live) {
    vi = valid[i] != 0;
#pragma unroll
    for (int c = 0; c < K; ++c) fi[c] = F[i * K + c];
  }
  // A row that is invalid (or past the end) is settled from the start.
  bool settled = !vi;

  for (int j0 = 0; j0 < n; j0 += kTile) {
    // Barrier before overwriting the tile; also ends the scan early once
    // every row of the block is settled.
    if (__syncthreads_and(settled)) break;
    const int rows = min(kTile, n - j0);
    for (int t = threadIdx.x; t < rows * K; t += kTile)
      fj[t] = F[j0 * K + t];
    vj[threadIdx.x] = threadIdx.x < rows ? valid[j0 + threadIdx.x] : 0;
    __syncthreads();
    if (!settled) {
      for (int jj = 0; jj < rows; ++jj) {
        if (!vj[jj]) continue;
        bool le = true;
        bool lt = false;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float a = fj[jj * K + c];
          le = le && (a <= fi[c]);
          lt = lt || (a < fi[c]);
        }
        if (le && lt) {
          settled = true;
          vi = false;  // dominated
          break;
        }
      }
    }
  }
  if (live) out[i] = vi ? 1 : 0;
}

template <int K>
cudaError_t launch(const float* F, const uint8_t* valid, uint8_t* out, int n,
                   cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile);
  pareto_filter_kernel<K><<<grid, kTile, 0, stream>>>(F, valid, out, n);
  return cudaGetLastError();
}

}  // namespace

// F: (n, k) float32 row-major, valid: (n,) uint8 0/1, out: (n,) uint8 0/1,
// all on the device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int pareto_filter_launch(const void* F, const void* valid,
                                    void* out, int n, int k, void* stream) {
  if (n <= 0) return 0;
  const float* f = static_cast<const float*>(F);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(f, v, o, n, s);
    case 2: return launch<2>(f, v, o, n, s);
    case 3: return launch<3>(f, v, o, n, s);
    case 4: return launch<4>(f, v, o, n, s);
    case 5: return launch<5>(f, v, o, n, s);
    case 6: return launch<6>(f, v, o, n, s);
    case 7: return launch<7>(f, v, o, n, s);
    case 8: return launch<8>(f, v, o, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
