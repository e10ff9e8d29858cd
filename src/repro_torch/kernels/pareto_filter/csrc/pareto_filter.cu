// Segmented Pareto dominance filter for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/pareto_filter/kernel.py::pareto_filter_pallas.
//
// What it computes: for S independent segments of an (S, n, k <= 8)
// float32 minimisation array F and an (S, n) validity array,
// out[s, i] = valid[s, i] && no valid j of segment s has F[s, j] <= F[s, i]
// in every column and F[s, j] < F[s, i] in at least one.  Invalid rows
// neither dominate nor survive, so a ragged batch is padded with invalid
// rows.  One segment (S = 1) is the single-mask filter.
//
// What bounds it on this card: bytes, at the main path's shapes.  A phase of
// Algorithm 1 filters 50-120 banks of (256, 2): about 2 KB read per bank
// and some 65k pair tests of 2k compares each, well under a microsecond of
// memory or ALU time for the whole phase.  What a kernel can lose is
// latency: a serial chain of dependent compares per row, too few blocks to
// fill 132 SMs, and loads that wait between barriers.  The pair tests grow
// as n^2, so at n in the thousands (K3's global filter, (4096, k)) the
// compares and the re-reads of the dominator rows from L2 take over.
//
// What the design does about it:
// * The grid runs over (segment, group of rows), so a phase's banks fill the
//   card in one launch.  The row groups are sized on the host so that
//   about 16 warps of work land on each SM.
// * A warp tests one row at a time.  Its lanes take the dominators
//   j = lane, lane + 32, ...: one a lane in the first step (where most
//   dominated rows meet a dominator), then four at a time with their loads
//   issued together.  After each step `__any_sync` ends the row's scan
//   once any lane found a dominator.  The serial chain per row is about
//   n / 128 steps instead of n, and the warp owns the row: no atomics, no
//   second pass.  A warp keeps the rows still alive as a bit mask.
// * The dominator rows pass through shared memory in tiles of about 8 KB
//   (256 rows at k = 8, 1,024 at k = 2), copied with 16-byte `cp.async`.
//   A segment that fits one tile (every bank of the main path, 256 rows)
//   is loaded once.  Longer segments stream through a two-stage ring: the
//   copy of tile t + 1 is in flight while tile t is tested, and a tile
//   holds enough rows that testing it takes longer than the copy.  The
//   validity bytes of tile t + 1 are loaded into registers at the same
//   time and stored beside it before the barrier.
// * The block stops streaming once none of its rows is alive
//   (`__syncthreads_and` at the top of each tile).
// * No tensor cores: the work is compares, not products.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 32;      // one bit each of a warp's mask
constexpr int kUnroll = 4;               // dominators a lane tests per vote
constexpr int kTargetWarps = 132 * 16;   // rows in flight to fill the card
constexpr unsigned kFull = 0xffffffffu;

// Dominator rows per stage: about 8 KB, a multiple of the block, at least
// 256 rows.
__host__ __device__ constexpr int tile_rows(int k) {
  return (2048 / k) / kThreads * kThreads < 256
             ? 256
             : (2048 / k) / kThreads * kThreads;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of `cnt` floats from `src` to the 16-byte aligned `dst`:
// 16 bytes a copy when `src` is 16-byte aligned too (every tile of a
// contiguous segment whose row count times k is a multiple of 4), else 4.
__device__ __forceinline__ void copy_tile_async(float* dst, const float* src,
                                                int cnt) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = cnt >> 2;
    for (int t = threadIdx.x; t < n4; t += kThreads)
      cp_async16(dst + 4 * t, src + 4 * t);
    done = n4 << 2;
  }
  for (int t = done + threadIdx.x; t < cnt; t += kThreads)
    cp_async4(dst + t, src + t);
}

template <int V>
__device__ __forceinline__ void load_valid(uint8_t (&v)[V], const uint8_t* vs,
                                           int j0, int n) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int j = j0 + threadIdx.x + u * kThreads;
    v[u] = j < n ? vs[j] : 0;
  }
}

// Row j of a tile into registers: float4 loads when k is a multiple of 4
// (lanes 32 bytes apart, so at k = 8 a quarter-warp meets 2-way bank
// conflicts instead of the 8-way of scalar loads), float2 when even.
template <int K>
__device__ __forceinline__ void load_row(float (&b)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      b[c] = x.x;
      b[c + 1] = x.y;
      b[c + 2] = x.z;
      b[c + 3] = x.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      b[c] = x.x;
      b[c + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) b[c] = p[c];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
pareto_filter_kernel(const float* __restrict__ F,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ out, int n, int rows_per_warp,
                     int blocks_per_seg) {
  constexpr int kTile = tile_rows(K);
  constexpr int kValidPerThread = kTile / kThreads;
  __shared__ __align__(16) float fj[2][kTile * K];
  __shared__ uint8_t vj[2][kTile];
  __shared__ float fi[kWarps * kMaxRowsPerWarp * K];

  const int seg = blockIdx.x / blocks_per_seg;
  const int rows_per_block = kWarps * rows_per_warp;
  const int row0 = (blockIdx.x % blocks_per_seg) * rows_per_block;
  const size_t base = static_cast<size_t>(seg) * n;
  const float* Fs = F + base * K;
  const uint8_t* vs = valid + base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // The block's rows, local index q * kWarps + warp for the warp's q-th row.
  for (int t = threadIdx.x; t < rows_per_block * K; t += kThreads) {
    const int r = row0 + t / K;
    fi[t] = r < n ? Fs[static_cast<size_t>(r) * K + t % K] : 0.f;
  }
  // Bit q: the warp's q-th row is valid and not yet dominated.
  const int my_row = row0 + lane * kWarps + warp;
  uint32_t alive = __ballot_sync(
      kFull, lane < rows_per_warp && my_row < n && vs[my_row] != 0);

  const int ntiles = (n + kTile - 1) / kTile;
  uint8_t vcur[kValidPerThread], vnxt[kValidPerThread] = {};
  copy_tile_async(fj[0], Fs, min(kTile, n) * K);
  cp_async_commit();
  load_valid(vcur, vs, 0, n);
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    // Every warp is done with the stage refilled below (tile t - 1's), and
    // the block stops once none of its rows is alive.
    if (__syncthreads_and(alive == 0)) break;
    const int j0 = t * kTile;
    if (t + 1 < ntiles) {
      const int j1 = j0 + kTile;
      copy_tile_async(fj[stage ^ 1], Fs + static_cast<size_t>(j1) * K,
                      min(kTile, n - j1) * K);
      load_valid(vnxt, vs, j1, n);
    }
    cp_async_commit();  // empty on the last tile: keeps the count uniform
#pragma unroll
    for (int u = 0; u < kValidPerThread; ++u)
      vj[stage][threadIdx.x + u * kThreads] = vcur[u];
    cp_async_wait<1>();  // tile t has landed; tile t + 1 may be in flight
    __syncthreads();

    const int rows = min(kTile, n - j0);
    const float* tile = fj[stage];
    const uint8_t* tv = vj[stage];
    uint32_t todo = alive;
    while (todo) {
      const int q = __ffs(todo) - 1;
      todo &= todo - 1;
      float a[K];
#pragma unroll
      for (int c = 0; c < K; ++c) a[c] = fi[(q * kWarps + warp) * K + c];
      // Does row j of the tile dominate row q?  A j past the tile reads
      // row 0 and is ignored, so the loads need no branch.
      auto dominates = [&](int j) {
        const int jr = j < rows ? j : 0;
        float b[K];
        load_row<K>(b, tile + jr * K);
        bool le = j < rows && tv[jr];
        bool lt = false;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          le = le && (b[c] <= a[c]);
          lt = lt || (b[c] < a[c]);
        }
        return le && lt;
      };
      // Most dominated rows meet a dominator among the first 32: one test a
      // lane there, then kUnroll a vote with their loads issued together.
      bool dom = __any_sync(kFull, dominates(lane));
      for (int jb = 32; !dom && jb < rows; jb += 32 * kUnroll) {
        bool d = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) d |= dominates(jb + u * 32 + lane);
        dom = __any_sync(kFull, d);
      }
      if (dom) alive &= ~(1u << q);
    }
#pragma unroll
    for (int u = 0; u < kValidPerThread; ++u) vcur[u] = vnxt[u];
  }
  cp_async_wait<0>();
  if (lane < rows_per_warp && my_row < n)
    out[base + my_row] = (alive >> lane) & 1u;
}

template <int K>
cudaError_t launch(const float* F, const uint8_t* valid, uint8_t* out, int S,
                   int n, cudaStream_t stream) {
  const long long rows = static_cast<long long>(S) * n;
  long long rpw = (rows + kTargetWarps - 1) / kTargetWarps;
  rpw = rpw < 1 ? 1 : (rpw > kMaxRowsPerWarp ? kMaxRowsPerWarp : rpw);
  const int rows_per_block = kWarps * static_cast<int>(rpw);
  const int blocks_per_seg = (n + rows_per_block - 1) / rows_per_block;
  const long long blocks = static_cast<long long>(S) * blocks_per_seg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  pareto_filter_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(F, valid, out, n,
                                      static_cast<int>(rpw), blocks_per_seg);
  return cudaGetLastError();
}

}  // namespace

// F: (S, n, k) float32 row-major, valid: (S, n) uint8 0/1, out: (S, n)
// uint8 0/1, all contiguous on the device.  Launches once on `stream` and
// returns cudaGetLastError().
extern "C" int pareto_filter_launch(const void* F, const void* valid,
                                    void* out, int S, int n, int k,
                                    void* stream) {
  if (S <= 0 || n <= 0) return 0;
  const float* f = static_cast<const float*>(F);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(f, v, o, S, n, s);
    case 2: return launch<2>(f, v, o, S, n, s);
    case 3: return launch<3>(f, v, o, S, n, s);
    case 4: return launch<4>(f, v, o, S, n, s);
    case 5: return launch<5>(f, v, o, S, n, s);
    case 6: return launch<6>(f, v, o, S, n, s);
    case 7: return launch<7>(f, v, o, S, n, s);
    case 8: return launch<8>(f, v, o, S, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
