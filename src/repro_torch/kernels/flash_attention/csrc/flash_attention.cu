// Flash attention with grouped-query heads for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
// What it computes: for q (BH, Sq, D) and k, v (BH / group, Skv, D) in
// float32, bfloat16 or float16, o = softmax(q k^T / sqrt(D)) v per
// collapsed head b, which reads KV head b / group (nothing is repeated in
// memory).  With `causal`, query t sees keys <= t + Skv - Sq (the ends are
// aligned); keys >= Skv are masked.  Both products and the online softmax
// run in float32, as the Pallas kernel casts to float32 before both; the
// output is rounded once to the input dtype.  Masked scores are the
// finite -1e30 the Pallas kernel uses.
//
// What bounds it on this card: at the serving shape (B 4, Hq 32, Hkv 2,
// S 2048, D 128, causal, bf16) the two products are 137.5 GFLOP and the
// tensors 143 MB, so the work is bound by operations (0.139 ms at the
// 989 TFLOP/s bf16 tensor-core rate; 0.043 ms of memory at 3.35 TB/s).
//
// What the design does about it: this first version is simple and right,
// not fast.  It runs both products on the CUDA cores in float32 (FMA), so
// its ceiling is the 67 TFLOP/s float32 rate, about 2 ms at the serving
// shape, and the tensor cores stay idle.  One block of 256 threads owns 64
// query rows of one head; a loop inside the block walks the KV tiles of
// 64 keys in order (the Pallas grid's sequential axis), holding Q, the K
// and V tile and the score tile in shared memory as float32, the running
// max and denominator in shared memory and the output accumulator in
// registers (a 4 x D/16 patch per thread).  Tiles wholly above the causal
// diagonal are never loaded.  Blocks with the most causal work start
// first.  A design with wgmma and TMA (bf16 operands from shared memory,
// warp-specialised loads) is what reaches the bound; it is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16 threads; 8 warps
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Shared memory of one block, in floats: Q (BQ x DB+1), K (BK x DB+1),
// V (BK x DB), scores (BQ x BK+1), and per row the running max, the
// denominator and this tile's rescale factor.  The +1 strides keep the
// column walks of Q, K and the scores off a single bank.
template <int DB>
constexpr int smem_floats() {
  return kBQ * (DB + 1) + kBK * (DB + 1) + kBK * DB + kBQ * (kBK + 1) +
         3 * kBQ;
}

template <typename T, int DB>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int nq,
                       int Sq, int Skv, int D, int group, int causal,
                       float scale) {
  constexpr int DP = DB + 1;
  constexpr int SP = kBK + 1;
  constexpr int CJ = DB / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* S = Vs + kBK * DB;
  float* m_s = S + kBQ * SP;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kBQ;
  const int offset = Skv - Sq;
  const T* qb = q + static_cast<size_t>(bh) * Sq * D;
  const T* kb = k + static_cast<size_t>(bh / group) * Skv * D;
  const T* vb = v + static_cast<size_t>(bh / group) * Skv * D;

  for (int i = tid; i < kBQ * DB; i += kThreads) {
    const int r = i / DB;
    const int d = i % DB;
    const int qi = q0 + r;
    Qs[r * DP + d] =
        (qi < Sq && d < D) ? to_f32(qb[static_cast<size_t>(qi) * D + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  int nk = (Skv + kBK - 1) / kBK;
  if (causal) {
    // The last KV tile any real row of this block sees.
    const int last_key = min(q0 + kBQ - 1, Sq - 1) + offset;
    nk = min(nk, last_key / kBK + 1);
  }

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kBK * DB; i += kThreads) {
      const int r = i / DB;
      const int d = i % DB;
      const int kj = k0 + r;
      const bool in = kj < Skv && d < D;
      const size_t at = static_cast<size_t>(kj) * D + d;
      Ks[r * DP + d] = in ? to_f32(kb[at]) : 0.f;
      Vs[r * DB + d] = in ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    // Scores: rows ty + 16 i, keys tx + 16 c.
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DB; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const int kj = k0 + col;
          const bool masked = kj >= Skv || (causal && kj > q0 + r + offset);
          S[r * SP + col] = masked ? kNeg : s[i][c] * scale;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w + 7; a lane holds two keys.
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const float s0 = S[r * SP + lane];
      const float s1 = S[r * SP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_cur);
      const float p1 = expf(s1 - m_cur);
      S[r * SP + lane] = p0;
      S[r * SP + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns tx + 16 c.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = Vs[kk * DB + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  // l_s was last written before the final tile's P V barrier.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DB>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Skv, int D, int group, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<DB>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (Sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(nq) * BH;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_kernel<T, DB>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), nq, Sq, Skv, D, group,
          causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Skv, int D, int group, int causal,
                     float scale, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale, s);
  if (D <= 64) return launch<T, 64>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale, s);
  if (D <= 128) return launch<T, 128>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale, s);
  return launch<T, 256>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale, s);
}

}  // namespace

// q: (BH, Sq, D), k and v: (BH / group, Skv, D), o: (BH, Sq, D), all
// contiguous on the device in one dtype: 0 float32, 1 bfloat16, 2 float16.
// Needs 1 <= D <= 256, Sq, Skv >= 1, BH % group == 0 and, with `causal`,
// Sq <= Skv (every query sees at least one key).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Skv, int D, int group, int causal,
                                      float scale, int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 256 || group <= 0 ||
      BH % group != 0 || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, D, group, causal,
                                     scale, s);
    case 2:
      return launch_d<__half>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale,
                              s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
