// Flash attention with grouped-query heads for Hopper (sm_90a): the body
// on the CUDA cores, and the C entry point that picks a body.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
// Two bodies compute the same function.  flash_attention_wgmma.cu runs
// both products on the tensor cores and takes bfloat16 and float16 with
// D <= 128: every model configuration of the repository.  This file's
// body takes what that one does not: float32 inputs (the tensor cores
// would round them to TF32, outside the reference test's float32
// tolerance of 2e-5) and 16-bit inputs with 128 < D <= 256.  The wrapper
// (ops.py::_body) chooses, and flash_attention_launch runs its choice or
// refuses the inputs; it never falls back to the other body.
//
// What this body computes: for q (BH, Sq, D) and k, v (BH / group, Skv,
// D) in float32, bfloat16 or float16, o = softmax(q k^T / sqrt(D)) v per
// collapsed head b, which reads KV head b / group (nothing is repeated in
// memory).  With `causal`, query t sees keys <= t + Skv - Sq (the ends are
// aligned); keys >= Skv are masked.  Both products and the online softmax
// run in float32, as the Pallas kernel casts to float32 before both; the
// output is rounded once to the input dtype.  Masked scores are the
// finite -1e30 the Pallas kernel uses.
//
// What bounds it on this card: float32 attention at the reference test
// shapes is bound by operations at the 67 TFLOP/s float32 rate of the
// CUDA cores.
//
// What the design does about it: it is simple and right, not fast.  One
// block of 256 threads owns 64 query rows of one head; a loop inside the
// block walks the KV tiles of 64 keys in order (the Pallas grid's
// sequential axis), holding Q, the K and V tile and the score tile in
// shared memory as float32, the running max and denominator in shared
// memory and the output accumulator in registers (a 4 x D/16 patch per
// thread).  Tiles wholly above the causal diagonal are never loaded.
// Blocks with the most causal work start first.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

// The tensor-core body (flash_attention_wgmma.cu): bfloat16 (dtype 1) or
// float16 (dtype 2) with D <= Dp <= 128, Dp % 8 == 0, strides as for
// flash_attention_launch; q, k and v 16-byte aligned with strides that are
// multiples of 8.
cudaError_t flash_attention_wgmma(const void* q, const void* k, const void* v,
                                  void* o, int B, int Hq, int Hkv, int Sq,
                                  int Skv, int D, int Dp,
                                  const long long* strides, int causal,
                                  float scale, int dtype, cudaStream_t stream);

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

// The CUDA-core body on contiguous (BH, S, D) tensors.
cudaError_t flash_attention_simt(const void* q, const void* k, const void* v,
                                 void* o, int BH, int Sq, int Skv, int D,
                                 int group, int causal, float scale, int dtype,
                                 cudaStream_t s) {
  if (D > 256) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, BH, Sq, Skv, D, group, causal, scale, s);
  // 16-bit inputs with D <= 128 take the tensor-core body.
  if (D <= 128) return cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16, 256>(q, k, v, o, BH, Sq, Skv, D, group,
                                      causal, scale, s);
  if (dtype == 2)
    return launch<__half, 256>(q, k, v, o, BH, Sq, Skv, D, group, causal,
                               scale, s);
  return cudaErrorInvalidValue;
}

// body: 0 the CUDA-core body above, 1 the tensor-core body
// (flash_attention_wgmma.cu).  q: (B, Hq, Sq, Dp), k and v: (B, Hkv, Skv,
// Dp), o: (B, Hq, Sq, D) on the device in one dtype (0 float32, 1
// bfloat16, 2 float16), each with D contiguous; `strides` holds the
// (batch, head, position) strides in elements of q, k, v and o (12
// values).  Dp is D, or for the tensor-core body D rounded up to a
// multiple of 8 with zeros in the added columns.  The CUDA-core body
// needs all four contiguous.  Needs Sq, Skv >= 1, Hq % Hkv == 0 and, with
// `causal`, Sq <= Skv (every query sees at least one key).  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// inputs the chosen body does not take.
extern "C" int flash_attention_launch(int body, const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D, int Dp,
                                      const long long* strides, int causal,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      D <= 0 || Dp < D || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1)
    return static_cast<int>(flash_attention_wgmma(q, k, v, o, B, Hq, Hkv, Sq,
                                                  Skv, D, Dp, strides, causal,
                                                  scale, dtype, s));
  if (body != 0 || Dp != D) return static_cast<int>(cudaErrorInvalidValue);
  // The CUDA-core body takes no strides: all four must be contiguous.
  const long long q_st[3] = {1LL * Hq * Sq * D, 1LL * Sq * D, D};
  const long long kv_st[3] = {1LL * Hkv * Skv * D, 1LL * Skv * D, D};
  const int sizes[2][3] = {{B, Hq, Sq}, {B, Hkv, Skv}};
  for (int t = 0; t < 4; ++t) {
    const long long* want = (t == 1 || t == 2) ? kv_st : q_st;
    const int* n = sizes[(t == 1 || t == 2) ? 1 : 0];
    for (int i = 0; i < 3; ++i)
      if (n[i] > 1 && strides[3 * t + i] != want[i])
        return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(flash_attention_simt(
      q, k, v, o, B * Hq, Sq, Skv, D, Hq / Hkv, causal, scale, dtype, s));
}
