// Flash attention on Hopper's tensor cores (sm_90a): the body for bfloat16
// and float16 inputs with head dim D <= 128.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
// What it computes: for q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), each
// with its own strides over (batch, head, position) and D contiguous,
// o = softmax(q k^T / sqrt(D)) v per query head h, which reads KV head
// h / (Hq / Hkv) (nothing is repeated in memory).  With `causal`, query t
// sees keys <= t + Skv - Sq (the ends are aligned); keys >= Skv are
// masked with the finite -1e30 the Pallas kernel uses.  Both products
// accumulate in float32 and the online softmax runs in float32, as in the
// Pallas kernel; the probabilities enter the second product as a high and
// a low part in the input type (P = hi + lo to about 2^-17 relative, so
// the product keeps float32 P as the Pallas kernel does), and the output
// is rounded once to the input type.
//
// What bounds it on this card: at the serving shape (B 4, Hq 32, Hkv 2,
// S 2048, D 128, causal, bf16) the two products are 137.5 GFLOP, 0.139 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against 143 MB of tensors,
// 0.043 ms at 3.35 TB/s: the work is bound by operations, and only
// warpgroup MMAs (wgmma) reach that rate.
//
// What the design does about it:
// * One block of three warpgroups owns 128 query rows of one query head.
//   Warpgroups 0 and 1 each own 64 rows and run both products as wgmma
//   with float32 accumulators in registers; warpgroup 2 hands its
//   registers to them (setmaxnreg: 24 a thread for it, 240 for them) and
//   one of its threads issues every load.
// * Loads are TMA copies (cp.async.bulk.tensor) that complete on mbarriers.
//   The tensor maps are built on the host per call and read the tensors
//   in place through their strides, so q, k and v as the model's layers
//   hand them over (transposed views of (B, S, H, D)) need no copy.  The
//   copies use the 128-byte swizzle that wgmma reads without bank
//   conflicts; D is cut into 64-column (128-byte) blocks, and a narrower D
//   is zero-filled to 64 by the copy itself.
// * Q (128 x DB) stays in shared memory; K and V tiles of 128 keys run
//   through a ring as deep as shared memory allows, so loads run ahead of
//   the products: 3 stages at D = 128 (32 KB + 3 x 64 KB = 224 KB), 4 at
//   D = 64 (a 2-stage ring kept the tensor cores waiting on loads).
// * S = Q K^T reads both operands from shared memory (K-major).  The
//   online softmax runs on the accumulator registers: a row's max and sum
//   combine over the four lanes that hold it, the accumulator is rescaled
//   by exp(m_prev - m_cur), and each probability is one FFMA and one ex2
//   in log2 units.
// * O += P V takes P from registers (the S accumulator layout is the A
//   operand layout of the next wgmma, packed to 16 bits) and V from shared
//   memory as an MN-major operand (the transpose bit of 16-bit types).
//   P rounded to 16 bits alone would move each probability by up to 2^-9
//   (bf16), which shows in the logits of a 40-layer model; so P is split
//   into hi = T(P) and lo = T(P - hi) and both are multiplied by the same
//   V tile: half as much tensor-core work again, for float32 P.
// * The tensor cores are kept busy two ways (FlashAttention-3's
//   schedule): a warpgroup issues S for tile j together with P V for tile
//   j - 1 and runs tile j's softmax while that product is in flight; and
//   the two warpgroups take turns to issue (named barriers), so one's
//   softmax runs beside the other's products.
// * Key tiles wholly above the causal diagonal are never loaded, only
//   tiles that straddle it or the end of the keys are masked, and the
//   query tiles with the most keys start first.
// * The epilogue multiplies by 1 / max(l, 1e-30), rounds once to T and
//   stores through registers into o's strides.
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kBK = 128;       // keys per K/V tile
constexpr int kThreads = 384;  // warpgroups 0, 1 compute; 2 loads
constexpr int kRowBytes = 128; // one swizzled row: 64 16-bit values
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes, for head-dim bucket DB (64 or
// 128): Q, then K of each stage, then V of each stage.  A tile of R rows
// is DB / 64 column blocks of R x 128 bytes, each swizzled in 1024-byte
// atoms of 8 rows, so every block starts 1024-byte aligned.
template <int DB>
struct Layout {
  // K/V ring depth: as deep as 227 KB allows (D = 128: 224 KB).
  static constexpr int kStages = DB == 128 ? 3 : 4;
  static constexpr int kQ = kBQ * DB * 2;
  static constexpr int kKV = kBK * DB * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kQ + kStages * kKV;
  static constexpr int kBytes = kQ + 2 * kStages * kKV;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Named barriers 1 and 2 among the two consumer warpgroups (256 threads):
// one side waits, the other arrives.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// --- TMA -------------------------------------------------------------------

// Copies the box at coordinates (c0 innermost .. c3) of `map` into `dst`;
// the bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending (groups complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous MMAs.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_ACC32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_ACC64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OUT32(d) WG_OUT8(d, 0), WG_OUT8(d, 8), WG_OUT8(d, 16), WG_OUT8(d, 24)
#define WG_OUT64(d) \
  WG_OUT32(d), WG_OUT8(d, 32), WG_OUT8(d, 40), WG_OUT8(d, 48), WG_OUT8(d, 56)

// d (64 x 128, f32) = [d +] A (64 x 16) B (16 x 128), A and B K-major in
// shared memory.
#define WG_SS_N128(TY)                                                   \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_ACC64 \
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                  \
      : WG_OUT64(d)                                                      \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    WG_SS_N128("f16");
  } else {
    WG_SS_N128("bf16");
  }
}

// d (64 x N, f32) += A (64 x 16, registers) B (16 x N), B MN-major in
// shared memory (transpose bit set).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 128) {
    // Operands %64..%69 after the 64 accumulators.
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_ACC64
          ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
          : WG_OUT64(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64
          ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
          : WG_OUT64(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
  } else {
    // Operands %32..%37 after the 32 accumulators.
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_ACC32
          ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
          : WG_OUT32(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
          ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
          : WG_OUT32(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
  }
}

// Two floats rounded to T and packed, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&h);
  }
  return r;
}

// The two 16-bit values of a pack2 word back in float32.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<__half2*>(&r));
  } else {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
  }
}

template <typename T>
__device__ __forceinline__ T round_to(float x) {
  if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(x);
  } else {
    return __float2bfloat16_rn(x);
  }
}

// 2^x by the special-function unit (ex2.approx: relative error about
// 2^-22; exp2f adds range handling the softmax does not need).
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// o row strides (elements) and the real head dim, for the store.
struct OutView {
  long long sb, sh, ss;
  int D;
};

template <typename T, int DB>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             T* __restrict__ o, const OutView ov, int Hq,
                             int Sq, int Skv, int group, int causal,
                             float scale_log2) {
  using L = Layout<DB>;
  constexpr int kStages = L::kStages;
  constexpr int kBlocks = DB / 64;  // 128-byte column blocks of a row
  constexpr int kAcc = DB / 2;      // O accumulators per thread
  constexpr int kS = kBK / 2;       // S accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  // Heaviest query tiles first, across all heads.
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int BH = gridDim.x / nq;
  const int tile = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int q0 = tile * kBQ;
  const int offset = Skv - Sq;
  int nk = (Skv + kBK - 1) / kBK;
  if (causal) {
    // The last key tile any real row of this block sees.
    nk = min(nk, (min(q0 + kBQ - 1, Sq - 1) + offset) / kBK + 1);
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      const int hk = h / group;
      mbar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int c = 0; c < kBlocks; ++c)
        tma_load_4d(smem + c * kBQ * kRowBytes, &tm_q, q_full, c * 64, q0, h,
                    b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        unsigned char* ks = smem + L::kK + s * L::kKV;
        unsigned char* vs = smem + L::kV + s * L::kKV;
        mbar_expect_tx(&k_full[s], L::kKV);
#pragma unroll
        for (int c = 0; c < kBlocks; ++c)
          tma_load_4d(ks + c * kBK * kRowBytes, &tm_k, &k_full[s], c * 64,
                      j * kBK, hk, b);
        mbar_expect_tx(&v_full[s], L::kKV);
#pragma unroll
        for (int c = 0; c < kBlocks; ++c)
          tma_load_4d(vs + c * kBK * kRowBytes, &tm_v, &v_full[s], c * 64,
                      j * kBK, hk, b);
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int wg_row = q0 + wg * 64;               // first row of this warpgroup
    const int r0 = wg_row + warp * 16 + lane / 4;  // and r0 + 8
    const int cq = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(smem) + wg * 64 * kRowBytes;

    float acc[kAcc];   // O, 64 rows x DB
    float sc[kS];      // S, then P, 64 rows x kBK
    uint32_t pa[kBK / 16][4];  // hi = T(P), the A operand of P V
    uint32_t pl[kBK / 16][4];  // lo = T(P - hi), a second A operand
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = 0.f;
    // Running row max (raw scores) and this thread's part of the row sum
    // for rows r0 (0) and r0 + 8 (1).
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

    // S = Q K_j^T, issued: D / 16 steps of 16 columns; a step moves 32
    // bytes inside a 128-byte swizzled row, then to the next column block.
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      mbar_wait(&k_full[s], (j / kStages) & 1);
      const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kKV);
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DB / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = desc_sw128(
            q_addr + (kk / 4) * kBQ * kRowBytes + col, 16, 1024);
        const uint64_t db = desc_sw128(
            k_addr + (kk / 4) * kBK * kRowBytes + col, 16, 1024);
        wgmma_ss_n128<T>(sc, da, db, kk > 0);
      }
      wg_commit();
    };
    // O += P V_j, issued: kBK / 16 steps of 16 keys; a step moves 16
    // swizzled rows (2048 bytes).  V is MN-major: its 64-column blocks lie
    // kBK rows apart.
    auto issue_pv = [&](int j) {
      const int s = j % kStages;
      mbar_wait(&v_full[s], (j / kStages) & 1);
      const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kKV);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = desc_sw128(v_addr + kk * 16 * kRowBytes,
                                       kBK * kRowBytes, 1024);
        wgmma_rs<T, DB>(acc, pa[kk], db);
        wgmma_rs<T, DB>(acc, pl[kk], db);
      }
      wg_commit();
    };
    // Online softmax of tile j on sc, in place: masks the tiles that
    // straddle this warpgroup's causal diagonal or the end of the keys,
    // updates the running max and sums (a row lives in the 4 lanes of a
    // quad: e = 0, 1 row r0, e = 2, 3 row r0 + 8), leaves the
    // probabilities exp(scale (s - m)) in sc and returns the factors
    // exp(scale (m_prev - m_cur)) for O.
    auto softmax = [&](int j, float& alpha0, float& alpha1) {
      const int k0 = j * kBK;
      if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > wg_row + offset)) {
#pragma unroll
        for (int i = 0; i < kS / 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * i + cq + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (key >= Skv || (causal && key > row + offset))
              sc[4 * i + e] = kNeg;
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kS / 4; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      alpha0 = fa_exp2((m0 - mx0) * scale_log2);
      alpha1 = fa_exp2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = m0 * scale_log2, mb1 = m1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kS / 4; ++i) {
        sc[4 * i] = fa_exp2(fmaf(sc[4 * i], scale_log2, -mb0));
        sc[4 * i + 1] = fa_exp2(fmaf(sc[4 * i + 1], scale_log2, -mb0));
        sc[4 * i + 2] = fa_exp2(fmaf(sc[4 * i + 2], scale_log2, -mb1));
        sc[4 * i + 3] = fa_exp2(fmaf(sc[4 * i + 3], scale_log2, -mb1));
        sum0 += sc[4 * i] + sc[4 * i + 1];
        sum1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l0 = l0 * alpha0 + sum0;  // quad sum at the end
      l1 = l1 * alpha1 + sum1;
    };
    // Rescales O and packs P to T, high and low part, as the A operands
    // of the next wgmmas: for keys 16 kk .. 16 kk + 15 the S registers
    // 8 kk .. 8 kk + 7 hold exactly the (row, key) pairs of the A
    // fragment, in order.
    auto rescale_and_pack = [&](float alpha0, float alpha1) {
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i) {
        acc[4 * i] *= alpha0;
        acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1;
        acc[4 * i + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          pa[kk][r] = pack2<T>(x, y);
          const float2 hi = unpack2<T>(pa[kk][r]);
          pl[kk][r] = pack2<T>(x - hi.x, y - hi.y);
        }
      }
    };

    float alpha0, alpha1;
    mbar_wait(q_full, 0);
    // Tile j's scores are computed while tile j - 1's P V runs, and its
    // softmax runs while that product is still on the tensor cores.  The
    // two warpgroups take turns to issue their products (named barriers
    // 1 and 2), so one's softmax runs beside the other's products.
    // Warpgroup w waits on barrier 1 + w for its turn and hands the turn
    // on after issuing; the last hand-over of warpgroup 1 has no taker.
    auto turn_begin = [&]() { named_sync(1 + wg); };
    auto turn_end = [&](bool last) {
      if (!(last && wg == 1)) named_arrive(2 - wg);
    };
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
    turn_begin();
    issue_s(0);
    turn_end(false);
    wg_wait<0>();
    fence_regs(sc);
    softmax(0, alpha0, alpha1);
    rescale_and_pack(alpha0, alpha1);
    for (int j = 1; j < nk; ++j) {
      turn_begin();
      issue_s(j);
      issue_pv(j - 1);
      turn_end(false);
      wg_wait<1>();  // S_j has landed; P V_{j-1} may still run
      fence_regs(sc);
      softmax(j, alpha0, alpha1);
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(j - 1) % kStages]);
      rescale_and_pack(alpha0, alpha1);
    }
    turn_begin();
    issue_pv(nk - 1);
    turn_end(true);
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(nk - 1) % kStages]);

    // Epilogue: divide by the row sums and round once to T.
    const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
    const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
    const bool pairs = (ov.D % 2 == 0) && (ov.sb % 2 == 0) &&
                       (ov.sh % 2 == 0) && (ov.ss % 2 == 0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= Sq) continue;
      const float inv = half ? inv1 : inv0;
      T* orow = o + b * ov.sb + h * ov.sh + row * ov.ss;
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i) {
        const int col = 8 * i + cq;
        const float x = acc[4 * i + 2 * half] * inv;
        const float y = acc[4 * i + 2 * half + 1] * inv;
        if (pairs && col + 1 < ov.D) {
          *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(x, y);
        } else {
          if (col < ov.D) orow[col] = round_to<T>(x);
          if (col + 1 < ov.D) orow[col + 1] = round_to<T>(y);
        }
      }
    }
  }
}

// --- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime so the library needs
// no link against the driver; null if the driver lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-d map over (D, S, H, B) with strides st = (b, h, s) in elements and
// boxes of 64 columns x `rows` positions of one head; 128-byte swizzle;
// out-of-range elements read as zero.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int B, int H, int S, int D, const long long* st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DB>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, void* o, const OutView& ov, int B,
                   int Hq, int Sq, int Skv, int group, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Layout<DB>::kBytes + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<T, DB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * B * Hq;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_wgmma_kernel<T, DB>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          mq, mk, mv, static_cast<T*>(o), ov, Hq, Sq, Skv, group, causal,
          scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Declared in flash_attention.cu, which calls it.
cudaError_t flash_attention_wgmma(const void* q, const void* k, const void* v,
                                  void* o, int B, int Hq, int Hkv, int Sq,
                                  int Skv, int D, int Dp,
                                  const long long* strides, int causal,
                                  float scale, int dtype,
                                  cudaStream_t stream) {
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  if (Dp > 128 || Dp % 8 != 0 || D > Dp) return cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases and byte strides.
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] <= 0 || strides[i] % 8 != 0) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = dtype == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, type, B, Hq, Sq, Dp, strides, kBQ) ||
      !make_map(&mk, k, type, B, Hkv, Skv, Dp, strides + 3, kBK) ||
      !make_map(&mv, v, type, B, Hkv, Skv, Dp, strides + 6, kBK))
    return cudaErrorInvalidValue;
  const OutView ov{strides[9], strides[10], strides[11], D};
  const int group = Hq / Hkv;
  if (dtype == 1) {
    return Dp <= 64 ? launch<__nv_bfloat16, 64>(mq, mk, mv, o, ov, B, Hq, Sq,
                                                 Skv, group, causal, scale,
                                                 stream)
                    : launch<__nv_bfloat16, 128>(mq, mk, mv, o, ov, B, Hq, Sq,
                                                  Skv, group, causal, scale,
                                                  stream);
  }
  return Dp <= 64 ? launch<__half, 64>(mq, mk, mv, o, ov, B, Hq, Sq, Skv,
                                       group, causal, scale, stream)
                  : launch<__half, 128>(mq, mk, mv, o, ov, B, Hq, Sq, Skv,
                                        group, causal, scale, stream);
}
