// Blockwise (flash) attention on Hopper's tensor cores (sm_90a), forward
// only: the kernels that the bfloat16 and float16 builds
// (flash_attention_bf16.cu, flash_attention_f16.cu) launch at every padded
// head width D8, through both C entries: flash_attention_tc_kernel up to
// kTcSliceD = 256, one block for the whole row, and past it
// flash_attention_tc_wide_kernel (below the first), slices of the output
// columns. It includes after flash_attention.cuh, whose dispatch<T> sends
// every 2-byte T here; the float32 build never includes this header.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// tensorframes_tpu/ops/pallas_kernels.py (pallas_call at :122, body
// :33-81) for those inputs. Same function as the kernel of
// flash_attention.cuh: per head softmax(Q K^T * scale) V with the online
// softmax in float32; -1e30 for keys past a ragged end and, when causal,
// for keys after the query; whole causal key tiles skipped; a zero
// denominator guarded to 1; the output rounded once to q's dtype to nearest
// even; on the _lse entry each row's float32 log-sum-exp, -inf where the
// denominator is 0. Layout: q, k, v, o contiguous (BH, S, D8), D8 a
// multiple of 8, 16-byte aligned (the wrapper's layout step).
//
// What bounds it on an H100 (BH 32, S 2048, D 64, causal): Q K^T and P V
// over the causal pairs are 17.2 GFLOP, 0.01738 ms at the 989 TFLOP/s of
// the bf16 / fp16 tensor cores; carrying P as two 2-byte operands (below)
// makes P V two products, 25.8 GFLOP and 0.0261 ms; q, k, v and o are
// 33.5 MB, 0.010 ms at 3.35 TB/s. At BH 16, S 2048, D 256 the products are
// 34.4 GFLOP, 0.0348 ms (51.6 GFLOP and 0.0521 ms with the pair), the bytes
// 0.020 ms. So it is bound by operations, and only wgmma reaches the
// tensor cores' rate. What the design does about it:
//
// 1. Q K^T on wgmma, both operands in shared memory (m64n64k16 or
//    m64n128k16, float32 sums in registers): K is stored (keys, D) with D
//    contiguous, the K-major layout of B, so nothing is transposed. The
//    products of two bf16 or two fp16 values are exact in float32: the
//    scores differ from the Pallas kernel's float32 dot only in the order
//    of the sum. The row max of the scores scaled by scale * log2(e) in
//    float32 is taken over the raw scores and scaled once (sc max(s), or
//    sc min(s) for a negative scale: the same number, since rounding is
//    monotone), which covers negative and zero scales without touching Q;
//    P = exp2(s sc - m) with the scaling in one FFMA.
// 2. P V on wgmma with P from registers: the score accumulator's fragment
//    is the A fragment of the next product (rows 16 w + lane / 4 and + 8,
//    columns 2 (lane % 4) + {0, 1} of each 8-column group), so P never
//    goes through shared memory; V (keys, D) is the transposed (MN-major)
//    B that 16-bit types allow. The Pallas kernel keeps P in float32 and
//    the output is held to one unit in its last place (rtol 2^-7 bf16,
//    2^-10 fp16, atol 1e-5); one rounding of P to the input type misses
//    that bar on outputs near 0, in bf16 and in fp16
//    (tests/test_torch_flash_attention_tc.py shows it), so P is carried as
//    a pair, two products into one float32 accumulator: P_lo = T(P - P_hi),
//    with P_hi = T(P) for fp16 (P_hi + P_lo within 2^-22 of P; where P_lo
//    falls below fp16's normal range its absolute error stays under
//    2^-25, which the row's denominator, at least 1, only divides) and
//    P_hi = P cut to its top 16 bits for bf16 (one byte permute instead
//    of two conversions; within 2^-16 of P). The row sum l is taken from
//    the float32 P, never from the pair.
// 3. Tiles and staging. A block is two consumer warpgroups of 64 query
//    rows (a 128-row Q tile) and nothing else: with a producer warpgroup
//    beside them ptxas (CUDA 12.9) capped every thread at the 168
//    registers of a 384-thread block whatever setmaxnreg moves at run
//    time, spilled and serialized the wgmma. Up to D8 64 a key tile is
//    64 keys and an SM holds two blocks (at most 128 registers a thread),
//    so four warpgroups share the tensor cores and one block's prologue
//    and epilogue overlap the other's loop; up to D8 128, 128 keys and one
//    block (218 registers). Past 128 a warpgroup keeps the whole output
//    row block, 96 or 128 float32 registers a thread at D8 192 or 256,
//    beside 32 for a 64-key score tile and 32 for its P pair: key tiles of
//    64 keys, one block, 188-196 registers up to D8 192 and 232-240 up to
//    256. (Splitting the output columns over two blocks or two passes,
//    each recomputing Q K^T, would have kept 128-key tiles at 1.33x the
//    operations: not needed, since one pass fits.) K and V tiles come by
//    TMA into rings of four stages up to D8 64, three up to 192 and two
//    past it (the 64 KB Q tile leaves room for four 32 KB tiles), each a
//    full/empty mbarrier pair: thread 0 of warpgroup 1 loads K tile j + S
//    and V tile j + S - 1 after its products of tile j, into stages both
//    warpgroups released a turn before; past D8 128 (kEarly) it loads K
//    tile j + S + 1 and V tile j + S, into the stages released by the
//    products it has just waited for, which gives a two-stage ring two
//    turns to fill a stage. The tensor maps are three-dimensional (D8, S,
//    BH), so a ragged tile's rows past S are zero-filled instead of read
//    from the next head, and their boxes are 64 columns of 128 bytes with
//    the 128-byte swizzle that wgmma's descriptors name: columns past D8
//    are zero-filled too, which covers the widths the k16 step does not
//    divide (8, 24, ..., 120, and past 128 every width up to the next
//    multiple of 32: the k16 steps round up to an even count, four
//    instantiations a dtype and entry instead of eight) while the wrapper
//    pads to 8 only. At D8 > 64 a row is two to four boxes, the
//    descriptors step across them, and P V is one m64nNk16 wgmma of N 128,
//    192 or 256 a k16 step. The maps are encoded on the host through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda, and passed
//    as __grid_constant__ parameters.
// 4. The two warpgroups of a block take turns on the tensor cores (named
//    barriers): one issues P V of its tile and Q K^T of the next as one
//    batch while the other runs its softmax, so the exponentials and the
//    pair's conversions, which take about as long as the products at
//    D 64, overlap the other warpgroup's products. No wgmma sits under a
//    condition (the last tile is peeled off the loop), and the warpgroup
//    index is broadcast from lane 0, so ptxas sees every branch around
//    them uniform and pipelines them.
// 5. Kept from the CUDA-core kernel: the heaviest-first one-dimensional
//    grid (block b takes head b % BH and query tile nq - 1 - b / BH, now
//    of 128 rows; the wrapper's block count follows it); masks only on
//    the tiles that straddle the diagonal or the ragged end; exp2 (here
//    one ex2.approx.ftz: values under 2^-126 flush to 0); the epilogue's
//    l = 0 guard (the output times one reciprocal) and log-sum-exp. The
//    output goes from registers to global memory, two elements a store.
//
// An mbarrier wait that lasts ~9 s traps (a launch failure the wrapper
// raises) instead of hanging the card. Shared memory: Q and the rings,
// 81 KB a block up to D8 64, 225 KB up to 128, 193 KB up to 256. Times,
// registers and what was tried and dropped are in PERF.md (H100 80GB HBM3,
// 700 W).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTcRows = 128;      // query rows a block
constexpr int kTcThreads = 256;   // two consumer warpgroups
constexpr int kTcConsumerWarps = 8;
constexpr int kTcBox = 64;        // columns of a TMA box: 128 bytes, the swizzle's span
constexpr int kTcBoxBytes = kTcRows * kTcBox * 2;  // 16 KB: a box of the Q tile
constexpr float kLn2 = 0.6931471805599453f;

// The tiles of the instantiation with DK k16 steps (D8 <= 16 DK): one
// 64-column box a row up to D8 64, with 64-key tiles, four stages and two
// blocks an SM (at most 128 registers a thread; ptxas takes 123-128); two
// boxes up to D8 128, with 128-key tiles, three stages and one block (218);
// three or four boxes up to D8 256, with 64-key tiles (the output alone is
// 96 or 128 registers a thread), one block, three or two stages (what 227 KB
// holds beside the 48 or 64 KB Q tile), each loaded a turn earlier (kEarly).
template <int DK>
struct TcShape {
  static constexpr int kBoxes = (DK + 3) / 4;
  static constexpr int kKeys = kBoxes == 2 ? 128 : 64;  // keys a tile
  static constexpr int kBlocks = kBoxes == 1 ? 2 : 1;   // blocks an SM
  static constexpr int kStages = kBoxes == 1 ? 4 : kBoxes == 4 ? 2 : 3;  // K and V tiles in flight
  // 1: the loader refills a stage as soon as both warpgroups released it
  // (K tile j + S + 1 and V tile j + S after the products of tile j);
  // 0: a turn later (K tile j + S, V tile j + S - 1), as up to D8 128
  static constexpr int kEarly = kBoxes >= 3 ? 1 : 0;
  static constexpr int kScores = kKeys / 2;             // score accumulators a thread
  static constexpr unsigned kQTile = kBoxes * kTcBoxBytes;     // bytes
  static constexpr unsigned kKVTile = kBoxes * kKeys * 128;
  // Q, the K and V rings, and 1024 bytes to align them
  static constexpr int kSmem = kQTile + 2 * kStages * kKVTile + 1024;
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers that wgmma reads or writes asynchronously: an empty asm that
// uses and redefines each keeps the compiler from moving their other uses
// across the fence, commit and wait around it, or reusing them meanwhile.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The descriptor of a 128-byte-swizzled wgmma operand at shared address
// addr: start >> 4 in bits 0-13, the leading-dimension byte offset >> 4
// in 16-29, the stride-dimension byte offset >> 4 in 32-45, base offset 0
// (every tile starts on 1024 bytes, the swizzle's period), layout 1 (128-byte
// swizzle) in bits 62-63. K-major (Q, K): sbo is the 1024 bytes between
// 8-row groups and lbo is unused; MN-major (V): sbo is the 1024 bytes
// between 8-key groups and lbo the bytes between 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

#define TFS_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TFS_R32                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TFS_R64                                                                    \
  TFS_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "   \
          "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, " \
          "%59, %60, %61, %62, %63"
#define TFS_R96                                                                      \
  TFS_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "  \
          "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "    \
          "%92, %93, %94, %95"
#define TFS_R128                                                                        \
  TFS_R96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "      \
          "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "    \
          "%120, %121, %122, %123, %124, %125, %126, %127"
#define TFS_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TFS_ACC16(d, i) TFS_ACC4(d, i), TFS_ACC4(d, i + 4), TFS_ACC4(d, i + 8), TFS_ACC4(d, i + 12)
#define TFS_ACC32(d, i) TFS_ACC16(d, i), TFS_ACC16(d, i + 16)

// d (64 x N float32) = or += A (64 x 16, shared, K-major) B^T (N x 16,
// shared, K-major); scale_d 0 overwrites d
#define TFS_WGMMA_QK32(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" TFS_R16 \
               "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                     \
               : TFS_ACC16(d, 0)                                                      \
               : "l"(da), "l"(db), "r"(scale_d))
#define TFS_WGMMA_QK64(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" TFS_R32 \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
               : TFS_ACC32(d, 0)                                                      \
               : "l"(da), "l"(db), "r"(scale_d))
#define TFS_WGMMA_QK128(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" TFS_R64 \
               "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                      \
               : TFS_ACC32(d, 0), TFS_ACC32(d, 32)                                     \
               : "l"(da), "l"(db), "r"(scale_d))

template <class T, int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "key tiles of 32, 64 or 128");
  if constexpr (N == 32) {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_QK32("f16");
    } else {
      TFS_WGMMA_QK32("bf16");
    }
  } else if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_QK64("f16");
    } else {
      TFS_WGMMA_QK64("bf16");
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_QK128("f16");
    } else {
      TFS_WGMMA_QK128("bf16");
    }
  }
}

// d (64 x N float32) += A (64 x 16, registers: a[0..3]) B (16 x N, shared,
// MN-major: the transposed B)
#define TFS_WGMMA_PV64(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" TFS_R32 \
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
               : TFS_ACC32(d, 0)                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TFS_WGMMA_PV128(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" TFS_R64 \
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
               : TFS_ACC32(d, 0), TFS_ACC32(d, 32)                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TFS_WGMMA_PV192(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {" TFS_R96       \
               "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"                           \
               : TFS_ACC32(d, 0), TFS_ACC32(d, 32), TFS_ACC32(d, 64)                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TFS_WGMMA_PV256(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" TFS_R128      \
               "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                       \
               : TFS_ACC32(d, 0), TFS_ACC32(d, 32), TFS_ACC32(d, 64), TFS_ACC32(d, 96)      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <class T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256,
                "P V takes one to four 64-column boxes");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_PV64("f16");
    } else {
      TFS_WGMMA_PV64("bf16");
    }
  } else if constexpr (N == 128) {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_PV128("f16");
    } else {
      TFS_WGMMA_PV128("bf16");
    }
  } else if constexpr (N == 192) {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_PV192("f16");
    } else {
      TFS_WGMMA_PV192("bf16");
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      TFS_WGMMA_PV256("f16");
    } else {
      TFS_WGMMA_PV256("bf16");
    }
  }
}

#undef TFS_WGMMA_QK32
#undef TFS_WGMMA_QK64
#undef TFS_WGMMA_QK128
#undef TFS_WGMMA_PV64
#undef TFS_WGMMA_PV128
#undef TFS_WGMMA_PV192
#undef TFS_WGMMA_PV256
#undef TFS_ACC32
#undef TFS_ACC16
#undef TFS_ACC4
#undef TFS_R128
#undef TFS_R96
#undef TFS_R64
#undef TFS_R32
#undef TFS_R16

// 2^x in one MUFU.EX2, results below float32's normal range flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tensor-core turn of consumer warpgroup w is named barrier 1 + w over
// both warpgroups: w waits on it, the other warpgroup arrives.
__device__ __forceinline__ void take_turn(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ void pass_turn(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + w) : "memory");
}

// S = Q K^T of one key tile, issued (no commit): DK k16 steps, step j
// reading 32 bytes into the rows of box j / 4 of Q (this warpgroup's 64
// rows) and of K (the tile's BK keys). With add, the first step adds to S
// too (a later window of the same tile's depth).
template <class T, int DK, int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr,
                                        int add = 0) {
#pragma unroll
  for (int j = 0; j < DK; ++j) {
    const uint32_t in_row = (j & 3) * 32;
    wgmma_qk<T, BK>(s, sw128_desc(q_addr + (j >> 2) * kTcBoxBytes + in_row, 16, 1024),
                    sw128_desc(k_addr + (j >> 2) * BK * 128 + in_row, 16, 1024), j > 0 || add);
  }
}

// (a, b) as the pair hi, lo, each two elements packed as wgmma's A
// registers take them (the first in the low half). fp16: hi = T(a, b)
// rounded, lo = T(a - hi, b - hi). bf16: hi is a and b cut to their top 16
// bits (one byte permute, no conversion either way), lo = T(a - hi, b - hi)
// rounded; hi + lo holds P to 2^-16 of itself (2^-17 with a rounded hi).
template <class T>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 f = __half22float2(h);
    const __half2 r = __floats2half2_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
    hi = __byte_perm(ua, ub, 0x7632);
    const __nv_bfloat162 r = __floats2bfloat162_rn(a - __uint_as_float(ua & 0xffff0000u),
                                                   b - __uint_as_float(ub & 0xffff0000u));
    lo = *reinterpret_cast<const uint32_t*>(&r);
  }
}

enum Reduce { kMax, kMin, kSum };

// The max, min or sum of this thread's NS / 2 accumulators of row half H
// (i with (i / 2) % 2 == H), as a tree. Every index is a constant, so r
// stays in registers.
template <Reduce R, int H, int NS>
__device__ __forceinline__ float row_reduce(const float (&s)[NS]) {
  static_assert(NS == 16 || NS == 32 || NS == 64, "key tiles of 32, 64 or 128");
  auto op = [](float x, float y) {
    return R == kMax ? fmaxf(x, y) : R == kMin ? fminf(x, y) : x + y;
  };
  float r[NS / 4];
#pragma unroll
  for (int c = 0; c < NS / 4; ++c) r[c] = op(s[4 * c + 2 * H], s[4 * c + 2 * H + 1]);
  if constexpr (NS == 64) {
#pragma unroll
    for (int c = 0; c < 8; ++c) r[c] = op(r[c], r[c + 8]);
  }
  if constexpr (NS >= 32) {
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = op(r[c], r[c + 4]);
  }
  return op(op(r[0], r[2]), op(r[1], r[3]));
}

// The row max of one key tile's scaled scores for this thread's two rows,
// taken over the raw scores and scaled once: the max of s sc is sc max(s)
// for sc >= 0 and sc min(s) for sc < 0, exactly, since rounding is
// monotone. Accumulator i holds row row0 + 8 ((i / 2) % 2), key key0 + 8
// (i / 4) + i % 2 of the tile. With kMask, keys at or past seq and, when
// causal, after the row are set to -inf (+inf for a negative scale) in s,
// which leaves them out of the max and makes their P 0 (below).
template <bool kMask, int NS>
__device__ __forceinline__ void row_max(float (&s)[NS], float (&mx)[2], float sc, int row0,
                                        int key0, int seq, int causal) {
  const bool neg = sc < 0.f;
  if constexpr (kMask) {
    const float out = neg ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = key0 + 8 * (i >> 2) + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (key >= seq || (causal && key > row)) s[i] = out;
    }
  }
  float raw[2];
  if (neg) {
    raw[0] = row_reduce<kMin, 0, NS>(s);
    raw[1] = row_reduce<kMin, 1, NS>(s);
  } else {
    raw[0] = row_reduce<kMax, 0, NS>(s);
    raw[1] = row_reduce<kMax, 1, NS>(s);
  }
  // a row with every key masked (none is: key 0 is in the first tile and
  // the diagonal in the last) keeps the running max
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = isinf(raw[h]) ? kNegInf : raw[h] * sc;
}

// P = 2^(s sc - m) with one FFMA before the exponential, 0 where masked;
// sum gets each row's part of the denominator from the float32 P.
template <bool kMask, int NS>
__device__ __forceinline__ void exponentiate(float (&s)[NS], float sc, const float (&m)[2],
                                             float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float p = ex2(fmaf(s[i], sc, -m[(i >> 1) & 1]));
    s[i] = kMask && isinf(s[i]) ? 0.f : p;
  }
  sum[0] = row_reduce<kSum, 0, NS>(s);
  sum[1] = row_reduce<kSum, 1, NS>(s);
}

// One key tile's online softmax for this thread's two rows: s holds the
// tile's scores on entry (key0: the tile's first key; rows_lo: the first
// row of this warpgroup); m, l and acc are rescaled, and P, the float32
// probabilities, leaves as the pair p_hi, p_lo in A-fragment order
// (registers 4 j .. 4 j + 3: the k16 step j, keys 16 j .. 16 j + 15).
// Masks only where the tile straddles the diagonal of this warpgroup's
// rows or the ragged end.
template <class T, int NO, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&acc)[NO], float (&m)[2],
                                             float (&l)[2], uint32_t (&p_hi)[NS / 2],
                                             uint32_t (&p_lo)[NS / 2], float sc, int row0,
                                             int key0, int c_lo, int rows_lo, int seq,
                                             int causal) {
  constexpr int BK = 2 * NS;  // keys a tile
  float mx[2];
  const bool edge = key0 + BK > seq || (causal && key0 + BK - 1 > rows_lo);
  if (edge)
    row_max<true>(s, mx, sc, row0, key0 + c_lo, seq, causal);
  else
    row_max<false>(s, mx, sc, row0, key0 + c_lo, seq, causal);
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2];
  if (edge)
    exponentiate<true>(s, sc, m, sum);
  else
    exponentiate<false>(s, sc, m, sum);
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], sum[h]);
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) split_pair<T>(s[2 * i], s[2 * i + 1], p_hi[i], p_lo[i]);
}

// O += P_hi V + P_lo V over one key tile of BK keys, issued (no commit):
// step j reads keys 16 j .. 16 j + 15 of the V tile at v_addr, whose
// 64-column boxes lie BK rows of 128 bytes apart
template <class T, int DN, int BK>
__device__ __forceinline__ void pv_tile(float (&acc)[DN / 2], const uint32_t (&p_hi)[BK / 4],
                                        const uint32_t (&p_lo)[BK / 4], uint32_t v_addr) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    const uint64_t dv = sw128_desc(v_addr + j * 16 * 128, BK * 128, 1024);
    wgmma_pv<T, DN>(acc, p_hi + 4 * j, dv);
    wgmma_pv<T, DN>(acc, p_lo + 4 * j, dv);
  }
}

// kLse: also store each row's log-sum-exp into lse (the second C entry).
// DK: the k16 steps of Q K^T, ceil(D8 / 16); the tiles hold ceil(DK / 4)
// boxes of 64 columns.
template <class T, int DK, bool kLse>
__global__ void __launch_bounds__(kTcThreads, TcShape<DK>::kBlocks)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                          float* __restrict__ lse, int bh, int seq, int d8, float sc,
                          int causal) {
  using Shape = TcShape<DK>;
  constexpr int E = Shape::kEarly;
  constexpr int NB = Shape::kBoxes;  // 64-column boxes a row
  constexpr int BK = Shape::kKeys;   // keys a tile
  constexpr int NS = Shape::kScores;
  constexpr int DN = kTcBox * NB;    // output columns P V computes
  constexpr int NO = DN / 2;         // output accumulators a thread
  constexpr unsigned kTile = Shape::kKVTile;
  extern __shared__ unsigned char tc_smem[];
  constexpr int S = Shape::kStages;
  __shared__ __align__(8) uint64_t bars[1 + 4 * S];
  // TMA's 128-byte swizzle repeats every 1024 bytes: tiles start on it
  unsigned char* qs = tc_smem + ((1024u - (smem_u32(tc_smem) & 1023u)) & 1023u);
  unsigned char* ks = qs + Shape::kQTile;  // S K tiles
  unsigned char* vs = ks + S * kTile;      // S V tiles
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;  // a stage each
  uint64_t* k_empty = k_full + S;
  uint64_t* v_full = k_empty + S;
  uint64_t* v_empty = v_full + S;

  const int tid = threadIdx.x;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform in
  // each warp: otherwise the branches on it count as divergent, and ptxas
  // serializes the wgmma after them
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);  // query rows 64 cw .. 64 cw + 63
  const int nq = (seq + kTcRows - 1) / kTcRows;
  const int head = static_cast<int>(blockIdx.x % static_cast<unsigned>(bh));
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(bh))) * kTcRows;
  const int k_end = causal ? min(seq, q0 + kTcRows) : seq;  // keys any row sees
  const int nk = (k_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kTcConsumerWarps);
      mbar_init(v_empty + s, kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 of warpgroup 1 issues every copy (warpgroup 0, which takes
  // the first turn, then carries no loads): K tile j and V tile j into
  // stage j % S, once both warpgroups have released the tile that stage
  // held before.
  const bool loader = tid == 128;
  auto load = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full, uint64_t* empty,
                  int j) {
    const int st = j % S;
    mbar_wait(empty + st, ((j / S) & 1) ^ 1);  // the stage's previous tile released
    mbar_expect_tx(full + st, kTile);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load(ring + st * kTile + b * BK * 128, map, full + st, b * kTcBox, j * BK, head);
  };
  if (loader) {
    mbar_expect_tx(q_full, Shape::kQTile);
#pragma unroll
    for (int b = 0; b < NB; ++b) tma_load(qs + b * kTcBoxBytes, &tq, q_full, b * kTcBox, q0, head);
    for (int j = 0; j < min(nk, S); ++j) load(&tk, ks, k_full, k_empty, j);
    for (int j = 0; j < min(nk, S - 1 + E); ++j) load(&tv, vs, v_full, v_empty, j);
  }

  const int t = tid % 128;
  const int lane = t & 31;
  const int row0 = q0 + 64 * cw + 16 * (t >> 5) + (lane >> 2);  // and row0 + 8
  const int c_lo = 2 * (lane & 3);  // first column of the thread's pairs
  const uint32_t q_addr = smem_u32(qs) + cw * 64 * 128;  // the warpgroup's 64 rows
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the scaled scores, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the running denominator
  float s_acc[NS];                  // the scores of a key tile, then its P
  uint32_t p_hi[NS / 2], p_lo[NS / 2];  // P as the pair, in A-fragment order

  // The two warpgroups take turns on the tensor cores: each issues its
  // products of a turn (P V of this tile, Q K^T of the next) and passes the
  // turn on, then runs its softmax while the other's products run. The
  // first turn is warpgroup 0's; both take nk + 1 turns, and the last pass
  // of warpgroup 1 is left out so that every named barrier completes. The
  // V stage of the last tile is not released: no load waits for it.
  if (cw == 1) pass_turn(0);
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  take_turn(cw);
  wgmma_fence();
  qk_tile<T, DK, BK>(s_acc, q_addr, k_addr);
  wgmma_commit();
  pass_turn(1 - cw);
  wgmma_wait_all();
  hold(s_acc);
  if (lane == 0) mbar_arrive(k_empty);  // this warp is done with K tile 0
  if constexpr (E == 1) {
    if (loader && S < nk) load(&tk, ks, k_full, k_empty, S);  // into K tile 0's stage
  }

  // every tile but the last: P V of this tile with Q K^T of the next
  for (int kb = 0; kb + 1 < nk; ++kb) {
    const int s = kb % S, s1 = (kb + 1) % S;
    softmax_tile<T, NO, NS>(s_acc, acc, m, l, p_hi, p_lo, sc, row0, kb * BK, c_lo,
                            q0 + 64 * cw, seq, causal);
    mbar_wait(v_full + s, (kb / S) & 1);
    mbar_wait(k_full + s1, ((kb + 1) / S) & 1);
    take_turn(cw);
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    wgmma_fence();
    pv_tile<T, DN, BK>(acc, p_hi, p_lo, v_addr + s * kTile);
    qk_tile<T, DK, BK>(s_acc, q_addr, k_addr + s1 * kTile);
    wgmma_commit();
    pass_turn(1 - cw);
    wgmma_wait_all();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    hold(s_acc);
    if (lane == 0) {
      mbar_arrive(v_empty + s);
      mbar_arrive(k_empty + s1);
    }
    // E 0: K tile kb + S into the stage of K tile kb, V tile kb + S - 1
    // into that of V tile kb - 1: both warpgroups' products that read those
    // finished a turn ago, so the waits are short. E 1: K tile kb + S + 1
    // and V tile kb + S into the stages of K tile kb + 1 and V tile kb,
    // which the other warpgroup released a turn ago and this one just now:
    // a two-stage ring then still has two turns to fill a stage
    if (loader) {
      if (kb + S + E < nk) load(&tk, ks, k_full, k_empty, kb + S + E);
      if (kb + S - 1 + E < nk) load(&tv, vs, v_full, v_empty, kb + S - 1 + E);
    }
  }
  // the last tile: P V alone (no wgmma sits under a condition: ptxas
  // serializes those); no copy reuses its V stage, so it is not released
  {
    const int kb = nk - 1;
    const int s = kb % S;
    softmax_tile<T, NO, NS>(s_acc, acc, m, l, p_hi, p_lo, sc, row0, kb * BK, c_lo,
                            q0 + 64 * cw, seq, causal);
    mbar_wait(v_full + s, (kb / S) & 1);
    take_turn(cw);
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    wgmma_fence();
    pv_tile<T, DN, BK>(acc, p_hi, p_lo, v_addr + s * kTile);
    wgmma_commit();
    if (cw == 0) pass_turn(1);
    wgmma_wait_all();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
  }

  const size_t head_row = static_cast<size_t>(head) * seq;
  if constexpr (NB <= 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const int row = row0 + 8 * h;
      if (row >= seq) continue;
      if constexpr (kLse) {
        if ((lane & 3) == 0)
          lse[head_row + row] =
              lh == 0.f ? __int_as_float(0xff800000) : fmaf(m[h], kLn2, logf(lh));
      }
      const float inv = 1.f / (lh == 0.f ? 1.f : lh);  // one division, not DN / 4
      T* orow = o + (head_row + row) * d8 + c_lo;
#pragma unroll
      for (int c = 0; c < DN / 8; ++c) {
        if (8 * c + c_lo < d8)
          *reinterpret_cast<unsigned*>(orow + 8 * c) =
              pack2<T>(acc[4 * c + 2 * h] * inv, acc[4 * c + 2 * h + 1] * inv);
      }
    }
  } else {
    // Past D8 128 the output goes through shared memory: a store of the
    // fragment's pairs writes 8 rows at once, 8 half-used sectors, and
    // 64 of them a thread took ~8% of a block's time at D8 256. Each warp
    // writes its 16 rows into its warpgroup's rows of the Q tile, which no
    // product reads any more, in the 128-byte swizzle's order (no bank
    // conflict either way), then stores whole rows, 16 bytes a lane.
    const int w16 = 16 * (t >> 5);  // the warp's first row in the warpgroup
    unsigned char* stage = qs + cw * 64 * 128;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const int row = row0 + 8 * h;
      if constexpr (kLse) {
        if ((lane & 3) == 0 && row < seq)
          lse[head_row + row] =
              lh == 0.f ? __int_as_float(0xff800000) : fmaf(m[h], kLn2, logf(lh));
      }
      inv[h] = 1.f / (lh == 0.f ? 1.f : lh);
    }
#pragma unroll
    for (int c = 0; c < DN / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = w16 + (lane >> 2) + 8 * h;  // r % 8 is lane / 4
        *reinterpret_cast<uint32_t*>(stage + (c >> 3) * kTcBoxBytes + r * 128 +
                                     (((c & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
            pack2<T>(acc[4 * c + 2 * h] * inv[h], acc[4 * c + 2 * h + 1] * inv[h]);
      }
    }
    __syncwarp();
    if (8 * lane < d8) {  // lane: the row's 16-byte chunk
      for (int rr = 0; rr < 16; ++rr) {
        const int r = w16 + rr;
        const int row = q0 + 64 * cw + r;
        if (row < seq)
          *reinterpret_cast<uint4*>(o + (head_row + row) * d8 + 8 * lane) =
              *reinterpret_cast<const uint4*>(stage + (lane >> 3) * kTcBoxBytes + r * 128 +
                                              (((lane & 7) ^ (r & 7)) << 4));
      }
    }
  }
}

template <class T, int DK, bool kLse>
cudaError_t launch_tc_width(TensorMapEncode encode, const T* q, const T* k, const T* v, T* o,
                            float* lse, int bh, int seq, int d8, float scale, int causal,
                            cudaStream_t stream) {
  using Shape = TcShape<DK>;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, encode, q, bh, seq, d8, kTcBox, kTcRows) ||
      !encode_map(&mk, encode, k, bh, seq, d8, kTcBox, Shape::kKeys) ||
      !encode_map(&mv, encode, v, bh, seq, d8, kTcBox, Shape::kKeys))
    return cudaErrorInvalidValue;
  const auto kernel = flash_attention_tc_kernel<T, DK, kLse>;
  const cudaError_t err = prepare(kernel, Shape::kSmem);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(bh) * ((seq + kTcRows - 1) / kTcRows);
  if (n > INT_MAX) return cudaErrorInvalidConfiguration;
  const float sc = scale * kLog2e;  // the scores in log2 units
  kernel<<<static_cast<unsigned>(n), kTcThreads, Shape::kSmem, stream>>>(mq, mk, mv, o, lse, bh,
                                                                         seq, d8, sc, causal);
  return cudaGetLastError();
}

// Past D8 256 (kTcSliceD). A block takes a 128-row query tile, as above,
// and a slice of NV 64-column boxes of the output (NV 3 or 4; slices =
// ceil(D8 / 256), NV = ceil(boxes / slices)), and computes Q K^T over the
// whole padded depth for it: each slice recomputes the scores, which keeps
// a warpgroup at 96 or 128 output registers. At BH 16, S 2048, D 512,
// causal that is 137 GFLOP with the P pair, 0.139 ms at 989 TFLOP/s,
// against 103 GFLOP for the function's own products (0.104 ms); the other
// split, one 64-row tile whose warpgroups sum halves of the depth and
// exchange their partial scores, would do only those, but shares each K
// and V tile between half as many rows (about twice the L2 traffic an
// operation) and runs both warpgroups' softmax at once, with no turns.
// Key tiles are 64 keys. Up to nine boxes (D8 576) the 128-row Q tile
// stays resident (144 KB at nine) and Q K^T runs in NWR windows of W boxes
// over it, each window a turn of its own with its 64-key K window in one
// of two stages (8 KB a box), beside one or two stages of V slices (what
// 227 KB holds: one past six boxes). Past nine boxes the Q tile does not
// fit: each window's Q is reloaded beside its K every key tile (NWR 0,
// windows of 4, 32-key tiles). Boxes past D8, whole or in part, are
// zero-filled by the copy and add 0 to the scores or stay 0 in the output.
// The epilogue writes only the slice's columns before D8, and slice 0
// alone the log-sum-exp.
template <int W, int NWR, int NV, int BK>
struct TcWideShape {
  static constexpr bool kStream = NWR == 0;
  static constexpr unsigned kQRes = NWR * W * kTcBoxBytes;            // resident Q
  static constexpr unsigned kQStage = kStream ? W * kTcBoxBytes : 0;  // a stage's Q window
  static constexpr unsigned kStage = kQStage + W * BK * 128;          // and its K window
  static constexpr unsigned kVTile = NV * BK * 128;
  // V slices in flight: two where they fit beside the rest, else one
  static constexpr int kVStages = kQRes + 2 * kStage + 2 * kVTile + 1024 <= 227 * 1024 ? 2 : 1;
  static constexpr int kSmem = kQRes + 2 * kStage + kVStages * kVTile + 1024;
};

template <class T, int W, int NWR, int NV, int BK, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                               float* __restrict__ lse, int bh, int seq, int d8, int slices,
                               float sc, int causal) {
  using Shape = TcWideShape<W, NWR, NV, BK>;
  constexpr bool kStream = Shape::kStream;
  constexpr int VS = Shape::kVStages;
  constexpr int NS = BK / 2;
  constexpr int DN = kTcBox * NV;  // output columns of the slice
  constexpr int NO = DN / 2;
  extern __shared__ unsigned char tcw_smem[];
  __shared__ __align__(8) uint64_t bars[9];
  unsigned char* base = tcw_smem + ((1024u - (smem_u32(tcw_smem) & 1023u)) & 1023u);
  unsigned char* qs = base;                      // the resident Q tile
  unsigned char* ring = qs + Shape::kQRes;       // two stages: Q window, K window
  unsigned char* vs = ring + 2 * Shape::kStage;  // VS V slices
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;  // a stage each
  uint64_t* k_empty = bars + 3;
  uint64_t* v_full = bars + 5;  // VS each
  uint64_t* v_empty = bars + 7;

  const int tid = threadIdx.x;
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);  // query rows 64 cw .. 64 cw + 63
  const int nq = (seq + kTcRows - 1) / kTcRows;
  const int slice = static_cast<int>(blockIdx.x % static_cast<unsigned>(slices));
  const int rest = static_cast<int>(blockIdx.x / static_cast<unsigned>(slices));
  const int head = rest % bh;
  const int q0 = (nq - 1 - rest / bh) * kTcRows;  // heaviest first
  const int col0 = slice * DN;                    // the slice's first output column
  const int k_end = causal ? min(seq, q0 + kTcRows) : seq;
  const int nk = (k_end + BK - 1) / BK;
  // windows of Q K^T a key tile: NWR over the resident Q tile, else enough
  // to cover the row
  const int nw = kStream ? ((d8 + kTcBox - 1) / kTcBox + W - 1) / W : NWR;
  const int total = nk * nw;  // windows in all, in the order they are used

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kTcConsumerWarps);
      mbar_init(v_empty + s, kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 of warpgroup 1 issues every copy: window n (key tile n / nw,
  // depth boxes W (n % nw) ..) into stage n % 2, V slice j into stage
  // j % VS, each once both warpgroups released what the stage held before.
  const bool loader = tid == 128;
  auto load_window = [&](int n) {
    const int st = n & 1;
    mbar_wait(k_empty + st, ((n >> 1) & 1) ^ 1);
    mbar_expect_tx(k_full + st, Shape::kStage);
    const int kt = n / nw;
    const int box0 = (n - kt * nw) * W;
    unsigned char* dst = ring + st * Shape::kStage;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      if constexpr (kStream)
        tma_load(dst + b * kTcBoxBytes, &tq, k_full + st, (box0 + b) * kTcBox, q0, head);
      tma_load(dst + Shape::kQStage + b * BK * 128, &tk, k_full + st, (box0 + b) * kTcBox,
               kt * BK, head);
    }
  };
  auto load_v = [&](int j) {
    const int st = j % VS;
    mbar_wait(v_empty + st, ((j / VS) & 1) ^ 1);
    mbar_expect_tx(v_full + st, Shape::kVTile);
#pragma unroll
    for (int b = 0; b < NV; ++b)
      tma_load(vs + st * Shape::kVTile + b * BK * 128, &tv, v_full + st, col0 + b * kTcBox,
               j * BK, head);
  };
  if (loader) {
    if constexpr (!kStream) {
      mbar_expect_tx(q_full, Shape::kQRes);
#pragma unroll
      for (int b = 0; b < NWR * W; ++b)
        tma_load(qs + b * kTcBoxBytes, &tq, q_full, b * kTcBox, q0, head);
    }
    for (int n = 0; n < min(total, 2); ++n) load_window(n);
    for (int j = 0; j < min(nk, VS); ++j) load_v(j);
  }

  const int t = tid % 128;
  const int lane = t & 31;
  const int row0 = q0 + 64 * cw + 16 * (t >> 5) + (lane >> 2);  // and row0 + 8
  const int c_lo = 2 * (lane & 3);
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t v_addr = smem_u32(vs);
  // the warpgroup's 64 rows of window n's Q (window w of the tile), and
  // window n's K. The address goes through an empty asm each turn: left
  // loop-invariant, the resident tile's 64-bit descriptors of every k16
  // step would be hoisted into registers (64 at 32 steps).
  auto q_addr = [&](int n, int w) {
    uint32_t a = (kStream ? ring_addr + (n & 1) * Shape::kStage
                          : smem_u32(qs) + w * W * kTcBoxBytes) +
                 cw * 64 * 128;
    asm volatile("" : "+r"(a));
    return a;
  };
  auto k_addr = [&](int n) { return ring_addr + (n & 1) * Shape::kStage + Shape::kQStage; };

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s_acc[NS];
  uint32_t p_hi[NS / 2], p_lo[NS / 2];

  // One turn of Q K^T alone: window n (window w of its tile), added to the
  // scores of the tile's earlier windows unless it is the first. After the
  // products, window n + 2 goes into the stage they free.
  auto qk_turn = [&](int n, int w) {
    mbar_wait(k_full + (n & 1), (n >> 1) & 1);
    take_turn(cw);
    hold(s_acc);
    wgmma_fence();
    qk_tile<T, 4 * W, BK>(s_acc, q_addr(n, w), k_addr(n), w > 0);
    wgmma_commit();
    pass_turn(1 - cw);
    wgmma_wait_all();
    hold(s_acc);
    if (lane == 0) mbar_arrive(k_empty + (n & 1));
    if (loader && n + 2 < total) load_window(n + 2);
  };

  // Turns as in the kernel above: a turn is P V of a tile with the first
  // window of the next (or one more window of it), and each warpgroup takes
  // nk nw + 1 of them
  if (cw == 1) pass_turn(0);
  if constexpr (!kStream) mbar_wait(q_full, 0);
  for (int w = 0; w < nw; ++w) qk_turn(w, w);

  for (int kb = 0; kb + 1 < nk; ++kb) {
    const int sv = kb % VS;
    const int n = (kb + 1) * nw;
    softmax_tile<T, NO, NS>(s_acc, acc, m, l, p_hi, p_lo, sc, row0, kb * BK, c_lo,
                            q0 + 64 * cw, seq, causal);
    mbar_wait(v_full + sv, (kb / VS) & 1);
    mbar_wait(k_full + (n & 1), (n >> 1) & 1);
    take_turn(cw);
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    wgmma_fence();
    pv_tile<T, DN, BK>(acc, p_hi, p_lo, v_addr + sv * Shape::kVTile);
    qk_tile<T, 4 * W, BK>(s_acc, q_addr(n, 0), k_addr(n));
    wgmma_commit();
    pass_turn(1 - cw);
    wgmma_wait_all();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    hold(s_acc);
    if (lane == 0) {
      mbar_arrive(v_empty + sv);
      mbar_arrive(k_empty + (n & 1));
    }
    if (loader) {
      if (n + 2 < total) load_window(n + 2);
      if (kb + VS < nk) load_v(kb + VS);
    }
    for (int w = 1; w < nw; ++w) qk_turn(n + w, w);
  }
  {
    const int kb = nk - 1;
    const int sv = kb % VS;
    softmax_tile<T, NO, NS>(s_acc, acc, m, l, p_hi, p_lo, sc, row0, kb * BK, c_lo,
                            q0 + 64 * cw, seq, causal);
    mbar_wait(v_full + sv, (kb / VS) & 1);
    take_turn(cw);
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    wgmma_fence();
    pv_tile<T, DN, BK>(acc, p_hi, p_lo, v_addr + sv * Shape::kVTile);
    wgmma_commit();
    if (cw == 0) pass_turn(1);
    wgmma_wait_all();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
  }

  // The epilogue of the kernel above past D8 128: the warpgroup's rows of a
  // Q tile that no product reads any more (the resident one, or stage 0's
  // window) take the output in the swizzle's order, then whole rows go out,
  // 16 bytes a lane, the slice's columns before d8 only.
  const size_t head_row = static_cast<size_t>(head) * seq;
  const int w16 = 16 * (t >> 5);
  unsigned char* stage = (kStream ? ring : qs) + cw * 64 * 128;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int row = row0 + 8 * h;
    if constexpr (kLse) {
      if (slice == 0 && (lane & 3) == 0 && row < seq)
        lse[head_row + row] = lh == 0.f ? __int_as_float(0xff800000) : fmaf(m[h], kLn2, logf(lh));
    }
    inv[h] = 1.f / (lh == 0.f ? 1.f : lh);
  }
#pragma unroll
  for (int c = 0; c < DN / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w16 + (lane >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + (c >> 3) * kTcBoxBytes + r * 128 +
                                   (((c & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
          pack2<T>(acc[4 * c + 2 * h] * inv[h], acc[4 * c + 2 * h + 1] * inv[h]);
    }
  }
  __syncwarp();
  if (8 * lane < DN && col0 + 8 * lane < d8) {
    for (int rr = 0; rr < 16; ++rr) {
      const int r = w16 + rr;
      const int row = q0 + 64 * cw + r;
      if (row < seq)
        *reinterpret_cast<uint4*>(o + (head_row + row) * d8 + col0 + 8 * lane) =
            *reinterpret_cast<const uint4*>(stage + (lane >> 3) * kTcBoxBytes + r * 128 +
                                            (((lane & 7) ^ (r & 7)) << 4));
    }
  }
}

template <class T, int W, int NWR, int NV, int BK, bool kLse>
cudaError_t launch_tc_wide_shape(TensorMapEncode encode, const T* q, const T* k, const T* v,
                                 T* o, float* lse, int bh, int seq, int d8, float scale,
                                 int causal, cudaStream_t stream) {
  using Shape = TcWideShape<W, NWR, NV, BK>;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, encode, q, bh, seq, d8, kTcBox, kTcRows) ||
      !encode_map(&mk, encode, k, bh, seq, d8, kTcBox, BK) ||
      !encode_map(&mv, encode, v, bh, seq, d8, kTcBox, BK))
    return cudaErrorInvalidValue;
  const auto kernel = flash_attention_tc_wide_kernel<T, W, NWR, NV, BK, kLse>;
  const cudaError_t err = prepare(kernel, Shape::kSmem);
  if (err != cudaSuccess) return err;
  const int slices = (d8 + kTcSliceD - 1) / kTcSliceD;
  const long long n = static_cast<long long>(slices) * bh * ((seq + kTcRows - 1) / kTcRows);
  if (n > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n), kTcThreads, Shape::kSmem, stream>>>(
      mq, mk, mv, o, lse, bh, seq, d8, slices, scale * kLog2e, causal);
  return cudaGetLastError();
}

// d8 > kTcSliceD, by boxes a row: 5-9 keep Q resident (5: one window, 6:
// two of 3, 7-8: two of 4, 9: three of 3; two slices up to 8, three at 9),
// more reload it in windows of 4 (slices of 4 boxes, 32-key tiles)
template <class T>
cudaError_t launch_tc_wide(TensorMapEncode encode, const T* q, const T* k, const T* v, T* o,
                           float* lse, int bh, int seq, int d8, float scale, int causal,
                           cudaStream_t stream) {
  switch ((d8 + kTcBox - 1) / kTcBox) {
#define TFS_TC_WIDE_CASE(W, NWR, NV, BK)                                                     \
  return lse != nullptr ? launch_tc_wide_shape<T, W, NWR, NV, BK, true>(                     \
                              encode, q, k, v, o, lse, bh, seq, d8, scale, causal, stream)   \
                        : launch_tc_wide_shape<T, W, NWR, NV, BK, false>(                    \
                              encode, q, k, v, o, lse, bh, seq, d8, scale, causal, stream);
    case 5:
      TFS_TC_WIDE_CASE(5, 1, 3, 64)
    case 6:
      TFS_TC_WIDE_CASE(3, 2, 3, 64)
    case 7:
    case 8:
      TFS_TC_WIDE_CASE(4, 2, 4, 64)
    case 9:
      TFS_TC_WIDE_CASE(3, 3, 3, 64)
    default:
      TFS_TC_WIDE_CASE(4, 0, 4, 32)
#undef TFS_TC_WIDE_CASE
  }
}

// One launch of the tensor-core kernels at a padded head width d8 (declared
// in flash_attention.cuh): cudaErrorNotSupported without the driver's
// tensor-map encoder, cudaErrorInvalidValue for a map it refuses.
template <class T>
cudaError_t launch_tc(const T* q, const T* k, const T* v, T* o, float* lse, int bh, int seq,
                      int d8, float scale, int causal, cudaStream_t stream) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (d8 > kTcSliceD)
    return launch_tc_wide<T>(encode, q, k, v, o, lse, bh, seq, d8, scale, causal, stream);
  // past D8 128 the k16 steps round up to an even count (D8 160, 192, 224,
  // 256): the box's zero-filled columns add 0 to the scores, and four
  // instantiations a dtype and entry take the place of eight
  switch ((d8 + 15) / 16) {
#define TFS_TC_CASE(DK)                                                                      \
  case DK:                                                                                   \
    return lse != nullptr ? launch_tc_width<T, DK, true>(encode, q, k, v, o, lse, bh, seq, d8, \
                                                         scale, causal, stream)             \
                          : launch_tc_width<T, DK, false>(encode, q, k, v, o, lse, bh, seq,  \
                                                          d8, scale, causal, stream);
    TFS_TC_CASE(1) TFS_TC_CASE(2) TFS_TC_CASE(3) TFS_TC_CASE(4)
    TFS_TC_CASE(5) TFS_TC_CASE(6) TFS_TC_CASE(7) TFS_TC_CASE(8)
    case 9:
    TFS_TC_CASE(10)
    case 11:
    TFS_TC_CASE(12)
    case 13:
    TFS_TC_CASE(14)
    case 15:
    TFS_TC_CASE(16)
#undef TFS_TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
