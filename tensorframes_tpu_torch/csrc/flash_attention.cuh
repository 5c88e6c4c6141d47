// Blockwise (flash) attention for Hopper (sm_90a), forward only: the CUDA-core
// kernels and the dispatch that flash_attention.cu (float32),
// flash_attention_f16.cu (float16) and flash_attention_bf16.cu (bfloat16)
// instantiate, one shared library each, so that nvcc builds the three at
// once. The one-slice kernel below takes float32 heads up to 128 wide, the
// wide kernel float32 heads past 128; bf16 and fp16 heads of every width run
// on the tensor cores (flash_attention_tc.cuh, which the two 2-byte builds
// include).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// tensorframes_tpu/ops/pallas_kernels.py (pallas_call at :122). Same
// function: per head, out = softmax(Q K^T * scale) V with an online
// softmax; `causal` masks key > query and skips whole key tiles above the
// diagonal; keys past the end of a ragged sequence are masked; a row whose
// denominator is 0 is guarded to 1. Layout: q, k, v, o are contiguous,
// 16-byte aligned (BH, S, D) arrays of one element type (float, __half or
// __nv_bfloat16), all heads of a batch in one launch, D any multiple of 8
// (the wrapper, ops/flash_attention.py, pads other widths with zero
// columns, casts other dtypes to float32 and copies strided or misaligned
// inputs). Like the Pallas kernel, which casts every block to float32, the
// kernels compute in float32 whatever they load (the tensor-core kernels
// multiply 2-byte elements as they are, exactly, into float32 sums),
// scores, softmax and the output accumulate in float32, and the output is
// rounded to the input type to nearest even (`astype`'s rounding). A second entry
// also stores each row's log-sum-exp of its scaled scores, (BH, S) float32
// (-inf where the denominator is 0): the softmax statistics that let a
// caller merge the outputs of launches over different keys (the ring
// attention of parallel/ring.py) and that a backward pass needs. It is
// written in the epilogue only, by a second instantiation of the kernel;
// the main loop is the same for both entries.
//
// Translation from the TPU kernel: the TPU grid walks key tiles in order on
// one core and carries the running max / denominator / accumulator in VMEM
// scratch across grid steps. Blocks on Hopper run in parallel and in no
// order, so the key-tile walk is a loop inside one thread block and the
// carried state lives in registers.
//
// What bounds it on an H100 (the main path's shape, BH 32, S 2048, D 64,
// causal, float32): Q K^T and P V over the causal pairs are 17.2 GFLOP per
// layer against 67 MB of q/k/v/o traffic, about 256 FLOP per byte, far
// above the card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20): it is bound
// by operations, at least 0.257 ms. TF32 tensor cores keep ~10 mantissa
// bits and miss the rtol 1e-4 parity bar, so every float32 product here is
// an FFMA on the CUDA cores; bf16 and fp16 products are exact in float32
// and run on the tensor cores instead (flash_attention_tc.cuh). What the
// design does about each limit:
//
// 1. Shared-memory instructions, not FFMAs, set the pace of a scalar inner
//    loop. Register tiling: a block takes a Q tile of kBlockQ = 64 rows and
//    walks K/V tiles of kBlockK = 64 rows with 128 threads as 8 row groups
//    x 16 lanes. Thread (ty, tx) owns query rows 8 ty .. 8 ty + 7 and keys
//    tx + 16 j (j < 4) of the score tile, and the same 8 rows x output
//    columns 4 tx + 64 h .. +3 (h < ceil(D / 64)) of O. Every Q and K
//    operand is a 128-bit shared load, every V operand 4 elements: in
//    float32, Q K^T issues 128 FFMA per 12 loads and P V 32 FFMA per 3
//    loads at D 64, against 2 FFMA per scalar load. Rows are d-contiguous
//    with a stride of the row's bytes rounded up to 32, plus 16 (D + 4
//    floats): 16-byte aligned, and the 8 rows a quarter-warp reads fall on 8
//    distinct bank groups;
//    Q's odd 8-row groups are shifted by 16 more bytes so the two row
//    groups of one warp read distinct banks. P is float32 and written
//    key-major, so P V reads a thread's 8 rows as two float4. The row max
//    reduces with shuffles over the 16 lanes of a row group; the row sum
//    stays split over those lanes until the end.
// 2. Staging is asynchronous: Q and the K/V stream are copied with 16-byte
//    cp.async.cg; rows past the
//    ragged end are zero-filled by the copy's source-size operand. K and V
//    go through a two-slot ring in the order K0, V0, K1, V1, ...: V_kb is
//    in flight while Q K_kb^T is computed, and K_kb+1 while P V_kb is. Two
//    barriers per key tile. At D 64 a float32 block holds 70 KB of shared memory and
//    an SM three blocks; a two-stage ring of whole K+V tiles would take
//    104 KB and allow two.
// 3. Heaviest tiles first: the grid is one dimension of BH x ceil(S /
//    kBlockQ) blocks (x, not y, so that no sequence length meets y's limit
//    of 65,535), and block b takes head b % BH and query tile nq - 1 - b /
//    BH: the longest causal rows of every head are scheduled before any
//    short one, and the tail wave is short.
// 4. Masks only where needed: interior key tiles skip the compares; only
//    tiles that straddle the diagonal or the ragged end take them. Scores
//    stay unscaled; scale * log2(e) folds into one FFMA before exp2f. A
//    negative scale negates the staged Q tile once, so the running max of
//    the unscaled scores is the max of the scaled ones.
//
// The wide kernel (flash_attention_wide_kernel, any multiple of 8 past 128)
// replaces the same Pallas kernel for float32 heads wider than 128. Its
// bound at BH 16, S 2048, D 256, causal: 34.4 GFLOP over the causal pairs, 0.513
// ms at 67 TFLOP/s (q/k/v/o: 0.040 ms), so it is bound by operations. A
// thread's output block at D 256 would be 8 rows x 32 floats, which spills,
// and a block's Q, K, V and P tiles would need 217 KB: a block takes a
// 64-row query tile and a slice of kWideSliceD = 256 output columns (the
// slices of a tile are neighbours in the grid), and computes each key
// tile's scores once for the whole slice (Q K^T runs ceil(D / 256) times,
// once up to D 256). Its 256 threads are two groups of 128 with the
// one-slice kernel's 8 x 4 score block a thread and its 128 FFMA per 12
// shared loads: group g owns output columns 128 g .. 128 g + 127 of the
// slice (64 accumulators a thread) and sums the scores over alternate
// column chunks of 128 bytes (kWideChunkD: 32 floats).
// Each group writes its partial sums to shared memory (8 float4 a thread),
// and after one block barrier each adds the other's: a sum of two floats
// does not depend on their order, so both groups hold the same scores, run
// the same online softmax and keep the same row statistics. Group 0 writes
// P; both then accumulate P V over their columns, skipping 64-column
// halves that lie past D. Staging is by TMA: thread 0 of each group loads
// its chunks of Q and of the K tile, 64 rows x 128 bytes each, into a
// two-slot ring one chunk ahead (an mbarrier a slot; a named barrier a
// group frees the slot), and its V columns once a key tile; the tensor
// maps (D, S, BH) zero-fill rows past S and columns past D, and the
// 128-byte swizzle puts the 8 rows a quarter-warp reads on distinct banks.
// A thread holds query rows ty + 8 i, so a warp's two Q rows also differ
// in row % 8. Per key tile: two block barriers (partial sums written, P
// complete). Shared memory: 177 KB (the two rings 64, V 64, P 17, the
// partial sums 32); one block of 8 warps an SM, as the parent's two blocks
// of 4. Dropped: the parent's
// design, 128-column slices that each recomputed the full-width scores
// (1.5x the operations at D 256) over 64-column chunks staged one at a
// time after the last was multiplied; staging by 16-byte cp.async from
// every thread, 128 copies a chunk (6% slower at D 256 in turns, PERF.md);
// splitting the score tile by keys between the groups, which halves a
// thread's score block to 8 x 2 (10 shared loads per 64 FFMA); spreading
// the copies' issue over three warps, and prefetching the tensor maps (no
// gain). Not tried: keeping the whole Q tile resident (66.6 KB at D 256,
// no room past it).
//
// Tiles by measurement at the LM shape (H100 80GB HBM3 at 700 W; the sweep
// is in PERF.md): 64-row Q tiles with 128 threads took 0.461 ms against
// 0.518 ms for 128-row tiles with 256 threads, whose 128-register cap (two
// blocks per SM) spills at D 64. ptxas (CUDA 12.9, sm_90a), float32: D 64
// uses 168 registers (three blocks per SM) and D 128 uses 214 (one); the
// instantiation that stores the log-sum-exp uses 168 and 218. That
// instantiation is kept apart because a runtime branch on the pointer cost
// the entry without it 0.7% on an H100 (PERF.md). The wide kernel uses 236
// and 238 registers (its Q K^T fully unrolled: 3.5% faster at D 256 than
// unrolled by 2). No
// instantiation of the three libraries spills (chip_smoke.py checks every
// one; the registers of each are in PERF.md).

#pragma once

#include <climits>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 64;                 // keys per tile
constexpr int kThreads = 128;               // 16 lanes x 8 row groups of 8 rows
constexpr int kSliceD = 128;                // widest head of the one-slice kernel
constexpr int kTcSliceD = 256;              // widest padded head of the tensor-core kernel
constexpr int kWideThreads = 2 * kThreads;  // the wide kernel: two groups of kThreads
constexpr int kWideSliceD = 256;            // output columns a block of the wide kernel
constexpr int kWideBox = kBlockQ * 128;     // bytes of its TMA boxes: 64 rows of 128 bytes
constexpr float kNegInf = -1e30f;           // the TPU kernel's mask value
constexpr long long kWatchdog = 1LL << 34;  // clock cycles of one mbarrier wait
constexpr float kLog2e = 1.4426950408889634f;

// elements of T in one 16-byte copy
template <class T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Shared-memory layout of a block that holds whole rows of width D, in
// elements of T (P in floats).
template <class T, int D>
struct Layout {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  // the row's bytes rounded up to 32, plus 16: 16-byte aligned, and 8
  // consecutive rows start on 8 distinct 16-byte bank groups
  static constexpr int kStride = ((D * kSize + 31) / 32 * 32 + 16) / kSize;
  static constexpr int kPStride = kBlockQ + 4;  // P is key-major: one key per row
  static constexpr int kQ = kBlockQ * kStride;
  static constexpr int kKV = kBlockK * kStride;
  static constexpr int kP = kBlockK * kPStride;
  static constexpr int kBytes = (kQ + 2 * kKV) * kSize + kP * 4;
  static constexpr int kNV = (D + 63) / 64;     // 4-column output groups a thread
  // Blocks an SM should hold (the float32 one-slice kernel): at D <= 64
  // shared memory (at most 68 KB a block) allows three; a wider head keeps
  // a 64-register accumulator and takes one.
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};

// The wide kernel's chunk: the float32 columns of a 128-byte row, a step of
// one group's Q K^T and the width of its TMA boxes (the 128-byte swizzle's
// span)
constexpr int kWideChunkD = 128 / static_cast<int>(sizeof(float));

// V boxes a group of the wide kernel loads a key tile: its 128 columns
constexpr int kWidePieces = kWideSliceD / 2 / kWideChunkD;

// Shared memory of the wide kernel, in boxes after up to 1024 bytes of
// alignment (the swizzle repeats every 1024): each group's two slots of a Q
// and a K box, each group's V boxes, then P and each group's partial
// scores (8 float4 a thread).
struct WideLayout {
  static constexpr int kRing = 2 * 2 * 2 * kWideBox;     // [group][slot][Q, K]
  static constexpr int kV = 2 * kWidePieces * kWideBox;  // [group][box]
  static constexpr int kP = kBlockK * (kBlockQ + 4) * 4;
  static constexpr int kX = 2 * 8 * kThreads * 16;
  static constexpr int kBytes = 1024 + kRing + kV + kP + kX;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// two floats as two 2-byte values, rounded to nearest even (the tensor-core
// kernels' output)
template <class T>
__device__ __forceinline__ unsigned pack2(float a, float b);

template <>
__device__ __forceinline__ unsigned pack2<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Offset of row r of a tile of width D: with kSwizzle, odd 8-row groups
// are shifted by 16 bytes (still inside the row's padded slot).
template <class T, int D, bool kSwizzle>
__device__ __forceinline__ int row_offset(int r) {
  return r * Layout<T, D>::kStride + (kSwizzle ? ((r >> 3) & 1) * kVec<T> : 0);
}

// One 16-byte chunk, column c of row r of a tile, from global row row0 + r;
// a row at or past seq is zero-filled (its address clamped to the last row).
template <class T, int D, bool kSwizzle>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int r, int c, int row0,
                                           int seq) {
  const int gr = row0 + r;
  cp_async16(dst + row_offset<T, D, kSwizzle>(r) + c,
             src + static_cast<size_t>(min(gr, seq - 1)) * D + c, gr < seq ? 16 : 0);
}

// Issues the cp.async copies of rows row0 .. row0 + ROWS - 1 of one head
// (row length D) into a tile. A thread copies one column chunk of every
// kStep-th row, so its addresses are one base plus constants and nothing
// per copy stays live across the key loop; where a row's chunk count does
// not divide kThreads, the threads past the last whole row of chunks idle.
template <class T, int D, int ROWS, bool kSwizzle>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0, int seq, int tid) {
  constexpr int kV = kVec<T>;
  constexpr int kChunks = D / kV;  // 16-byte chunks per row
  constexpr int kStep = kThreads / kChunks;
  const int r0 = tid / kChunks, c = (tid % kChunks) * kV;
  if (kThreads % kChunks != 0 && r0 >= kStep) return;
#pragma unroll
  for (int it = 0; it < (ROWS + kStep - 1) / kStep; ++it) {
    const int r = r0 + it * kStep;
    if (ROWS % kStep == 0 || r < ROWS) copy_chunk<T, D, kSwizzle>(dst, src, r, c, row0, seq);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// this thread's arrival, and the bytes the phase waits for besides
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of this parity; a fresh
// barrier counts its phase before the first as complete at parity 1.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > kWatchdog) __trap();
}

// A box of the tensor map at element coordinates (c0, c1, c2), innermost
// first, into shared memory; the barrier counts its bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the named barrier of group g of the wide kernel (barrier 0 is the block's)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(kThreads) : "memory");
}

// s[i][j] += the product of Q row 8 ty + i and K row tx + 16 j over DC
// columns; qr and kr point at this thread's first Q and K rows, in tiles of
// row strides QS and KS.
template <int DC, int QS, int KS>
__device__ __forceinline__ void qk(float (&s)[8][4], const float* qr, const float* kr) {
#pragma unroll 4
  for (int d = 0; d < DC; d += 4) {
    float4 kf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kf[j] = ld4(kr + 16 * j * KS + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 qf = ld4(qr + i * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
        s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
        s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
        s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
      }
    }
  }
}

// One key tile's online-softmax step for a thread's 8 rows x 4 keys: s holds
// the unscaled scores on entry and the probabilities on exit; m is the
// running max of the unscaled scores, l this thread's part of the running
// denominator, acc the output rows (rescaled here). Row i is qr0 + R i.
template <bool kMask, int NA, int R>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m)[8], float (&l)[8],
                                               float (&acc)[8][NA], float sc, int qr0,
                                               int kc0, int seq, int causal) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = kc0 + 16 * j;
      ok[j] = !kMask || (kc < seq && !(causal && kc > qr0 + R * i));
      if (!ok[j]) s[i][j] = kNegInf;
    }
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float mc = m_new * sc;
    const float alpha = exp2f((m[i] - m_new) * sc);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = exp2f(fmaf(s[i][j], sc, -mc));
      s[i][j] = ok[j] ? p : 0.f;
      sum += s[i][j];
    }
    l[i] = fmaf(l[i], alpha, sum);
    m[i] = m_new;
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[i][a] *= alpha;
  }
}

// The scores' step of one key tile for the thread's 8 rows (8 ty + i, or
// with kInterleaved ty + 8 i): masked where the tile straddles the diagonal
// or the ragged end.
template <int NA, bool kInterleaved = false>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], float (&m)[8], float (&l)[8],
                                             float (&acc)[8][NA], float sc, int q0, int k0,
                                             int ty, int tx, int seq, int causal) {
  constexpr int R = kInterleaved ? 8 : 1;
  const int qr0 = q0 + (kInterleaved ? ty : 8 * ty);
  const bool edge = k0 + kBlockK > seq || (causal && k0 + kBlockK - 1 > q0);
  if (edge)
    online_softmax<true, NA, R>(s, m, l, acc, sc, qr0, k0 + tx, seq, causal);
  else
    online_softmax<false, NA, R>(s, m, l, acc, sc, qr0, k0 + tx, seq, causal);
}

// The thread's probabilities into P, key-major.
__device__ __forceinline__ void store_p(float* pw, const float (&s)[8][4]) {
  constexpr int PS = kBlockQ + 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* p = pw + 16 * j * PS;
    st4(p, s[0][j], s[1][j], s[2][j], s[3][j]);
    st4(p + 4, s[4][j], s[5][j], s[6][j], s[7][j]);
  }
}

// O += P V for this thread's 8 rows x 4 NV columns (column group h only
// where kFullV or tx + 16 h < kCols4); V rows of stride VS.
template <int NV, bool kFullV, int kCols4, int VS>
__device__ __forceinline__ void accumulate_pv(float (&acc)[8][4 * NV], const float* pr,
                                              const float* vr, int tx) {
  constexpr int PS = kBlockQ + 4;
#pragma unroll 8
  for (int c = 0; c < kBlockK; ++c) {
    const float4 p0 = ld4(pr + c * PS);
    const float4 p1 = ld4(pr + c * PS + 4);
    const float pc[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      if (kFullV || tx + 16 * h < kCols4) {
        const float4 vf = ld4(vr + c * VS + 64 * h);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * h + 0] = fmaf(pc[i], vf.x, acc[i][4 * h + 0]);
          acc[i][4 * h + 1] = fmaf(pc[i], vf.y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(pc[i], vf.z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(pc[i], vf.w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// The wide kernel's tiles are TMA boxes of 64 rows x 128 bytes, 128-byte
// swizzled: the 16-byte chunk u of row r lies at r 128 + ((u ^ r % 8) 16).
__device__ __forceinline__ int swizzled(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// s[i][j] += the product of Q row ty + 8 i and K row tx + 16 j over one
// chunk; both rows' chunk u at byte u ^ (row % 8), that is u ^ ty and
// u ^ tx % 8, so the 8 rows a quarter-warp reads and a warp's two Q rows
// fall on distinct banks.
__device__ __forceinline__ void qk_wide(float (&s)[8][4], const unsigned char* qt,
                                        const unsigned char* kt, int ty, int tx) {
  const unsigned char* qr = qt + ty * 128;
  const unsigned char* kr = kt + tx * 128;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int qu = (u ^ ty) << 4, ku = (u ^ (tx & 7)) << 4;
    float4 kf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kf[j] = ld4(reinterpret_cast<const float*>(kr + 2048 * j + ku));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 qf = ld4(reinterpret_cast<const float*>(qr + 1024 * i + qu));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
        s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
        s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
        s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
      }
    }
  }
}

// O += P V for the thread's 8 rows x columns 4 tx + 64 h (h < NH) of its
// group's 128, from the group's V boxes vg (kWideChunkD columns each)
template <int NH>
__device__ __forceinline__ void pv_wide(float (&acc)[8][8], const float* pr,
                                        const unsigned char* vg, int tx) {
  constexpr int PS = kBlockQ + 4;
  constexpr int kPerBox = kWideChunkD / 4;  // 4-column groups a box row
  // the thread's 4 columns of group h: box h 64 / kWideChunkD + tx / kPerBox,
  // the row's 16-byte chunk tx % kPerBox
  const int cu = tx % kPerBox;
  const unsigned char* vb = vg + (tx / kPerBox) * kWideBox;
#pragma unroll 8
  for (int c = 0; c < kBlockK; ++c) {
    const float4 p0 = ld4(pr + c * PS);
    const float4 p1 = ld4(pr + c * PS + 4);
    const float pc[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const int off = swizzled(c, cu);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float4 vf =
          ld4(reinterpret_cast<const float*>(vb + h * (64 / kWideChunkD) * kWideBox + off));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][4 * h + 0] = fmaf(pc[i], vf.x, acc[i][4 * h + 0]);
        acc[i][4 * h + 1] = fmaf(pc[i], vf.y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(pc[i], vf.z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(pc[i], vf.w, acc[i][4 * h + 3]);
      }
    }
  }
}

// The row's denominator over its 16 lanes; with kLse, lane 0 stores the
// log-sum-exp of the row's scaled scores, m |scale| + ln(l), where m is the
// running max in unscaled units (of the negated scores when the scale is
// negative); -inf for a row whose denominator is 0. Returns the
// denominator guarded to 1.
template <bool kLse>
__device__ __forceinline__ float finish_row(float li, float mi, float scale, float* lse,
                                            size_t at, bool store_lse) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
  if constexpr (kLse) {
    if (store_lse)
      lse[at] = li == 0.f ? __int_as_float(0xff800000) : fmaf(mi, fabsf(scale), logf(li));
  }
  return li == 0.f ? 1.f : li;
}

// The float32 kernel at head widths up to kSliceD. kLse: also store each
// row's log-sum-exp into lse (the second C entry); the instantiation
// without it is the kernel as it was before that output.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, Layout<float, D>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int bh, int seq, float scale, int causal) {
  using T = float;
  using L = Layout<T, D>;
  constexpr int S = L::kStride;
  constexpr int PS = L::kPStride;
  constexpr int NV = L::kNV;
  constexpr bool kFullV = D % 64 == 0;  // every lane owns output columns
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // kBlockQ x S, odd 8-row groups shifted
  T* ks = qs + L::kQ;                   // kBlockK x S
  T* vs = ks + L::kKV;                  // kBlockK x S
  float* ps = reinterpret_cast<float*>(vs + L::kKV);  // kBlockK x PS, key-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (seq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / bh)) * kBlockQ;  // heaviest first
  const size_t head = static_cast<size_t>(blockIdx.x % bh) * seq * D;
  const T* kh = k + head;
  const T* vh = v + head;

  stage_rows<T, D, kBlockQ, true>(qs, q + head, q0, seq, tid);
  stage_rows<T, D, kBlockK, false>(ks, kh, 0, seq, tid);
  cp_async_commit();

  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;  // keys any row sees
  const int nk = (k_end + kBlockK - 1) / kBlockK;
  float sc = scale * kLog2e;  // p = 2^(s sc - m sc)

  float m[8], l[8], acc[8][4 * NV];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < 4 * NV; ++a) acc[i][a] = 0.f;
  }

  cp_async_wait_all();
  __syncthreads();  // Q and K tile 0 are staged
  if (sc < 0.f) {
    for (int i = tid; i < L::kQ; i += kThreads) qs[i] = -qs[i];
    sc = -sc;
    __syncthreads();
  }

  const T* qr = qs + row_offset<T, D, true>(8 * ty);  // this thread's Q rows
  const T* kr = ks + tx * S;                          // and K rows (+ 16 j)
  float* pw = ps + tx * PS + 8 * ty;                  // its P entries
  const float* pr = ps + 8 * ty;                      // its P rows in P V
  const T* vr = vs + 4 * tx;                          // its V columns

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlockK;
    stage_rows<T, D, kBlockK, false>(vs, vh, k0, seq, tid);
    cp_async_commit();

    // S = Q K^T for this thread's 8 x 4 block
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    qk<D, S, S>(s, qr, kr);

    softmax_step(s, m, l, acc, sc, q0, k0, ty, tx, seq, causal);
    store_p(pw, s);

    cp_async_wait_all();
    __syncthreads();  // V tile kb and P are complete; K tile kb is consumed
    if (kb + 1 < nk) {
      stage_rows<T, D, kBlockK, false>(ks, kh, k0 + kBlockK, seq, tid);
      cp_async_commit();
    }

    accumulate_pv<NV, kFullV, D / 4, S>(acc, pr, vr, tx);

    cp_async_wait_all();
    __syncthreads();  // K tile kb + 1 is staged; V and P are consumed
  }

  const size_t lse_row = static_cast<size_t>(blockIdx.x % bh) * seq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * ty + i;
    const float li = finish_row<kLse>(l[i], m[i], scale, lse, lse_row + row,
                                      tx == 0 && row < seq);
    if (row >= seq) continue;
    T* orow = o + head + static_cast<size_t>(row) * D + 4 * tx;
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      if (kFullV || tx + 16 * h < D / 4) {
        st4(orow + 64 * h, acc[i][4 * h] / li, acc[i][4 * h + 1] / li,
            acc[i][4 * h + 2] / li, acc[i][4 * h + 3] / li);
      }
    }
  }
}

// float32 heads wider than kSliceD (see the header), any multiple of 8; only
// the float32 build instantiates it. Block b takes
// output slice b % slices (kWideSliceD columns) of head (b / slices) % BH's
// query tile nq - 1 - b / (slices BH). Group g (threads 128 g ..) owns the
// slice's columns 128 g .. 128 g + 127 and sums the scores over column
// chunks 1 - g, 3 - g, ...: where the chunk count is odd, group 1, whose
// columns in the last slice are the fewer, takes the extra chunk. A
// thread holds query rows ty + 8 i (not 8 ty + i: with the swizzle a
// warp's two Q rows then fall on distinct banks) and keys tx + 16 j.
template <bool kLse>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_attention_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                            float* __restrict__ lse, int bh, int seq, int d, int slices,
                            float scale, int causal) {
  using W = WideLayout;
  constexpr int CD = kWideChunkD;
  constexpr int NP = kWidePieces;
  constexpr int PS = kBlockQ + 4;
  constexpr int kHalf = kWideSliceD / 2;  // output columns a group
  extern __shared__ unsigned char wide_smem[];
  __shared__ __align__(8) uint64_t bars[2 * 3];  // a group's two chunk slots and its V boxes
  unsigned char* base = wide_smem + ((1024u - (smem_u32(wide_smem) & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int g = tid / kThreads;  // warp-uniform
  const int t = tid % kThreads;
  const int tx = t & 15;
  const int ty = t >> 4;
  unsigned char* ring = base + g * 4 * kWideBox;             // slot s: Q box, K box at 2 s
  unsigned char* vg = base + W::kRing + g * NP * kWideBox;   // this group's V boxes
  float* ps = reinterpret_cast<float*>(base + W::kRing + W::kV);  // kBlockK x PS, key-major
  float4* xs = reinterpret_cast<float4*>(ps + kBlockK * PS);      // [group][row i][thread]
  uint64_t* full = bars + 3 * g;  // the slots' barriers, then V's
  uint64_t* v_full = full + 2;

  const int slice = static_cast<int>(blockIdx.x % slices);
  const int rest = static_cast<int>(blockIdx.x / slices);
  const int nq = (seq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - rest / bh) * kBlockQ;   // heaviest first
  const int vcol = slice * kWideSliceD + kHalf * g;  // this group's output columns
  const int hd = rest % bh;
  const int chunks = (d + CD - 1) / CD;
  const int mine = (chunks + g) / 2;  // this group's chunks a key tile: at least 2
  const int first = 1 - g;            // its first chunk
  // its 64-column halves with a column before d; the boxes of the others
  // are neither loaded nor multiplied
  const int live = (vcol < d) + (vcol + 64 < d);

  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 6; ++b) mbar_init(bars + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 of each group issues its copies: chunk c of Q and of the K
  // tile at k0 into a slot, the live boxes of the V tile at k0
  const bool issuer = t == 0;
  auto load_chunk = [&](int slot, int k0, int c) {
    mbar_expect_tx(full + slot, 2 * kWideBox);
    tma_load(ring + 2 * slot * kWideBox, &tq, full + slot, c * CD, q0, hd);
    tma_load(ring + (2 * slot + 1) * kWideBox, &tk, full + slot, c * CD, k0, hd);
  };
  auto load_v = [&](int k0) {
    mbar_expect_tx(v_full, live * (NP / 2) * kWideBox);
    for (int p = 0; p < live * (NP / 2); ++p)
      tma_load(vg + p * kWideBox, &tv, v_full, vcol + p * CD, k0, hd);
  };

  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  const int nk = (k_end + kBlockK - 1) / kBlockK;
  // a negative scale negates the scores, so the running max of the
  // unscaled scores is the max of the scaled ones
  const bool neg = scale < 0.f;
  const float sc = fabsf(scale) * kLog2e;

  float m[8], l[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) acc[i][a] = 0.f;
  }

  float* pw = ps + tx * PS + 8 * ty;  // P column 8 ty + i holds row ty + 8 i
  const float* pr = ps + 8 * ty;
  float4* x_out = xs + g * 8 * kThreads + t;
  const float4* x_in = xs + (1 - g) * 8 * kThreads + t;

  if (issuer) load_chunk(0, 0, first);
  int n = 0;  // the group's chunks before this one: it is in slot n % 2
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlockK;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int i = 0; i < mine; ++i, ++n) {
      // the group is done with chunk n - 1, whose slot takes chunk n + 1,
      // and, at i = 0, with P V of the last tile: its V boxes are free
      group_sync(g);
      if (issuer) {
        if (i + 1 < mine)
          load_chunk((n + 1) & 1, k0, first + 2 * (i + 1));
        else if (kb + 1 < nk)
          load_chunk((n + 1) & 1, k0 + kBlockK, first);  // the next tile's first chunk
        if (i == 0 && live > 0) load_v(k0);
      }
      mbar_wait(full + (n & 1), (n >> 1) & 1);
      const unsigned char* cs = ring + 2 * (n & 1) * kWideBox;
      qk_wide(s, cs, cs + kWideBox, ty, tx);
    }

    // the scores: this group's partial sums plus the other's. A float sum
    // of two terms does not depend on their order, so both groups hold the
    // same scores, run the same online softmax and keep the same row
    // statistics (what merges them)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x_out[i * kThreads] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();  // both partial sums are written; both groups are done with P
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = x_in[i * kThreads];
      s[i][0] += x.x;
      s[i][1] += x.y;
      s[i][2] += x.z;
      s[i][3] += x.w;
      if (neg) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = -s[i][j];
      }
    }

    softmax_step<8, true>(s, m, l, acc, sc, q0, k0, ty, tx, seq, causal);
    if (g == 0) store_p(pw, s);

    if (live > 0) mbar_wait(v_full, kb & 1);  // this group's V boxes of tile kb
    __syncthreads();                          // P is complete
    if (live == 2)
      pv_wide<2>(acc, pr, vg, tx);
    else if (live == 1)
      pv_wide<1>(acc, pr, vg, tx);
  }

  const size_t head = static_cast<size_t>(hd) * seq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    const float li = finish_row<kLse>(l[i], m[i], scale, lse, head + row,
                                      slice == 0 && g == 0 && tx == 0 && row < seq);
    if (row >= seq) continue;
    float* orow = o + (head + row) * d + vcol + 4 * tx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (vcol + 4 * tx + 64 * h < d) {
        st4(orow + 64 * h, acc[i][4 * h] / li, acc[i][4 * h + 1] / li,
            acc[i][4 * h + 2] / li, acc[i][4 * h + 3] / li);
      }
    }
  }
}

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, or nullptr
inline TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// The (D, S, BH) tensor map of one operand (D a multiple of 8): boxes of
// cols columns (128 bytes) x rows rows of one head, 128-byte swizzled;
// elements outside the tensor read 0.
template <class T>
bool encode_map(CUtensorMap* map, TensorMapEncode encode, const T* base, int bh, int seq, int d,
                int cols, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(T),
                                 static_cast<cuuint64_t>(seq) * d * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<T*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// blocks of a one-dimensional grid, or 0 past gridDim.x's limit
inline unsigned grid_blocks(int slices, int bh, int seq) {
  const long long n = static_cast<long long>(slices) * bh * ((seq + kBlockQ - 1) / kBlockQ);
  return n > INT_MAX ? 0u : static_cast<unsigned>(n);
}

template <int D, bool kLse>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                   int seq, float scale, int causal, cudaStream_t stream) {
  using L = Layout<float, D>;
  const auto kernel = flash_attention_kernel<D, kLse>;
  const cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = grid_blocks(1, bh, seq);
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  kernel<<<blocks, kThreads, L::kBytes, stream>>>(q, k, v, o, lse, bh, seq, scale, causal);
  return cudaGetLastError();
}

template <bool kLse>
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* o, float* lse,
                        int bh, int seq, int d, float scale, int causal, cudaStream_t stream) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, encode, q, bh, seq, d, kWideChunkD, kBlockQ) ||
      !encode_map(&mk, encode, k, bh, seq, d, kWideChunkD, kBlockK) ||
      !encode_map(&mv, encode, v, bh, seq, d, kWideChunkD, kBlockK))
    return cudaErrorInvalidValue;
  using W = WideLayout;
  const auto kernel = flash_attention_wide_kernel<kLse>;
  const cudaError_t err = prepare(kernel, W::kBytes);
  if (err != cudaSuccess) return err;
  const int slices = (d + kWideSliceD - 1) / kWideSliceD;
  const unsigned blocks = grid_blocks(slices, bh, seq);
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  kernel<<<blocks, kWideThreads, W::kBytes, stream>>>(mq, mk, mv, o, lse, bh, seq, d, slices,
                                                      scale, causal);
  return cudaGetLastError();
}

// The tensor-core kernels of bf16 and fp16 at every padded head width,
// defined in flash_attention_tc.cuh, which only the 2-byte builds include.
template <class T>
cudaError_t launch_tc(const T* q, const T* k, const T* v, T* o, float* lse, int bh, int seq,
                      int d8, float scale, int causal, cudaStream_t stream);

// The kernel the last dispatch on this thread launched (tfs_flash_attention_
// last_route): the float32 one-slice kernel, the float32 wide kernel or a
// tensor-core kernel.
enum Route { kRouteNone = -1, kRouteCudaCore = 0, kRouteWide = 1, kRouteTensorCore = 2 };
thread_local int last_route = kRouteNone;

// One launch at the given head_dim (a positive multiple of 8). Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for another head_dim,
// cudaErrorInvalidConfiguration for a grid past 2^31 - 1 blocks.
template <class T>
int dispatch(const void* qv, const void* kv, const void* vv, void* ov, float* lse, int bh,
             int seq, int head_dim, float scale, int causal, void* stream) {
  last_route = kRouteNone;
  if (bh <= 0 || seq <= 0) return 0;
  if (head_dim <= 0 || head_dim % 8) return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  T* o = static_cast<T*>(ov);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    last_route = kRouteTensorCore;
    return launch_tc<T>(q, k, v, o, lse, bh, seq, head_dim, scale, causal, s);
  } else if (head_dim > kSliceD) {
    last_route = kRouteWide;
    return lse != nullptr ? launch_wide<true>(q, k, v, o, lse, bh, seq, head_dim, scale, causal, s)
                          : launch_wide<false>(q, k, v, o, lse, bh, seq, head_dim, scale, causal, s);
  } else {
    last_route = kRouteCudaCore;
    switch (head_dim) {
#define TFS_CASE(D)                                                                   \
  case D:                                                                             \
    return lse != nullptr ? launch<D, true>(q, k, v, o, lse, bh, seq, scale, causal, s) \
                          : launch<D, false>(q, k, v, o, lse, bh, seq, scale, causal, s);
      TFS_CASE(8) TFS_CASE(16) TFS_CASE(24) TFS_CASE(32)
      TFS_CASE(40) TFS_CASE(48) TFS_CASE(56) TFS_CASE(64)
      TFS_CASE(72) TFS_CASE(80) TFS_CASE(88) TFS_CASE(96)
      TFS_CASE(104) TFS_CASE(112) TFS_CASE(120) TFS_CASE(128)
#undef TFS_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace

// The C interface of one element type (loaded with ctypes), SUFFIX naming
// it; each entry returns dispatch's cudaError_t. The _lse entry also
// stores each row's log-sum-exp of its scaled scores into lse, a
// contiguous (bh, seq) float32 array. tfs_flash_attention_last_route gives
// the Route of the calling thread's last dispatch, -1 where it launched
// nothing.
#define TFS_ATTENTION_ENTRIES(T, SUFFIX)                                                    \
  extern "C" int tfs_flash_attention_##SUFFIX(const void* q, const void* k, const void* v,  \
                                              void* o, int bh, int seq, int head_dim,       \
                                              float scale, int causal, void* stream) {      \
    return dispatch<T>(q, k, v, o, nullptr, bh, seq, head_dim, scale, causal, stream);      \
  }                                                                                         \
  extern "C" int tfs_flash_attention_lse_##SUFFIX(const void* q, const void* k,             \
                                                  const void* v, void* o, float* lse,       \
                                                  int bh, int seq, int head_dim,            \
                                                  float scale, int causal, void* stream) {  \
    return dispatch<T>(q, k, v, o, lse, bh, seq, head_dim, scale, causal, stream);          \
  }                                                                                         \
  extern "C" const char* tfs_cuda_error_string(int code) {                                  \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }                                                                                         \
  extern "C" int tfs_flash_attention_last_route() { return last_route; }
