// Blockwise (flash) attention for Hopper (sm_90a), float32, forward only.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// tensorframes_tpu/ops/pallas_kernels.py (pallas_call at :122). Same
// function: per head, out = softmax(Q K^T * scale) V with an online
// softmax; `causal` masks key > query and skips whole key tiles above the
// diagonal; keys past the end of a ragged sequence are masked; a row whose
// denominator is 0 is guarded to 1. Layout: q, k, v, o are contiguous
// (BH, S, D) float32, all heads of a batch in one launch, D a multiple of 8
// in [8, 128]. A second entry also stores each row's log-sum-exp of its
// scaled scores, (BH, S) float32 (-inf where the denominator is 0): the
// softmax statistics that let a caller merge the outputs of launches over
// different keys (the ring attention of parallel/ring.py) and that a
// backward pass needs. It is written in the epilogue only, by a second
// instantiation of the kernel; the main loop is the same for both entries.
//
// Translation from the TPU kernel: the TPU grid walks key tiles in order on
// one core and carries the running max / denominator / accumulator in VMEM
// scratch across grid steps. Blocks on Hopper run in parallel and in no
// order, so the key-tile walk is a loop inside one thread block and the
// carried state lives in registers.
//
// What bounds it on an H100 (the main path's shape, BH 32, S 2048, D 64,
// causal): Q K^T and P V over the causal pairs are 17.2 GFLOP of float32 per
// layer against 67 MB of q/k/v/o traffic, about 256 FLOP per byte, far
// above the card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20): it is bound
// by operations, at least 0.257 ms. TF32 tensor cores keep ~10 mantissa
// bits and miss the rtol 1e-4 parity bar, so every product here is a
// float32 FFMA on the CUDA cores. What the design does about each limit:
//
// 1. Shared-memory instructions, not FFMAs, set the pace of a scalar inner
//    loop. Register tiling: a block takes a Q tile of kBlockQ = 64 rows and
//    walks K/V tiles of kBlockK = 64 rows with 128 threads as 8 row groups
//    x 16 lanes. Thread (ty, tx) owns query rows 8 ty .. 8 ty + 7 and keys
//    tx + 16 j (j < 4) of the score tile, and the same 8 rows x output
//    columns 4 tx + 64 h .. +3 (h < ceil(D / 64)) of O. Every operand is a
//    128-bit shared load (float4): Q K^T issues 128 FFMA per 12 loads, P V
//    32 FFMA per 3 loads at D 64, against 2 FFMA per scalar load.
//    Rows are d-contiguous with a stride of D + 4 floats, which keeps 16-byte
//    alignment and puts the 8 rows a quarter-warp reads on 8 distinct bank
//    groups; Q's odd 8-row groups are shifted by 4 more floats so the two
//    row groups of one warp read distinct banks. P is written key-major, so
//    P V reads a thread's 8 rows as two float4. The row max reduces with
//    shuffles over the 16 lanes of a row group; the row sum stays split over
//    those lanes until the end.
// 2. Staging is asynchronous: Q and the K/V stream are copied with 16-byte
//    cp.async.cg; rows past the ragged end are zero-filled by the copy's
//    source-size operand. K and V go through a two-slot ring in the order
//    K0, V0, K1, V1, ...: V_kb is in flight while Q K_kb^T is computed, and
//    K_kb+1 while P V_kb is. Two barriers per key tile. At D 64 a block
//    holds 70 KB of shared memory and an SM three blocks; a two-stage ring
//    of whole K+V tiles would take 104 KB and allow two.
// 3. Heaviest tiles first: the grid is (BH, ceil(S / kBlockQ)) and block y
//    takes query tile nq - 1 - y, so the longest causal rows of every head
//    are scheduled before any short one and the tail wave is short.
// 4. Masks only where needed: interior key tiles skip the compares; only
//    tiles that straddle the diagonal or the ragged end take them. Scores
//    stay unscaled; scale * log2(e) folds into one FFMA before exp2f. A
//    negative scale negates the staged Q tile once, so the running max of
//    the unscaled scores is the max of the scaled ones.
//
// Tiles by measurement at the LM shape (H100 80GB HBM3 at 700 W; the sweep
// is in PERF.md): 64-row Q tiles with 128 threads took 0.461 ms against
// 0.518 ms for 128-row tiles with 256 threads, whose 128-register cap (two
// blocks per SM) spills at D 64. ptxas (CUDA 12.9, sm_90a): D 64 uses 168
// registers (three blocks per SM) and D 128 uses 218 (one), both with 0
// bytes of spill stores and loads; the instantiation that stores the
// log-sum-exp uses 168 and 220. That instantiation is kept apart because a
// runtime branch on the pointer cost the entry without it 0.7% on an
// H100 (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 64;                 // keys per tile
constexpr int kThreads = 128;               // 16 lanes x 8 row groups of 8 rows
constexpr float kNegInf = -1e30f;           // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one block, in floats.
template <int D>
struct Layout {
  static constexpr int kStride = D + 4;         // Q, K, V row stride
  static constexpr int kPStride = kBlockQ + 4;  // P is key-major: one key per row
  static constexpr int kQ = kBlockQ * kStride;
  static constexpr int kKV = kBlockK * kStride;
  static constexpr int kP = kBlockK * kPStride;
  static constexpr int kBytes = (kQ + 2 * kKV + kP) * 4;
  static constexpr int kNV = (D + 63) / 64;     // float4 output columns a thread
  // Blocks an SM should hold: at D <= 64 shared memory (at most 68 KB a
  // block) allows three; a wider head keeps a 64-register accumulator and
  // takes one.
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
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

// Offset of row r of a tile: stride D + 4; with kSwizzle, odd 8-row groups
// are shifted by 4 floats (still inside the row's padded slot).
template <int D, bool kSwizzle>
__device__ __forceinline__ int row_offset(int r) {
  return r * (D + 4) + (kSwizzle ? ((r >> 3) & 1) * 4 : 0);
}

// One 16-byte chunk, column c of row r of a tile, from global row row0 + r;
// a row at or past seq is zero-filled (its address clamped to the last row).
template <int D, bool kSwizzle>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, int r, int c, int row0,
                                           int seq) {
  const int gr = row0 + r;
  cp_async16(dst + row_offset<D, kSwizzle>(r) + c,
             src + static_cast<size_t>(min(gr, seq - 1)) * D + c, gr < seq ? 16 : 0);
}

// Issues the cp.async copies of rows row0 .. row0 + ROWS - 1 of one head
// (row length D) into a tile. Where a row's chunk count divides THREADS, a
// thread copies one column chunk of every kStep-th row, so its addresses are
// one base plus constants and nothing per copy stays live across the key
// loop.
template <int D, int ROWS, int THREADS, bool kSwizzle>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int seq,
                                           int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  if constexpr (THREADS % kChunks == 0) {
    constexpr int kStep = THREADS / kChunks;
    const int r0 = tid / kChunks, c = (tid % kChunks) * 4;
#pragma unroll
    for (int it = 0; it < (ROWS + kStep - 1) / kStep; ++it) {
      const int r = r0 + it * kStep;
      if (ROWS % kStep == 0 || r < ROWS) copy_chunk<D, kSwizzle>(dst, src, r, c, row0, seq);
    }
  } else {
    constexpr int kTotal = ROWS * kChunks;
#pragma unroll
    for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
      const int i = tid + it * THREADS;
      if (kTotal % THREADS == 0 || i < kTotal)
        copy_chunk<D, kSwizzle>(dst, src, i / kChunks, (i % kChunks) * 4, row0, seq);
    }
  }
}

// One key tile's online-softmax step for a thread's 8 rows x 4 keys: s holds
// the unscaled scores on entry and the probabilities on exit; m is the
// running max of the unscaled scores, l this thread's part of the running
// denominator, acc the output rows (rescaled here).
template <bool kMask, int NA>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m)[8], float (&l)[8],
                                               float (&acc)[8][NA], float sc, int qr0,
                                               int kc0, int seq, int causal) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = kc0 + 16 * j;
      ok[j] = !kMask || (kc < seq && !(causal && kc > qr0 + i));
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

// kLse: also store each row's log-sum-exp into lse (the second C entry);
// the instantiation without it is the kernel as it was before that output.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int seq, float scale, int causal) {
  using L = Layout<D>;
  constexpr int T = kThreads;
  constexpr int S = L::kStride;
  constexpr int PS = L::kPStride;
  constexpr int NV = L::kNV;
  constexpr bool kFullV = D % 64 == 0;  // every lane owns output columns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;          // kBlockQ x S, odd 8-row groups shifted
  float* ks = qs + L::kQ;    // kBlockK x S
  float* vs = ks + L::kKV;   // kBlockK x S
  float* ps = vs + L::kKV;   // kBlockK x PS, key-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest tiles first
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const float* kh = k + head;
  const float* vh = v + head;

  stage_rows<D, kBlockQ, T, true>(qs, q + head, q0, seq, tid);
  stage_rows<D, kBlockK, T, false>(ks, kh, 0, seq, tid);
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
    for (int i = tid; i < L::kQ; i += T) qs[i] = -qs[i];
    sc = -sc;
    __syncthreads();
  }

  const float* qr = qs + row_offset<D, true>(8 * ty);  // this thread's Q rows
  const float* kr = ks + tx * S;                       // and K rows (+ 16 j)
  float* pw = ps + tx * PS + 8 * ty;                   // its P entries
  const float* pr = ps + 8 * ty;                       // its P rows in P V
  const float* vr = vs + 4 * tx;                       // its V columns

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlockK;
    stage_rows<D, kBlockK, T, false>(vs, vh, k0, seq, tid);
    cp_async_commit();

    // S = Q K^T for this thread's 8 x 4 block
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = ld4(kr + 16 * j * S + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf = ld4(qr + i * S + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    const bool edge = k0 + kBlockK > seq || (causal && k0 + kBlockK - 1 > q0);
    if (edge)
      online_softmax<true>(s, m, l, acc, sc, q0 + 8 * ty, k0 + tx, seq, causal);
    else
      online_softmax<false>(s, m, l, acc, sc, q0 + 8 * ty, k0 + tx, seq, causal);

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* p = pw + 16 * j * PS;
      st4(p, s[0][j], s[1][j], s[2][j], s[3][j]);
      st4(p + 4, s[4][j], s[5][j], s[6][j], s[7][j]);
    }

    cp_async_wait_all();
    __syncthreads();  // V tile kb and P are complete; K tile kb is consumed
    if (kb + 1 < nk) {
      stage_rows<D, kBlockK, T, false>(ks, kh, k0 + kBlockK, seq, tid);
      cp_async_commit();
    }

    // O += P V for this thread's 8 rows x 4 NV columns
#pragma unroll 8
    for (int c = 0; c < kBlockK; ++c) {
      const float4 p0 = ld4(pr + c * PS);
      const float4 p1 = ld4(pr + c * PS + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        if (kFullV || tx + 16 * h < D / 4) {
          const float4 vf = ld4(vr + c * S + 64 * h);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * h + 0] = fmaf(pv[i], vf.x, acc[i][4 * h + 0]);
            acc[i][4 * h + 1] = fmaf(pv[i], vf.y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(pv[i], vf.z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(pv[i], vf.w, acc[i][4 * h + 3]);
          }
        }
      }
    }

    cp_async_wait_all();
    __syncthreads();  // K tile kb + 1 is staged; V and P are consumed
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + 8 * ty + i;
    if (row >= seq) continue;
    if constexpr (kLse) {
      // the softmax statistics, for a caller that merges several launches'
      // outputs (the ring of parallel/ring.py): the log-sum-exp of the row's
      // scaled scores, m scale + ln(l), where m is the running max in
      // unscaled units (of the negated Q when the scale is negative, so
      // |scale|); -inf for a row whose denominator is 0
      if (tx == 0)
        lse[static_cast<size_t>(blockIdx.x) * seq + row] =
            li == 0.f ? __int_as_float(0xff800000) : fmaf(m[i], fabsf(scale), logf(li));
    }
    li = li == 0.f ? 1.f : li;
    float* orow = o + head + static_cast<size_t>(row) * D + 4 * tx;
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      if (kFullV || tx + 16 * h < D / 4) {
        st4(orow + 64 * h, acc[i][4 * h] / li, acc[i][4 * h + 1] / li,
            acc[i][4 * h + 2] / li, acc[i][4 * h + 3] / li);
      }
    }
  }
}

template <int D, bool kLse>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                   int seq, float scale, int causal, cudaStream_t stream) {
  using L = Layout<D>;
  const auto kernel = flash_attention_f32_kernel<D, kLse>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(q, k, v, o, lse, seq, scale, causal);
  return cudaGetLastError();
}

// One launch at the given head_dim. Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a head_dim the kernel was not built for.
int dispatch(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
             int seq, int head_dim, float scale, int causal, void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define TFS_CASE(D)                                                      \
  case D:                                                                \
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

}  // namespace

// C interface (loaded with ctypes); each returns dispatch's cudaError_t.
extern "C" int tfs_flash_attention_f32(const float* q, const float* k, const float* v,
                                       float* o, int bh, int seq, int head_dim, float scale,
                                       int causal, void* stream) {
  return dispatch(q, k, v, o, nullptr, bh, seq, head_dim, scale, causal, stream);
}

// The same, and each row's log-sum-exp of its scaled scores into lse, a
// contiguous (bh, seq) float32 array.
extern "C" int tfs_flash_attention_lse_f32(const float* q, const float* k, const float* v,
                                           float* o, float* lse, int bh, int seq, int head_dim,
                                           float scale, int causal, void* stream) {
  return dispatch(q, k, v, o, lse, bh, seq, head_dim, scale, causal, stream);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
