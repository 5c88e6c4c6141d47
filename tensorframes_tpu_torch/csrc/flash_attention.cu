// Blockwise (flash) attention for Hopper (sm_90a), float32, forward only.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// tensorframes_tpu/ops/pallas_kernels.py (pallas_call at :122). Same
// function: per head, out = softmax(Q K^T * scale) V with an online
// softmax; `causal` masks key > query and skips whole key tiles above the
// diagonal; keys past the end of a ragged sequence are masked; a row whose
// denominator is 0 is guarded to 1. Layout: q, k, v, o are contiguous
// (BH, S, D) float32, all heads of a batch in one launch.
//
// Translation from the TPU kernel: the TPU grid walks key tiles in order on
// one core and carries the running max / denominator / accumulator in VMEM
// scratch across grid steps. Blocks on Hopper run in parallel and in no
// order, so the key-tile walk is a loop inside one thread block and the
// carried state lives in registers. Grid = (ceil(S / 64), BH); each block
// stages its 64-row Q tile once and then one 64-row K/V tile at a time in
// dynamic shared memory (rows padded by one float against bank conflicts).
// 256 threads as 16 x 16: thread (ty, tx) owns query rows ty + 16 i and key
// columns tx + 16 j (i, j < 4) of the score tile, and output columns
// tx + 16 jj of the same rows, so row max and row sum reduce over the 16
// lanes of a half-warp with shuffles.
//
// What bounds it on an H100 (the main path's shape, BH = 32, S = 2048,
// D = 64, causal): Q K^T and P V are 4 BH S^2 D / 2 = 17.2 GFLOP of float32
// per layer against 64 MiB of q/k/v/o traffic, about 256 FLOP per byte,
// far above the card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20): it is
// bound by operations, at least 0.26 ms. This first version does plain
// float32 FMAs on the CUDA cores (TF32 tensor cores would miss the f32
// parity bar); its inner loops read two shared-memory operands per FMA
// pair, so shared-memory bandwidth, not the FMA rate, is its real limit.
// The design answer is to keep every score and the accumulator out of
// device memory (O(S) traffic instead of O(S^2)) and to skip masked tiles;
// register tiling, wgmma and bf16 are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockK + 1;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__host__ __device__ constexpr size_t smem_floats(int d) {
  return 3 * kBlockQ * static_cast<size_t>(d + 1) + kBlockQ * kPStride;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int seq, float scale,
                           int causal) {
  constexpr int DP = D + 1;            // padded row stride in shared memory
  constexpr int NJ = (D + 15) / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // kBlockQ x DP
  float* ks = qs + kBlockQ * DP;       // kBlockK x DP
  float* vs = ks + kBlockK * DP;       // kBlockK x DP
  float* ps = vs + kBlockK * DP;       // kBlockQ x kPStride

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qb = blockIdx.x;
  const int q0 = qb * kBlockQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = q0 + r;
    qs[r * DP + c] = gr < seq ? q[head + static_cast<size_t>(gr) * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  int nk = (seq + kBlockK - 1) / kBlockK;
  if (causal) nk = min(nk, qb + 1);  // tiles wholly above the diagonal
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool ok = gr < seq;
      const size_t g = head + static_cast<size_t>(gr) * D + c;
      ks[r * DP + c] = ok ? k[g] : 0.f;
      vs[r * DP + c] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      bool ok[4];
      float rowmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        ok[j] = kc < seq && (!causal || kc <= qr);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_new = fmaxf(m[i], rowmax);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l[i] = alpha * l[i] + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx + 16 * jj;
        const float vv = d < D ? vs[c * DP + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= seq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) o[head + static_cast<size_t>(qr) * D + d] = acc[i][jj] / li;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int bh, int seq, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_f32_kernel<D>
      <<<grid, kThreads, smem, stream>>>(q, k, v, o, seq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a head_dim the kernel was not built for.
extern "C" int tfs_flash_attention_f32(const float* q, const float* k,
                                       const float* v, float* o, int bh,
                                       int seq, int head_dim, float scale,
                                       int causal, void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define TFS_CASE(D) \
  case D:           \
    return launch<D>(q, k, v, o, bh, seq, scale, causal, s);
    TFS_CASE(8) TFS_CASE(16) TFS_CASE(24) TFS_CASE(32)
    TFS_CASE(40) TFS_CASE(48) TFS_CASE(56) TFS_CASE(64)
    TFS_CASE(72) TFS_CASE(80) TFS_CASE(88) TFS_CASE(96)
    TFS_CASE(104) TFS_CASE(112) TFS_CASE(120) TFS_CASE(128)
#undef TFS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
