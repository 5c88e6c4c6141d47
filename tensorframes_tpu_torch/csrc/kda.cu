// Kimi Delta Attention (KDA): the gated delta-rule recurrence of one linear
// attention layer, token by token with the state on chip.
//
// It replaces no TPU kernel: the JAX package has no linear-attention layer.
// A token-by-token loop of library operations would take several launches a
// token, 4,096 tokens a layer.
//
// For each sequence b and head h, with q_t and k_t L2-normalised (dk = 128),
// the log-decay g_t (dk), beta_t (a scalar) and v_t (dv = 128), and the state
// S (dk x dv) zero at the sequence's start:
//   S'  = Diag(exp(g_t)) S
//   u_t = v_t - S'^T k_t
//   S   = S' + beta_t k_t u_t^T
//   o_t = scale * S^T q_t
// The kernel takes o_t as scale * (S'^T q_t + beta_t u_t (k_t . q_t)), which
// equals S^T q_t, so that both reductions of a step (over S' k and S' q) share
// one pass and one exchange between threads. No state is written out.
//
// Bound by latency: 7 operations a state element a token against 20 bytes of
// q, k, g, v and o a row, but every token waits on the one before. The design
// spreads one head's state over 4 blocks (32 value columns each) and each
// column's 128 rows over 8 threads of a warp (16 rows a thread, in registers),
// so that a step is 16 rows of arithmetic and a 3-level shuffle a thread,
// with 2 warps on each of an SM's schedulers at 32 heads. The block stages
// kSteps tokens of q, k, exp(g), its v columns and beta in shared memory
// (double-buffered, the next tokens' global loads issued before the current
// tokens' steps), each thread reading its rows as 16-byte vectors: the 8
// threads of a column read 8 consecutive vectors, which share no bank.
// exp(g) is taken once an element as it is staged (expf, not the fast
// intrinsic). The C entry launches on the stream it is given, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kDim = 128;                   // dk = dv
constexpr int kCols = 32;                   // value columns a block
constexpr int kGroups = 8;                  // threads that share a column
constexpr int kRows = kDim / kGroups;       // rows a thread: 16
constexpr int kVecs = kRows / 4;            // 16-byte vectors of them: 4
constexpr int kThreads = kCols * kGroups;   // 256
constexpr int kSlices = kDim / kCols;       // blocks a head: 4
constexpr int kColsPerWarp = 32 / kGroups;  // 4
constexpr int kSteps = 8;                   // tokens staged at once
constexpr int kRowVecs = kDim / 4;          // 16-byte vectors a row: 32

static_assert(kSteps * kRowVecs == kThreads, "one q, k and g vector a thread a stage");
static_assert(kSteps * kCols / 4 <= kThreads, "one v vector a thread a stage at most");

struct Stage {
  float4 a[kSteps][kRowVecs];  // exp(g)
  float4 k[kSteps][kRowVecs];
  float4 q[kSteps][kRowVecs];
  float4 v[kSteps][kCols / 4];
  float beta[kSteps];
};

// What a thread loads of one stage, held in registers until the stage's
// buffer is free.
struct Fetch {
  float4 q, k, g, v;
  float beta;
};

__device__ __forceinline__ float4 exp4(float4 g) {
  return make_float4(expf(g.x), expf(g.y), expf(g.z), expf(g.w));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Row offset (in floats) of token t of sequence b, head h, in (B, S, H, 128).
__device__ __forceinline__ long long row_of(int b, long long t, int h, long long seq, int heads) {
  return ((static_cast<long long>(b) * seq + t) * heads + h) * kDim;
}

__device__ __forceinline__ void fetch(Fetch& f, const float* q, const float* k, const float* g,
                                      const float* beta, const float* v, int b, int h, int col0,
                                      long long t0, long long seq, int heads) {
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const int s = tid / kRowVecs, c = tid % kRowVecs;
    const long long t = t0 + s;
    if (t < seq) {
      const long long r = row_of(b, t, h, seq, heads) + 4 * c;
      f.q = load4(q + r);
      f.k = load4(k + r);
      f.g = load4(g + r);
    } else {
      f.q = f.k = f.g = zero;
    }
  }
  if (tid < kSteps * kCols / 4) {
    const int s = tid / (kCols / 4), c = tid % (kCols / 4);
    const long long t = t0 + s;
    f.v = t < seq ? load4(v + row_of(b, t, h, seq, heads) + col0 + 4 * c) : zero;
  }
  if (tid < kSteps) {
    const long long t = t0 + tid;
    f.beta = t < seq ? __ldg(beta + (static_cast<long long>(b) * seq + t) * heads + h) : 0.f;
  }
}

__device__ __forceinline__ void stage(Stage& st, const Fetch& f) {
  const int tid = threadIdx.x;
  const int s = tid / kRowVecs, c = tid % kRowVecs;
  st.q[s][c] = f.q;
  st.k[s][c] = f.k;
  st.a[s][c] = exp4(f.g);
  if (tid < kSteps * kCols / 4) st.v[tid / (kCols / 4)][tid % (kCols / 4)] = f.v;
  if (tid < kSteps) st.beta[tid] = f.beta;
}

// The sum over the kGroups threads of a column (lanes that differ in their low
// bits); every one of them gets the same sum, added in the same order.
__device__ __forceinline__ float column_sum(float x) {
#pragma unroll
  for (int m = 1; m < kGroups; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__global__ void __launch_bounds__(kThreads) kda_kernel(const float* __restrict__ q,
                                                       const float* __restrict__ k,
                                                       const float* __restrict__ g,
                                                       const float* __restrict__ beta,
                                                       const float* __restrict__ v,
                                                       float* __restrict__ out, long long seq,
                                                       int heads, float scale) {
  __shared__ Stage st[2];
  const int slice = blockIdx.x % kSlices;
  const int h = (blockIdx.x / kSlices) % heads;
  const int b = blockIdx.x / (kSlices * heads);
  const int col0 = slice * kCols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = warp * kColsPerWarp + lane / kGroups;  // within the block's columns
  const int grp = lane % kGroups;  // rows 4 * (m * kGroups + grp) + j, m < kVecs, j < 4

  float s[kRows];  // S[rows, col0 + col]
#pragma unroll
  for (int i = 0; i < kRows; ++i) s[i] = 0.f;

  Fetch f;
  fetch(f, q, k, g, beta, v, b, h, col0, 0, seq, heads);
  stage(st[0], f);
  __syncthreads();
  const long long chunks = (seq + kSteps - 1) / kSteps;
  for (long long c = 0; c < chunks; ++c) {
    const Stage& cur = st[c & 1];
    const long long t0 = c * kSteps;
    const bool more = c + 1 < chunks;
    if (more) fetch(f, q, k, g, beta, v, b, h, col0, t0 + kSteps, seq, heads);
    const int steps = static_cast<int>(seq - t0 < kSteps ? seq - t0 : kSteps);
    for (int t = 0; t < steps; ++t) {
      float kr[kRows];
      float ak[4] = {0.f, 0.f, 0.f, 0.f}, aq[4] = {0.f, 0.f, 0.f, 0.f};
      float kq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const int vec = m * kGroups + grp;
        const float4 a4 = cur.a[t][vec], k4 = cur.k[t][vec], q4 = cur.q[t][vec];
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * m + j;
          s[i] *= av[j];
          kr[i] = kv[j];
          ak[j] = fmaf(s[i], kv[j], ak[j]);
          aq[j] = fmaf(s[i], qv[j], aq[j]);
          kq[j] = fmaf(kv[j], qv[j], kq[j]);
        }
      }
      const float sk = column_sum((ak[0] + ak[1]) + (ak[2] + ak[3]));
      const float sq = column_sum((aq[0] + aq[1]) + (aq[2] + aq[3]));
      const float kdq = column_sum((kq[0] + kq[1]) + (kq[2] + kq[3]));
      const float4 v4 = cur.v[t][col / 4];
      const float vj = (col & 3) == 0 ? v4.x : (col & 3) == 1 ? v4.y : (col & 3) == 2 ? v4.z : v4.w;
      const float w = cur.beta[t] * (vj - sk);
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = fmaf(kr[i], w, s[i]);
      if (grp == 0) out[row_of(b, t0 + t, h, seq, heads) + col0 + col] = scale * fmaf(w, kdq, sq);
    }
    if (more) stage(st[(c + 1) & 1], f);
    __syncthreads();
  }
}

}  // namespace

// o (B, S, H, 128) of the recurrence over q, k, g, v (B, S, H, 128) and beta
// (B, S, H), all float32, contiguous and 16-byte aligned, q and k normalised
// by the caller; one launch of B * H * 4 blocks.
extern "C" int tfs_kda(const float* q, const float* k, const float* g, const float* beta,
                       const float* v, float* out, int batch, long long seq, int heads,
                       float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq < 0) return cudaErrorInvalidValue;
  if (seq == 0) return cudaSuccess;
  const long long blocks = static_cast<long long>(batch) * heads * kSlices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kda_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, g, beta, v, out, seq, heads, scale);
  return cudaGetLastError();
}

extern "C" const char* tfs_kda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
