// Keyed sums: the per-group sums of several row-wise outputs and the group
// counts, in one pass over the rows (the segment plan of `aggregate`).
//
// It replaces no TPU kernel: the JAX package sums segments with XLA
// (`jax.ops.segment_sum`, or a one-hot product on the TPU for few keys). On
// the card the library route was an `index_add` a fetch into one table a
// chunk of rows, with the chunk slots built by full-length int64 passes, and
// a `bincount` for the counts: each pass read the ids again.
//
// Bound by bytes: a row is read once (its int64 id and each output's W
// values) and the work per byte is one add. The design keeps every table on
// chip and reads each id and value from device memory once:
// - a persistent grid (as many blocks as fit on the SMs) walks tiles of
//   kTileRows rows; 16-byte vector loads of the value rows where the width
//   and alignment allow, streaming loads (the values are read once), the
//   ids through the read-only path (each output's pass finds them in cache);
// - each block adds its rows into tile tables in shared memory with
//   shared-memory atomics (compare-and-swap loops on this card: a float add
//   has no native shared-memory atomic, and lanes that swap one address in
//   one instruction retry in turn). Where the tables fit, one a row position
//   of a warp's instruction: the rows one instruction touches add into
//   distinct tables, so its lanes never contend for an address and each
//   swap succeeds at once, and the tables are shifted so that the lanes'
//   columns fall in distinct banks (on an H100 at 700 W, 100M rows of 8
//   float32 values and their squares into 16 groups: 2.3 ms against 4.6
//   with one table a warp and a 2.15 ms bytes bound, as
//   tests/torch_keyed_sums_timing.py --tables-bytes 16384 shows); else one
//   table a warp, else one (`layout_of`). The count is one more column,
//   added with output 0;
// - the accumulation length is bounded: at the end of each tile the tile
//   table is added into the block's float64 running table and cleared, so
//   no float32 accumulator takes more than kTileRows adds, however many rows
//   a group has (one float32 accumulator per group loses small addends over
//   millions of rows: a bias, not noise);
// - each block writes its float64 table to a partials buffer, and a second
//   launch adds them over the blocks in a fixed order, in float64, rounding
//   to the outputs' dtype once. float64 outputs accumulate in float64
//   throughout.
// Ids outside [0, groups) are dropped. The C entries launch on the stream
// they are given, never synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 4096;  // the most adds one float32 accumulator takes
constexpr int kBatch = 4;        // loads a thread issues before its adds
constexpr int kMaxOutputs = 8;   // more are refused (ops/keyed_sums.py routes them elsewhere)
constexpr int kFinishParts = 32;  // threads that split one slot's blocks in the second launch

struct Outputs {
  const void* values[kMaxOutputs];  // (n, width) row-major
  void* tables[kMaxOutputs];        // (groups, width)
  int width[kMaxOutputs];
  int offset[kMaxOutputs];  // the output's first column in a table row
  int vec[kMaxOutputs];     // 1: rows load as 16-byte vectors
  int rows_log2[kMaxOutputs];  // log2 of a row's chunks, or -1
  int k;
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void add(float* dst, float4 x) {
    atomicAdd(dst, x.x);
    atomicAdd(dst + 1, x.y);
    atomicAdd(dst + 2, x.z);
    atomicAdd(dst + 3, x.w);
  }
};

template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void add(double* dst, double2 x) {
    atomicAdd(dst, x.x);
    atomicAdd(dst + 1, x.y);
  }
};

__device__ __forceinline__ bool in_range(long long g, int groups) {
  return g >= 0 && g < groups;
}

// Where a tile's rows add: `warps` x `positions` tables of `groups` rows of
// `stride` accumulators, `pitch` apart. Row r of a tile, added by warp w,
// goes to table (w % warps) * positions + r % positions: one table a group
// of warps, so that other warps' swaps do not collide with its own, and one
// a row position of a warp's instruction, so that the rows one instruction
// touches add into distinct tables and its lanes never contend for an
// address. Where `shifted`, the stride is a multiple of 32 and table t starts
// shift(t % positions) words into its pitch, so that one instruction's lanes
// fall in distinct banks whatever their groups: a lane loads `spread` values
// of output 0, `lanes` lanes a row. `positions` is a power of two.
struct Layout {
  int cols;  // the outputs' widths, then the count
  int stride;
  int positions;
  int warps;
  int pitch;
  int spread;
  int lanes;
  int shifted;
};

constexpr int kMaxTables = 256;

// One output's values of a tile added into the tile tables at the output's
// columns (`first`: the offsets in `tile` of the tables of the warp's group,
// one a row position); output 0 also adds each row's count. A chunk is what a lane loads: 16
// bytes where `vec`, else one value; `rows_log2` is log2 of a row's chunks
// where that is a power of two, else -1.
template <typename T>
__device__ __forceinline__ void add_output(const long long* __restrict__ ids, long long r0,
                                           int rows, int groups, const T* __restrict__ v,
                                           int w, bool vec, int rows_log2, int offset,
                                           bool count, T* tile, const int* first,
                                           const Layout& L) {
  constexpr int kVec = Vec<T>::n;
  const int step = vec ? kVec : 1;
  const int per_row = w / step;
  const int chunks = rows * per_row;
  const int pmask = L.positions - 1;
  for (int base = threadIdx.x; base < chunks; base += kThreads * kBatch) {
    typename Vec<T>::type x[kBatch];
    long long g[kBatch];
    int c[kBatch], r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      g[u] = -1;
      c[u] = r[u] = 0;
      if (i < chunks) {
        if (rows_log2 >= 0) {
          r[u] = i >> rows_log2;
          c[u] = (i - (r[u] << rows_log2)) * step;
        } else {
          r[u] = i / per_row;
          c[u] = (i - r[u] * per_row) * step;
        }
        g[u] = __ldg(ids + r0 + r[u]);
        if (vec) {
          x[u] = __ldcs(reinterpret_cast<const typename Vec<T>::type*>(v) + i);
        } else {
          x[u].x = __ldcs(v + static_cast<size_t>(i));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!in_range(g[u], groups)) continue;
      T* row = tile + first[r[u] & pmask] + g[u] * L.stride;
      if (vec) {
        Vec<T>::add(row + offset + c[u], x[u]);
      } else {
        atomicAdd(row + offset + c[u], x[u].x);
      }
      if (count && c[u] == 0) atomicAdd(row + L.cols - 1, T(1));
    }
  }
}

// Shared memory: the float64 running table (groups x cols), then the tile
// tables (`Layout`). Column cols - 1 is the count.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    keyed_sums_kernel(const long long* __restrict__ ids, long long n, int groups, Layout L,
                      Outputs outs, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int first[kMaxTables];  // each table's offset in the tile
  const int cols = L.cols, slots = groups * cols, tables = L.warps * L.positions;
  double* running = reinterpret_cast<double*>(smem);
  T* tile = reinterpret_cast<T*>(running + slots);
  for (int t = threadIdx.x; t < tables; t += kThreads) {
    const int p = t % L.positions;
    const int shift = p % L.spread + L.spread * L.lanes * (p / L.spread);
    first[t] = t * L.pitch + (L.shifted ? shift % 32 : 0);
  }
  for (int i = threadIdx.x; i < slots; i += kThreads) running[i] = 0.0;
  for (int i = threadIdx.x; i < tables * L.pitch; i += kThreads) tile[i] = T(0);
  __syncthreads();
  const int* mine = first + (threadIdx.x / 32 % L.warps) * L.positions;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * kTileRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kTileRows), n - r0));
    for (int k = 0; k < outs.k; ++k) {
      const int w = outs.width[k];
      add_output<T>(ids, r0, rows, groups, static_cast<const T*>(outs.values[k]) + r0 * w, w,
                    outs.vec[k] != 0, outs.rows_log2[k], outs.offset[k], k == 0, tile, mine, L);
    }
    __syncthreads();
    // fold the tile into the running table, tables in order, and clear it
    for (int i = threadIdx.x; i < slots; i += kThreads) {
      const int g = i / cols, c = i - g * cols;
      double s = running[i];
      for (int tb = 0; tb < tables; ++tb) {
        T* p = tile + first[tb] + g * L.stride + c;
        s += static_cast<double>(*p);
        *p = T(0);
      }
      running[i] = s;
    }
    __syncthreads();
  }
  double* out = partials + static_cast<size_t>(blockIdx.x) * slots;
  for (int i = threadIdx.x; i < slots; i += kThreads) out[i] = running[i];
}

// The blocks' partials added in a fixed order: thread (lane, part) of a
// block sums blocks part, part + kFinishParts, ... of slot
// blockIdx.x * 32 + lane, and the parts are added in order.
template <typename T>
__global__ void __launch_bounds__(32 * kFinishParts)
    keyed_sums_finish(const double* __restrict__ partials, int blocks, int groups, int cols,
                      Outputs outs, long long* __restrict__ counts) {
  __shared__ double part[kFinishParts][33];
  const int slots = groups * cols;
  const int lane = threadIdx.x % 32, p = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (i < slots) {
    for (int b = p; b < blocks; b += kFinishParts) s += partials[static_cast<size_t>(b) * slots + i];
  }
  part[p][lane] = s;
  __syncthreads();
  if (p != 0 || i >= slots) return;
  for (int q = 1; q < kFinishParts; ++q) s += part[q][lane];
  const int g = i / cols, c = i - g * cols;
  if (c == cols - 1) {
    counts[g] = static_cast<long long>(s);
    return;
  }
  int k = 0;
  while (k + 1 < outs.k && c >= outs.offset[k + 1]) ++k;
  static_cast<T*>(outs.tables[k])[static_cast<size_t>(g) * outs.width[k] + (c - outs.offset[k])] =
      static_cast<T>(s);
}

// The outputs of a launch: values, widths, offsets, whether rows load as
// 16-byte vectors (width and alignment) and log2 of a row's chunks.
template <typename T>
int outputs_of(int groups, int k, const void* const* values, const int* widths,
               void* const* tables, Outputs* outs) {
  if (groups < 1 || k < 1 || k > kMaxOutputs) return cudaErrorInvalidValue;
  *outs = Outputs{};
  outs->k = k;
  int cols = 0;
  for (int j = 0; j < k; ++j) {
    if (widths[j] < 1) return cudaErrorInvalidValue;
    outs->values[j] = values[j];
    outs->tables[j] = tables ? tables[j] : nullptr;
    outs->width[j] = widths[j];
    outs->offset[j] = cols;
    outs->vec[j] = widths[j] % Vec<T>::n == 0 && reinterpret_cast<size_t>(values[j]) % 16 == 0;
    const int per_row = outs->vec[j] ? widths[j] / Vec<T>::n : widths[j];
    outs->rows_log2[j] = -1;
    for (int b = 0; b < 31; ++b) {
      if (per_row == 1 << b) outs->rows_log2[j] = b;
    }
    cols += widths[j];
  }
  // tables of int-sized pitches: far past what fits in shared memory
  if (static_cast<long long>(groups) * (cols + 64) > (1 << 26)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The tile tables (`Layout`): the first that fits in `tables_bytes` of one
// table a row position of a warp's instruction with a stride of whole banks,
// shifted; the same with an odd stride; one table a warp; else one table. A
// lane loads `spread` values of output 0 (16 bytes where its rows load as
// vectors), `lanes` lanes a row, so one instruction's 32 lanes touch at
// most `positions` rows (a power of two).
template <typename T>
Layout layout_of(int groups, const Outputs& outs, int tables_bytes) {
  const int cols = outs.offset[outs.k - 1] + outs.width[outs.k - 1] + 1;
  const int spread = outs.vec[0] ? Vec<T>::n : 1;
  const int lanes = std::max(1, outs.width[0] / spread);
  const int rows = 32 % lanes == 0 ? 32 / lanes : 31 / lanes + 2;
  int positions = 1;
  while (positions < rows) positions *= 2;
  const int banked = (cols + 31) / 32 * 32, odd = cols | 1;
  const int tiers[3][4] = {{banked, positions, 1, 1}, {odd, positions, 1, 0},
                           {odd, 1, kThreads / 32, 0}};
  for (const auto& t : tiers) {
    const long long pitch = static_cast<long long>(groups) * t[0] + 32 * t[3];
    if (t[1] * t[2] > 1 &&
        t[1] * t[2] * pitch * static_cast<long long>(sizeof(T)) <= tables_bytes)
      return Layout{cols, t[0], t[1], t[2], static_cast<int>(pitch), spread, lanes, t[3]};
  }
  return Layout{cols, odd, 1, 1, groups * odd, spread, lanes, 0};
}

// Dynamic shared memory of a launch: the float64 running table, then the
// tile tables.
template <typename T>
long long smem_of(int groups, const Layout& L) {
  return static_cast<long long>(groups) * L.cols * sizeof(double) +
         static_cast<long long>(L.warps) * L.positions * L.pitch * sizeof(T);
}

template <typename T>
int plan(long long n, int groups, int k, const void* const* values, const int* widths,
         int tables_bytes, int* out) {
  if (n < 1) return cudaErrorInvalidValue;
  Outputs outs;
  cudaError_t err = static_cast<cudaError_t>(outputs_of<T>(groups, k, values, widths, nullptr, &outs));
  if (err != cudaSuccess) return err;
  const Layout L = layout_of<T>(groups, outs, tables_bytes);
  const long long smem = smem_of<T>(groups, L);
  if (smem > (1 << 30)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(keyed_sums_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keyed_sums_kernel<T>, kThreads,
                                                      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const int got[9] = {L.stride, L.positions, L.warps, L.pitch, L.spread, L.lanes, L.shifted,
                      static_cast<int>(smem),
                      static_cast<int>(std::min(tiles, static_cast<long long>(per_sm) * sms))};
  std::copy(got, got + 9, out);
  return cudaSuccess;
}

template <typename T>
int launch(const long long* ids, long long n, int groups, int k, const void* const* values,
           const int* widths, void* const* tables, long long* counts, double* partials,
           int blocks, int tables_bytes, cudaStream_t stream) {
  if (n < 1 || blocks < 1) return cudaErrorInvalidValue;
  Outputs outs;
  cudaError_t err = static_cast<cudaError_t>(outputs_of<T>(groups, k, values, widths, tables, &outs));
  if (err != cudaSuccess) return err;
  const Layout L = layout_of<T>(groups, outs, tables_bytes);
  if (L.warps * L.positions > kMaxTables) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_of<T>(groups, L));
  err = cudaFuncSetAttribute(keyed_sums_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  keyed_sums_kernel<T><<<blocks, kThreads, smem, stream>>>(ids, n, groups, L, outs, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int slots = groups * L.cols;
  keyed_sums_finish<T><<<(slots + 31) / 32, 32 * kFinishParts, 0, stream>>>(
      partials, blocks, groups, L.cols, outs, counts);
  return cudaGetLastError();
}

}  // namespace

// The plan of a launch over n rows into `groups` groups: the tile tables'
// stride, positions, warps, pitch, spread, lanes and shifted (`Layout`,
// within `tables_bytes` of shared memory where one of the shared layouts
// fits), the dynamic shared memory and the thread blocks, into plan[0..8].
// The partials buffer of the launch holds blocks * groups * (sum(widths) + 1)
// float64 values.
extern "C" int tfs_keyed_sums_plan(int elem_bytes, long long n, int groups, int k,
                                   const void* const* values, const int* widths, int tables_bytes,
                                   int* plan_out) {
  if (elem_bytes == 4) return plan<float>(n, groups, k, values, widths, tables_bytes, plan_out);
  if (elem_bytes == 8) return plan<double>(n, groups, k, values, widths, tables_bytes, plan_out);
  return cudaErrorInvalidValue;
}

// The K tables (groups, widths[j]) of values of elem_bytes each (float32 or
// float64), and the int64 counts (groups,), with the plan's layout for the
// same n, groups, values, widths and tables_bytes over `blocks` blocks.
extern "C" int tfs_keyed_sums(int elem_bytes, const long long* ids, long long n, int groups, int k,
                              const void* const* values, const int* widths, void* const* tables,
                              long long* counts, double* partials, int blocks, int tables_bytes,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<float>(ids, n, groups, k, values, widths, tables, counts, partials, blocks,
                         tables_bytes, s);
  if (elem_bytes == 8)
    return launch<double>(ids, n, groups, k, values, widths, tables, counts, partials, blocks,
                          tables_bytes, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* tfs_keyed_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
