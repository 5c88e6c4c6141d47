// Key factorization: the sorted distinct values of an int32 or int64 key
// column and each row's index into them, as torch.unique(sorted=True,
// return_inverse=True) gives them, for columns of at most kCapacity distinct
// keys (the key stage of `aggregate`, `frame.factorize_keys`).
//
// It replaces no TPU kernel: the JAX package leaves the factorization to
// XLA's sort. On the card the library route sorted every row's key with its
// row index (a radix sort of n pairs), then scattered the inverse back, to
// find a handful of distinct values.
//
// Bound by bytes: every key is read twice and every group id written once,
// and nothing is sorted at row scale. Two streaming passes and a finish:
// - the distinct pass: a grid that fills the SMs walks the keys in 16-byte
//   vector loads (the unaligned head and tail one key at a time). Each block
//   keeps an open-addressing hash set of the 64-bit keys in shared memory; a
//   probe reads the slot first, and only a key the block has not seen yet
//   takes a compare-and-swap, so with few keys nearly every probe is a plain
//   shared-memory read that hits. At its end a block merges its keys into one
//   global set and its count. A key equal to kEmpty, the empty slot's marker,
//   never enters a set: a flag says it was seen;
// - overflow: past kCapacity distinct keys in a block or in the global set, a
//   flag is set in device memory; every block polls it once a chunk of its
//   rows and stops, so a column of a million keys pays a fraction of one pass
//   before the caller takes torch.unique;
// - the finish (one block, after the caller's one host read of the count and
//   the flags): the d <= kCapacity keys sorted ascending as signed integers by
//   a bitonic sort in shared memory, written out in the keys' dtype, and a
//   lookup table of at least 2d slots (32 at 16 keys) holding each key's rank;
// - the lookup pass: each block copies the lookup table into shared memory,
//   reads each key once and writes its int64 rank, contiguous.
// The C entries launch on the stream they are given, never synchronise, and
// return cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // vector loads a thread issues a chunk
constexpr int kSlotBits = 13;
constexpr int kSlots = 1 << kSlotBits;  // a block's set and the global set
constexpr int kCapacity = kSlots / 2;   // distinct keys, the marker key included
constexpr int kFinishThreads = 1024;
constexpr long long kEmpty = LLONG_MIN;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;

// The workspace (long long words): the global set, then the count of its
// keys, the overflow flag and the marker flag, then the lookup table's keys
// and its int32 ranks.
constexpr int kCount = kSlots, kOverflow = kSlots + 1, kMarker = kSlots + 2;
constexpr int kLookupKeys = kSlots + 4;
constexpr int kLookupMax = 2 * kCapacity;
constexpr int kLookupRanks = kLookupKeys + kLookupMax;
constexpr int kWorkWords = kLookupRanks + kLookupMax / 2;

__device__ __forceinline__ unsigned slot_of(long long k, int bits) {
  return static_cast<unsigned>((static_cast<unsigned long long>(k) * kGolden) >> (64 - bits));
}

// 16 bytes of keys: V keys, each widened to long long.
template <typename T>
struct Keys;

template <>
struct Keys<int> {
  using vec = int4;
  static constexpr int V = 4;
  __device__ static long long at(const int4& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  }
};

template <>
struct Keys<long long> {
  using vec = longlong2;
  static constexpr int V = 2;
  __device__ static long long at(const longlong2& x, int i) { return i == 0 ? x.x : x.y; }
};

// Where 16-byte loads start: `head` keys before the first 16-byte boundary
// (at most n), `vecs` whole vectors, then the tail.
struct Span {
  long long n;
  int head;
  long long vecs;
};

template <typename T>
Span span_of(const T* keys, long long n) {
  const int V = Keys<T>::V;
  const uintptr_t off = reinterpret_cast<uintptr_t>(keys) % 16;
  long long head = off ? static_cast<long long>((16 - off) / sizeof(T)) : 0;
  if (head > n) head = n;
  return Span{n, static_cast<int>(head), (n - head) / V};
}

// The row of the i-th key outside the vectors: the head, then the tail.
template <typename T>
__device__ __forceinline__ long long edge_row(const Span& s, int i) {
  return i < s.head ? i : s.head + s.vecs * Keys<T>::V + (i - s.head);
}

template <typename T>
__device__ __forceinline__ int edges_of(const Span& s) {
  return static_cast<int>(s.n - s.vecs * Keys<T>::V);
}

__device__ __forceinline__ void overflowed(long long* work) {
  *reinterpret_cast<volatile long long*>(work + kOverflow) = 1;
}

// One key into the block's set. Past kCapacity keys the block stops (`stop`)
// and raises the global flag; once it has stopped, no key takes a free slot,
// so the set never fills and a probe always ends.
__device__ __forceinline__ void add_to_block(long long k, volatile long long* set, int* count,
                                             volatile int* stop, int* marker, long long* work) {
  if (k == kEmpty) {
    *marker = 1;
    return;
  }
  unsigned s = slot_of(k, kSlotBits);
  for (int p = 0; p < kSlots; ++p) {
    const long long cur = set[s];
    if (cur == k) return;
    if (cur == kEmpty) {
      if (*stop) return;
      const long long prev = static_cast<long long>(
          atomicCAS(reinterpret_cast<unsigned long long*>(const_cast<long long*>(set + s)),
                    static_cast<unsigned long long>(kEmpty), static_cast<unsigned long long>(k)));
      if (prev == kEmpty) {
        if (atomicAdd(count, 1) >= kCapacity) {
          *stop = 1;
          overflowed(work);
        }
        return;
      }
      if (prev == k) return;
    }
    s = (s + 1) & (kSlots - 1);
  }
  *stop = 1;
  overflowed(work);
}

// One of a block's keys into the global set and its count.
__device__ __forceinline__ void add_to_global(long long k, long long* work) {
  volatile long long* set = work;
  volatile long long* flag = work + kOverflow;
  unsigned s = slot_of(k, kSlotBits);
  for (int p = 0; p < kSlots; ++p) {
    const long long cur = set[s];
    if (cur == k) return;
    if (cur == kEmpty) {
      if (*flag) return;
      const long long prev = static_cast<long long>(
          atomicCAS(reinterpret_cast<unsigned long long*>(work + s),
                    static_cast<unsigned long long>(kEmpty), static_cast<unsigned long long>(k)));
      if (prev == kEmpty) {
        if (atomicAdd(reinterpret_cast<unsigned long long*>(work + kCount), 1ull) >= kCapacity)
          overflowed(work);
        return;
      }
      if (prev == k) return;
    }
    s = (s + 1) & (kSlots - 1);
  }
  overflowed(work);
}

__global__ void clear_kernel(long long* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kSlots) work[i] = kEmpty;
  if (i >= kSlots && i < kLookupKeys) work[i] = 0;
}

// Dynamic shared memory: the block's set of kSlots keys, so three blocks fit
// an SM (told to ptxas: left to itself it holds the kernel to 32 registers
// and spills).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    distinct_kernel(const T* __restrict__ keys, Span sp, long long* __restrict__ work) {
  using K = Keys<T>;
  extern __shared__ long long block_set[];
  __shared__ int count, stop, marker;
  volatile long long* set = block_set;
  for (int i = threadIdx.x; i < kSlots; i += kThreads) block_set[i] = kEmpty;
  if (threadIdx.x == 0) count = stop = marker = 0;
  __syncthreads();
  volatile int* halt = &stop;
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < edges_of<T>(sp); i += kThreads)
      add_to_block(keys[edge_row<T>(sp, i)], set, &count, halt, &marker, work);
  }
  const typename K::vec* body = reinterpret_cast<const typename K::vec*>(keys + sp.head);
  const volatile long long* flag = work + kOverflow;
  constexpr long long kChunk = kThreads * kUnroll;
  for (long long c = blockIdx.x * kChunk; c < sp.vecs; c += gridDim.x * kChunk) {
    // polled with the chunk's loads, acted on after them
    const bool done = *flag != 0 || *halt != 0;
    typename K::vec x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = c + u * kThreads + threadIdx.x;
      if (i < sp.vecs) x[u] = __ldcs(body + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * kThreads + threadIdx.x >= sp.vecs) continue;
#pragma unroll
      for (int e = 0; e < K::V; ++e) add_to_block(K::at(x[u], e), set, &count, halt, &marker, work);
    }
    if (done) break;
  }
  __syncthreads();
  if (*halt || *flag) return;
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const long long k = set[i];
    if (k != kEmpty) add_to_global(k, work);
  }
  if (threadIdx.x == 0 && marker) work[kMarker] = 1;
}

// log2 of the lookup table's slots: at least 2d, at least 32.
int lookup_bits_of(int d) {
  int bits = 5;
  while ((1 << bits) < 2 * d) ++bits;
  return bits;
}

// One block: the d distinct keys sorted, written to `uniq`, and the lookup
// table built in the workspace. The marker key, where seen, is the least of
// all: rank 0, and kept out of the table.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(long long* __restrict__ work, int d, int bits, T* __restrict__ uniq) {
  __shared__ long long sorted[kCapacity];
  __shared__ int filled;
  int p2 = 1;
  while (p2 < d) p2 *= 2;
  if (threadIdx.x == 0) filled = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kFinishThreads) {
    const long long k = work[i];
    if (k != kEmpty) sorted[atomicAdd(&filled, 1)] = k;
  }
  __syncthreads();
  if (threadIdx.x == 0 && work[kMarker]) sorted[filled] = kEmpty;
  for (int i = d + threadIdx.x; i < p2; i += kFinishThreads) sorted[i] = LLONG_MAX;
  __syncthreads();
  for (int k = 2; k <= p2; k *= 2) {
    for (int j = k / 2; j > 0; j /= 2) {
      for (int i = threadIdx.x; i < p2; i += kFinishThreads) {
        const int o = i ^ j;
        if (o > i) {
          const long long a = sorted[i], b = sorted[o];
          if ((a > b) == ((i & k) == 0)) {
            sorted[i] = b;
            sorted[o] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int slots = 1 << bits;
  long long* keys = work + kLookupKeys;
  int* ranks = reinterpret_cast<int*>(work + kLookupRanks);
  for (int i = threadIdx.x; i < slots; i += kFinishThreads) keys[i] = kEmpty;
  __syncthreads();
  for (int r = threadIdx.x; r < d; r += kFinishThreads) {
    const long long k = sorted[r];
    uniq[r] = static_cast<T>(k);
    if (k == kEmpty) continue;
    unsigned s = slot_of(k, bits);
    while (atomicCAS(reinterpret_cast<unsigned long long*>(keys + s),
                     static_cast<unsigned long long>(kEmpty),
                     static_cast<unsigned long long>(k)) != static_cast<unsigned long long>(kEmpty))
      s = (s + 1) & (slots - 1);
    ranks[s] = r;
  }
}

__device__ __forceinline__ long long rank_of(long long k, const long long* keys, const int* ranks,
                                             int bits) {
  if (k == kEmpty) return 0;
  const int mask = (1 << bits) - 1;
  unsigned s = slot_of(k, bits);
  for (int p = 0; p <= mask; ++p) {
    if (keys[s] == k) return ranks[s];
    s = (s + 1) & mask;
  }
  return -1;  // not reached: every key is in the table
}

// Dynamic shared memory: the lookup table's 2^bits keys, then its ranks.
// `vec_out`: the ranks of a vector of keys store as 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const T* __restrict__ keys, Span sp, const long long* __restrict__ work, int bits,
                  long long* __restrict__ inverse, int vec_out) {
  using K = Keys<T>;
  extern __shared__ long long table[];
  const int slots = 1 << bits;
  int* ranks = reinterpret_cast<int*>(table + slots);
  const int* g_ranks = reinterpret_cast<const int*>(work + kLookupRanks);
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    table[i] = work[kLookupKeys + i];
    ranks[i] = g_ranks[i];
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < edges_of<T>(sp); i += kThreads) {
      const long long r = edge_row<T>(sp, i);
      inverse[r] = rank_of(keys[r], table, ranks, bits);
    }
  }
  const typename K::vec* body = reinterpret_cast<const typename K::vec*>(keys + sp.head);
  long long* out = inverse + sp.head;
  constexpr long long kChunk = kThreads * kUnroll;
  for (long long c = blockIdx.x * kChunk; c < sp.vecs; c += gridDim.x * kChunk) {
    typename K::vec x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = c + u * kThreads + threadIdx.x;
      if (i < sp.vecs) x[u] = __ldcs(body + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = c + u * kThreads + threadIdx.x;
      if (i >= sp.vecs) continue;
      long long r[K::V];
#pragma unroll
      for (int e = 0; e < K::V; ++e) r[e] = rank_of(K::at(x[u], e), table, ranks, bits);
      long long* o = out + i * K::V;
      if (vec_out) {
#pragma unroll
        for (int e = 0; e < K::V; e += 2)
          __stcs(reinterpret_cast<longlong2*>(o + e), make_longlong2(r[e], r[e + 1]));
      } else {
#pragma unroll
        for (int e = 0; e < K::V; ++e) o[e] = r[e];
      }
    }
  }
}

// Blocks of `kernel` that fill the card, at most one a chunk of vectors.
template <typename F>
int blocks_of(F kernel, int smem, long long vecs, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long chunks = (vecs + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  long long b = static_cast<long long>(per_sm) * sms;
  if (chunks < b) b = chunks;
  *blocks = static_cast<int>(b < 1 ? 1 : b);
  return cudaSuccess;
}

template <typename T>
int distinct(const T* keys, long long n, long long* work, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const Span sp = span_of(keys, n);
  const int smem = kSlots * static_cast<int>(sizeof(long long));
  int blocks = 0;
  int err = blocks_of(distinct_kernel<T>, smem, sp.vecs, &blocks);
  if (err != cudaSuccess) return err;
  clear_kernel<<<(kLookupKeys + kThreads - 1) / kThreads, kThreads, 0, stream>>>(work);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  distinct_kernel<T><<<blocks, kThreads, smem, stream>>>(keys, sp, work);
  return cudaGetLastError();
}

template <typename T>
int lookup(const T* keys, long long n, long long* work, int d, T* uniq, long long* inverse,
           cudaStream_t stream) {
  if (n < 1 || d < 1 || d > kCapacity) return cudaErrorInvalidValue;
  const Span sp = span_of(keys, n);
  const int bits = lookup_bits_of(d);
  const int smem = (1 << bits) * static_cast<int>(sizeof(long long) + sizeof(int));
  int blocks = 0;
  int err = blocks_of(lookup_kernel<T>, smem, sp.vecs, &blocks);
  if (err != cudaSuccess) return err;
  finish_kernel<T><<<1, kFinishThreads, 0, stream>>>(work, d, bits, uniq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int vec_out = reinterpret_cast<uintptr_t>(inverse + sp.head) % 16 == 0;
  lookup_kernel<T><<<blocks, kThreads, smem, stream>>>(keys, sp, work, bits, inverse, vec_out);
  return cudaGetLastError();
}

}  // namespace

// The kernel's constants: [capacity, set slots, workspace words, the empty
// marker, the word of the count (then the overflow and marker flags)].
extern "C" int tfs_factorize_constants(long long* out) {
  const long long c[5] = {kCapacity, kSlots, kWorkWords, kEmpty, kCount};
  for (int i = 0; i < 5; ++i) out[i] = c[i];
  return 0;
}

// The distinct pass over n >= 1 keys of elem_bytes (4: int32, 8: int64) into
// the workspace of kWorkWords long long words: afterwards the count of
// distinct keys other than the marker, the overflow flag and the marker flag
// lie at words kCount, kCount + 1 and kCount + 2.
extern "C" int tfs_factorize_distinct(int elem_bytes, const void* keys, long long n,
                                      long long* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return distinct(static_cast<const int*>(keys), n, work, s);
  if (elem_bytes == 8) return distinct(static_cast<const long long*>(keys), n, work, s);
  return cudaErrorInvalidValue;
}

// After a distinct pass that did not overflow and found d keys in all (the
// marker key counted), 1 <= d <= capacity: the sorted keys into `uniq` (d,
// the keys' dtype) and each key's rank into `inverse` (n int64).
extern "C" int tfs_factorize_lookup(int elem_bytes, const void* keys, long long n, long long* work,
                                    int d, void* uniq, long long* inverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return lookup(static_cast<const int*>(keys), n, work, d, static_cast<int*>(uniq), inverse, s);
  if (elem_bytes == 8)
    return lookup(static_cast<const long long*>(keys), n, work, d, static_cast<long long*>(uniq),
                  inverse, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* tfs_factorize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
