"""Probe of the other split for bf16 attention past head width 256, on the card.

    python3 tests/torch_attention_split_probe.py [ROUNDS [BHxSxD]]

The package's kernel past padded head width 256
(`flash_attention_tc_wide_kernel` in `tensorframes_tpu_torch/csrc/
flash_attention_tc.cuh`) gives each block a 128-row query tile and a slice
of at most 256 output columns, and recomputes the scores for every slice.
This script builds the other split from the same header's pieces, at D 512
and bf16 only: a block takes a 64-row query tile (resident, 64 KB) and all
512 output columns; each of its two warpgroups sums Q K^T over half of the
depth (four 64-column boxes, m64n32 products over 32-key tiles), the two
exchange their partial scores through shared memory and add them (a
two-term float sum does not depend on its order, so both hold the same
scores), run the same softmax and compute P V for their own 256 columns,
with P as the kernel's pair of 2-byte values. K and V tiles come by TMA in
two stages each; a turn is P V of one tile with the half scores of the
next, both warpgroups at once (the exchange leaves no room for turns).

It writes the source under `tensorframes_tpu_torch/_build/split_probe/`,
builds it with `nvcc`, checks it against `flash_attention_reference` at
the one-unit-in-the-last-place bar (rtol 2^-7, atol 1e-5) on a ragged
causal and a full shape, then times it and the package's
`flash_attention` in turns, ROUNDS rounds (default 11) of 20 launches at
BHxSxD (default 16x2048x512, causal; D must be 512). Prints one JSON line:
the card's name and power limit, the probe's ptxas line, the medians and
quartiles in ms, and the largest error. Not collected by pytest; needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

_SOURCE = r"""
#include "flash_attention.cuh"
#include "flash_attention_tc.cuh"

namespace {

constexpr int kSpRows = 64;    // query rows a block, shared by both warpgroups
constexpr int kSpKeys = 32;    // keys a tile
constexpr int kSpBoxes = 8;    // 64-column boxes a row (D8 512)
constexpr int kSpQBox = kSpRows * 128;        // 8 KB
constexpr int kSpKVBox = kSpKeys * 128;       // 4 KB
constexpr int kSpTile = kSpBoxes * kSpKVBox;  // 32 KB
constexpr int kSpX = 128 * 16 * 4;            // a warpgroup's partial scores: 8 KB
constexpr int kSpSmem = kSpBoxes * kSpQBox + 4 * kSpTile + 4 * kSpX + 1024;

__device__ __forceinline__ void both_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __launch_bounds__(256, 1)
split_probe_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int bh,
                   int seq, float sc, int causal) {
  using T = __nv_bfloat16;
  constexpr int BK = kSpKeys, NS = BK / 2, DN = 256, NO = DN / 2;
  extern __shared__ unsigned char sp_smem[];
  __shared__ __align__(8) uint64_t bars[9];
  unsigned char* qs = sp_smem + ((1024u - (smem_u32(sp_smem) & 1023u)) & 1023u);
  unsigned char* ks = qs + kSpBoxes * kSpQBox;  // two K tiles
  unsigned char* vs = ks + 2 * kSpTile;         // two V tiles
  float4* xs = reinterpret_cast<float4*>(vs + 2 * kSpTile);  // [parity][warpgroup][i][thread]
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 3;
  uint64_t* v_full = bars + 5;
  uint64_t* v_empty = bars + 7;

  const int tid = threadIdx.x;
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nq = (seq + kSpRows - 1) / kSpRows;
  const int head = static_cast<int>(blockIdx.x % static_cast<unsigned>(bh));
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(bh))) * kSpRows;
  const int k_end = causal ? min(seq, q0 + kSpRows) : seq;
  const int nk = (k_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kTcConsumerWarps);
      mbar_init(v_empty + s, kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool loader = tid == 128;
  auto load = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full, uint64_t* empty,
                  int j) {
    const int st = j & 1;
    mbar_wait(empty + st, ((j >> 1) & 1) ^ 1);
    mbar_expect_tx(full + st, kSpTile);
    for (int b = 0; b < kSpBoxes; ++b)
      tma_load(ring + st * kSpTile + b * kSpKVBox, map, full + st, b * kTcBox, j * BK, head);
  };
  if (loader) {
    mbar_expect_tx(q_full, kSpBoxes * kSpQBox);
    for (int b = 0; b < kSpBoxes; ++b) tma_load(qs + b * kSpQBox, &tq, q_full, b * kTcBox, q0, head);
    for (int j = 0; j < min(nk, 2); ++j) load(&tk, ks, k_full, k_empty, j);
    for (int j = 0; j < min(nk, 2); ++j) load(&tv, vs, v_full, v_empty, j);
  }

  const int t = tid % 128;
  const int lane = t & 31;
  const int row0 = q0 + 16 * (t >> 5) + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  // this warpgroup's half of the depth (Q and K boxes 4 cw ..) and of the
  // output columns (V boxes 4 cw ..)
  const uint32_t q_addr = smem_u32(qs) + cw * 4 * kSpQBox;
  const uint32_t k_addr = smem_u32(ks) + cw * 4 * kSpKVBox;
  const uint32_t v_addr = smem_u32(vs) + cw * 4 * kSpKVBox;

  float acc[NO];
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s_acc[NS];
  uint32_t p_hi[NS / 2], p_lo[NS / 2];

  auto qk_half = [&](uint32_t ka) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t in_row = (j & 3) * 32;
      wgmma_qk<T, BK>(s_acc, sw128_desc(q_addr + (j >> 2) * kSpQBox + in_row, 16, 1024),
                      sw128_desc(ka + (j >> 2) * kSpKVBox + in_row, 16, 1024), j > 0);
    }
  };
  // both warpgroups' partial sums of key tile j, added in one order
  auto exchange = [&](int j) {
    float4* mine = xs + ((j & 1) * 2 + cw) * 4 * 128 + t;
    const float4* theirs = xs + ((j & 1) * 2 + 1 - cw) * 4 * 128 + t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mine[i * 128] = make_float4(s_acc[4 * i], s_acc[4 * i + 1], s_acc[4 * i + 2], s_acc[4 * i + 3]);
    both_sync();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = theirs[i * 128];
      s_acc[4 * i] += x.x;
      s_acc[4 * i + 1] += x.y;
      s_acc[4 * i + 2] += x.z;
      s_acc[4 * i + 3] += x.w;
    }
  };

  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  wgmma_fence();
  qk_half(k_addr);
  wgmma_commit();
  wgmma_wait_all();
  hold(s_acc);
  if (lane == 0) mbar_arrive(k_empty);
  if (loader && 2 < nk) load(&tk, ks, k_full, k_empty, 2);
  exchange(0);

  for (int kb = 0; kb + 1 < nk; ++kb) {
    const int s = kb & 1, s1 = (kb + 1) & 1;
    softmax_tile<T, NO, NS>(s_acc, acc, m, l, p_hi, p_lo, sc, row0, kb * BK, c_lo, q0, seq,
                            causal);
    mbar_wait(v_full + s, (kb >> 1) & 1);
    mbar_wait(k_full + s1, ((kb + 1) >> 1) & 1);
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    wgmma_fence();
    pv_tile<T, DN, BK>(acc, p_hi, p_lo, v_addr + s * kSpTile);
    qk_half(k_addr + s1 * kSpTile);
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    hold(s_acc);
    if (lane == 0) {
      mbar_arrive(v_empty + s);
      mbar_arrive(k_empty + s1);
    }
    if (loader) {
      if (kb + 3 < nk) load(&tk, ks, k_full, k_empty, kb + 3);
      if (kb + 2 < nk) load(&tv, vs, v_full, v_empty, kb + 2);
    }
    exchange(kb + 1);
  }
  {
    const int kb = nk - 1;
    const int s = kb & 1;
    softmax_tile<T, NO, NS>(s_acc, acc, m, l, p_hi, p_lo, sc, row0, kb * BK, c_lo, q0, seq,
                            causal);
    mbar_wait(v_full + s, (kb >> 1) & 1);
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    wgmma_fence();
    pv_tile<T, DN, BK>(acc, p_hi, p_lo, v_addr + s * kSpTile);
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
  }

  // the output through this warpgroup's own Q boxes (its half of the
  // depth, which the other warpgroup never reads), whole rows out
  const size_t head_row = static_cast<size_t>(head) * seq;
  const int w16 = 16 * (t >> 5);
  unsigned char* stage = qs + cw * 4 * kSpQBox;
  float inv[2];
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    inv[h] = 1.f / (lh == 0.f ? 1.f : lh);
  }
#pragma unroll
  for (int c = 0; c < DN / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w16 + (lane >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + (c >> 3) * kSpQBox + r * 128 +
                                   (((c & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
          pack2<T>(acc[4 * c + 2 * h] * inv[h], acc[4 * c + 2 * h + 1] * inv[h]);
    }
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = w16 + rr;
    const int row = q0 + r;
    if (row < seq)
      *reinterpret_cast<uint4*>(o + (head_row + row) * 512 + cw * DN + 8 * lane) =
          *reinterpret_cast<const uint4*>(stage + (lane >> 3) * kSpQBox + r * 128 +
                                          (((lane & 7) ^ (r & 7)) << 4));
  }
}

}  // namespace

extern "C" int split_probe_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                                int seq, float scale, int causal, void* stream) {
  using T = __nv_bfloat16;
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, encode, static_cast<const T*>(q), bh, seq, 512, kTcBox, kSpRows) ||
      !encode_map(&mk, encode, static_cast<const T*>(k), bh, seq, 512, kTcBox, kSpKeys) ||
      !encode_map(&mv, encode, static_cast<const T*>(v), bh, seq, 512, kTcBox, kSpKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(split_probe_kernel, kSpSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(bh) * ((seq + kSpRows - 1) / kSpRows);
  split_probe_kernel<<<blocks, 256, kSpSmem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<T*>(o), bh, seq, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}
"""


def _build():
    from tensorframes_tpu_torch.ops import _cuda_build

    out_dir = os.path.join(_ROOT, "tensorframes_tpu_torch", "_build", "split_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "split_probe.cu")
    with open(src, "w") as f:
        f.write(_SOURCE)
    lib_path = os.path.join(out_dir, "libsplit_probe.so")
    csrc = os.path.join(_ROOT, "tensorframes_tpu_torch", "csrc")
    proc = subprocess.run(
        [_cuda_build._nvcc(), *_cuda_build._FLAGS, "-I", csrc, "-o", lib_path, src],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line or "serialized" in line]
    lib = ctypes.CDLL(lib_path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.split_probe_bf16.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, i32, ptr]
    lib.split_probe_bf16.restype = i32
    return lib, ptxas


def _probe(lib, q, k, v, causal: bool):
    bh, seq, d = q.shape
    out = torch.empty_like(q)
    rc = lib.split_probe_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, seq,
                              1.0 / d**0.5, int(causal),
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"split probe launch failed: cudaError {rc}")
    return out


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)  # the host queues every call meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tensorframes_tpu_torch.ops import flash_attention as fa

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 11
    shape = [int(n) for n in (sys.argv[2] if len(sys.argv) > 2 else "16x2048x512").split("x")]
    if shape[2] != 512:
        raise SystemExit("the probe is built for head width 512")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lib, ptxas = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    for check_shape, causal in (((2, 300, 512), True), ((3, 129, 512), False)):
        q, k, v = (torch.randn(*check_shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        got = _probe(lib, q, k, v, causal).float()
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q, k, v, causal=causal).float()
        bad = ((got - want).abs() > 1e-5 + 2.0**-7 * want.abs()).sum().item()
        if bad:
            raise AssertionError(f"split probe {check_shape} causal={causal}: {bad} elements "
                                 "past one unit in the last place")
        err = max(err, (got - want).abs().max().item())
    q, k, v = (torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    entries = {"split_probe": lambda: _probe(lib, q, k, v, True),
               "flash_attention": lambda: fa.flash_attention(q, k, v, causal=True)}
    times = {name: [] for name in entries}
    for r in range(rounds):
        for name in (list(entries) if r % 2 == 0 else list(reversed(entries))):
            times[name].append(_time_ms(entries[name]))
    print(json.dumps({
        "card": card, "shape": shape, "dtype": "bfloat16", "causal": True, "rounds": rounds,
        "ptxas": ptxas, "max_abs_err": err,
        "median_ms": {n: float(np.median(t)) for n, t in times.items()},
        "quartiles_ms": {n: [float(np.percentile(t, 25)), float(np.percentile(t, 75))]
                         for n, t in times.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
