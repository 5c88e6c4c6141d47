"""Where the wide attention kernel's cycles go, on the card.

    python3 tests/torch_attention_wide_trace.py [BHxSxD ...]

Copies `tensorframes_tpu_torch/csrc/flash_attention.cuh`, adds `clock64()`
sums to the copy's `flash_attention_wide_kernel` (thread 0 of each group:
its waits at the group barrier and for a chunk's TMA copies, the copies it
issues, Q K^T, the exchange of partial scores, the softmax with P, the wait
for V and P, P V), builds the float32 library from it with `nvcc` into
`tensorframes_tpu_torch/_build/wide_trace/`, and runs it causal at each
shape (float32 heads wider than 128; default 16x2048x256 and 16x2048x136).
Prints one JSON line a shape: the card's name and power limit, the traced
kernel's and the package's kernel's device ms (20 launches, the stream held
while the host queues them), and each group's mean cycles a key tile in
each phase, with their shares. The sums perturb the kernel a little:
compare the two ms. Not collected by pytest; needs a CUDA card and nvcc.
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

_MAX_BLOCKS = 8192  # blocks whose sums the traced kernel keeps
_PHASES = ["total", "barrier_and_copy_wait", "copy_issue", "qk", "exchange", "softmax",
           "pv_wait", "pv"]


def _patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the header changed: {old[:60]!r} found {src.count(old)} times")
    return src.replace(old, new)


def _traced_header(src: str) -> str:
    tick = "cyc[{i}] += clock64() - tt; tt = clock64();\n"
    src = _patch(src, "namespace {\n\nconstexpr int kBlockQ",
                 f"__device__ long long tfs_wide_trace[{_MAX_BLOCKS}][2][8];\n\n"
                 "namespace {\n\nconstexpr int kBlockQ")
    src = _patch(src, "  if (issuer) load_chunk(0, 0, first);\n",
                 "  const long long t_start = clock64();\n"
                 "  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tt = t_start;\n"
                 "  if (issuer) load_chunk(0, 0, first);\n")
    src = _patch(src, "      group_sync(g);\n      if (issuer) {",
                 "      tt = clock64();\n      group_sync(g);\n      " + tick.format(i=1)
                 + "      if (issuer) {")
    src = _patch(src, "      mbar_wait(full + (n & 1), (n >> 1) & 1);\n",
                 "      " + tick.format(i=2) + "      mbar_wait(full + (n & 1), (n >> 1) & 1);\n"
                 "      " + tick.format(i=1))
    src = _patch(src, "      qk_wide(s, cs, cs + kWideBox, ty, tx);\n    }\n",
                 "      qk_wide(s, cs, cs + kWideBox, ty, tx);\n"
                 "      asm volatile(\"\" ::: \"memory\");\n      " + tick.format(i=3)
                 + "    }\n    tt = clock64();\n")
    src = _patch(src, "    softmax_step<8, true>(",
                 "    " + tick.format(i=4) + "    softmax_step<8, true>(")
    src = _patch(src, "    if (g == 0) store_p(pw, s);\n",
                 "    if (g == 0) store_p(pw, s);\n    " + tick.format(i=5))
    src = _patch(src, "    __syncthreads();                          // P is complete\n",
                 "    __syncthreads();                          // P is complete\n    "
                 + tick.format(i=6))
    src = _patch(src, "      pv_wide<1>(acc, pr, vg, tx);\n  }\n",
                 "      pv_wide<1>(acc, pr, vg, tx);\n"
                 "    asm volatile(\"\" ::: \"memory\");\n    " + tick.format(i=7) + "  }\n"
                 f"  if (t == 0 && blockIdx.x < {_MAX_BLOCKS}) {{\n"
                 "    long long* r = tfs_wide_trace[blockIdx.x][g];\n"
                 "    r[0] = clock64() - t_start;\n"
                 "    for (int i = 1; i < 8; ++i) r[i] = cyc[i];\n  }\n")
    return src


def _build(out_dir: str) -> ctypes.CDLL:
    from tensorframes_tpu_torch.ops import _cuda_build

    csrc = os.path.join(_ROOT, "tensorframes_tpu_torch", "csrc")
    with open(os.path.join(csrc, "flash_attention.cuh")) as f:
        header = _traced_header(f.read())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "flash_attention.cuh"), "w") as f:
        f.write(header)
    src = os.path.join(out_dir, "trace_f32.cu")
    with open(src, "w") as f:
        f.write('#include "flash_attention.cuh"\n'
                "TFS_ATTENTION_ENTRIES(float, f32)\n"
                'extern "C" int tfs_wide_trace_read(void* host) {\n'
                "  return static_cast<int>(cudaMemcpyFromSymbol(host, tfs_wide_trace,\n"
                "                                               sizeof(tfs_wide_trace)));\n}\n")
    lib_path = os.path.join(out_dir, "libtrace_f32.so")
    proc = subprocess.run([_cuda_build._nvcc(), *_cuda_build._FLAGS, "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(lib_path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfs_flash_attention_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, f32, i32, ptr]
    lib.tfs_flash_attention_f32.restype = i32
    lib.tfs_wide_trace_read.argtypes = [ptr]
    lib.tfs_wide_trace_read.restype = i32
    return lib


def _device_ms(fn, iters: int = 20) -> float:
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

    shapes = [[int(n) for n in a.split("x")] for a in sys.argv[1:]] or [[16, 2048, 256],
                                                                        [16, 2048, 136]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lib = _build(os.path.join(_ROOT, "tensorframes_tpu_torch", "_build", "wide_trace"))
    for bh, s, d in shapes:
        if d % 8 or d <= 128:
            raise ValueError(f"the float32 wide kernel takes D a multiple of 8 past 128, got {d}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(3))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def traced():
            rc = lib.tfs_flash_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             o.data_ptr(), bh, s, d, d**-0.5, 1, stream)
            if rc:
                raise RuntimeError(f"traced launch failed: cudaError {rc}")

        traced_ms = _device_ms(traced)
        package_ms = _device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        traced()
        torch.cuda.synchronize()
        buf = np.zeros((_MAX_BLOCKS, 2, 8), dtype=np.int64)
        if lib.tfs_wide_trace_read(buf.ctypes.data):
            raise RuntimeError("reading the trace failed")
        nq = -(-s // 64)
        blocks = min(-(-d // 256) * bh * nq, _MAX_BLOCKS)
        # key tiles a block walks, causal: query tile j sees tiles 0 .. j
        tiles = -(-d // 256) * bh * sum(j + 1 for j in range(nq))
        sums = buf[:blocks].sum(axis=0).astype(np.float64)  # [group][phase]
        print(json.dumps({
            "card": card, "shape": [bh, s, d], "dtype": "float32", "causal": True,
            "traced_ms": traced_ms, "package_ms": package_ms, "blocks": blocks,
            "key_tiles": tiles,
            "cycles_per_key_tile": {
                f"group{g}": {p: float(sums[g][i] / tiles) for i, p in enumerate(_PHASES)}
                for g in (0, 1)},
            "share": {
                f"group{g}": {p: float(sums[g][i] / sums[g][0]) for i, p in enumerate(_PHASES)}
                for g in (0, 1)},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
