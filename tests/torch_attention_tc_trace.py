"""Where the tensor-core attention kernel's cycles go, on the card.

    python3 tests/torch_attention_tc_trace.py [BHxSxD ...]

Copies `tensorframes_tpu_torch/csrc/flash_attention_tc.cuh`, adds
`clock64()` sums to the copy (each warpgroup's prologue up to its first
scores, softmax, waits on the K / V barriers, waits for its turn, its
tensor-core batches from issue to completion, the epilogue), builds the bf16
library from it with `nvcc` into `tensorframes_tpu_torch/_build/trace/`, and
runs it causal at each shape (default 32x2048x64 and 16x2048x128). Prints one
JSON line a shape: the card's name and power limit, the traced kernel's and
the package's kernel's device ms (20 launches, the stream held while the
host queues them), and the mean cycles a warpgroup spends in each phase per
key tile, with their shares. The sums perturb the kernel a little: compare
the two ms. Not collected by pytest; needs a CUDA card and nvcc.
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
_PHASES = ["total", "prologue", "softmax", "barrier_wait", "turn_wait", "tensor_core_batch",
           "epilogue"]


def _patch(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"the header changed: {old[:60]!r} found {src.count(old)} times")
    return src.replace(old, new)


def _traced_header(header: str) -> str:
    # only flash_attention_tc_kernel (D8 <= 256) is traced: the wide kernel
    # after it is left as it is
    src, sep, wide = header.partition("// Past D8 256 (kTcSliceD).")
    if not sep:
        raise RuntimeError("the header changed: the wide kernel's comment is not found")
    src = _patch(src, "namespace {\n\nconstexpr int kTcRows",
                 f"__device__ long long tfs_tc_trace[{_MAX_BLOCKS}][2][8];\n\n"
                 "namespace {\n\nconstexpr int kTcRows")
    src = _patch(src, "  float acc[NO];\n",
                 "  const long long t_start = clock64();\n"
                 "  long long cyc[7] = {0, 0, 0, 0, 0, 0, 0}, tt = t_start;\n"
                 "  float acc[NO];\n")
    src = _patch(src, "  if (lane == 0) mbar_arrive(k_empty);  // this warp is done with K tile 0\n",
                 "  if (lane == 0) mbar_arrive(k_empty);  // this warp is done with K tile 0\n"
                 "  cyc[1] = clock64() - t_start;\n")
    src = _patch(src, "    softmax_tile<T, NO, NS>(",
                 "    tt = clock64();\n    softmax_tile<T, NO, NS>(", count=2)
    src = _patch(src, "                            q0 + 64 * cw, seq, causal);\n",
                 "                            q0 + 64 * cw, seq, causal);\n"
                 "    hold(p_hi);\n    cyc[2] += clock64() - tt;\n    tt = clock64();\n", count=2)
    src = _patch(src, "    take_turn(cw);\n",
                 "    cyc[3] += clock64() - tt;\n    tt = clock64();\n    take_turn(cw);\n"
                 "    cyc[4] += clock64() - tt;\n    tt = clock64();\n", count=2)
    src = _patch(src, "    hold(s_acc);\n    if (lane == 0) {\n",
                 "    hold(s_acc);\n    cyc[5] += clock64() - tt;\n    if (lane == 0) {\n")
    src = _patch(src, "    hold(p_lo);\n  }\n\n  const size_t head_row",
                 "    hold(p_lo);\n    cyc[5] += clock64() - tt;\n  }\n  tt = clock64();\n\n"
                 "  const size_t head_row")
    src = _patch(src, "  }\n}\n\ntemplate <class T, int DK, bool kLse>",
                 "  }\n"
                 "  cyc[6] = clock64() - tt;\n"
                 f"  if (t == 0 && blockIdx.x < {_MAX_BLOCKS}) {{\n"
                 "    long long* r = tfs_tc_trace[blockIdx.x][cw];\n"
                 "    r[0] = clock64() - t_start;\n"
                 "    for (int i = 1; i < 7; ++i) r[i] = cyc[i];\n"
                 "    r[7] = nk;\n  }\n}\n\ntemplate <class T, int DK, bool kLse>")
    return src + sep + wide


def _build(out_dir: str) -> ctypes.CDLL:
    from tensorframes_tpu_torch.ops import _cuda_build

    csrc = os.path.join(_ROOT, "tensorframes_tpu_torch", "csrc")
    with open(os.path.join(csrc, "flash_attention_tc.cuh")) as f:
        header = _traced_header(f.read())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "flash_attention_tc.cuh"), "w") as f:
        f.write(header)
    src = os.path.join(out_dir, "trace_bf16.cu")
    with open(src, "w") as f:
        f.write(f'#include "{os.path.join(csrc, "flash_attention.cuh")}"\n'
                '#include "flash_attention_tc.cuh"\n'
                "TFS_ATTENTION_ENTRIES(__nv_bfloat16, bf16)\n"
                'extern "C" int tfs_tc_trace_read(void* host) {\n'
                "  return static_cast<int>(cudaMemcpyFromSymbol(host, tfs_tc_trace,\n"
                "                                               sizeof(tfs_tc_trace)));\n}\n")
    lib_path = os.path.join(out_dir, "libtrace_bf16.so")
    proc = subprocess.run([_cuda_build._nvcc(), *_cuda_build._FLAGS, "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(lib_path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfs_flash_attention_bf16.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, f32, i32, ptr]
    lib.tfs_flash_attention_bf16.restype = i32
    lib.tfs_tc_trace_read.argtypes = [ptr]
    lib.tfs_tc_trace_read.restype = i32
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

    shapes = [[int(n) for n in a.split("x")] for a in sys.argv[1:]] or [[32, 2048, 64],
                                                                        [16, 2048, 128]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lib = _build(os.path.join(_ROOT, "tensorframes_tpu_torch", "_build", "trace"))
    for bh, s, d in shapes:
        if d % 8 or d > 256:
            raise ValueError(f"the tensor-core kernel takes D a multiple of 8 up to 256, got {d}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def traced():
            rc = lib.tfs_flash_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              o.data_ptr(), bh, s, d, d**-0.5, 1, stream)
            if rc:
                raise RuntimeError(f"traced launch failed: cudaError {rc}")

        traced_ms = _device_ms(traced)
        package_ms = _device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        traced()
        torch.cuda.synchronize()
        buf = np.zeros((_MAX_BLOCKS, 2, 8), dtype=np.int64)
        if lib.tfs_tc_trace_read(buf.ctypes.data):
            raise RuntimeError("reading the trace failed")
        blocks = min(bh * -(-s // 128), _MAX_BLOCKS)
        rows = buf[:blocks]
        tiles = int(rows[:, :, 7].sum())  # key tiles, both warpgroups
        sums = rows[:, :, :7].sum(axis=(0, 1)).astype(np.float64)
        print(json.dumps({
            "card": card, "shape": [bh, s, d], "dtype": "bfloat16", "causal": True,
            "traced_ms": traced_ms, "package_ms": package_ms, "blocks": blocks,
            "key_tiles_per_warpgroup": tiles // 2,
            "cycles_per_key_tile": {p: float(sums[i] / tiles) for i, p in enumerate(_PHASES)},
            "share": {p: float(sums[i] / sums[0]) for i, p in enumerate(_PHASES)},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
