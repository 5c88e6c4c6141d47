"""Where the card's time goes in two imported-graph calls of `chip_smoke.py`.

    python3 -m tensorframes_tpu_torch.tools.profile_imported

Runs, on the CUDA card, the smoke's Inception scoring call (`InceptionLite`
at 299x299, width 32, 1000 classes, 2,048 random images in 8 blocks) and
its branchy `map_rows` call (10,000,000 float32 rows in 8 blocks, the
committed v2 fixture), each once to warm up and once under
`torch.profiler`. Prints one JSON line per call: the wall time, the device
time summed over kernels, the device's busy share (kernel time over wall
time; kernels of one stream do not overlap) and the kernels that took the
most device time, grouped by kind and listed by name.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

import tensorframes_tpu_torch as tft

_FIXTURES = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests", "fixtures", "torch_port"
)

# kernel-name fragments -> kind, first match wins
_KINDS = (
    ("convolution", ("conv", "xmma", "implicit", "winograd", "fft", "cudnn", "sm90")),
    ("matmul", ("gemm", "cutlass")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("copy / cat / pad", ("copy", "cat", "pad", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, parts in _KINDS:
        if any(p in low for p in parts):
            return kind
    return "other"


def _profiled(what: str, fn, top: int = 12) -> None:
    fn()  # lowering, cuDNN plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time for e in kernels) / 1e6
    by_kind = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kind[_kind(e.name)] += e.device_time / 1e6
        by_name[e.name][0] += e.device_time / 1e6
        by_name[e.name][1] += 1
    names = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    print(json.dumps({
        "call": what, "wall_s": wall, "device_s": device_s,
        "device_busy_share": device_s / wall, "kernels": len(kernels),
        "by_kind_s": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": n[:120], "s": s, "launches": c} for n, (s, c) in names
        ],
    }), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)

    graph, _ = tft.dsl.build(
        tft.InceptionLite(image_size=299, width=32, num_classes=1000, seed=0).scoring_graph()
    )
    wire = graph.to_bytes()
    gen = torch.Generator(device="cuda").manual_seed(4)
    imgs = torch.rand(2048, 299, 299, 3, device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("images", imgs)]).repartition(8)
    _profiled(
        "inception_map_blocks",
        lambda: tft.map_blocks(wire, df, fetch_names=["probs"], trim=True),
    )
    del df, imgs

    with open(os.path.join(_FIXTURES, "branchy_v2.pb"), "rb") as f:
        branchy = f.read()
    x = (torch.rand(10_000_000, device="cuda", generator=gen) - 0.5) * 40.0
    xdf = tft.TensorFrame([tft.Column("x", x)]).repartition(8)
    _profiled(
        "branchy_map_rows",
        lambda: tft.map_rows(branchy, xdf, fetch_names=["out", "trips"]),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
