"""What the cost ledger and telemetry cost a `map_blocks` call, and where.

Runs ``chip_smoke.py`` phase 16's x+3 map (float32 rows in blocks) with
``cost_ledger`` and ``telemetry`` both off, both on, and each alone, in
ROUNDS interleaved rounds whose order alternates, and prints per variant
the medians of three host times: until the first block's program is
launched (``telemetry.launching``, the part of the call the card waits
for), until the verb returns (the host's whole enqueue), and until the
card has finished (the call's wall time, as the smoke times it).

    python tests/torch_ledger_overhead_timing.py ROUNDS [ROWS] [BLOCKS]

ROWS defaults to 200,000,000 and BLOCKS to 8. With few rows (say 8,192)
the loop waits on the host alone, and the enqueue column reads the whole
host cost of each variant. It runs on the card when there is one, else
on the CPU. Not collected by pytest.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.utils import telemetry

VARIANTS = {
    "off": dict(cost_ledger=False, telemetry=False),
    "on": {},
    "ledger only": dict(telemetry=False),
    "telemetry only": dict(cost_ledger=False),
}


def main() -> None:
    rounds = int(sys.argv[1])
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else 200_000_000
    blocks = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    cuda = torch.cuda.is_available()
    dev = "cuda" if cuda else "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip())
    x = torch.rand(rows, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    z = (tft.block(df, "x") + 3.0).named("z")
    ex = Executor()

    first = []
    launching = telemetry.launching

    def stamped():
        if not first:
            first.append(time.perf_counter())
        launching()

    telemetry.launching = stamped

    def call(variant):
        with tft.config.override(**VARIANTS[variant]):
            first.clear()
            sync()
            t0 = time.perf_counter()
            tft.map_blocks(z, df, executor=ex, device=dev)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
        return (first[0] - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t0) * 1e3

    names = list(VARIANTS)
    for _ in range(3):
        for v in names:
            call(v)
    telemetry.resolve_device_times()
    got = {v: [] for v in names}
    for r in range(rounds):
        for v in names if r % 2 == 0 else names[::-1]:
            got[v].append(call(v))
        telemetry.resolve_device_times()
    off_wall = statistics.median(t[2] for t in got["off"])
    for v in names:
        first_ms, enqueue_ms, wall_ms = (
            statistics.median(t[i] for t in got[v]) for i in range(3)
        )
        print(json.dumps({
            "variant": v, "rows": rows, "blocks": blocks, "rounds": rounds,
            "first_launch_ms": first_ms, "enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
            "wall_over_off": wall_ms / off_wall,
        }), flush=True)


if __name__ == "__main__":
    main()
