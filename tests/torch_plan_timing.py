"""Host-visible times of the verb paths a port change touches, in rounds.

Prints one JSON line of medians over ROUNDS calls each, after one warm-up
call each:

- ``map_blocks`` x+3 over ROWS float32 rows in 8 blocks, and the same with
  ``mesh=parallel.data_mesh()`` where the package has meshes (one call a
  shard);
- ``reduce_blocks`` sum over the same rows, local and with the mesh;
- the exact ``aggregate`` plan of ``chip_smoke.py`` phase 5 (a Sum / Max
  graph over 1,000,000 rows and 1,000 keys of uneven size): seconds a
  call and milliseconds a distinct group size;
- on the card, where the package has ``TensorFrame.to_global``, the x+3
  map and the sum over the rows sharded once over every card (one call
  a shard).

Local and mesh calls alternate, the order flipping each round. Run it
from the root of the checkout whose package it should time (it imports
the ``tensorframes_tpu_torch`` beside its ``tests/`` directory), so two
checkouts in turns compare two commits on one card:

    python tests/torch_plan_timing.py ROUNDS [ROWS]

It runs on the card when there is one, else on the CPU. Not collected by
pytest.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import tensorframes_tpu_torch as tft


def _timer(dev):
    def sync():  # every card: a global frame's shards run on all of them
        if dev == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    return wall


def main() -> None:
    rounds = int(sys.argv[1])
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else 200_000_000
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    card = None
    if dev == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    wall = _timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(rows, device=dev, generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(8)
    z = (tft.block(df, "x") + 3.0).named("z")
    s = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input")).named("x")
    mesh = None
    try:
        from tensorframes_tpu_torch.parallel import data_mesh

        mesh = data_mesh(devices=[dev])
    except ImportError:
        pass
    calls = {
        "map_blocks": lambda: tft.map_blocks(z, df, device=dev),
        "reduce_sum": lambda: tft.reduce_blocks(s, df, device=dev),
    }
    if mesh is not None:
        calls["map_blocks_mesh"] = lambda: tft.map_blocks(z, df, mesh=mesh)
        calls["reduce_sum_mesh"] = lambda: tft.reduce_blocks(s, df, mesh=mesh)
    if dev == "cuda" and hasattr(tft.TensorFrame, "to_global"):
        gf = df.to_global()
        # a lead-axis sum: a monoid the shards' partials combine by
        gs = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
        calls["map_blocks_global"] = lambda: gf.map_blocks(z)
        calls["reduce_sum_global"] = lambda: tft.reduce_blocks(gs, gf)

    n, nkeys = 1_000_000, 1000
    u = torch.rand(n, device=dev, generator=gen)
    keys = (u * u * nkeys).to(torch.int64)
    v = torch.rand(n, device=dev, generator=gen) + 0.5
    edf = tft.TensorFrame([tft.Column("k", keys), tft.Column("x", v)]).repartition(8)
    xi = tft.dsl.block(edf, "x", tf_name="x_input")
    ratio = (tft.dsl.reduce_sum(xi, axes=[0]) / tft.dsl.reduce_max(xi, axes=[0])).named("x")
    grouped = tft.group_by(edf, "k")
    calls["aggregate_exact"] = lambda: tft.aggregate(ratio, grouped, device=dev)
    sizes = np.bincount(keys.cpu().numpy())
    distinct = len(np.unique(sizes[sizes > 0]))

    for fn in calls.values():
        fn()
    times = {k: [] for k in calls}
    names = list(calls)
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            times[k].append(wall(calls[k]))
    med = {k: statistics.median(t) for k, t in times.items()}
    print(json.dumps({
        "card": card, "device": dev, "cards": torch.cuda.device_count(), "rounds": rounds,
        "rows": rows,
        "median_s": med,
        "quartiles_s": {k: [float(q) for q in np.percentile(t, [25, 75])] for k, t in times.items()},
        "aggregate_exact_distinct_sizes": distinct,
        "aggregate_exact_ms_per_size": med["aggregate_exact"] * 1e3 / distinct,
    }), flush=True)


if __name__ == "__main__":
    main()
