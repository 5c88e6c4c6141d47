"""Time the keyed-sums kernel on the card, by default at the benchmark cell's shape.

    python3 tests/torch_keyed_sums_timing.py [--rounds 11] [--rows 100000000]
        [--shape 16:8,8 [G:W,W,...]] [--tables-bytes B,B,...]

Builds ``csrc/keyed_sums.cu`` of the checkout it runs from. For each
``--shape`` (G groups, one float32 output of each width W; the default
``16:8,8`` is ``meanvar.k16``'s: 8 values and their squares into 16 keys)
it draws ROWS rows with uniform ids and times:

- ``kernel``: `keyed_sums` as the segment plan calls it, and
  ``kernel_tables_<B>``: one launch with its tile tables held to B bytes of
  shared memory (``--tables-bytes``; at the default shape 16384 gives one
  table a warp, 8192 one table), each with the layout it planned. Shapes
  past the kernel's table have none of these;
- ``plain``: `keyed_sums_reference`, the plain version;
- ``segment_tables``: `aggregate._segment_tables` over all the outputs as
  means, the segment plans' step (the kernel where it takes the shape, else
  a segment sum an output and a `bincount`);
- ``segment_reduce_bincount``: a `segment_reduce` sum an output and a
  `torch.bincount`, the step the segment plan ran before the kernel.

ROUNDS rounds, the entries in turns (reversed every other round), each
entry the mean of a few calls between CUDA events after a warm-up. Prints
one JSON line a shape: the card's name and power limit, the medians and
quartiles in ms, the bytes bound (ids and outputs read once at 3.35 TB/s)
and each entry's share of it, the widest relative gap of the kernel's (or
the segment step's) means from float64, whether the counts are exact, and
ptxas's registers and spills for each instantiation
(`_cuda_build.build_logs`). Run it from the roots of two checkouts in turns
to compare them on one card. Not collected by pytest.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ptxas(log: str) -> dict:
    """Each entry function of a build log: [registers, spill stores, spill
    loads] (bytes)."""
    out = {}
    for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers",
        log, re.S,
    ):
        name = re.sub(r"^_Z\d+", "", m.group(1))
        out[name] = [int(m.group(4)), int(m.group(2)), int(m.group(3))]
    return out


def _shape(text: str):
    groups, widths = text.split(":")
    return int(groups), [int(w) for w in widths.split(",")]


def _float64_means(outs, ids, groups):
    """Each output's per-group means in float64, and the counts."""
    n = ids.shape[0]
    counts = torch.bincount(ids, minlength=groups)
    means = []
    for v in outs:
        s = torch.zeros(groups, v.shape[1], dtype=torch.float64, device=v.device)
        for lo in range(0, n, 10_000_000):
            s.index_add_(0, ids[lo:lo + 10_000_000], v[lo:lo + 10_000_000].double())
        means.append(s / counts.double()[:, None])
    return means, counts


def _one_shape(n: int, groups: int, widths, tables_bytes, rounds: int, card: str) -> dict:
    from tensorframes_tpu_torch.aggregate import _segment_tables
    from tensorframes_tpu_torch.ops import keyed_sums as ks
    from tensorframes_tpu_torch.ops.standard import segment_reduce

    gen = torch.Generator(device="cuda").manual_seed(2**31 + 7)
    ids = torch.randint(0, groups, (n,), generator=gen, device="cuda")
    if widths == [8, 8]:
        v = torch.rand(n, 8, generator=gen, device="cuda")
        outs = [v, v * v]  # as meanvar.k16 sums them
    else:
        outs = [torch.rand(n, w, generator=gen, device="cuda") for w in widths]
    bases = [f"x{j}" for j in range(len(outs))]
    means = dict.fromkeys(bases, "mean")
    kernel = ks.takes_kernel(ids.device, [torch.float32] * len(outs), groups, widths)

    def parent():
        for o in outs:
            segment_reduce(o, ids, groups, "sum")
        torch.bincount(ids, minlength=groups)

    entries = {}
    layouts = {}
    if kernel:
        entries["kernel"] = (lambda: ks.keyed_sums(outs, ids, groups), 20)
        layouts["kernel"] = ks._plan(outs, n, groups)
        for b in tables_bytes:
            entries[f"kernel_tables_{b}"] = (lambda b=b: ks._launch(outs, ids, groups, b), 20)
            layouts[f"kernel_tables_{b}"] = ks._plan(outs, n, groups, b)
    entries["plain"] = (lambda: ks.keyed_sums_reference(outs, ids, groups), 3)
    entries["segment_tables"] = (
        lambda: _segment_tables(bases, outs, means, ids, groups, True), 3 + 17 * kernel)
    entries["segment_reduce_bincount"] = (parent, 3)

    want, want_counts = _float64_means(outs, ids, groups)
    sums, counts = (ks.keyed_sums(outs, ids, groups) if kernel
                    else _segment_tables(bases, outs, means, ids, groups, True))
    gap = max(float(((s.double() / counts.double()[:, None] - w) / w).abs().max())
              for s, w in zip(sums, want))
    counts_exact = bool(torch.equal(counts, want_counts))
    del want, sums
    times = {name: [] for name in entries}
    for r in range(rounds):
        order = list(entries) if r % 2 == 0 else list(reversed(entries))
        for name in order:
            fn, iters = entries[name]
            times[name].append(_time_ms(fn, iters))
    bound_ms = 1e3 * n * (8 + 4 * sum(widths)) / _PEAK_BYTES_S
    med = {k: float(np.median(t)) for k, t in times.items()}
    return {
        "card": card, "rows": n, "groups": groups, "widths": widths, "kernel_takes": kernel,
        "rounds": rounds, "median_ms": med,
        "quartiles_ms": {k: [float(np.percentile(t, 25)), float(np.percentile(t, 75))]
                         for k, t in times.items()},
        "bound_ms": bound_ms,
        "share_of_bound": {k: bound_ms / m for k, m in med.items()},
        "plans": layouts,
        "mean_rel_err_vs_float64": gap, "counts_exact": counts_exact,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=11)
    parser.add_argument("--rows", type=int, default=100_000_000)
    parser.add_argument("--shape", nargs="+", type=_shape, default=[(16, [8, 8])],
                        help="G:W,W,... (groups: the outputs' row widths)")
    parser.add_argument("--tables-bytes", default="",
                        help="comma-separated shared-memory budgets for the tile tables")
    args = parser.parse_args()
    tables_bytes = [int(b) for b in args.tables_bytes.split(",") if b]
    from tensorframes_tpu_torch.ops import _cuda_build
    from tensorframes_tpu_torch.ops import keyed_sums as ks

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for groups, widths in args.shape:
        line = _one_shape(args.rows, groups, widths, tables_bytes, args.rounds, card)
        line["launches"] = ks.keyed_sums.launches
        line["ptxas"] = _ptxas(_cuda_build.build_logs.get("keyed_sums", ""))
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
