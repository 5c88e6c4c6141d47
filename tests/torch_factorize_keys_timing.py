"""Time the key factorization kernel on the card, by default at the benchmark cell's shape.

    python3 tests/torch_factorize_keys_timing.py [--rounds 11] [--rows 100000000]
        [--keys 16 [K ...]] [--dtype int64|int32]

Builds ``csrc/factorize_keys.cu`` of the checkout it runs from. For each
``--keys`` K it draws ROWS keys uniformly from K values (the default, 16
int64 keys over 100M rows, is ``meanvar.k16``'s key column) and times, in
turns (reversed every other round), each the mean of a few calls between CUDA
events after a warm-up:

- ``kernel``: `ops.factorize_keys.factorize`, the one host read of the
  distinct count included;
- ``plain``: ``torch.unique(sorted=True, return_inverse=True)``, the route it
  replaces.

Then one call of each under `torch.profiler`, for the device time of each
kernel they launch. Prints one JSON line a K: the card's name and power
limit, the medians and quartiles in ms, the bytes bound (keys read twice and
the int64 ids written once at 3.35 TB/s) and the kernel's share of it, the
per-kernel device ms, whether the two agree bit for bit (past the kernel's
capacity: that it returned None), and ptxas's registers and spills
(`_cuda_build.build_logs`, a checkout's first build only). Run it from the
roots of two checkouts in turns to compare them on one card. Not collected
by pytest.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

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


def _kernel_ms(fn) -> dict:
    """Device ms of each kernel one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key[:60]] = round(us / 1e3, 4)
    return out


def _ptxas(log: str) -> dict:
    out = {}
    for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers",
        log, re.S,
    ):
        out[m.group(1)] = [int(m.group(4)), int(m.group(2)), int(m.group(3))]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=11)
    p.add_argument("--rows", type=int, default=100_000_000)
    p.add_argument("--keys", type=int, nargs="+", default=[16])
    p.add_argument("--dtype", choices=["int64", "int32"], default="int64")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tensorframes_tpu_torch.ops import _cuda_build
    from tensorframes_tpu_torch.ops import factorize_keys as fk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dtype = getattr(torch, args.dtype)
    for k in args.keys:
        gen = torch.Generator(device="cuda").manual_seed(2**31 + k)
        keys = torch.randint(0, k, (args.rows,), generator=gen, device="cuda", dtype=dtype)
        got, want = fk.factorize(keys), torch.unique(keys, sorted=True, return_inverse=True)
        equal = (got is None) if k > fk.CAPACITY else (
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        del got, want
        entries = {"kernel": lambda: fk.factorize(keys),
                   "plain": lambda: torch.unique(keys, sorted=True, return_inverse=True)}
        times = {name: [] for name in entries}
        for r in range(args.rounds):
            for name in (list(entries) if r % 2 == 0 else list(entries)[::-1]):
                times[name].append(_time_ms(entries[name], 5 if name == "kernel" else 2))
        bound_ms = args.rows * keys.element_size() * 2 / _PEAK_BYTES_S * 1e3 + (
            args.rows * 8 / _PEAK_BYTES_S * 1e3)
        line = {"card": card, "rows": args.rows, "keys": k, "dtype": args.dtype,
                "equal": equal, "bound_ms": bound_ms}
        for name, t in times.items():
            q = statistics.quantiles(t, n=4)
            line[f"{name}_ms"] = statistics.median(t)
            line[f"{name}_quartiles_ms"] = [q[0], q[2]]
        line["share_of_bound"] = bound_ms / line["kernel_ms"]
        line["kernel_device_ms"] = _kernel_ms(entries["kernel"])
        line["plain_device_ms"] = _kernel_ms(entries["plain"])
        line["ptxas"] = _ptxas(_cuda_build.build_logs.get("factorize_keys", ""))
        print(json.dumps(line), flush=True)
        del keys
    return 0


if __name__ == "__main__":
    sys.exit(main())
