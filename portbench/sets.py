"""Run a cell several times, one process a run, and report each metric's
spread: the distance between the first and third quartile
(`statistics.quantiles(values, n=4)`) as a share of the median, the
measure the bounds in ``BENCHMARK.json`` are set from.

    python3 -m portbench.sets --workload <name> --seconds <s> --seeds 11,12,13 \\
        [--trace 0|1] [--out runs.jsonl]

Each run's result line (or its exit code and the end of its standard
error) goes to ``--out`` as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def summarize(lines: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per metric: median, spread, min, max over the runs that printed."""
    out: Dict[str, Dict[str, float]] = {}
    names = {n for ln in lines for n in ln.get("metrics", {})}
    for n in sorted(names):
        vals = [ln["metrics"][n]["value"] for ln in lines if n in ln.get("metrics", {})]
        if len(vals) >= 2:
            out[n] = {"median": statistics.median(vals), "spread": spread(vals),
                      "min": min(vals), "max": max(vals), "runs": len(vals)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--trace", default="0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    lines, failed = [], 0
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds.split(","):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "portbench.run", "--workload", args.workload,
                 "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
                capture_output=True, text=True)
            wall = time.perf_counter() - t
            rec = {"workload": args.workload, "seed": int(seed), "trace": int(args.trace),
                   "rc": proc.returncode, "wall_s": wall}
            last = proc.stdout.strip().splitlines()[-1:] if proc.stdout.strip() else []
            if proc.returncode == 0 and last:
                rec["line"] = json.loads(last[0])
                lines.append(rec["line"])
                failed += not rec["line"]["correct"]
            else:
                failed += 1
            rec["stderr_tail"] = proc.stderr[-3000:]
            print(json.dumps({k: v for k, v in rec.items() if k != "stderr_tail"}), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": args.workload, "summary": summarize(lines),
                      "failed_or_incorrect": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
