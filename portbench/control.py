"""The precision controls: the plain reference put in the program's place,
computed in the precision just below the one the configuration states, its
outputs handed to the cell's own comparison (the driver's ``compare``, as a
run's check hands it the window's outputs). A sound limit makes every
control come out not correct.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

prints one JSON line a seed: the compared numbers of the control at the
cell's own sizes and inputs, each beside the cell's limit, and ``correct``.

- ``fn_map_blocks_lm`` cells (float32 with TF32 off): the reference's
  logits with TF32 on, for every frame the window goes round.
- ``aggregate`` / ``aggregate_global`` cells (float32): the keyed means in
  bfloat16 (`keyed_meanvar.means_bf16`) over the rows of every rank, for
  every frame.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import torch

from portbench import harness
from portbench.drivers import aggregate as agg
from portbench.drivers import fn_map_blocks_lm as lm
from portbench.reference import gpt2
from portbench.reference import keyed_meanvar


def lm_control(cell: harness.Cell, seed: int, device) -> List[harness.Compared]:
    cfg, traffic = cell.config, cell.traffic
    w = lm.widths(cfg)
    weights = lm.make_weights(cfg, seed, device)
    kept = []
    with gpt2.matmul_precision(tf32=True):
        for f in range(traffic["frames"]):
            tokens = lm.make_tokens(cfg, traffic, seed, f, device)
            kept.append((f, torch.cat(list(gpt2.logits_blocks(
                weights, tokens, w["heads"], w["layers"], traffic["check_block"])))))
    del weights
    return lm.compare(cfg, traffic, seed, device, kept, cell.limits)


def meanvar_control(cell: harness.Cell, seed: int, device) -> List[harness.Compared]:
    cfg, traffic, ranks = cell.config, cell.traffic, cell.chips
    kept = []
    for f in range(traffic["frames"]):
        parts = (agg.make_rows(cfg, seed, r, f, device) for r in range(ranks))
        k, m, q = keyed_meanvar.means_bf16(parts, cfg["keys"])
        kept.append((f, k.numpy(), m.numpy(), q.numpy()))
    return agg.compare(cfg, seed, device, kept, cell.limits, ranks)


CONTROLS = {"fn_map_blocks_lm": lm_control, "aggregate": meanvar_control,
            "aggregate_global": meanvar_control}


def readings(root: Path, workload: str, seeds: List[int], device) -> List[Dict]:
    cell = harness.resolve(root, workload)
    control = CONTROLS[cell.traffic["driver"]]
    out = []
    for seed in seeds:
        compared = control(cell, seed, device)
        out.append({"workload": workload, "seed": seed,
                    "compared": {x.name: {"value": x.value, "limit": x.limit, "ok": x.ok}
                                 for x in compared},
                    "correct": harness.correct(compared)})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for rec in readings(harness.PKG.parent, args.workload,
                        [int(s) for s in args.seeds.split(",")], device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
