"""A checkout of the benchmark at sizes a CPU test can hold: a copy of
``portbench/`` beside a ``BENCHMARK.json`` of tiny cells, each with the
driver, metrics and limits of the cell it stands for."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

GPT2_TINY = {
    "name": "gpt2-tiny", "n_embd": 32, "n_head": 2, "n_layer": 2, "n_positions": 64,
    "vocab_size": 97, "layer_norm_epsilon": 1e-05, "initializer_range": 0.02, "reduced": [],
}
MEANVAR_TINY = {"name": "meanvar-tiny", "rows_per_card": 20000, "width": 8, "keys": 16,
                "reduced": []}
TRAFFIC = {
    "score.tiny": {"driver": "fn_map_blocks_lm", "sequences": 4, "seq_len": 16, "blocks": 2,
                   "frames": 2, "warmup_calls": 1, "check_calls": 2, "check_block": 2},
    "k16.tiny": {"driver": "aggregate", "blocks": 4, "frames": 2, "warmup_calls": 1},
    "k16.r4.tiny": {"driver": "aggregate_global", "blocks": 4, "frames": 2, "warmup_calls": 1},
}
# tiny cell -> (config, traffic, chips, the real cell whose limits it takes)
CELLS = {
    "gpt2.tiny": ("gpt2-tiny", "score.tiny", 1, "gpt2m.score.s1024"),
    "meanvar.tiny": ("meanvar-tiny", "k16.tiny", 1, "meanvar.k16"),
    "meanvar.tiny.r4": ("meanvar-tiny", "k16.r4.tiny", 4, "meanvar.k16"),
}


def make_checkout(tmp: Path) -> Path:
    """``tmp`` holding the benchmark with the tiny cells added as data."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pkg = tmp / "portbench"
    for conf in (GPT2_TINY, MEANVAR_TINY):
        (pkg / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": "tiny",
                                 "file": f"portbench/configs/{conf['name']}.json",
                                 "reduced": [], "why": "CPU test"})
    for name, mix in TRAFFIC.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (conf, traffic, chips, real) in CELLS.items():
        shutil.copy(pkg / "limits" / f"{real}.json", pkg / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": conf, "traffic": traffic,
                                   "chips": chips, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
