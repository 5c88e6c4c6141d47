"""``BENCHMARK.json`` keeps to the benchmark's format, every cell finds its
files by name, and a new cell, traffic mix, configuration and per-layer
metric come in as files alone."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (tiny.REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((tiny.REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = BENCH["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
    assert {w["config"] for w in cells} == set(configs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert not set(e2e) & set(layer) and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert harness._applies(e2e[m["moves"]], w), (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for w in cells:
        reported = [n for n, m in e2e.items() if harness._applies(m, w)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness._applies(m, w) for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.resolve(tiny.REPO, workload)
    assert cell.driver_path.exists()
    assert set(cell.metrics) == set(cell.end_to_end) | set(cell.per_layer)
    for m in cell.metrics.values():
        assert callable(harness.load_module(m["path"], "metric").read)
    assert cell.limits


def test_a_new_cell_comes_in_as_files(tmp_path):
    root = tiny.make_checkout(tmp_path)
    # every file the repository has is untouched in the copy
    for p in (tiny.REPO / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert (root / p.relative_to(tiny.REPO)).read_bytes() == p.read_bytes()
    # a per-layer metric of its own, as one more file and one more entry
    (root / "portbench" / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "verbs",
                               "moves": "call_p95_ms", "workloads": ["gpt2.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve(root, "gpt2.tiny")
    assert cell.config["name"] == "gpt2-tiny" and cell.traffic["seq_len"] == 16
    assert "calls_in_window" in cell.per_layer
    line, compared = harness.run_cell(cell, 2**31 + 5, 0.3, True, torch.device("cpu"),
                                      time.perf_counter(), 0.0)
    assert line["correct"], line
    assert line["metrics"]["calls_in_window"]["value"] == line["attempted"] > 0
    assert list(line)[-1] == "compared"
    with pytest.raises(KeyError):
        harness.resolve(root, "no.such.cell")


def test_a_split_metric_shares_the_reader_of_its_stem(tmp_path):
    (tmp_path / "device_idle.py").write_text("")
    (tmp_path / "call_p95_ms.py").write_text("")
    (tmp_path / "call_p95_ms.train.py").write_text("")
    assert harness.reader_path(tmp_path, "device_idle.rows") == tmp_path / "device_idle.py"
    assert harness.reader_path(tmp_path, "device_idle.a.b") == tmp_path / "device_idle.py"
    assert harness.reader_path(tmp_path, "call_p95_ms.train") == tmp_path / "call_p95_ms.train.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path(tmp_path, "device_busy.rows")
