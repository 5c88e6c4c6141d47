"""The benchmark's core: find a cell's files by name, run its closed loop,
read its metrics, decide `correct`, and build the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell lives in a file of its own, found by the names in
``BENCHMARK.json``:

- ``<file>`` of the configuration entry: its sizes (JSON);
- ``portbench/traffic/<traffic>.json``: the mix, whose ``driver`` names
  ``portbench/drivers/<driver>.py``, the code that builds the cell's inputs
  and calls the program;
- ``portbench/metrics/<metric>.py``: one reader a metric, ``read(run)``
  returning a number or None (nothing to read). A quantity split by the
  end-to-end metric it moves (``device_idle.tokens``, ``device_idle.rows``)
  shares the reader of its stem (``device_idle.py``): without a file of
  the whole name, the name is cut at its last dot until one is found;
- ``portbench/limits/<workload>.json``: the limit of each number that
  decides the cell's ``correct``.

A driver module has ``setup(ctx) -> cell``; the cell has ``work`` (what one
call does, counted from shapes: ``items`` and the work unit, and whatever
its metrics read), ``call(i)``, ``keep(i, out)``, ``counters()``,
``release()`` and ``check(limits) -> [Compared]``; a multi-rank driver
(``RANKS = True``) also ``agree(stop) -> bool`` and ``gather(obj)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent

# modules no process of the benchmark may load, by whole top-level name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tensorframes_tpu"})


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of `FORBIDDEN`, compared whole: ``tensorframes_tpu_torch`` and
    ``jaxtyping`` are not ``tensorframes_tpu`` and ``jax``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


@dataclasses.dataclass
class Compared:
    """One number the check compares, its limit, and whether it passed."""

    name: str
    value: float
    limit: float
    ok: bool


def correct(compared: List[Compared]) -> bool:
    """A run (or a control) is correct when it compared something and every
    number is within its limit."""
    return bool(compared) and all(x.ok for x in compared)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything its name finds."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    driver_path: Path
    metrics: Dict[str, Dict[str, Any]]  # end-to-end and per-layer, by name
    end_to_end: List[str]
    per_layer: List[str]


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader_path(metrics: Path, name: str) -> Path:
    """The reader of metric ``name``: ``<name>.py``, else that of the name
    cut at its last dot (``device_idle.rows`` -> ``device_idle.py``)."""
    stem = name
    while True:
        path = metrics / f"{stem}.py"
        if path.exists():
            return path
        if "." not in stem:
            raise FileNotFoundError(metrics / f"{name}.py")
        stem = stem.rsplit(".", 1)[0]


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its
    configuration, traffic, limits, driver and metric readers found by
    name under ``root``. Raises ``FileNotFoundError`` or ``KeyError`` for
    anything missing."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pkg = root / "portbench"
    try:
        w = next(w for w in bench["workloads"] if w["name"] == workload)
    except StopIteration:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json") from None
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((pkg / "limits" / f"{workload}.json").read_text())
    driver_path = pkg / "drivers" / f"{traffic['driver']}.py"
    if not driver_path.exists():
        raise FileNotFoundError(driver_path)
    metrics = {}
    e2e = [m["name"] for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m["name"] for m in bench["per_layer"] if _applies(m, workload)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in e2e or m["name"] in layer:
            metrics[m["name"]] = dict(m, path=reader_path(pkg / "metrics", m["name"]))
    return Cell(workload, int(w["chips"]), config, traffic, limits, driver_path, metrics,
                e2e, layer)


def load_module(path: Path, prefix: str):
    """The module at ``path``, loaded under a name of its own (metric names
    hold dots, so they are loaded by path, not imported by name)."""
    name = f"portbench._{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a driver's ``setup`` gets."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    device: Any  # torch.device
    rank: int = 0
    world: int = 1
    port: Optional[int] = None


@dataclasses.dataclass
class Run:
    """One run's record, what the metric readers read."""

    setup_s: float
    window_s: float
    latencies_s: List[float]
    work: Dict[str, Any]
    counters: Dict[str, float]
    trace: Optional[Dict[str, Any]] = None  # this rank's trace summary
    traces: Optional[List[Dict[str, Any]]] = None  # every rank's

    @property
    def calls(self) -> int:
        return len(self.latencies_s)

    def mean_busy_s(self) -> Optional[float]:
        if not self.traces:
            return None
        return statistics.fmean(t["busy_s"] for t in self.traces)


def derived_seed(seed: int, *parts: int) -> int:
    """A generator seed for one part of the inputs (a rank, a frame), from
    the run's seed: distinct parts get distinct streams."""
    x = seed & ((1 << 64) - 1)
    for p in parts:
        x = (x * 0x9E3779B97F4A7C15 + p + 1) & ((1 << 63) - 1)
    return x


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             age0: float, rank: int = 0, world: int = 1, port: Optional[int] = None):
    """Set up ``cell``, warm it, run its window, read its metrics and check
    it. ``t0`` is `time.perf_counter()` at the process's first line and
    ``age0`` the process's age then. Returns (result line or None on ranks
    past 0, the compared numbers)."""
    import torch

    from . import trace as _trace

    # where set-up goes: seconds from the process's start to each mark
    marks = {"imports": age0 + time.perf_counter() - t0}
    driver = load_module(cell.driver_path, "driver")
    ctx = Context(cell.config, cell.traffic, seed, device, rank, world, port)
    c = driver.setup(ctx)
    _sync(device)
    marks["inputs"] = age0 + time.perf_counter() - t0
    lockstep = getattr(driver, "RANKS", False)
    for i in range(int(cell.traffic.get("warmup_calls", 2))):
        c.call(i)
        _sync(device)
        if lockstep:
            c.agree(False)
        marks[f"warm_call_{i}"] = age0 + time.perf_counter() - t0
    tracer = _trace.Tracer() if trace else None
    before = c.counters()
    if lockstep:
        c.agree(False)  # every rank starts the window together
    setup_s = age0 + time.perf_counter() - t0
    if tracer is not None:
        tracer.start()
    lat: List[float] = []
    start = time.perf_counter()
    window_start_ns = time.time_ns()
    i = 0
    while True:
        t = time.perf_counter()
        with torch.profiler.record_function(_trace.CALL_SPAN):
            out = c.call(i)
            _sync(device)
            stop = time.perf_counter() - start >= seconds
            if lockstep:
                stop = c.agree(stop)
        lat.append(time.perf_counter() - t)
        c.keep(i, out)
        del out
        i += 1
        if stop:
            break
    window_s = time.perf_counter() - start
    window_end_ns = time.time_ns()
    summary = None
    if tracer is not None:
        tracer.stop()
        summary = tracer.summary(window_start_ns, window_end_ns, window_s)
    after = c.counters()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(setup_s, window_s, lat, c.work, counters, summary)
    if lockstep:
        every = c.gather({"peak": peak, "trace": summary})
        if rank == 0:
            peak = max(e["peak"] for e in every)
            run.traces = [e["trace"] for e in every] if trace else None
    elif trace:
        run.traces = [summary]
    metrics = {}
    if rank == 0:
        names = cell.per_layer if trace else cell.end_to_end
        for name in names:
            m = cell.metrics[name]
            value = load_module(m["path"], "metric").read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    c.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = c.check(cell.limits)
    if rank != 0:
        return None, compared
    line = {
        "correct": correct(compared),
        "attempted": run.calls,
        "failed": 0,
        "metrics": metrics,
        "device": device_record(device, world, peak, run if trace else None),
    }
    if trace and summary is not None:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["setup_marks_s"] = marks
    line["compared"] = {x.name: {"value": x.value, "limit": x.limit} for x in compared}
    return line, compared


def device_record(device, world: int, peak: int, run: Optional[Run]) -> Dict[str, Any]:
    import torch

    rec = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": world,
        "memory_peak_bytes": int(peak),
    }
    if run is not None and run.traces:
        rec["busy_s"] = run.mean_busy_s()
        rec["window_s"] = statistics.fmean(t["window_s"] for t in run.traces)
    return rec


def report(line: Dict[str, Any], compared: List[Compared]) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for x in compared:
        print(f"compared {x.name} {x.value!r} limit {x.limit!r} "
              f"{'ok' if x.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
