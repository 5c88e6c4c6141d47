"""PyTorch port: the program cost ledger, OOM forensics and the telemetry
endpoint's runtime routes (`runtime/costmodel.py`, `runtime/executor.py`,
`utils/telemetry.py`, `utils/telemetry_http.py`), held to the JAX package
on the CPU.

Mirrors `tests/test_observability.py`'s `TestCostLedger`,
`TestOomForensics` and `TestEndpoint`. The port counts flops on the meta
device by its stated convention (`runtime.costmodel`'s docstring); on
matmul and elementwise programs — ``x * 3``, ``tanh(a @ w)``, ``relu(a @ w
+ b)`` and the MLP scoring graph at block and row level — the flops equal
the JAX ledger's (XLA's cost analysis), with the JAX package's shape
bucketing off so both count the same rows. Bytes are held to a hand count.

Program kinds that end at ``None`` (flops and bytes unknown): a program
whose graph holds `_Cond`/`_While` (the lifted-rows and per-row plans of a
control-flow graph, a block graph with a scalar cond or loop: their work
depends on the data), and one whose meta replay raises. The block, reduce,
combine, fused-lazy, vmapped-rows and vmapped-aggregate programs always
carry numbers.

On the CPU `costmodel.memory_overview()` reports no rows: it lists CUDA
devices only, and torch keeps no allocator statistics for host memory.
"""

import json
import logging
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.runtime import costmodel as jcost
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.runtime import costmodel as tcost
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.testing import faults as tchaos
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import CPU, host, reset_port


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _frame(rows=4096, blocks=8):
    return tft.TensorFrame.from_dict({"x": np.arange(rows, dtype=np.float32)}, num_blocks=blocks)


def _chained_lazy(df, executor=None):
    lf = df.lazy(device=CPU).map_blocks(
        (tft.block(df, "x") * 2.0 + 1.0).named("y"), executor=executor
    )
    return lf.reduce_blocks(
        tft.dsl.reduce_sum(tft.block(lf, "y", tf_name="y_input"), axes=[0]).named("y"),
        executor=executor, device=CPU,
    )


def _flops_by_program(cm):
    return {fp: c["flops_per_exec"] for fp, c in cm.program_costs().items()}


# ---------------------------------------------------------------------------
# the cost ledger
# ---------------------------------------------------------------------------


class TestCostLedger:
    def test_chained_lazy_reports_cost_for_every_program(self):
        # enough rows that the dispatches, not the host planning between
        # them, fill the window
        ex = Executor()
        df = _frame(rows=1 << 23, blocks=8)
        out = _chained_lazy(df, executor=ex)
        want = float((np.arange(1 << 23, dtype=np.float64) * 2.0 + 1.0).sum())
        assert float(out) == pytest.approx(want, rel=1e-5)
        diag = tft.diagnostics(ex, format="json")
        assert diag["window"]["coverage"] >= 0.95, diag["window"]
        cached_fps = {str(k[1]) for k in ex.cache_keys()}
        assert len(cached_fps) == 2  # the fused block program, the combine
        rows = {r["program"]: r for r in diag["cost"]["programs"]}
        for fp in cached_fps:
            r = rows[fp]
            assert r["execs"] > 0
            assert r["flops_per_exec"] is not None, fp
            assert r["bytes_per_exec"] is not None, fp
            assert r["footprint_bytes"], fp
            assert r["achieved_flops_s"] is not None
            assert r["achieved_hbm_bytes_s"] is not None
            # the CPU has no datasheet peak
            assert r["flops_frac_of_peak"] is None and r["hbm_frac_of_peak"] is None
        assert "cost ledger" in tft.diagnostics(ex)

    def test_chained_lazy_flops_equal_jax(self):
        """The fused map+reduce program and the combine count the same
        flops in both packages (x*2+1 then a sum: 3*512-1 per block of 512
        rows; 7 for the combine of 8 partials)."""
        x = np.arange(4096, dtype=np.float32)
        tdf = tft.TensorFrame.from_dict({"x": x}, num_blocks=8)
        _chained_lazy(tdf)
        jdf = tfs.TensorFrame.from_dict({"x": x}, num_blocks=8)
        with jconfig.override(shape_bucketing=False):
            jlf = jdf.lazy().map_blocks((tfs.block(jdf, "x") * 2.0 + 1.0).named("y"))
            jlf.reduce_blocks(
                tfs.dsl.reduce_sum(tfs.block(jlf, "y", tf_name="y_input"), axes=[0]).named("y")
            )
        assert sorted(_flops_by_program(tcost).values()) == [7.0, 3 * 512 - 1.0]
        assert sorted(_flops_by_program(tcost).values()) == sorted(
            v for v in _flops_by_program(jcost).values() if v is not None
        )

    def test_exec_counts_are_exact(self):
        df = _frame(rows=512, blocks=4)
        z = (tft.block(df, "x") * 3.0).named("y")
        tft.map_blocks(z, df, device=CPU)
        before = {fp: c["execs"] for fp, c in tcost.program_costs().items()}
        tft.map_blocks(z, df, device=CPU)
        after = tcost.program_costs()
        grew = {
            fp: after[fp]["execs"] - before.get(fp, 0)
            for fp in after if after[fp]["execs"] != before.get(fp, 0)
        }
        assert sum(grew.values()) == 4, grew

    def test_uneven_blocks_count_per_shape(self):
        df = tft.TensorFrame([tft.Column("x", torch.arange(10.0, dtype=torch.float64))], [0, 3, 6, 10])
        tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU)
        shapes = next(iter(tcost.program_shapes().values()))
        assert sorted((e["rows"], e["execs"], e["flops"]) for e in shapes) == [
            (3, 2, 3.0), (4, 1, 4.0)
        ]
        c = next(iter(tcost.program_costs().values()))
        assert c["execs"] == 3 and c["total_flops"] == 10.0 and c["shapes"] == 2

    def test_verb_peak_high_water(self):
        df = _frame(rows=2048, blocks=4)
        tft.map_blocks((tft.block(df, "x") * 2.0).named("y"), df, device=CPU)
        pk = tcost.verb_peaks()["map_blocks"]
        assert pk["bytes"] == 2 * 512 * 4 and pk["program"] and pk["rows"] == 512

    def test_disabled_ledger_captures_nothing(self):
        df = _frame(rows=256, blocks=2)
        with tconfig.override(cost_ledger=False):
            tft.map_blocks((tft.block(df, "x") + 7.0).named("y"), df, device=CPU)
            assert tcost.program_costs() == {}

    def test_deep_capture_fills_temp_bytes(self):
        df = _frame(rows=333, blocks=1)
        x = tft.block(df, "x")
        with tconfig.override(cost_ledger_memory=True):
            tft.map_blocks(((x * 7.125 + 1.0) * x).named("y"), df, device=CPU)
        (c,) = tcost.program_costs().values()
        assert c["temp_known"]
        # two intermediates of 333 float32 live at the peak, the output apart
        assert tcost.program_shapes()[next(iter(tcost.program_costs()))][0]["temp_bytes"] == 2 * 333 * 4
        assert c["footprint_bytes"] == 4 * 333 * 4

    def test_shallow_capture_leaves_temp_unknown(self):
        df = _frame(rows=64, blocks=1)
        tft.map_blocks((tft.block(df, "x") * 7.0).named("y"), df, device=CPU)
        (c,) = tcost.program_costs().values()
        assert not c["temp_known"]
        assert "(+temp?)" in tft.diagnostics()

    def test_roofline_fractions_with_known_peak(self, monkeypatch):
        df = _frame(rows=512, blocks=2)
        tft.map_blocks((tft.block(df, "x") * 0.5).named("y"), df, device=CPU)
        kind = tcost.device_peaks()["device_kind"]
        assert kind == "cpu"
        monkeypatch.setitem(tcost.DEVICE_PEAKS, kind, {"hbm_bytes_s": 1e9, "matmul_flops_s": 1e12})
        agg = ttele.span_aggregates()
        rows = [r for r in tcost.roofline(agg["by_program"]) if r["execs"]]
        assert rows
        for r in rows:
            assert r["flops_frac_of_peak"] > 0
            assert r["hbm_frac_of_peak"] > 0
            assert r["hbm_frac_of_peak"] == pytest.approx(r["achieved_hbm_bytes_s"] / 1e9)

    def test_h100_peaks_table(self):
        row = tcost.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
        assert row == {"hbm_bytes_s": 3.35e12, "matmul_flops_s": 67e12}
        assert tcost.device_peaks("cpu") == {
            "device_kind": "cpu", "hbm_bytes_s": None, "matmul_flops_s": None,
        }

    def test_memory_overview_on_the_cpu(self):
        """One row per CUDA device; the CPU has none (see the module
        docstring). The JAX package lists its CPU device without
        statistics."""
        assert not torch.cuda.is_available()
        assert tcost.memory_overview() == []
        jrows = jcost.memory_overview()
        assert jrows and all(re.match(r"^\w+:\d+$", r["device"]) for r in jrows)
        assert set(jrows[0]) >= {"device", "device_kind", "live_buffer_bytes",
                                 "live_buffers", "bytes_in_use", "peak_bytes_in_use"}

    def test_device_memory_gauges_registered(self):
        fams = ttele._registry._gauge_multi_fns
        for name in ("live_buffer_bytes", "device_bytes_in_use", "device_peak_bytes",
                     "costmodel_residual"):
            assert name in fams, name
        # no CUDA device: the families export no rows
        assert "tfs_live_buffer_bytes{" not in ttele.export_prometheus()

    def test_capture_neither_lowers_nor_caches(self):
        ex = Executor()
        df = _frame(rows=96, blocks=3)
        tft.map_blocks((tft.block(df, "x") - 1.0).named("y"), df, device=CPU, executor=ex)
        tft.map_blocks((tft.block(df, "x") - 1.0).named("y"), df, device=CPU, executor=ex)
        assert ex.compile_count == 1 and len(ex.cache_keys()) == 1
        assert ex.cache_misses == 1 and ex.cache_hits == 1
        assert ex.program_shape_compiles() == {ex.cache_keys()[0]: 1}

    def test_shape_storm_warns_once(self, caplog):
        ex = Executor()
        # the package logger does not propagate to the root logger
        log = logging.getLogger("tensorframes_tpu_torch.executor")
        log.addHandler(caplog.handler)
        try:
            with tconfig.override(recompile_warn_shapes=2):
                for n in (4, 5, 6, 7):
                    df = tft.TensorFrame.from_dict({"x": np.arange(float(n))})
                    z = (tft.block(df, "x") + 2.0).named("y")
                    tft.map_blocks(z, df, device=CPU, executor=ex)
                d = tft.diagnostics(ex, format="json")
        finally:
            log.removeHandler(caplog.handler)
        storms = [r for r in caplog.records if "shape storm" in r.getMessage()]
        assert len(storms) == 1
        assert d["recompile"]["threshold"] == 2 and d["recompile"]["worst"] == 4
        assert len(d["recompile"]["storming"]) == 1

    def test_transcendentals_counted_apart(self):
        df = _frame(rows=100, blocks=1)
        tft.map_blocks(tft.dsl.tanh(tft.block(df, "x")).named("y"), df, device=CPU)
        ((kind, sig),) = [
            k for p in tcost._programs.values() for k in p["shapes"]
        ]
        ent = next(iter(tcost._programs.values()))["shapes"][(kind, sig)]
        assert ent["flops"] == 0.0 and ent["transcendentals"] == 100.0


# ---------------------------------------------------------------------------
# the counting conventions against JAX and a hand count
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_A = _RNG.standard_normal((200, 64)).astype(np.float32)
_W = (_RNG.standard_normal((64, 48)) * 0.1).astype(np.float32)
_B = _RNG.standard_normal(48).astype(np.float32)
_SIZES = [16, 32, 32, 4]
_PARAMS = [
    ((_RNG.standard_normal((a, b)) * 0.1).astype(np.float32), (_RNG.standard_normal(b) * 0.1).astype(np.float32))
    for a, b in zip(_SIZES[:-1], _SIZES[1:])
]
_FEATS = _RNG.standard_normal((256, 16)).astype(np.float32)


def _program(pkg, case):
    """``(frame, fetch, verb)`` of one counting case in ``pkg``."""
    if case == "x*3":
        df = pkg.TensorFrame.from_dict({"x": np.arange(1000, dtype=np.float32)})
        return df, (pkg.block(df, "x") * 3.0).named("z"), pkg.map_blocks
    if case in ("tanh(a@w)", "relu(a@w+b)"):
        df = pkg.TensorFrame.from_dict({"a": _A})
        h = pkg.dsl.matmul(pkg.block(df, "a"), pkg.dsl.constant(_W))
        if case == "tanh(a@w)":
            return df, pkg.dsl.tanh(h).named("z"), pkg.map_blocks
        h = pkg.dsl._nary("BiasAdd", [h, pkg.dsl.constant(_B)])
        return df, pkg.dsl.relu(h).named("z"), pkg.map_blocks
    block = case == "mlp-block"
    if pkg is tft:
        model = tft.models.MLP.from_jax_params(_PARAMS, device=CPU)
    else:
        import jax.numpy as jnp

        from tensorframes_tpu.models import MLP

        model = MLP(_SIZES)
        model.params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in _PARAMS]
    df = pkg.TensorFrame.from_dict({"features": _FEATS})
    return df, model.scoring_graph("features", block=block), (
        pkg.map_blocks if block else pkg.map_rows
    )


class TestCountingConventions:
    @pytest.mark.parametrize(
        "case", ["x*3", "tanh(a@w)", "relu(a@w+b)", "mlp-block", "mlp-rows"]
    )
    def test_flops_equal_jax(self, case):
        df, fetch, verb = _program(tft, case)
        verb(fetch, df, device=CPU)
        jdf, jfetch, jverb = _program(tfs, case)
        with jconfig.override(shape_bucketing=False):
            jverb(jfetch, jdf)
        got = list(_flops_by_program(tcost).values())
        want = list(_flops_by_program(jcost).values())
        assert len(got) == len(want) == 1
        assert got == want

    def test_x_times_3_bytes_are_operand_plus_result(self):
        df, fetch, verb = _program(tft, "x*3")
        verb(fetch, df, device=CPU)
        (c,) = tcost.program_costs().values()
        # the scalar 3.0 counts 0 bytes; XLA's count is 16,004
        assert c["bytes_per_exec"] == 2 * 4 * 1000
        assert c["flops_per_exec"] == 1000

    def test_matmul_bytes_hand_count(self):
        df, fetch, verb = _program(tft, "relu(a@w+b)")
        verb(fetch, df, device=CPU)
        (c,) = tcost.program_costs().values()
        m, k, n = 200, 64, 48
        mm = 4 * (m * k + k * n + m * n)
        bias = 4 * (m * n + n + m * n)
        relu = 4 * (m * n + m * n)
        assert c["bytes_per_exec"] == mm + bias + relu
        assert c["flops_per_exec"] == 2 * m * k * n + m * n + m * n

    def test_sum_is_n_minus_1(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(512.0)})
        g = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
        tft.reduce_blocks(g, df, device=CPU)
        assert list(_flops_by_program(tcost).values()) == [511.0]

    def test_program_kinds_with_numbers(self):
        """block, reduce, reduce-combine, fused-lazy, vmap-rows and
        vmap-agg programs all carry flops and bytes."""
        df = tft.TensorFrame.from_dict(
            {"x": np.arange(64.0), "k": np.arange(64) % 4}, num_blocks=4
        )
        ex = Executor()
        tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU, executor=ex)
        tft.reduce_blocks(
            tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x"),
            df, device=CPU, executor=ex,
        )
        tft.map_rows((tft.row(df, "x") * 2.0).named("y"), df, device=CPU, executor=ex)
        _chained_lazy(df, executor=ex)
        xin = tft.block(df, "x", tf_name="x_input")
        spread = (tft.dsl.reduce_max(xin, axes=[0]) - tft.dsl.reduce_min(xin, axes=[0])).named("x")
        tft.aggregate(spread, tft.group_by(df, "k"), device=CPU, executor=ex)
        kinds = {k[0] for k in ex.cache_keys()}
        assert kinds == {"block", "vmap-rows", "reduce-combine", "vmap-agg"}
        costs = tcost.program_costs()
        for key in ex.cache_keys():
            c = costs[str(key[1])]
            assert c["flops_per_exec"] is not None and c["bytes_per_exec"] is not None, key

    def test_control_flow_programs_end_at_none(self):
        """The lifted-rows program of a per-row cond, and a block graph with
        a scalar cond: their work depends on the data, so the ledger keeps
        None (their executions are still counted)."""
        from test_torch_vectorize import _branchy_bytes

        x = np.linspace(-2.0, 2.0, 16).astype(np.float32)
        df = tft.TensorFrame.from_dict({"x": x}, num_blocks=2)
        ex = Executor()
        tft.map_rows(_branchy_bytes(), df, fetch_names=["out", "trips"], device=CPU, executor=ex)
        (key,) = ex.cache_keys()
        assert key[0] == "lifted-rows"
        c = tcost.program_costs()[str(key[1])]
        assert c["execs"] == 2
        assert c["flops_per_exec"] is None and c["bytes_per_exec"] is None
        assert c["footprint_bytes"]  # argument and output bytes are exact


# ---------------------------------------------------------------------------
# dispatch spans: execute seconds from CUDA events
# ---------------------------------------------------------------------------


class _FakeEvent:
    def __init__(self, ms=0.0, ready=True):
        self.ms, self.ready = ms, ready

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True

    def elapsed_time(self, other):
        return other.ms - self.ms


class TestDispatchEvents:
    def _timed(self, spans, ms0, ms1, ready=True):
        t = ttele._Timing(_FakeEvent(ms0))
        t.ev1 = _FakeEvent(ms1, ready=ready)
        for sp in spans:
            t.spans.append(sp)
            sp.events = t
        return t

    def test_exec_seconds_read_the_events_lazily(self):
        s = ttele.Span(1, None, "d", "dispatch", 0.0, 1.0, 0, {})
        self._timed([s], 0.0, 2.5, ready=False)
        assert ttele.exec_seconds(s) == 1.0  # pending: the host span
        assert s.events is not None
        assert ttele.exec_seconds(s, wait=True) == pytest.approx(0.0025)
        assert s.events is None and s.attrs["device_s"] == pytest.approx(0.0025)
        assert ttele.exec_seconds(s) == pytest.approx(0.0025)
        assert len(ttele._event_pool) == 2  # the resolved pair is reused

    def test_a_run_splits_its_time_by_rows(self):
        a = ttele.Span(1, None, "b", "dispatch", 0.0, 0.5, 0, {"rows": 100})
        b = ttele.Span(2, None, "b", "dispatch", 0.5, 0.6, 0, {"rows": 300})
        self._timed([a, b], 0.0, 8.0)
        assert ttele.exec_seconds(b) == pytest.approx(0.006)
        assert a.events is None and a.attrs["device_s"] == pytest.approx(0.002)

    def test_an_open_run_reads_the_host_time(self):
        s = ttele.Span(1, None, "d", "dispatch", 0.0, 1.0, 0, {"rows": 4})
        t = ttele._Timing(_FakeEvent(0.0))
        t.spans.append(s)
        s.events = t
        assert ttele.exec_seconds(s, wait=True) == 1.0 and s.events is t

    def test_span_aggregates_use_device_seconds(self):
        s = ttele.Span(1, None, "map_blocks.block", "dispatch", 0.0, 0.001, 0,
                       {"program": "p", "rows": 8})
        self._timed([s], 0.0, 4.0)
        agg = ttele.span_aggregates([s])
        assert agg["by_program"]["p"]["execute_s"] == pytest.approx(0.004)

    def test_a_run_times_its_dispatches_with_one_pair(self, monkeypatch):
        """On a CUDA device a verb's block loop records two events in all
        (the first launch, the loop's end), not two a dispatch; a dispatch
        outside a run gets its own pair. Fake events stand in for CUDA's."""
        made = []

        class Ev:
            def __init__(self):
                self.ms = None
                made.append(self)

            def record(self, stream):
                self.ms = float(len(made))

            def query(self):
                return True

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return other.ms - self.ms

        monkeypatch.setattr(ttele, "_new_event", Ev)
        monkeypatch.setattr(ttele, "_current_stream", lambda device: "stream")
        cuda = torch.device("cuda")
        with ttele.dispatch_run(cuda):
            for rows in (100, 300):
                with ttele.dispatch_span("b", program="p", rows=rows, torch_device=cuda):
                    ttele.launching()
                    ttele.launching()  # a second program launch: no event
        assert len(made) == 2
        with ttele.dispatch_span("c", program="q", rows=5, torch_device=cuda):
            ttele.launching()
        assert len(made) == 4
        ttele.resolve_device_times()
        disp = [s for s in ttele.spans() if s.kind == "dispatch"]
        assert [s.attrs["device_s"] for s in disp] == pytest.approx([0.00025, 0.00075, 0.001])
        # no run and no launch inside a span: no event, the host span
        with ttele.dispatch_span("d", program="r", rows=1, torch_device=cuda):
            pass
        assert len(made) == 4 and ttele.spans()[-1].events is None

    def test_a_run_observes_block_rows_at_its_end(self, monkeypatch):
        """Inside a run the dispatch spans and their `block_rows`
        observations wait for the run's end and then all land, in dispatch
        order, each span the child of the span around the run; a finished
        span holds no reference to its run or to another dispatch."""
        monkeypatch.setattr(ttele, "_new_event", lambda: _FakeEvent())
        monkeypatch.setattr(_FakeEvent, "record", lambda self, stream: None, raising=False)
        monkeypatch.setattr(ttele, "_current_stream", lambda device: "stream")
        cuda = torch.device("cuda")

        def observed():
            h = ttele._registry.histogram_snapshot().get(("block_rows", ()))
            return 0 if h is None else h[3]

        with ttele.span("outer") as outer, ttele.dispatch_run(cuda):
            for rows in (100, 300, 5):
                with ttele.dispatch_span("b", program="p", rows=rows, torch_device=cuda):
                    ttele.launching()
            assert observed() == 0
            assert not [s for s in ttele.spans() if s.kind == "dispatch"]
        assert observed() == 3
        h = ttele._registry.histogram_snapshot()[("block_rows", ())]
        assert h[2] == pytest.approx(405.0)
        disp = [s for s in ttele.spans() if s.kind == "dispatch"]
        assert [s.attrs["rows"] for s in disp] == [100, 300, 5]
        assert all(s.parent_id == outer for s in disp)
        assert all(s.run is None and s.prev is None and s.timing is None for s in disp)

    def test_spans_inside_a_run_dispatch_parent_to_it(self):
        """A run's dispatch sets no contextvar, yet what opens inside it
        (a span, an already-timed event) is its child, and it is the
        current program and span until it ends."""
        with ttele.span("v", kind="verb") as v, ttele.dispatch_run(CPU):
            with ttele.dispatch_span("b", program="p", rows=4) as d:
                assert ttele.current_program() == "p"
                assert ttele.current_span_id() == d
                with ttele.span("inner") as i:
                    assert ttele.current_span_id() == i
                ttele.add_event("ev", "compile", 0.0, 1.0)
            assert ttele.current_program() is None
            assert ttele.current_span_id() == v
        by_id = {s.span_id: s for s in ttele.spans()}
        (ev,) = [s for s in by_id.values() if s.name == "ev"]
        assert by_id[d].parent_id == v and by_id[i].parent_id == d and ev.parent_id == d

    def test_cpu_dispatch_records_no_events(self):
        df = _frame(rows=32, blocks=2)
        tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU)
        disp = [s for s in ttele.spans() if s.kind == "dispatch"]
        assert len(disp) == 2 and all(s.events is None for s in disp)
        assert all(s.attrs["program"] and s.attrs["rows"] == 16 for s in disp)
        assert {s.attrs["block"] for s in disp} == {0, 1}

    def test_dispatch_spans_carry_the_verb(self):
        df = _frame(rows=32, blocks=2)
        tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU)
        by_id = {s.span_id: s for s in ttele.spans()}
        for s in ttele.spans():
            if s.kind == "dispatch":
                assert by_id[s.parent_id].name == "map_blocks"


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------


class TestOomForensics:
    def test_injected_resource_produces_snapshot(self):
        df = _frame(rows=2048, blocks=4)
        z = (tft.block(df, "x") * 2.0 + 1.0).named("y")
        ref = host(tft.map_blocks(z, df, device=CPU)["y"].values)
        with tchaos.inject(nth=[1], fault="resource") as plan:
            got = host(tft.map_blocks(z, df, device=CPU)["y"].values)
        assert plan.injected == 1
        np.testing.assert_array_equal(ref, got)
        from tensorframes_tpu_torch.utils.inspection import executor_stats

        fl = executor_stats()["faults"]
        assert fl["splits"] >= 1
        snap = fl["forensics"][0]
        assert snap["verb"] == "map_blocks" and snap["program"]
        assert snap["decision"].startswith("split:")
        assert snap["rows"] > 0 and snap["depth"] == 0
        assert snap["modeled"]["footprint_bytes"] > 0
        assert snap["devices"] == []  # no CUDA device on the CPU
        assert snap["error"].startswith("InjectedFault")
        assert "oom[map_blocks]" in tft.diagnostics()

    def test_depth_exhausted_records_reraise_decision(self):
        df = _frame(rows=1024, blocks=2)
        z = (tft.block(df, "x") + 1.0).named("y")
        tft.map_blocks(z, df, device=CPU)
        with tconfig.override(oom_split_depth=0):
            with tchaos.inject(nth=[0], fault="resource"):
                with pytest.raises(tchaos.InjectedFault):
                    tft.map_blocks(z, df, device=CPU)
        snaps = tfaults.forensics_snapshot()
        assert snaps and snaps[-1]["decision"] == "reraise:split-depth-exhausted"

    def test_escaping_oom_captures_an_incident(self, tmp_path):
        df = _frame(rows=64, blocks=1)
        z = (tft.block(df, "x") + 1.0).named("y")
        with tconfig.override(oom_split_depth=0, incident_dir=str(tmp_path)):
            with tchaos.inject(nth=[0], fault="resource"):
                with pytest.raises(tchaos.InjectedFault):
                    tft.map_blocks(z, df, device=CPU)
            rows = tft.incidents()
        assert any(r["trigger"] == "oom" for r in rows)


# ---------------------------------------------------------------------------
# diagnostics and the live endpoint
# ---------------------------------------------------------------------------


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=10) as r:
        return r.status, r.read().decode()


class TestEndpoint:
    def test_diagnostics_json_has_the_jax_sections(self):
        _chained_lazy(_frame(rows=256, blocks=2))
        d = tft.diagnostics(format="json")
        json.dumps(d)  # JSON-serializable
        jd = tfs.diagnostics(format="json")
        assert set(d) == set(jd)
        assert set(d["globalframe"]) == set(jd["globalframe"])
        assert d["health"] == [] and d["faults"]["splits"] == 0
        assert set(d["cost"]) == set(jd["cost"])
        with pytest.raises(ValueError, match="format"):
            tft.diagnostics(format="yaml")

    def test_routes(self):
        srv = ttele.serve(port=0)
        try:
            _chained_lazy(_frame(rows=1024, blocks=4))
            code, metrics = _get(srv.url, "/metrics")
            assert code == 200 and "# HELP" in metrics
            code, body = _get(srv.url, "/healthz")
            assert code == 200 and json.loads(body)["status"] == "ok"
            code, body = _get(srv.url, "/diagnostics")
            d = json.loads(body)
            assert code == 200 and d["window"]["spans"] > 0 and "cost" in d
            code, body = _get(srv.url, "/trace")
            assert code == 200 and json.loads(body)["traceEvents"]
            code, body = _get(srv.url, "/profile")
            p = json.loads(body)
            assert code == 200 and p["schema"] == 1 and p["programs"]
            assert p["meta"]["note"] == "telemetry_http:/profile"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.url, "/nope")
            assert ei.value.code == 404
        finally:
            srv.close()

    def test_diagnostics_and_profile_name_the_same_programs(self):
        srv = ttele.serve(port=0)
        try:
            _chained_lazy(_frame(rows=1024, blocks=4))
            d = json.loads(_get(srv.url, "/diagnostics")[1])
            p = json.loads(_get(srv.url, "/profile")[1])
        finally:
            srv.close()
        ledger = {r["program"] for r in d["cost"]["programs"] if r["execs"]}
        assert ledger == set(p["programs"])

    def test_concurrent_scrapes_during_a_run(self):
        srv = ttele.serve(port=0)
        errors = []
        stop = threading.Event()

        def scrape():
            while not stop.is_set():
                try:
                    for route in ("/metrics", "/diagnostics", "/profile"):
                        code, body = _get(srv.url, route)
                        assert code == 200 and body
                except Exception as e:  # noqa: BLE001 - collected for the assert
                    errors.append(e)
                    return

        threads = [threading.Thread(target=scrape) for _ in range(4)]
        try:
            for t in threads:
                t.start()
            df = _frame(rows=4096, blocks=16)
            for _ in range(5):
                _chained_lazy(df)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=20)
            srv.close()
        assert not errors, errors
        assert all(not t.is_alive() for t in threads)
