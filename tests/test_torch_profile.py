"""PyTorch port: `explain_analyze`, the persistent `WorkloadProfile`, the
cost-model residuals and profile portability (`lazy.py`,
`runtime/profiler.py`, `runtime/costmodel.py`), held to the JAX package on
the CPU.

Mirrors `tests/test_profile.py`'s `TestExplainAnalyze`,
`TestWorkloadProfile`, `TestResiduals` and `TestProfileReport`. Both
packages write the same profile schema: a profile the JAX package saved
loads in the port and gives the port's autotuner the same
`Recommendation`s as the JAX autotuner, and a profile the port saved
renders and diffs with the repository's `tools/profile_report.py`.
"""

import importlib.util
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.runtime import autotune as jat
from tensorframes_tpu.runtime import costmodel as jcost
from tensorframes_tpu.runtime import profiler as jprofiler
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.runtime import autotune as tat
from tensorframes_tpu_torch.runtime import costmodel as tcost
from tensorframes_tpu_torch.runtime import profiler as tprofiler
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import CPU, reset_port


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _frame(rows=4100, blocks=8):
    return tft.TensorFrame.from_dict({"x": np.arange(rows, dtype=np.float32)}, num_blocks=blocks)


def _lazy_chain(df, ex, scale=3.0):
    return df.lazy(device=CPU).map_blocks(
        (tft.block(df, "x") * scale + 1.0).named("y"), executor=ex
    )


def _run_reduce(lf, ex):
    return lf.reduce_blocks(
        tft.dsl.reduce_sum(tft.block(lf, "y", tf_name="y_input"), axes=[0]).named("y"),
        executor=ex, device=CPU,
    )


# ---------------------------------------------------------------------------
# explain_analyze
# ---------------------------------------------------------------------------


class TestExplainAnalyze:
    def test_chained_lazy_acceptance(self):
        # enough rows that the dispatches, not the host planning between
        # them, fill the window
        ex = Executor()
        lf = _lazy_chain(_frame(rows=(1 << 23) + 4, blocks=8), ex)
        rep = tft.explain_analyze(lambda: _run_reduce(lf, ex), format="json")
        assert rep["coverage"] >= 0.95, rep
        assert rep["wall_s"] > 0 and rep["spans"] > 0
        cached = {str(k[1]) for k in ex.cache_keys()}
        assert len(cached) == 2
        progs = {p["program"]: p for p in rep["programs"]}
        for fp in cached:
            p = progs[fp]
            assert p["dispatches"] > 0
            assert p["modeled_flops_per_exec"] is not None, fp
            assert p["modeled_bytes_per_exec"] is not None, fp
            assert p["achieved_flops_s"] is not None, fp
            assert p["residual_ratio"] is not None, fp
        fused = max(rep["programs"], key=lambda p: p["dispatches"])
        # 2^23 + 4 rows in 8 blocks: four blocks one row longer; no padding
        assert fused["dispatches"] == 8 and fused["rows"] == (1 << 23) + 4
        assert fused["pad_rows"] == 0
        assert fused["bucket_rungs"] == [1 << 20, (1 << 20) + 1]

    def test_json_keys_equal_jax(self):
        ex = Executor()
        lf = _lazy_chain(_frame(rows=512, blocks=4), ex)
        rep = tft.explain_analyze(lambda: _run_reduce(lf, ex), format="json")
        jdf = tfs.TensorFrame.from_dict({"x": np.arange(512, dtype=np.float32)}, num_blocks=4)
        jlf = jdf.lazy().map_blocks((tfs.block(jdf, "x") * 3.0 + 1.0).named("y"))
        jrep = tfs.explain_analyze(
            lambda: jlf.reduce_blocks(
                tfs.dsl.reduce_sum(tfs.block(jlf, "y", tf_name="y_input"), axes=[0]).named("y")
            ),
            format="json",
        )
        assert set(rep) == set(jrep)
        assert set(rep["programs"][0]) == set(jrep["programs"][0])
        assert set(rep["stages"][0]) == set(jrep["stages"][0])

    def test_text_rendering(self):
        ex = Executor()
        lf = _lazy_chain(_frame(rows=1024, blocks=4), ex)
        text = tft.explain_analyze(lambda: _run_reduce(lf, ex))
        assert "explain_analyze:" in text and "observed stages" in text
        assert "modeled" in text and "achieved" in text

    def test_lazy_frame_input_forces_fresh(self):
        ex = Executor()
        lf = _lazy_chain(_frame(rows=512, blocks=4), ex)
        lf.force()  # memoized: explain_analyze must still measure a run
        rep = tft.explain_analyze(lf, format="json")
        assert any(p["dispatches"] > 0 for p in rep["programs"]), rep
        assert rep["plan"]["stages"][0]["verb"] == "map_blocks"
        assert rep["plan"]["outputs"] == ["y"]

    def test_relational_frame_input(self):
        df = _frame(rows=256, blocks=2)
        rel = df.lazy(device=CPU).filter(tft.col("x") > 100.0)
        rep = tft.explain_analyze(rel, format="json")
        assert rep["wall_s"] > 0 and rep["plan"] is None
        assert any(s["name"] == "explain_analyze.sync" for s in rep["stages"])

    def test_rejects_bad_inputs(self):
        df = _frame(rows=64, blocks=2)
        lf = _lazy_chain(df, Executor())
        with pytest.raises(TypeError, match="LazyPlan"):
            tft.explain_analyze(lf.plan())
        with pytest.raises(TypeError, match="LazyFrame or a callable"):
            tft.explain_analyze(df)
        with pytest.raises(ValueError, match="format"):
            tft.explain_analyze(lf, format="yaml")

    def test_requires_telemetry(self):
        lf = _lazy_chain(_frame(rows=64, blocks=2), Executor())
        with tconfig.override(telemetry=False):
            with pytest.raises(RuntimeError, match="telemetry"):
                tft.explain_analyze(lf)


# ---------------------------------------------------------------------------
# WorkloadProfile
# ---------------------------------------------------------------------------


class TestWorkloadProfile:
    def test_save_load_round_trip_exact(self, tmp_path):
        ex = Executor()
        _run_reduce(_lazy_chain(_frame(), ex), ex)
        p1 = tprofiler.snapshot(note="run-1")
        path = str(tmp_path / "prof.json")
        p1.save(path)
        p2 = tprofiler.load(path)
        assert p2.to_dict() == json.loads(json.dumps(p1.to_dict()))
        assert p2.meta["note"] == "run-1" and p2.programs
        assert p2.meta["device_kind"] == "cpu"

    def test_sections_equal_jax(self):
        ex = Executor()
        _run_reduce(_lazy_chain(_frame(rows=512, blocks=4), ex), ex)
        jdf = tfs.TensorFrame.from_dict({"x": np.arange(512, dtype=np.float32)}, num_blocks=4)
        tfs.map_blocks((tfs.block(jdf, "x") * 3.0).named("y"), jdf)
        port, ref = tprofiler.snapshot().to_dict(), jprofiler.snapshot().to_dict()
        assert set(port) == set(ref)
        for key in ("verbs", "programs", "bucketing", "serving", "admission", "residuals"):
            assert "error" not in port[key], (key, port[key])
        assert set(port["residuals"]) == set(ref["residuals"])
        assert set(port["autotune"]) == set(ref["autotune"])
        fp = next(iter(port["programs"]))
        assert set(port["programs"][fp]) == set(next(iter(ref["programs"].values())))
        assert port["verbs"]["reduce_blocks"]["calls"] == 1

    def test_rerun_diff_zero_structural_drift(self, tmp_path):
        ex = Executor()
        df = _frame()
        _run_reduce(_lazy_chain(df, ex, scale=7.25), ex)
        p1 = tprofiler.snapshot(note="run-1")
        path = str(tmp_path / "prof1.json")
        p1.save(path)
        ttele.reset()
        tcost.reset()
        _run_reduce(_lazy_chain(df, ex, scale=7.25), ex)
        p2 = tprofiler.snapshot(note="run-2")
        d = tprofiler.load(path).diff(p2)
        assert d["structural"] == [] and not d["structural_drift"]
        assert d["timing"]
        assert set(p1.programs) == set(p2.programs)
        for fp in p1.programs:
            assert p1.programs[fp]["rungs"] == p2.programs[fp]["rungs"]

    def test_diff_reports_structural_drift(self):
        ex = Executor()
        _lazy_chain(_frame(rows=512, blocks=2), ex).force()
        p1 = tprofiler.snapshot()
        ttele.reset()
        tcost.reset()
        ex2 = Executor()
        _lazy_chain(_frame(rows=300, blocks=3), ex2, scale=5.0).force()
        d = p1.diff(tprofiler.snapshot())
        assert d["structural_drift"] and any("program" in s for s in d["structural"])

    def test_merge_sums_counters_and_hists(self):
        ex = Executor()
        _lazy_chain(_frame(rows=512, blocks=4), ex).force()
        p = tprofiler.snapshot()
        m = p.merge(p)
        assert p.verbs
        for verb, v in p.verbs.items():
            assert m.verbs[verb]["calls"] == 2 * v["calls"]
            assert m.verbs[verb]["latency"]["count"] == 2 * v["latency"]["count"]
        for fp in p.programs:
            assert m.programs[fp]["execs"] == 2 * p.programs[fp]["execs"]
            assert m.programs[fp]["rungs"] == p.programs[fp]["rungs"]

    def test_merge_refuses_mismatched_buckets(self):
        _lazy_chain(_frame(rows=512, blocks=4), Executor()).force()
        p1 = tprofiler.snapshot()
        ttele.reset()
        with tconfig.override(histogram_buckets={"seconds": [0.5, 1.0, 2.0]}):
            _lazy_chain(_frame(rows=512, blocks=4), Executor()).force()
            p2 = tprofiler.snapshot()
        with pytest.raises(ValueError, match="bucket"):
            p1.merge(p2)

    def test_schema_version_checked(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"schema": 999}))
        with pytest.raises(ValueError, match="schema"):
            tprofiler.load(str(path))

    def test_serving_ingest_admission_sections(self):
        ttele.counter_inc("serve_requests", 5.0, endpoint="ep1")
        ttele.counter_inc("serve_batches", 2.0, endpoint="ep1")
        ttele.counter_inc("serve_shed", 1.0, endpoint="ep1")
        ttele.counter_inc("ingest_chunks", 4.0, stage="decode")
        ttele.counter_inc("ingest_stage_busy_seconds", 0.5, stage="decode")
        ttele.counter_inc("ingest_stage_wait_seconds", 0.25, stage="decode")
        ttele.counter_inc("deadline_exceeded", 2.0, verb="map_blocks")
        p = tprofiler.snapshot().to_dict()
        assert p["serving"]["endpoints"]["ep1"] == {"requests": 5, "batches": 2, "shed": 1}
        assert p["ingest"]["decode"]["busy_s"] == pytest.approx(0.5)
        assert p["ingest"]["decode"]["wait_s"] == pytest.approx(0.25)
        assert p["admission"]["deadline_exceeded"]["map_blocks"] == 2

    def test_profile_route(self):
        _lazy_chain(_frame(rows=512, blocks=4), Executor()).force()
        srv = ttele.serve(port=0)
        try:
            with urllib.request.urlopen(f"{srv.url}/profile", timeout=10) as r:
                assert r.status == 200
                body = json.loads(r.read())
        finally:
            srv.close()
        assert body["schema"] == tprofiler.PROFILE_SCHEMA and body["programs"]
        assert "verbs" in body and "bucketing" in body


class TestCrossPackageProfiles:
    def _jax_workload_profile(self, tmp_path):
        """A JAX run whose ladder and serving sections give the autotuner
        something to move: clustered blocks just above a growth-2 rung."""
        df = tfs.TensorFrame.from_dict(
            {"x": np.arange(20 * 1100, dtype=np.float32)}, num_blocks=20
        )
        for _ in range(2):
            tfs.map_blocks((tfs.block(df, "x") * 2.0).named("y"), df)
        path = str(tmp_path / "jax_profile.json")
        jprofiler.snapshot(note="saved by jax").save(path)
        return path

    def test_jax_saved_profile_loads_and_recommends_the_same(self, tmp_path):
        path = self._jax_workload_profile(tmp_path)
        prof = tprofiler.load(path)
        assert prof.meta["note"] == "saved by jax" and prof.programs
        knobs = {
            "shape_bucket_growth": 2.0, "shape_bucket_min": 8,
            "ingest_decode_workers": 1, "stream_prefetch_depth": 1,
            "serve_batch_window_ms": 5.0, "serve_default_timeout_s": 30.0,
            "max_concurrent_verbs": 0, "endpoint_windows": {},
        }
        got = [r.to_dict() for r in tat.recommend(prof, knobs=knobs)]
        want = [r.to_dict() for r in jat.recommend(jprofiler.load(path), knobs=knobs)]
        assert got == want
        assert any(r["knob"] == "shape_bucket_growth" for r in got)
        # and as Recommendation objects
        assert [tat.Recommendation(**r) for r in got] == [
            tat.Recommendation(**r) for r in want
        ]

    def test_port_saved_profile_loads_in_jax(self, tmp_path):
        ex = Executor()
        _run_reduce(_lazy_chain(_frame(rows=1025, blocks=4), ex), ex)
        path = str(tmp_path / "port_profile.json")
        tprofiler.snapshot(note="saved by the port").save(path)
        jp = jprofiler.load(path)
        assert jp.meta["note"] == "saved by the port"
        assert not jp.diff(jp)["structural_drift"]
        assert set(jp.programs) == set(tprofiler.load(path).programs)


# ---------------------------------------------------------------------------
# cost-model residuals
# ---------------------------------------------------------------------------


def _fake_dispatch(fp, rows, seconds, n=1):
    """A dispatched program without a verb: a ledger entry by `note_exec`
    plus already-timed dispatch spans, the residual join's two inputs."""
    args = [torch.zeros((rows, 8), dtype=torch.float32)]
    out = [torch.zeros((rows, 8), dtype=torch.float32)]
    for i in range(n):
        tcost.note_exec(("block", fp), args, out)
        ttele.add_event(
            f"fake.{fp}", "dispatch", 100.0 + i, 100.0 + i + seconds, program=fp, rows=rows,
        )


class TestResiduals:
    def test_relative_residual_fit(self):
        _fake_dispatch("prog_a", 512, 0.010, n=4)
        _fake_dispatch("prog_b", 512, 0.090, n=4)
        res = tcost.residuals()
        assert res["fit"]["bytes_per_s"] is not None
        ra = res["programs"]["prog_a"]["residual_ratio"]
        rb = res["programs"]["prog_b"]["residual_ratio"]
        assert ra < 1.0 < rb
        assert rb / ra == pytest.approx(9.0, rel=0.05)

    def test_same_residuals_as_jax(self):
        for cm, tele, arr in (
            (tcost, ttele, lambda: torch.zeros((512, 8), dtype=torch.float32)),
            (jcost, jtele, lambda: np.zeros((512, 8), dtype=np.float32)),
        ):
            for fp, secs in (("prog_a", 0.010), ("prog_b", 0.090)):
                for i in range(4):
                    cm.note_exec(("block", fp), [arr()], [arr()])
                    tele.add_event(f"fake.{fp}", "dispatch", 100.0 + i, 100.0 + i + secs,
                                   program=fp, rows=512)
        got, want = tcost.residuals(), jcost.residuals()
        for fp in ("prog_a", "prog_b"):
            assert got["programs"][fp]["residual_ratio"] == pytest.approx(
                want["programs"][fp]["residual_ratio"], rel=1e-9
            )
        assert got["fit"]["bytes_per_s"] == pytest.approx(want["fit"]["bytes_per_s"], rel=1e-9)
        jtele.reset()
        jcost.reset()

    def test_flagging_threshold(self):
        _fake_dispatch("prog_a", 512, 0.010, n=4)
        _fake_dispatch("prog_b", 512, 0.090, n=4)
        with tconfig.override(cost_residual_warn_ratio=2.0):
            res = tcost.residuals()
            assert res["programs"]["prog_a"]["flagged"]
            assert not res["programs"]["prog_b"]["flagged"]
        with tconfig.override(cost_residual_warn_ratio=0.0):
            assert not any(p["flagged"] for p in tcost.residuals()["programs"].values())

    def test_diagnostics_accuracy_section(self):
        _fake_dispatch("prog_a", 512, 0.010, n=4)
        _fake_dispatch("prog_b", 512, 0.090, n=4)
        with tconfig.override(cost_residual_warn_ratio=2.0):
            assert tft.diagnostics(format="json")["accuracy"]["programs"]["prog_a"]["flagged"]
            text = tft.diagnostics()
        assert "cost-model accuracy" in text and "MODEL MISPRICES" in text

    def test_real_chain_residuals_present(self):
        ex = Executor()
        _run_reduce(_lazy_chain(_frame(), ex), ex)
        res = tcost.residuals()
        assert res["fit"]["groups"] > 0
        assert any(p["residual_ratio"] is not None for p in res["programs"].values())
        assert res["by_class"]["reduce"]["bytes_per_s"] > 0

    def test_planner_and_materialize_read_the_fit(self):
        from tensorframes_tpu_torch.graph.optimizer import Estimator

        assert tcost.planner_throughput("map") is None
        assert Estimator().throughput("map") == 2.0e9  # the cold start
        df = _frame(rows=1024, blocks=4)
        z = (tft.block(df, "x") + 4.0).named("z")
        tft.map_blocks(z, df, device=CPU)
        fit = tcost.residuals()["by_class"]["map"]["bytes_per_s"]
        assert fit > 0
        assert tcost.planner_throughput("map") == pytest.approx(fit)
        assert Estimator().throughput("map") == pytest.approx(fit)
        # one execution's modeled bytes (x + 4 over 256 rows) over the fit
        fp = tft.dsl.build(z)[0].fingerprint()
        whole_fit = tcost.residuals()["fit"]["bytes_per_s"]
        assert tcost.modeled_recompute_s(fp) == pytest.approx(2 * 256 * 4 / whole_fit)

    def test_costmodel_residual_prometheus_family(self):
        _fake_dispatch("prog_a", 512, 0.010, n=4)
        _fake_dispatch('we"ird\\prog\n', 512, 0.030, n=4)
        lines = ttele.export_prometheus().splitlines()
        idx = [i for i, ln in enumerate(lines) if ln.startswith("tfs_costmodel_residual{")]
        assert idx
        help_i = lines.index(
            "# HELP tfs_costmodel_residual "
            "Span-achieved vs cost-model-predicted time ratio per program"
        )
        type_i = lines.index("# TYPE tfs_costmodel_residual gauge")
        assert help_i < type_i < idx[0]
        assert any('program="we\\"ird\\\\prog\\n"' in ln for ln in lines)


# ---------------------------------------------------------------------------
# the profile report tool on a profile the port saved
# ---------------------------------------------------------------------------


class TestProfileReport:
    def _tool(self):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            "profile_report", os.path.join(root, "tools", "profile_report.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def _saved(self, tmp_path, name="p.json", rows=1025, blocks=4, scale=3.0):
        ex = Executor()
        _run_reduce(_lazy_chain(_frame(rows=rows, blocks=blocks), ex, scale=scale), ex)
        path = str(tmp_path / name)
        tprofiler.snapshot(note="report-test").save(path)
        return path

    def test_render(self, tmp_path, capsys):
        assert self._tool().main([self._saved(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "workload profile" in out and "programs (cost ledger):" in out
        assert "verbs:" in out

    def test_json_mode(self, tmp_path, capsys):
        assert self._tool().main([self._saved(tmp_path), "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["schema"] == tprofiler.PROFILE_SCHEMA

    def test_self_diff_clean(self, tmp_path, capsys):
        path = self._saved(tmp_path)
        assert self._tool().main([path, "--diff", path, "--fail-on-drift"]) == 0
        assert "structural drift: none" in capsys.readouterr().out

    def test_drift_exit_code(self, tmp_path, capsys):
        tool = self._tool()
        a = self._saved(tmp_path, "a.json")
        ttele.reset()
        tcost.reset()
        b = self._saved(tmp_path, "b.json", rows=300, blocks=3, scale=5.0)
        assert tool.main([a, "--diff", b]) == 0
        assert tool.main([a, "--diff", b, "--fail-on-drift"]) == 2
        assert "STRUCTURAL DRIFT" in capsys.readouterr().out
