"""PyTorch port: the closed-loop autotuner and the config pin layer
(`runtime/autotune.py`, `config.py`), held to the JAX package on the CPU.

Mirrors `tests/test_autotune.py`: the pin layer (`set_tuned` refuses a
knob the operator set, `reset_tuning` restores defaults, `override` scopes
pins and tuned values), env seeding, each policy against the JAX
package's on the same synthetic profiles (equal `Recommendation`s),
determinism and hysteresis, `apply` (pins, clamps, spans, counters,
per-endpoint serving windows, the endpoint re-warm after a ladder change)
and the background loop, which starts only when ``config.autotune`` is
on.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import tensorframes_tpu_torch as tft
from tensorframes_tpu.runtime import autotune as jat
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch import shape_policy as tsp
from tensorframes_tpu_torch.runtime import autotune as tat
from tensorframes_tpu_torch.runtime import profiler as tprofiler
from tensorframes_tpu_torch.serving import registry as tregistry
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import CPU, reset_port

PROFILE_SCHEMA = tprofiler.PROFILE_SCHEMA


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _hist(buckets, counts, hsum, count):
    return {"buckets": list(buckets), "counts": list(counts),
            "sum": float(hsum), "count": int(count)}


def _fill_profile(mean_fill, samples=30, rungs=(4096,), verb="map_blocks"):
    return {
        "schema": PROFILE_SCHEMA,
        "bucketing": {
            "fill": {verb: _hist([0.5, 1.0], [samples, 0, 0], mean_fill * samples, samples)}
        },
        "programs": {"abc": {"rungs": list(rungs), "execs": samples}},
    }


def _ingest_profile(comp_busy, comp_wait, dec_busy, dec_wait, chunks=20):
    return {
        "schema": PROFILE_SCHEMA,
        "ingest": {
            "compute": {"chunks": chunks, "busy_s": comp_busy, "wait_s": comp_wait},
            "decode": {"chunks": chunks, "busy_s": dec_busy, "wait_s": dec_wait},
        },
    }


def _serving_profile(shed=0, p99_bucket=0.001, coalesce_per_batch=4, requests=64,
                     batches=16, endpoints=("ep",)):
    counts = [batches, 0, 0] if p99_bucket <= 0.001 else [0, batches, 0]
    return {
        "schema": PROFILE_SCHEMA,
        "serving": {
            "endpoints": {
                e: {"requests": requests, "batches": batches, "shed": shed} for e in endpoints
            },
            "batch_requests": _hist([1, 4, 16], [0, batches, 0, 0],
                                    coalesce_per_batch * batches, batches),
            "queue_seconds": _hist([0.001, 1.0], counts, p99_bucket * batches, batches),
        },
    }


def _admission_profile(admitted, shed, peak, sat):
    return {
        "schema": PROFILE_SCHEMA,
        "admission": {"admitted": admitted, "shed": shed, "peak_in_flight": peak},
        "residuals": {"peak_ratio_max": sat},
    }


_KNOBS = {
    "shape_bucket_growth": 2.0,
    "shape_bucket_min": 8,
    "ingest_decode_workers": 1,
    "stream_prefetch_depth": 1,
    "serve_batch_window_ms": 5.0,
    "serve_default_timeout_s": 30.0,
    "max_concurrent_verbs": 0,
    "endpoint_windows": {},
}


def _dicts(recs):
    return [r.to_dict() for r in recs]


# ---------------------------------------------------------------------------
# config pin layer
# ---------------------------------------------------------------------------


class TestConfigPins:
    def test_update_pins(self):
        assert not tconfig.is_explicit("stream_prefetch_depth")
        with tconfig.override(stream_prefetch_depth=2):
            assert tconfig.is_explicit("stream_prefetch_depth")
        assert not tconfig.is_explicit("stream_prefetch_depth")

    def test_set_tuned_refused_on_pin(self):
        with tconfig.override(stream_prefetch_depth=2):
            assert tconfig.set_tuned("stream_prefetch_depth", 4) is False
            assert tconfig.get().stream_prefetch_depth == 2
            assert tconfig.tuned() == {}

    def test_set_tuned_applies_and_resets(self):
        assert tconfig.set_tuned("stream_prefetch_depth", 4) is True
        assert tconfig.get().stream_prefetch_depth == 4
        assert tconfig.tuned() == {"stream_prefetch_depth": 4}
        assert not tconfig.is_explicit("stream_prefetch_depth")
        tconfig.reset_tuning()
        assert tconfig.get().stream_prefetch_depth == 1 and tconfig.tuned() == {}

    def test_update_supersedes_tuned(self):
        tconfig.set_tuned("shape_bucket_min", 16)
        with tconfig.override(shape_bucket_min=32):
            assert tconfig.tuned() == {}
            assert tconfig.get().shape_bucket_min == 32
        # the override's exit restores the tuned value and its ledger entry
        assert tconfig.get().shape_bucket_min == 16
        assert tconfig.tuned() == {"shape_bucket_min": 16}

    def test_unknown_key_raises(self):
        with pytest.raises(AttributeError):
            tconfig.set_tuned("no_such_knob", 1)

    def test_new_knobs_default_as_jax(self):
        from tensorframes_tpu import config as jconfig

        for k in ("cost_ledger", "cost_ledger_memory", "cost_residual_warn_ratio",
                  "recompile_warn_shapes", "oom_split_depth", "autotune",
                  "autotune_interval_s"):
            assert getattr(tconfig.get(), k) == getattr(jconfig.Config(), k), k
        assert tconfig.get().oom_split_depth == 3 and tconfig.get().autotune is False


class TestEnvCoverage:
    def _child(self, env, code):
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
            env={**os.environ, **env},
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc.stdout.strip().splitlines()[-1]

    def test_env_overrides_seed_and_pin(self):
        out = self._child(
            {"TFS_SERVE_QUEUE_LIMIT": "31", "TFS_AUTOTUNE_INTERVAL_S": "lots"},
            "from tensorframes_tpu_torch import config as c\n"
            "print(c.get().serve_queue_limit, c.is_explicit('serve_queue_limit'),"
            " c.get().autotune_interval_s, c.is_explicit('autotune_interval_s'),"
            " c.set_tuned('serve_queue_limit', 7), c.get().serve_queue_limit)\n",
        )
        assert out == "31 True 30.0 False False 31"


# ---------------------------------------------------------------------------
# the four policies, against the JAX package's
# ---------------------------------------------------------------------------

_LADDER_CASES = [
    (_fill_profile(0.55), 2.0, 8),
    (_fill_profile(0.86), 2.0, 8),
    (_fill_profile(0.97, rungs=tuple(range(64, 64 * 20, 64))), 2.0, 8),
    (_fill_profile(0.55, rungs=tuple(range(64, 64 * 20, 64))), 2.0, 8),
    (_fill_profile(0.55, samples=5), 2.0, 8),
    (_fill_profile(0.40, verb="serve:ep"), 2.0, 8),
    (_fill_profile(0.90, rungs=(4096,)), 2.0, 8),
    (_fill_profile(0.90, rungs=(64,)), 2.0, 8),
    (_fill_profile(0.55), 3.0, 8),
]
_INGEST_CASES = [
    (_ingest_profile(1.0, 9.0, 9.0, 1.0), 1, 1),
    (_ingest_profile(1.0, 9.0, 2.0, 8.0), 2, 1),
    (_ingest_profile(9.0, 0.1, 0.5, 9.5), 3, 2),
    (_ingest_profile(8.0, 1.5, 3.0, 7.0), 2, 2),
    (_ingest_profile(1.0, 9.0, 2.0, 8.0), 2, 8),
    (_ingest_profile(1.0, 9.0, 9.0, 1.0), 32, 4),
    (_ingest_profile(1.0, 9.0, 9.0, 1.0, chunks=3), 1, 1),
]
_SERVING_CASES = [
    (_serving_profile(shed=2), 5.0, None),
    (_serving_profile(p99_bucket=1.0), 5.0, None),
    (_serving_profile(), 5.0, None),
    (_serving_profile(coalesce_per_batch=1), 5.0, None),
    (_serving_profile(requests=4), 5.0, None),
    (_serving_profile(p99_bucket=1.0, endpoints=("a", "b")), 5.0, None),
    (_serving_profile(), 5.0, {"ep": 20.0}),
]
_ADMISSION_CASES = [
    (_admission_profile(100, 5, 2, None), 2),
    (_admission_profile(100, 0, 3, 0.9), 0),
    (_admission_profile(100, 0, 3, 0.9), 16),
    (_admission_profile(100, 5, 3, 0.35), 4),
    (_admission_profile(jat.MIN_ADMITTED - 1, 5, 2, None), 2),
]


class TestPoliciesEqualJax:
    @pytest.mark.parametrize("case", range(len(_LADDER_CASES)))
    def test_ladder_policy(self, case):
        prof, growth, mn = _LADDER_CASES[case]
        got = _dicts(tat.ladder_policy(prof, growth=growth, min_bucket=mn))
        assert got == _dicts(jat.ladder_policy(prof, growth=growth, min_bucket=mn))

    @pytest.mark.parametrize("case", range(len(_INGEST_CASES)))
    def test_ingest_policy(self, case):
        prof, workers, depth = _INGEST_CASES[case]
        kw = dict(decode_workers=workers, prefetch_depth=depth, max_workers=8)
        assert _dicts(tat.ingest_policy(prof, **kw)) == _dicts(jat.ingest_policy(prof, **kw))

    @pytest.mark.parametrize("case", range(len(_SERVING_CASES)))
    def test_serving_policy(self, case):
        prof, window, ep_windows = _SERVING_CASES[case]
        kw = dict(window_ms=window, default_timeout_s=30.0, endpoint_windows=ep_windows)
        assert _dicts(tat.serving_policy(prof, **kw)) == _dicts(jat.serving_policy(prof, **kw))

    @pytest.mark.parametrize("case", range(len(_ADMISSION_CASES)))
    def test_admission_policy(self, case):
        prof, limit = _ADMISSION_CASES[case]
        assert _dicts(tat.admission_policy(prof, limit=limit)) == _dicts(
            jat.admission_policy(prof, limit=limit)
        )

    def test_constants_equal_jax(self):
        assert tat.SAFETY_BOUNDS == jat.SAFETY_BOUNDS
        for k in ("FILL_LOW", "FILL_HIGH", "MIN_FILL_SAMPLES", "MIN_RAISE_FACTOR",
                  "MIN_RAISE_STEP", "STARVED_HIGH", "STARVED_LOW", "DECODE_BUSY_HIGH",
                  "DECODE_BUSY_LOW", "MIN_INGEST_CHUNKS", "PRESSURE_FRAC",
                  "HEADROOM_FRAC", "WIDEN_COALESCE", "MIN_SERVE_REQUESTS", "SAT_HIGH",
                  "SAT_LOW", "MIN_ADMITTED"):
            assert getattr(tat, k) == getattr(jat, k), k

    def test_the_policies_move_as_documented(self):
        recs = tat.ladder_policy(_fill_profile(0.55), growth=2.0, min_bucket=8)
        # shrink the growth; the smallest rung (4096) sits far above the
        # ladder min, so raise the min by the bounded step (x8)
        assert [(r.knob, r.proposed) for r in recs] == [
            ("shape_bucket_growth", 1.5), ("shape_bucket_min", 64)
        ]
        recs = tat.ingest_policy(_ingest_profile(1.0, 9.0, 9.0, 1.0), 1, 1, max_workers=8)
        assert [(r.knob, r.proposed) for r in recs] == [
            ("ingest_decode_workers", 2), ("stream_prefetch_depth", 2)
        ]
        (s,) = tat.serving_policy(_serving_profile(shed=2), 5.0, 30.0)
        assert (s.scope, s.proposed) == ("endpoint:ep", 2.5)
        (a,) = tat.admission_policy(_admission_profile(100, 0, 3, 0.9), limit=0)
        assert (a.knob, a.proposed) == ("max_concurrent_verbs", 3)


# ---------------------------------------------------------------------------
# determinism + hysteresis
# ---------------------------------------------------------------------------


class TestDeterminism:
    def test_same_profile_same_recommendations(self):
        prof = _fill_profile(0.55)
        a = _dicts(tat.recommend(prof, knobs=_KNOBS))
        assert a and a == _dicts(tat.recommend(prof, knobs=_KNOBS))
        assert a == _dicts(jat.recommend(prof, knobs=_KNOBS))

    def test_recommend_is_pure_not_compounding(self):
        prof = _fill_profile(0.55)
        for _ in range(3):
            growth = [r for r in tat.recommend(prof, knobs=_KNOBS)
                      if r.knob == "shape_bucket_growth"]
            assert growth[0].proposed == 1.5

    def test_recommend_reads_the_live_config(self):
        tconfig.set_tuned("shape_bucket_growth", 3.0)
        (g,) = [r for r in tat.recommend(_fill_profile(0.55)) if r.knob == "shape_bucket_growth"]
        assert (g.current, g.proposed) == (3.0, 2.0)


class TestHysteresis:
    def test_borderline_signal_never_flips(self):
        prof = _fill_profile((tat.FILL_LOW + tat.FILL_HIGH) / 2)
        for _ in range(5):
            assert not [r for r in tat.recommend(prof, knobs=_KNOBS)
                        if r.knob == "shape_bucket_growth"]

    def test_converges_into_dead_band(self):
        growth, moves = 3.0, 0
        for _ in range(10):
            fill = min(0.98, 0.55 * (3.0 / growth) ** 0.8)
            g = [r for r in tat.ladder_policy(_fill_profile(fill), growth=growth, min_bucket=8)
                 if r.knob == "shape_bucket_growth"]
            if not g:
                break
            growth = g[0].proposed
            moves += 1
        assert 0 < moves < 6

    def test_profile_delta_equals_jax(self):
        old = {**_fill_profile(0.30, samples=100), **_serving_profile(requests=40, batches=10),
               **_ingest_profile(1.0, 2.0, 3.0, 4.0),
               "admission": {"admitted": 10, "shed": 1, "peak_in_flight": 2, "wait_seconds": 0.5}}
        new = {**_fill_profile(0.30, samples=100), **_serving_profile(requests=90, batches=20),
               **_ingest_profile(2.0, 3.0, 5.0, 6.0, chunks=40),
               "admission": {"admitted": 25, "shed": 3, "peak_in_flight": 4, "wait_seconds": 1.5}}
        new["bucketing"]["fill"]["map_blocks"] = _hist(
            [0.5, 1.0], [100, 100, 0], 0.30 * 100 + 0.95 * 100, 200
        )
        got = tat.profile_delta(new, old)
        assert got == jat.profile_delta(new, old)
        h = got["bucketing"]["fill"]["map_blocks"]
        assert h["count"] == 100 and abs(h["sum"] / h["count"] - 0.95) < 1e-9
        assert got["serving"]["endpoints"]["ep"]["requests"] == 50


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _register(name, rows=64, **over):
    df = tft.TensorFrame.from_dict({"x": np.arange(rows, dtype=np.float32)})
    with tconfig.override(**over):
        tft.serving.register(
            name, (tft.block(df, "x") * 2.0).named("y"), {"x": "float32"}, device=CPU,
        )
    return tregistry.get(name)


class TestApply:
    def test_pin_survives_tuning_cycle(self):
        with tconfig.override(shape_bucket_growth=2.0):
            res = tft.autotune(_fill_profile(0.55))
            dec = [d for d in res["applied"] if d["knob"] == "shape_bucket_growth"]
            assert dec and dec[0]["outcome"] == "skipped:pinned"
            assert tconfig.get().shape_bucket_growth == 2.0
            assert "shape_bucket_growth" not in tconfig.tuned()

    def test_applied_value_and_counter_and_span(self):
        res = tft.autotune(_fill_profile(0.55))
        dec = [d for d in res["applied"] if d["knob"] == "shape_bucket_growth"]
        assert dec and dec[0]["outcome"] == "applied"
        assert tconfig.get().shape_bucket_growth == 1.5
        assert tconfig.tuned()["shape_bucket_growth"] == 1.5
        assert ttele.flat_counters().get("autotune_adjustments{knob=shape_bucket_growth}") == 1.0
        spans = [s for s in ttele.spans() if s.kind == "tuning"]
        assert any(s.name == "autotune.shape_bucket_growth" and s.attrs["outcome"] == "applied"
                   for s in spans)
        assert tat.decisions()[-1]["outcome"] in ("applied", "skipped:pinned")

    def test_safety_clamp(self):
        dec = tat.apply([tat.Recommendation("stream_prefetch_depth", "config", 1, 99, "test")])
        lo, hi = tat.SAFETY_BOUNDS["stream_prefetch_depth"]
        assert dec[0]["applied_value"] == hi == tconfig.get().stream_prefetch_depth

    def test_unknown_scope_is_a_decision(self):
        dec = tat.apply([tat.Recommendation("serve_batch_window_ms", "mesh:x", 5.0, 7.5, "t")])
        assert dec[0]["outcome"] == "skipped:unknown-scope:mesh:x"

    def test_endpoint_window_apply(self):
        ep = _register("at-ep", serve_warm_compile=False)
        assert ep.batch_window_ms is None and ep.describe()["batch_window_ms"] is None
        dec = tat.apply([tat.Recommendation("serve_batch_window_ms", "endpoint:at-ep", 5.0, 7.5, "t")])
        assert dec[0]["outcome"] == "applied"
        assert ep.batch_window_ms == 7.5 and ep.describe()["batch_window_ms"] == 7.5
        assert tat.state()["endpoint_windows"] == {"at-ep": 7.5}
        dec = tat.apply([tat.Recommendation("serve_batch_window_ms", "endpoint:ghost", 5.0, 7.5, "t")])
        assert dec[0]["outcome"] == "skipped:unknown-endpoint"
        with tconfig.override(serve_batch_window_ms=5.0):
            dec = tat.apply([tat.Recommendation("serve_batch_window_ms", "endpoint:at-ep", 7.5, 11.0, "t")])
            assert dec[0]["outcome"] == "skipped:pinned"
        assert ep.batch_window_ms == 7.5

    def test_batcher_reads_endpoint_window(self):
        import importlib

        batcher_mod = importlib.import_module("tensorframes_tpu_torch.serving.batcher")
        ep = _register("at-win", serve_warm_compile=False)
        cfg = tconfig.get()
        assert batcher_mod._window_s(ep, cfg) == pytest.approx(cfg.serve_batch_window_ms / 1e3)
        ep.batch_window_ms = 12.0
        assert batcher_mod._window_s(ep, cfg) == pytest.approx(0.012)
        with tconfig.override(serve_batch_window_ms=3.0):
            assert batcher_mod._window_s(ep, tconfig.get()) == pytest.approx(0.003)
        assert batcher_mod._window_s(ep, cfg) == pytest.approx(0.012)
        tat.reset()
        assert ep.batch_window_ms is None

    def test_ladder_change_rewarms_endpoints(self):
        ep = _register("at-warm", rows=16, serve_max_batch_rows=32)
        old = ep.warmed_rungs
        assert old
        dec = tat.apply([tat.Recommendation("shape_bucket_growth", "config", 2.0, 1.5, "t")])
        assert dec[0]["outcome"] == "applied"
        assert ep.warmed_rungs == tuple(tsp.bucket_ladder(32)) and ep.warmed_rungs != old


# ---------------------------------------------------------------------------
# one-shot + background loop + surfacing
# ---------------------------------------------------------------------------


class TestOneShotAndLoop:
    def test_autotune_from_saved_path(self, tmp_path):
        path = str(tmp_path / "p.json")
        tprofiler.WorkloadProfile(_fill_profile(0.55)).save(path)
        res = tft.autotune(path)
        assert any(d["knob"] == "shape_bucket_growth" and d["outcome"] == "applied"
                   for d in res["applied"])

    def test_autotune_recommend_only(self):
        res = tft.autotune(_fill_profile(0.55), apply_recommendations=False)
        assert res["recommendations"] and not res["applied"]
        assert "shape_bucket_growth" not in tconfig.tuned()

    def test_rejects_a_non_profile(self):
        with pytest.raises(TypeError, match="WorkloadProfile"):
            tat.recommend(42)

    def test_off_by_default_no_thread(self):
        assert not tconfig.get().autotune
        assert tat.maybe_start() is None
        assert not any(t.name == "tfs-autotune" for t in threading.enumerate())

    def test_loop_starts_and_stops(self):
        with tconfig.override(autotune=True, autotune_interval_s=30.0):
            tuner = tat.maybe_start()
            assert tuner is not None and tuner.running
            st = tat.state()
            assert st["enabled"] and st["running"]
            tat.stop()
        assert not any(t.name == "tfs-autotune" for t in threading.enumerate())

    def test_loop_runs_cycles(self):
        import time

        tuner = tat.AutoTuner(interval_s=0.05)
        tuner.start()
        try:
            deadline = time.monotonic() + 10.0
            while tuner.cycles < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            tuner.stop()
        assert tuner.cycles >= 2 and not tuner.running

    def test_cycle_tunes_on_deltas(self, monkeypatch):
        """Two manual cycles: the first sees the low-fill history and
        moves the knob; the second's delta holds no new evidence."""
        prof = _fill_profile(0.55)
        monkeypatch.setattr(tprofiler, "snapshot",
                            lambda note=None: tprofiler.WorkloadProfile(dict(prof)))
        tuner = tat.AutoTuner()
        tuner.cycle()
        assert tconfig.tuned().get("shape_bucket_growth") == 1.5
        tuner.cycle()
        assert tconfig.tuned().get("shape_bucket_growth") == 1.5

    def test_diagnostics_and_profile_surface_state(self):
        tconfig.set_tuned("stream_prefetch_depth", 3)
        data = tft.diagnostics(format="json")
        assert data["autotune"]["tuned"] == {"stream_prefetch_depth": 3}
        assert "tuned stream_prefetch_depth = 3" in tft.diagnostics()
        prof = tprofiler.snapshot()
        assert prof.data["autotune"]["tuned"] == {"stream_prefetch_depth": 3}
        assert "peak_ratio_max" in prof.data["residuals"]

    def test_state_keys_equal_jax(self):
        assert set(tat.state()) == set(jat.state())

    def test_recorder_carries_the_decisions(self, tmp_path):
        from tensorframes_tpu_torch.runtime import blackbox as tblackbox

        tft.autotune(_fill_profile(0.55))
        with tconfig.override(incident_dir=str(tmp_path)):
            bundle = tft.incidents(tblackbox.capture("fault", RuntimeError("x")))
        assert bundle["autotune_decisions"] and bundle["autotune_decisions"][0]["knob"]
        assert bundle["config"]["tuned"] == tconfig.tuned()
