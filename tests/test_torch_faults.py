"""PyTorch port: classified retries and OOM block splits in the verbs, the
numerics guard, and the public names (`runtime/faults.py`, `api.py`,
`lazy.py`), held to the JAX package on the CPU.

Mirrors `tests/test_faults.py`'s `TestClassifiedRetries`, `TestOomSplit`
and `TestLedgerSurfacing` through each package's own injection seam
(`testing.faults.inject`, ``fault="resource"`` for an out-of-memory
error): each case runs in both packages on the same seeded inputs, and the
results, the ledger counts and the forensic decisions agree. Map results
are equal; sum and mean reduces match within rtol 1e-12. Then the
numerics guard against JAX's message in every verb, `ShapeHints`,
`ops.supported` and the names the port's namespaces re-export.
"""

import time

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu.graph import ShapeHints as JShapeHints
from tensorframes_tpu.graph import analyze_graph as janalyze
from tensorframes_tpu.ops import supported as jsupported
from tensorframes_tpu.schema import Shape as JShape
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.testing import faults as tchaos
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele
from tensorframes_tpu_torch.utils.inspection import executor_stats as texecutor_stats

from _torch_runtime import CPU, FAST_RETRY, SIDES, host, reset_port

SIDE_NAMES = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _frame(side, data, blocks):
    return SIDES[side]["pkg"].TensorFrame.from_dict(data, num_blocks=blocks)


def _sum_graph(side, df):
    pkg = SIDES[side]["pkg"]
    return pkg.dsl.reduce_sum(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x")


def _map(side, fetch, df, **kw):
    s = SIDES[side]
    return host(s["pkg"].map_blocks(fetch, df, **s["dev"], **kw)["z"].values)


def _reduce(side, fetch, df, **kw):
    s = SIDES[side]
    return host(s["pkg"].reduce_blocks(fetch, df, **s["dev"], **kw))


# ---------------------------------------------------------------------------
# classified retries end to end
# ---------------------------------------------------------------------------


class TestClassifiedRetries:
    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_transient_faults_recover_bit_identical(self, side):
        s = SIDES[side]
        x = np.random.RandomState(0).rand(4096).astype(np.float32)
        df = _frame(side, {"x": x}, 8)
        z = (s["pkg"].block(df, "x") * 2.0 + 1.0).named("z")
        ref_map = _map(side, z, df)
        gmin = s["pkg"].dsl.reduce_min(
            s["pkg"].block(df, "x", tf_name="x_input"), axes=[0]
        ).named("x")
        ref_min = float(_reduce(side, gmin, df))
        with s["config"].override(block_retry_attempts=8, verb_retry_budget=200, **FAST_RETRY):
            with s["chaos"].inject(rate=0.3, seed=7) as plan:
                got_map = _map(side, z, df)
                got_min = float(_reduce(side, gmin, df))
        assert plan.injected > 0
        np.testing.assert_array_equal(ref_map, got_map)
        np.testing.assert_array_equal(got_map, x * np.float32(2.0) + np.float32(1.0))
        assert ref_min == got_min == float(x.min())
        led = s["faults"].ledger_snapshot()
        assert led["transient"] > 0 and led["retries"] > 0

    def test_same_plan_same_injections_in_both_packages(self):
        """The seeded plan fires at the same dispatch ordinals in both
        packages: the same blocks retry the same number of times."""
        x = np.random.RandomState(3).rand(1024).astype(np.float32)
        got = {}
        for side in SIDE_NAMES:
            s = SIDES[side]
            df = _frame(side, {"x": x}, 8)
            z = (s["pkg"].block(df, "x") + 1.0).named("z")
            _map(side, z, df)  # warm: no lowering inside the injected run
            with s["config"].override(block_retry_attempts=8, verb_retry_budget=200, **FAST_RETRY):
                with s["chaos"].inject(rate=0.4, seed=11) as plan:
                    _map(side, z, df)
            got[side] = (plan.injected, plan.faulted_ordinals, s["faults"].ledger_snapshot()["retries"])
        assert got["torch"] == got["jax"]

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_deterministic_error_single_attempt_e2e(self, side):
        """check_numerics' FloatingPointError surfaces at once even with a
        big retry budget."""
        s = SIDES[side]
        df = _frame(side, {"x": np.array([1.0, 0.0, 4.0])}, 1)
        x = s["pkg"].block(df, "x")
        z = (x / (x - x)).named("z")  # 0/0 -> nan
        with s["config"].override(check_numerics=True, block_retry_attempts=5):
            t0 = time.perf_counter()
            with pytest.raises(FloatingPointError, match="map_blocks.*'z'"):
                _map(side, z, df)
            dt = time.perf_counter() - t0
        assert dt < 2.0
        led = s["faults"].ledger_snapshot()
        assert led["retries"] == 0 and led["transient"] == 0

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_injected_deterministic_not_retried(self, side):
        s = SIDES[side]
        df = _frame(side, {"x": np.arange(8.0)}, 1)
        z = (s["pkg"].block(df, "x") + 1.0).named("z")
        with s["config"].override(block_retry_attempts=5):
            with s["chaos"].inject(nth=[0], fault="deterministic") as plan:
                with pytest.raises(s["chaos"].InjectedFault):
                    _map(side, z, df)
        assert plan.injected == 1
        assert s["faults"].ledger_snapshot()["failfast"] == 1

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_verb_budget_bounds_retries(self, side):
        s = SIDES[side]
        df = _frame(side, {"x": np.arange(64.0)}, 4)
        z = (s["pkg"].block(df, "x") + 1.0).named("z")
        with s["config"].override(block_retry_attempts=50, verb_retry_budget=3, **FAST_RETRY):
            with s["chaos"].inject(rate=1.0) as plan:
                with pytest.raises(s["chaos"].InjectedFault):
                    _map(side, z, df)
        # 1 first attempt + 3 budgeted retries, then the budget is spent
        assert plan.injected <= 6

    @pytest.mark.parametrize("verb", ["map_rows", "reduce_rows", "aggregate"])
    def test_other_verbs_retry_transient_faults(self, verb):
        """`map_rows`, `reduce_rows` (its general plan's pair callable) and
        `aggregate` dispatch through a fault scope as well."""
        x = np.random.RandomState(5).rand(64).astype(np.float32)
        df = tft.TensorFrame.from_dict(
            {"x": x, "k": np.arange(64) % 4}, num_blocks=4
        )

        def run():
            if verb == "map_rows":
                return host(tft.map_rows((tft.row(df, "x") * 2.0).named("z"), df, device=CPU)["z"].values)
            if verb == "reduce_rows":
                f32, sc = tft.ScalarType.float32, tft.Shape(())
                x1 = tft.dsl.placeholder(f32, sc, name="x_1")
                x2 = tft.dsl.placeholder(f32, sc, name="x_2")
                return host(tft.reduce_rows((x1 * 0.5 + x2).named("x"), df, device=CPU))
            g = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
            return host(tft.aggregate(g, tft.group_by(df, "k"), device=CPU)["x"].values)

        ref = run()
        # the segment aggregate is one whole-frame dispatch
        nth = [0] if verb == "aggregate" else [0, 2]
        with tft.config.override(block_retry_attempts=8, verb_retry_budget=400, **FAST_RETRY):
            with tchaos.inject(nth=nth, fault="transient") as plan:
                got = run()
        assert plan.injected == len(nth)
        np.testing.assert_array_equal(ref, got)
        assert tfaults.ledger_snapshot()["retries"] == len(nth)


# ---------------------------------------------------------------------------
# OOM block splitting
# ---------------------------------------------------------------------------


class TestOomSplit:
    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_map_split_concatenates(self, side):
        s = SIDES[side]
        x = np.random.RandomState(1).rand(1024).astype(np.float32)
        df = _frame(side, {"x": x}, 2)
        z = (s["pkg"].block(df, "x") * 2.0).named("z")
        ref = _map(side, z, df)
        with s["chaos"].inject(nth=[0], fault="resource"):
            got = _map(side, z, df)
        np.testing.assert_array_equal(ref, got)
        led = s["faults"].ledger_snapshot()
        assert led["splits"] >= 1 and led["resource"] >= 1

    def test_split_ledgers_agree(self):
        x = np.random.RandomState(2).rand(1000).astype(np.float32)
        out = {}
        for side in SIDE_NAMES:
            s = SIDES[side]
            df = _frame(side, {"x": x}, 2)
            z = (s["pkg"].block(df, "x") - 0.5).named("z")
            with s["chaos"].inject(nth=[0, 1], fault="resource") as plan:
                got = _map(side, z, df)
            snaps = s["faults"].forensics_snapshot()
            out[side] = (
                got, plan.injected,
                {k: s["faults"].ledger_snapshot()[k] for k in ("resource", "splits", "retries")},
                [(d["verb"], d["rows"], d["depth"], d["decision"]) for d in snaps],
            )
        np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
        assert out["torch"][1:] == out["jax"][1:]

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_reduce_split_monoid_combines(self, side):
        df = _frame(side, {"x": np.arange(512.0, dtype=np.float64)}, 2)
        ref = float(_reduce(side, _sum_graph(side, df), df))
        with SIDES[side]["chaos"].inject(nth=[0], fault="resource"):
            got = float(_reduce(side, _sum_graph(side, df), df))
        np.testing.assert_allclose(got, ref, rtol=1e-12)
        assert SIDES[side]["faults"].ledger_snapshot()["splits"] >= 1

    @pytest.mark.parametrize("op", ["min", "max", "prod"])
    def test_reduce_split_other_monoids_exact(self, op):
        vals = np.random.RandomState(4).uniform(0.9, 1.1, 300)
        got = {}
        for side in SIDE_NAMES:
            pkg = SIDES[side]["pkg"]
            df = _frame(side, {"x": vals}, 1)
            g = pkg.dsl._reducer(
                op.capitalize(), pkg.block(df, "x", tf_name="x_input"), [0], False
            ).named("x")
            with SIDES[side]["chaos"].inject(nth=[0], fault="resource"):
                got[side] = float(_reduce(side, g, df))
        want = float(getattr(np, op)(vals))
        if op == "prod":
            np.testing.assert_allclose(got["torch"], want, rtol=1e-12)
            np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-12)
        else:
            assert got["torch"] == got["jax"] == want

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_reduce_split_mean_weighted(self, side):
        vals = np.arange(101.0)
        pkg = SIDES[side]["pkg"]
        df = _frame(side, {"x": vals}, 1)
        gmean = pkg.dsl.reduce_mean(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
        ref = float(_reduce(side, gmean, df))
        with SIDES[side]["chaos"].inject(nth=[0], fault="resource"):
            got = float(_reduce(side, gmean, df))
        np.testing.assert_allclose(got, ref, rtol=1e-12)
        assert abs(got - float(vals.mean())) < 1e-9

    def test_mean_combine_keeps_the_partial_dtype(self):
        a = torch.tensor([1.0, 2.0], dtype=torch.float32)
        b = torch.tensor([3.0, 5.0], dtype=torch.float32)
        (out,) = tfaults.combine_split_partials(["mean"], [a], [b], 1, 3)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), [2.5, 4.25])

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_unclassifiable_reduce_reraises(self, side):
        pkg = SIDES[side]["pkg"]
        df = _frame(side, {"x": np.arange(64.0)}, 1)
        x_in = pkg.block(df, "x", tf_name="x_input")
        spread = (pkg.dsl.reduce_max(x_in, axes=[0]) - pkg.dsl.reduce_min(x_in, axes=[0])).named("x")
        with SIDES[side]["chaos"].inject(nth=[0], fault="resource"):
            with pytest.raises(SIDES[side]["chaos"].InjectedFault, match="RESOURCE"):
                _reduce(side, spread, df)
        assert SIDES[side]["faults"].ledger_snapshot()["splits"] == 0
        snaps = SIDES[side]["faults"].forensics_snapshot()
        assert snaps[-1]["decision"] == "reraise:unclassifiable-reduce"

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_split_depth_bounded(self, side):
        s = SIDES[side]
        df = _frame(side, {"x": np.arange(64.0)}, 1)
        z = (s["pkg"].block(df, "x") + 1.0).named("z")
        with s["config"].override(oom_split_depth=2):
            with s["chaos"].inject(rate=1.0, fault="resource") as plan:
                with pytest.raises(s["chaos"].InjectedFault):
                    _map(side, z, df)
        # 1 + 2 + 4 dispatches at depths 0..2 at most, then the original
        # error re-raises
        assert plan.injected <= 7
        assert s["faults"].forensics_snapshot()[-1]["decision"] == "reraise:split-depth-exhausted"

    def test_split_depth_equal_injections_in_both_packages(self):
        got = {}
        for side in SIDE_NAMES:
            s = SIDES[side]
            df = _frame(side, {"x": np.arange(64.0)}, 1)
            z = (s["pkg"].block(df, "x") + 1.0).named("z")
            with s["config"].override(oom_split_depth=2):
                with s["chaos"].inject(rate=1.0, fault="resource") as plan:
                    with pytest.raises(s["chaos"].InjectedFault):
                        _map(side, z, df)
            got[side] = (plan.injected, s["faults"].ledger_snapshot()["splits"])
        assert got["torch"] == got["jax"]

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_lazy_fused_reduce_splits(self, side):
        s = SIDES[side]
        pkg = s["pkg"]
        df = _frame(side, {"x": np.arange(256.0)}, 2)
        ref = float(np.arange(256.0).sum() * 2.0)
        with s["chaos"].inject(nth=[0], fault="resource"):
            lz = df.lazy(**s["dev"])
            fused = pkg.map_blocks((pkg.block(lz, "x") * 2.0).named("y"), lz)
            y_in = pkg.block(fused, "y", tf_name="y_input")
            got = float(host(fused.reduce_blocks(pkg.dsl.reduce_sum(y_in, axes=[0]).named("y"))))
        np.testing.assert_allclose(got, ref, rtol=1e-12)
        assert s["faults"].ledger_snapshot()["splits"] >= 1

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_lazy_force_splits_row_local_chain(self, side):
        s = SIDES[side]
        pkg = s["pkg"]
        x = np.random.RandomState(6).rand(600)
        df = _frame(side, {"x": x}, 3)
        lz = df.lazy(**s["dev"])
        lz = pkg.map_blocks((pkg.block(lz, "x") * 3.0).named("y"), lz)
        lz = pkg.map_blocks((pkg.block(lz, "y") + 1.0).named("w"), lz)
        with s["config"].override(plan_pipeline=False) if side == "torch" else s["config"].override():
            with s["chaos"].inject(nth=[1], fault="resource"):
                out = lz.force()
        np.testing.assert_array_equal(host(out.column("w").values), x * 3.0 + 1.0)
        assert s["faults"].ledger_snapshot()["splits"] == 1

    def test_map_rows_splits(self):
        x = np.random.RandomState(8).rand(100, 3).astype(np.float32)
        df = tft.TensorFrame.from_dict({"x": x}, num_blocks=2)
        z = tft.dsl.reduce_sum(tft.row(df, "x"), axes=[0]).named("z")
        with tchaos.inject(nth=[0], fault="resource"):
            got = host(tft.map_rows(z, df, device=CPU)["z"].values)
        np.testing.assert_allclose(got, x.sum(axis=1), rtol=1e-6)
        assert tfaults.ledger_snapshot()["splits"] == 1
        assert ttele.flat_counters()["block_splits{verb=map_rows}"] == 1.0

    def test_trimmed_map_is_not_row_local(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(16.0)}, num_blocks=1)
        z = tft.dsl.reduce_sum(tft.block(df, "x"), axes=[0], keep_dims=True).named("z")
        with tchaos.inject(nth=[0], fault="resource"):
            with pytest.raises(tchaos.InjectedFault):
                tft.map_blocks(z, df, trim=True, device=CPU)
        assert tfaults.forensics_snapshot()[-1]["decision"] == "reraise:not-row-local"

    def test_cuda_oom_classifies_as_resource_and_splits(self):
        """A genuine `torch.cuda.OutOfMemoryError` (raised by hand here: the
        CPU has no card) takes the split path like an injected one."""
        x = np.arange(32.0)
        df = tft.TensorFrame.from_dict({"x": x}, num_blocks=1)
        z = (tft.block(df, "x") + 1.0).named("z")
        fn_calls = []

        def hook(fn, key):
            def wrapper(*args):
                fn_calls.append(args[0].shape[0])
                if len(fn_calls) == 1:
                    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
                return fn(*args)
            return wrapper

        from tensorframes_tpu_torch.runtime import executor as texec

        texec.set_fault_injector(hook)
        try:
            got = host(tft.map_blocks(z, df, device=CPU)["z"].values)
        finally:
            texec.set_fault_injector(None)
        np.testing.assert_array_equal(got, x + 1.0)
        assert fn_calls == [32, 16, 16]
        snap = tfaults.forensics_snapshot()[-1]
        assert snap["error"].startswith("OutOfMemoryError") and snap["decision"].startswith("split:")
        assert all(isinstance(v, (str, int, type(None), dict, list)) for v in snap.values())


# ---------------------------------------------------------------------------
# ledger surfacing
# ---------------------------------------------------------------------------


class TestLedgerSurfacing:
    def test_executor_stats_carries_fault_ledger(self):
        s = texecutor_stats()
        j = tfs.executor_stats()
        assert set(s) >= {"compile_count", "cache_hits", "cache_misses", "cache_entries",
                          "jit_shape_compiles", "faults", "admission"}
        assert set(s["faults"]) >= {
            "transient", "resource", "deterministic", "retries", "splits", "failfast",
            "forensics",
        }
        # the port leaves out device evictions and grant timeouts (the
        # multi-device scheduler and the CPU-fallback watchdog)
        assert set(s["faults"]) | {"evictions", "grant_timeouts"} == set(j["faults"])

    @pytest.mark.parametrize("side", SIDE_NAMES)
    def test_block_splits_counter(self, side):
        s = SIDES[side]
        df = _frame(side, {"x": np.arange(64.0)}, 1)
        z = (s["pkg"].block(df, "x") + 1.0).named("z")
        with s["chaos"].inject(nth=[0], fault="resource"):
            _map(side, z, df)
        tele = jtele if side == "jax" else ttele
        c = tele.flat_counters()
        assert c.get("block_splits{verb=map_blocks}", 0) >= 1
        assert c.get("fault_retries{class=resource}", 0) >= 1

    def test_forensics_snapshot_names_the_program(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(2048, dtype=np.float32)}, num_blocks=4)
        z = (tft.block(df, "x") * 2.0 + 1.0).named("z")
        ref = _map("torch", z, df)
        with tchaos.inject(nth=[1], fault="resource") as plan:
            got = _map("torch", z, df)
        assert plan.injected == 1
        np.testing.assert_array_equal(ref, got)
        snap = texecutor_stats()["faults"]["forensics"][0]
        assert snap["verb"] == "map_blocks" and snap["program"]
        assert snap["decision"].startswith("split:") and snap["rows"] == 512 and snap["depth"] == 0
        assert snap["modeled"]["footprint_bytes"] == 2 * 512 * 4
        assert snap["error"].startswith("InjectedFault")
        assert "oom[map_blocks]" in tft.diagnostics()

    def test_forensics_log_is_bounded_and_resets(self):
        err = RuntimeError("RESOURCE_EXHAUSTED: synthetic")
        for i in range(40):
            tfaults.record_oom("v", f"prog{i}", 10, 0, "split:x", err)
        assert len(tfaults.forensics_snapshot()) == 16
        assert ttele.flat_counters()["oom_forensics{verb=v}"] == 40.0
        tfaults.reset_ledger()
        assert tfaults.forensics_snapshot() == []


# ---------------------------------------------------------------------------
# the numerics guard
# ---------------------------------------------------------------------------


def _numerics_case(side, verb):
    """One verb of ``side`` whose output holds NaN/Inf: ``(thunk, expected
    message prefix)``."""
    s = SIDES[side]
    pkg, dev = s["pkg"], s["dev"]
    x = np.array([1.0, 0.0, -1.0], dtype=np.float32)
    df = pkg.TensorFrame.from_dict({"x": x, "k": np.array([0, 0, 1])}, num_blocks=1)
    if verb == "map_blocks":
        f = (pkg.block(df, "x") / 0.0).named("z")
        return lambda: pkg.map_blocks(f, df, **dev), "map_blocks block 0: fetch 'z' contains 3"
    if verb == "map_rows":
        f = (pkg.row(df, "x") / 0.0).named("z")
        return lambda: pkg.map_rows(f, df, **dev), "map_rows block 0: fetch 'z' contains 3"
    if verb == "reduce_blocks":
        f = pkg.dsl.reduce_sum(pkg.block(df, "x", tf_name="x_input") / 0.0, axes=[0]).named("x")
        return lambda: pkg.reduce_blocks(f, df, **dev), "reduce_blocks block 0: fetch 'x' contains 1"
    if verb == "reduce_rows":
        f32, sc = pkg.ScalarType.float32, pkg.Shape(())
        x1 = pkg.dsl.placeholder(f32, sc, name="x_1")
        x2 = pkg.dsl.placeholder(f32, sc, name="x_2")
        f = (x1 / x2).named("x")
        return lambda: pkg.reduce_rows(f, df, **dev), "reduce_rows block 0: fetch 'x' contains 1"
    if verb == "aggregate":
        f = pkg.dsl.reduce_sum(pkg.block(df, "x", tf_name="x_input") / 0.0, axes=[0]).named("x")
        return (
            lambda: pkg.aggregate(f, pkg.group_by(df, "k"), **dev),
            "aggregate (segment fast path): fetch 'x' contains 2",
        )
    lz = df.lazy(**dev)
    f = (pkg.block(lz, "x") / 0.0).named("z")
    return lambda: pkg.map_blocks(f, lz).force(), "lazy fused block 0: fetch 'z' contains 3"


class TestNumericsGuard:
    @pytest.mark.parametrize(
        "verb",
        ["map_blocks", "map_rows", "reduce_blocks", "reduce_rows", "aggregate", "lazy.force"],
    )
    def test_raises_with_the_jax_message(self, verb):
        msgs = {}
        for side in SIDE_NAMES:
            run, prefix = _numerics_case(side, verb)
            with SIDES[side]["config"].override(check_numerics=True):
                with pytest.raises(FloatingPointError) as ei:
                    run()
            msgs[side] = str(ei.value)
            assert msgs[side].startswith(prefix), msgs[side]
        assert msgs["torch"] == msgs["jax"]
        assert msgs["torch"].endswith("non-finite value(s) (check_numerics is on)")

    @pytest.mark.parametrize("verb", ["map_blocks", "reduce_blocks", "lazy.force"])
    def test_off_by_default_returns_the_values(self, verb):
        run, _ = _numerics_case("torch", verb)
        run()  # no raise

    def test_map_blocks_x_over_zero(self):
        """The repaired fault: the port returned ``[inf, nan, -inf]``."""
        df = tft.TensorFrame.from_dict({"x": np.array([1.0, 0.0, -1.0])})
        z = (tft.block(df, "x") / 0.0).named("z")
        out = host(tft.map_blocks(z, df, device=CPU)["z"].values)
        assert np.isinf(out[0]) and np.isnan(out[1]) and np.isinf(out[2])
        with tft.config.override(check_numerics=True):
            with pytest.raises(FloatingPointError, match=r"map_blocks block 0: fetch 'z' contains 3"):
                tft.map_blocks(z, df, device=CPU)

    def test_clean_path_costs_one_host_sync_per_block(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(40.0)}, num_blocks=4)
        xb = tft.block(df, "x")
        z, y = (xb + 1.0).named("z"), (xb * 2.0).named("y")
        tprof.reset_stats()
        with tft.config.override(check_numerics=True):
            tft.map_blocks([z, y], df, device=CPU)
        assert tprof.stats()["host_sync"] == 4.0

    def test_non_float_fetches_are_not_checked(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(4, dtype=np.int64)})
        z = (tft.block(df, "x") + 1).named("z")
        tprof.reset_stats()
        with tft.config.override(check_numerics=True):
            tft.map_blocks(z, df, device=CPU)
        assert "host_sync" not in tprof.stats()

    def test_retry_module_reexports_the_guard(self):
        from tensorframes_tpu_torch.runtime import retry as tretry

        assert tretry.maybe_check_numerics is tfaults.maybe_check_numerics
        assert tretry.run_with_retries is tfaults.run_with_retries


# ---------------------------------------------------------------------------
# ShapeHints, ops.supported, the public names
# ---------------------------------------------------------------------------


class TestPublicNames:
    def test_hint_overrides_unknown(self):
        from tensorframes_tpu_torch.graph import ShapeHints, analyze_graph

        x = tft.dsl.placeholder(tft.ScalarType.float64, tft.Shape((None,)), name="x")
        z = (x + 1.0).named("z")
        g, fetches = tft.dsl.build(z)
        summary = analyze_graph(g, fetches, hints=ShapeHints(out_shapes={"z": tft.Shape((10,))}))
        assert summary.outputs["z"].shape == tft.Shape((10,))
        # JAX on the same graph
        jx = jdsl.placeholder(tfs.ScalarType.float64, JShape((None,)), name="x")
        jg, jf = jdsl.build((jx + 1.0).named("z"))
        js = janalyze(jg, jf, hints=JShapeHints(out_shapes={"z": JShape((10,))}))
        assert summary.outputs["z"].shape.dims == js.outputs["z"].shape.dims
        # without a hint the dim stays unknown
        assert analyze_graph(g, fetches).outputs["z"].shape == tft.Shape((None,))

    def test_hint_stands_in_for_block_size_dependent_rank(self, monkeypatch):
        """When the two meta probes disagree on an output's rank, a hint
        stands in (JAX: `analysis.py:145-158`); without one the analysis
        raises. The lowering is replaced by one whose output rank is the
        probe size, since no lowering rule of the port makes such a
        graph."""
        from tensorframes_tpu_torch.graph import ShapeHints, analyze_graph
        from tensorframes_tpu_torch.graph import analysis as tanalysis

        def rank_follows_block(graph, fetches, feed_names, device, **kw):
            return lambda x: (torch.empty((1,) * x.shape[0], device=device),)

        monkeypatch.setattr(tanalysis, "build_callable", rank_follows_block)
        x = tft.dsl.placeholder(tft.ScalarType.float32, tft.Shape((None,)), name="x")
        g, f = tft.dsl.build((x * 7.0).named("z"))
        with pytest.raises(ValueError, match="rank depends on the block size"):
            analyze_graph(g, f)
        s = analyze_graph(g, f, hints=ShapeHints(out_shapes={"z": tft.Shape((2, 2))}))
        assert s.outputs["z"].shape == tft.Shape((2, 2))

    def test_shape_hints_are_exported(self):
        assert tft.ShapeHints is tft.graph.ShapeHints
        assert tft.ShapeHints().out_shapes == {}

    def test_ops_supported_equals_jax(self):
        from tensorframes_tpu_torch.ops import supported

        x = tft.dsl.placeholder(tft.ScalarType.float32, tft.Shape((None,)), name="x")
        g, f = tft.dsl.build((tft.dsl.sqrt(x) + 1.0).named("z"))
        assert supported(g, f) == (True, "")
        jx = jdsl.placeholder(tfs.ScalarType.float32, JShape((None,)), name="x")
        jg, jf = jdsl.build((jdsl.sqrt(jx) + 1.0).named("z"))
        assert jsupported(jg, jf) == (True, "")
        bad = tft.Graph.from_bytes(g.to_bytes())
        bad["z"].op = "NoSuchOp"
        ok, why = supported(bad, f)
        jbad = tfs.Graph.from_bytes(jg.to_bytes())
        jbad["z"].op = "NoSuchOp"
        assert (ok, why) == jsupported(jbad, jf) == (False, "unsupported op 'NoSuchOp' (node 'z')")

    @pytest.mark.parametrize(
        "module,names",
        [
            ("utils", ["save_frame", "load_frame", "save_params", "load_params", "stats",
                       "reset_stats", "diagnostics", "trace", "annotate", "record"]),
            ("ops", ["register", "registered_ops", "get_rule", "GraphLoweringError", "OpRule",
                     "LowerCtx", "build_callable", "supported"]),
            ("graph", ["analyze_graph", "freeze_variables", "has_variables", "GraphSummary",
                       "NodeSummary", "ShapeHints"]),
        ],
    )
    def test_namespaces_reexport_the_jax_names(self, module, names):
        import importlib

        port = importlib.import_module(f"tensorframes_tpu_torch.{module}")
        ref = importlib.import_module(f"tensorframes_tpu.{module}")
        for n in names:
            assert hasattr(port, n), n
            assert n in port.__all__, n
            assert hasattr(ref, n), n

    def test_top_level_runtime_names(self):
        for n in ("diagnostics", "explain_analyze", "autotune", "ShapeHints", "profile"):
            assert hasattr(tft, n) and hasattr(tfs, n), n
        assert tft.profile.WorkloadProfile is not None and callable(tft.profile.snapshot)

    def test_profiling_trace_and_annotate(self, tmp_path):
        from tensorframes_tpu_torch.utils import annotate, trace

        df = tft.TensorFrame.from_dict({"x": np.arange(8.0)})
        with trace(str(tmp_path)) as prof:
            with annotate("tfs-region"):
                tft.map_blocks((tft.block(df, "x") + 1.0).named("z"), df, device=CPU)
        names = {e.key for e in prof.key_averages()}
        assert "tfs-region" in names
        assert (tmp_path / "trace.json").stat().st_size > 0


class TestLastPublicNames:
    """The names the port lacked until the multi-process slice:
    `graph.vectorize.state` / `reset_state` behind the diagnostics'
    ``row_vectorize`` section, `Executor.run` / `clear` and
    `utils.profiling.record`, each against the JAX package."""

    @staticmethod
    def _branchy_calls(side):
        """The same map_rows and lifted map_blocks calls in one package,
        from a clean count: its vectorize state, shape-analysis memo and a
        fresh executor (a program traced by an earlier test in this
        process would not trace again)."""
        from tensorframes_tpu.graph import analysis as janalysis
        from tensorframes_tpu.graph import vectorize as jvec
        from tensorframes_tpu.graph.control_flow import functionalize as jfun
        from tensorframes_tpu.runtime.executor import Executor as JExecutor
        from tensorframes_tpu_torch.graph import analysis as tanalysis
        from tensorframes_tpu_torch.graph import vectorize as tvec
        from tensorframes_tpu_torch.graph.control_flow import functionalize as tfun
        from tensorframes_tpu_torch.runtime.executor import Executor

        from test_torch_vectorize import _branchy_bytes

        pkg, vec, fun, memo, ex = {
            "jax": (tfs, jvec, jfun, janalysis._analysis_cache, JExecutor()),
            "torch": (tft, tvec, tfun, tanalysis._cache, Executor()),
        }[side]
        vec.reset_state()
        memo.clear()
        dev = dict(SIDES[side]["dev"], executor=ex)
        data = _branchy_bytes()
        x = np.array([2.0, -1.0, 0.5, -300.0, 0.0, 77.0, 8.0, 3.0], np.float32)
        df = pkg.TensorFrame.from_dict({"x": x}, num_blocks=2)
        lifted, fetches = fun(pkg.Graph.from_bytes(data), ["out", "trips"])
        vec.lift_to_block_level(lifted)
        for _ in range(2):
            pkg.map_rows(data, df, fetch_names=["out", "trips"], **dev)
            pkg.map_blocks(lifted, df, fetch_names=fetches, **dev)
        with pkg.config.override(row_vectorize=False):
            pkg.map_rows(data, df, fetch_names=["out", "trips"], **dev)
        return vec

    def test_row_vectorize_diagnostics_equal_jax(self):
        from tensorframes_tpu_torch.graph import vectorize as tvec

        got = {}
        for side, tele in (("jax", jtele), ("torch", ttele)):
            vec = self._branchy_calls(side)
            got[side] = tele.diagnostics_data()["row_vectorize"]
            vec.reset_state()
            assert vec.state() == {"lowered": {}, "fallbacks": {}}
        assert got["torch"] == got["jax"]
        # lowerings count once a traced program: the lifted graph's cond and
        # loop, not every dispatch of them
        assert set(got["torch"]["lowered"]) == {"cond", "while"}
        assert tvec.state() == {"lowered": {}, "fallbacks": {}}

    def test_no_diagnostics_section_errors_on_a_plain_run(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(8.0)}, num_blocks=2)
        tft.map_blocks((tft.block(df, "x") + 1.0).named("z"), df, device=CPU)
        tft.reduce_blocks(_sum_graph("torch", df), df, device=CPU)
        data = ttele.diagnostics_data()
        broken = {k: v for k, v in data.items() if isinstance(v, dict) and "error" in v}
        assert broken == {}

    def test_executor_run_and_clear_match_jax(self):
        from tensorframes_tpu.runtime.executor import Executor as JExecutor
        from tensorframes_tpu_torch.runtime.executor import Executor

        x = np.arange(6.0).reshape(3, 2)
        outs = {}
        for side, ex_cls in (("jax", JExecutor), ("torch", Executor)):
            pkg = SIDES[side]["pkg"]
            ph = pkg.dsl.placeholder(pkg.ScalarType.float64, pkg.Shape((None, 2)), name="x")
            g, f = pkg.dsl.build([(ph * 2.0).named("y"), pkg.dsl.reduce_sum(ph, axes=[0]).named("s")])
            ex = ex_cls()
            kw = {"device": CPU} if side == "torch" else {}
            lazy = ex.run(g, f, {"x": x}, **kw)
            host_out = ex.run(g, f, {"x": x}, materialize=True, **kw)
            assert all(isinstance(o, np.ndarray) for o in host_out)
            assert len(ex.cache_keys()) == 1
            ex.clear()
            assert ex.cache_keys() == []
            outs[side] = ([host(o) for o in lazy], host_out)
        assert isinstance(Executor().run(*tft.dsl.build(
            (tft.dsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x") + 1.0)
            .named("y")), {"x": np.float64(1.0)}, device=CPU)[0], torch.Tensor)
        for t, j in zip(outs["torch"][0] + outs["torch"][1], outs["jax"][0] + outs["jax"][1]):
            np.testing.assert_array_equal(t, j)

    def test_profiling_record_matches_jax(self):
        from tensorframes_tpu.utils import profiling as jprof

        for side, prof, tele in (("jax", jprof, jtele), ("torch", tprof, ttele)):
            tele.reset()
            with prof.record("probe", rows=5):
                time.sleep(0.002)
            with prof.record("probe"):
                pass
            flat = tele.flat_counters()
            assert flat["probe.calls"] == 2.0 and flat["probe.rows"] == 5.0, side
            verb = [s for s in tele.spans() if s.kind == "verb" and s.name == "probe"]
            assert len(verb) == 2, side
            # one clock: the counter is the spans' own seconds
            assert flat["probe.seconds"] == pytest.approx(sum(s.seconds for s in verb)), side
            hist = tele.metrics_snapshot()[2]
            assert sum(h[3] for k, h in hist.items() if k[0] == "verb_seconds") == 2, side
