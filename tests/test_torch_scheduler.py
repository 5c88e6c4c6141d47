"""PyTorch port: the block scheduler (`runtime/scheduler.py`) and
``devices=`` on the verbs, held to the JAX package's `runtime.scheduler` on
the CPU.

The JAX package schedules over its 8 virtual CPU devices
(`tests/conftest.py`); the port's stand-in is 8 labelled CPU slots,
``torch.device("cpu", i)``, patched in as the local devices
(`scheduler._local_devices`). Both label them ``cpu:0`` ... ``cpu:7``, so
placements and dispatch-span labels compare directly. Mirrors
`tests/test_scheduler.py`'s classes: TestPlan, TestResolve, TestPlacement,
TestResults, TestStreaming, TestHostSyncDiscipline; TestLazyMeshRoutes holds
a lazy plan's mesh routes to `tensorframes_tpu.parallel.verbs`'
`fused_map_blocks` / `fused_reduce_blocks`.

Tolerances: maps, min, max, integer sums, keys and labels exact; float32
sums and means rtol 1e-5, float64 sums rtol 1e-6 (a schedule combines a
card's partials first, another grouping of the same sum); `reduce_rows`
keeps the fold order, so even a non-associative float fold is bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu.runtime import scheduler as jrs
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.runtime import scheduler as trs
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.utils import telemetry as ttele
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

from _torch_runtime import reset_port

CPU = "cpu"
NDEV = 8
SLOTS = [torch.device("cpu", i) for i in range(NDEV)]
LABELS = [f"cpu:{i}" for i in range(NDEV)]


@pytest.fixture(autouse=True)
def _slots(monkeypatch):
    """The port's local devices: 8 labelled CPU slots (JAX's 8 virtual
    devices)."""
    assert len(jax.local_devices()) == NDEV
    reset_port()
    monkeypatch.setattr(trs, "_local_devices", lambda: list(SLOTS))
    yield
    reset_port()


def _frames(sizes, mod=13, dtype=np.float32):
    n = int(sum(sizes))
    offsets = list(np.cumsum([0] + list(sizes)))
    x = (np.arange(n) % mod).astype(dtype)
    j = tfs.TensorFrame([tfs.TensorFrame.from_dict({"x": x})["x"]], offsets)
    t = tft.TensorFrame([tft.TensorFrame.from_dict({"x": x})["x"]], offsets)
    return j, t


def _both(data, num_blocks):
    return (tfs.TensorFrame.from_dict(data, num_blocks=num_blocks),
            tft.TensorFrame.from_dict(data, num_blocks=num_blocks))


def _reduce(pkg, d, df, op, col="x"):
    ph = pkg.block(df, col, tf_name=col + "_input")
    return getattr(d, f"reduce_{op}")(ph, axes=[0]).named(col)


def _labels(tele, prefix):
    return [
        s.attrs.get("device") for s in tele.spans()
        if s.kind == "dispatch" and s.name.startswith(prefix)
    ]


class TestPlan:
    def test_largest_first_least_loaded(self):
        assert trs.plan([8, 1, 7, 2], 2) == jrs.plan([8, 1, 7, 2], 2) == [0, 0, 1, 1]

    def test_zero_weight_blocks_unassigned(self):
        assert trs.plan([4, 0, 4], 2) == jrs.plan([4, 0, 4], 2) == [0, None, 1]

    def test_deterministic_under_ties(self):
        assert trs.plan([5, 5, 5, 5], 4) == jrs.plan([5, 5, 5, 5], 4) == [0, 1, 2, 3]

    def test_fewer_blocks_than_devices(self):
        assert trs.plan([3], 8) == jrs.plan([3], 8) == [0]

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("ndev", [1, 2, 3, 8])
    def test_equals_jax_on_random_weights(self, seed, ndev):
        rng = np.random.default_rng(seed)
        weights = [int(w) for w in rng.integers(0, 50, size=int(rng.integers(1, 40)))]
        assert trs.plan(weights, ndev) == jrs.plan(weights, ndev)

    def test_rejects_zero_devices(self):
        with pytest.raises(ValueError, match=">= 1 device"):
            trs.plan([1], 0)


class TestResolve:
    def test_off_disables(self):
        with tft.config.override(block_scheduler="off"):
            assert trs.resolve() is None

    def test_auto_on_with_multiple_devices(self):
        with tft.config.override(block_scheduler="auto"), tfs.config.override(block_scheduler="auto"):
            assert [trs.device_label(d) for d in trs.resolve()] == [
                jrs.device_label(d) for d in jrs.resolve()
            ] == LABELS

    def test_auto_off_with_one_device(self, monkeypatch):
        monkeypatch.setattr(trs, "_local_devices", lambda: SLOTS[:1])
        with tft.config.override(block_scheduler="auto"):
            assert trs.resolve() is None
        with tft.config.override(block_scheduler="global"):
            assert trs.resolve() is None

    def test_on_schedules_even_one_device(self, monkeypatch):
        monkeypatch.setattr(trs, "_local_devices", lambda: SLOTS[:1])
        with tft.config.override(block_scheduler="on"):
            assert trs.resolve() == (SLOTS[0],)

    def test_typo_mode_raises(self):
        with tft.config.override(block_scheduler="yes"), tfs.config.override(block_scheduler="yes"):
            for rs in (trs, jrs):
                with pytest.raises(ValueError, match="'auto' | 'on' | 'off' | 'global'"):
                    rs.resolve()

    def test_explicit_devices_win_over_off(self):
        with tft.config.override(block_scheduler="off"):
            assert trs.resolve(devices=[0]) == (SLOTS[0],)
            assert trs.resolve(devices=[SLOTS[3], "cpu"]) == (SLOTS[3], torch.device("cpu"))

    def test_explicit_empty_devices_rejected(self):
        for rs in (trs, jrs):
            with pytest.raises(ValueError, match=r"devices=\[\] is ambiguous"):
                rs.resolve(devices=[])

    def test_index_out_of_range(self):
        for rs in (trs, jrs):
            with pytest.raises(ValueError, match="index 8 out of range for 8 local"):
                rs.resolve(devices=[8])

    def test_mesh_takes_precedence(self):
        assert trs.resolve(mesh=object()) is None
        for rs in (trs, jrs):
            with pytest.raises(ValueError, match="mutually exclusive"):
                rs.resolve(devices=[0], mesh=object())

    def test_unsupported_executor_never_scheduled(self):
        class NoSched:
            supports_scheduling = False

        assert trs.resolve(executor=NoSched()) is None
        assert trs.resolve(executor=Executor()) is not None
        with pytest.raises(ValueError, match="supports block scheduling"):
            trs.resolve(devices=[0], executor=NoSched())

    def test_no_card_means_no_cpu_fallback(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
        monkeypatch.undo()  # the real local devices: the cards, none here
        with tft.config.override(block_scheduler="on"):
            with pytest.raises(RuntimeError, match="CUDA"):
                trs.resolve()
        with pytest.raises(RuntimeError, match="CUDA"):
            trs.resolve(devices=["cuda:1"])
        df = tft.TensorFrame.from_dict({"x": np.arange(4.0)})
        with pytest.raises(RuntimeError, match="CUDA"):
            tft.map_blocks((tft.block(df, "x") + 1.0).named("z"), df, devices=["cuda:1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            tft.map_blocks((tft.block(df, "x") + 1.0).named("z"), df)

    def test_devices_and_device_together_raise(self):
        df = tft.TensorFrame.from_dict({"k": np.arange(4) % 2, "x": np.arange(4.0)})
        z = (tft.block(df, "x") + 1.0).named("z")
        for call in (
            lambda: tft.map_blocks(z, df, devices=[0], device=CPU),
            lambda: tft.map_rows((tdsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x")
                                  + 1.0).named("y"), df, devices=[0], device=CPU),
            lambda: tft.reduce_blocks(_reduce(tft, tdsl, df, "sum"), df, devices=[0], device=CPU),
            lambda: tft.aggregate(_reduce(tft, tdsl, df, "sum"), tft.group_by(df, "k"),
                                  devices=[0], device=CPU),
        ):
            with pytest.raises(ValueError, match="devices= or device="):
                call()


class TestKnobs:
    KNOBS = {"block_scheduler": "TFS_BLOCK_SCHEDULER",
             "global_frame_min_rows": "TFS_GLOBAL_FRAME_MIN_ROWS",
             "device_cooldown_s": "TFS_DEVICE_COOLDOWN_S"}

    @pytest.mark.parametrize("knob", sorted(KNOBS))
    def test_defaults_equal_jax(self, knob):
        from tensorframes_tpu import config as jconfig
        from tensorframes_tpu_torch import config as tconfig

        assert getattr(tconfig.Config(), knob) == getattr(jconfig.Config(), knob)

    @pytest.mark.parametrize("knob,raw", [
        ("block_scheduler", "ON"), ("block_scheduler", "0"), ("block_scheduler", "true"),
        ("block_scheduler", "global"), ("global_frame_min_rows", "16"),
        ("global_frame_min_rows", "-3"), ("global_frame_min_rows", "many"),
        ("device_cooldown_s", "2.5"), ("device_cooldown_s", "-1"),
    ])
    def test_env_seeding_as_jax(self, knob, raw, monkeypatch):
        from tensorframes_tpu import config as jconfig
        from tensorframes_tpu_torch import config as tconfig

        monkeypatch.setenv(self.KNOBS[knob], raw)
        assert getattr(tconfig.Config(), knob) == getattr(jconfig.Config(), knob)


class TestPlacement:
    def test_deterministic_placement_ledgers(self):
        ex = Executor()
        _, df = _frames([40, 10, 30, 20, 5])
        z = (tft.block(df, "x") * 2.0).named("z")
        tft.map_blocks(z, df, executor=ex)
        first = dict(ex.device_dispatches)
        assert sum(first.values()) == 5 and len(first) == 5
        tft.map_blocks(z, df, executor=ex)
        assert ex.device_dispatches == {k: 2 * v for k, v in first.items()}

    @pytest.mark.parametrize("sizes", [[40, 10, 30, 20], [7, 7, 7, 7, 7, 7, 7, 7, 7, 7], [3, 90, 1]])
    def test_span_labels_equal_jax(self, sizes):
        jdf, tdf = _frames(sizes)
        jtele.reset()
        tfs.map_blocks((tfs.block(jdf, "x") + 1.0).named("z"), jdf)
        ttele.reset()
        tft.map_blocks((tft.block(tdf, "x") + 1.0).named("z"), tdf)
        want = _labels(jtele, "map_blocks.block")
        assert _labels(ttele, "map_blocks.block") == want
        assert want == [LABELS[s] for s in jrs.plan(jdf.block_sizes(), NDEV)]

    def test_schedule_labels_equal_jax_sched_label(self):
        sizes = [5, 50, 0, 17, 17, 2, 90, 33, 1, 60]
        jdf, tdf = _frames(sizes)
        js = jrs.schedule_for(jdf)
        ts = trs.schedule_for(tdf)
        assert [ts.label(i) for i in range(len(sizes))] == [js.label(i) for i in range(len(sizes))]
        assert ts.anchor_device() == SLOTS[0]

    def test_executor_per_device_counts(self):
        ex = Executor()
        _, df = _frames([16, 16, 16])
        tft.map_blocks((tft.block(df, "x") * 3.0).named("z"), df, executor=ex)
        assert sum(ex.device_dispatches.values()) == 3 and len(ex.device_dispatches) == 3
        # a lowered callable for every device a block touched
        assert {k: v for k, v in ex.device_compiles.items()} == {l: 1 for l in LABELS[:3]}

    def test_devices_override_pins(self):
        ex = Executor()
        _, df = _frames([8, 8, 8])
        tft.map_blocks((tft.block(df, "x") - 1.0).named("z"), df, executor=ex, devices=[1])
        assert ex.device_dispatches == {"cpu:1": 3}

    def test_explicit_device_pins_with_scheduling_off(self):
        ex = Executor()
        _, df = _frames([8, 8, 8])
        ttele.reset()
        tft.map_blocks((tft.block(df, "x") - 1.0).named("z"), df, executor=ex, device=CPU)
        assert ex.device_dispatches == {}
        assert _labels(ttele, "map_blocks.block") == [None] * 3

    def test_queue_depth_gauge_drains(self):
        _, df = _frames([5, 9, 3, 11])
        tft.map_blocks((tft.block(df, "x") * 2.0).named("z"), df)
        _, gauges, _ = ttele.metrics_snapshot()
        depths = {dict(l)["device"]: v for (n, l), v in gauges.items() if n == "scheduler_queue_depth"}
        assert set(depths) == set(LABELS[:4]) and all(v == 0 for v in depths.values())


class TestResults:
    def test_map_bit_identical(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal(999).astype(np.float32)
        jdf, tdf = _both({"x": x}, 7)
        ref = np.asarray(tfs.map_blocks((tfs.block(jdf, "x") * 1.7 + 0.3).named("z"), jdf)["z"].values)
        out = tft.map_blocks((tft.block(tdf, "x") * 1.7 + 0.3).named("z"), tdf)
        # XLA fuses the multiply-add; the port rounds twice
        np.testing.assert_allclose(out.host_values("z"), ref, rtol=1e-6, atol=1e-7)
        local = tft.map_blocks((tft.block(tdf, "x") * 1.7 + 0.3).named("z"), tdf, device=CPU)
        np.testing.assert_array_equal(out.host_values("z"), local.host_values("z"))

    @pytest.mark.parametrize("op", ["min", "max"])
    def test_reduce_min_max_exact(self, op):
        x = np.random.default_rng(3).standard_normal(500).astype(np.float32)
        jdf, tdf = _both({"x": x}, 6)
        ref = float(tfs.reduce_blocks(_reduce(tfs, jdsl, jdf, op), jdf))
        assert float(tft.reduce_blocks(_reduce(tft, tdsl, tdf, op), tdf)) == ref == getattr(x, op)()

    @pytest.mark.parametrize("op", ["sum", "mean"])
    @pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-6)])
    def test_reduce_float_sum_mean_within_tolerance(self, op, dtype, rtol):
        x = np.random.default_rng(5).standard_normal(4096).astype(dtype)
        jdf, tdf = _both({"x": x}, 9)
        ref = float(tfs.reduce_blocks(_reduce(tfs, jdsl, jdf, op), jdf))
        out = float(tft.reduce_blocks(_reduce(tft, tdsl, tdf, op), tdf))
        np.testing.assert_allclose(out, ref, rtol=rtol)
        if op == "sum":  # a mean combines the block means, as in the reference
            np.testing.assert_allclose(out, x.astype(np.float64).sum(), rtol=rtol)

    def test_integer_sum_exact(self):
        jdf, tdf = _frames([33, 1, 60, 6], dtype=np.int64)
        ref = int(tfs.reduce_blocks(_reduce(tfs, jdsl, jdf, "sum"), jdf))
        assert int(tft.reduce_blocks(_reduce(tft, tdsl, tdf, "sum"), tdf)) == ref

    def test_assoc_reduce_combines_per_device_first(self):
        # 10 blocks over 8 slots: two slots hold two partials each, which
        # combine on their slot before the one combine on the anchor
        _, tdf = _frames([10] * 10, dtype=np.int64)
        ttele.reset()
        tft.reduce_blocks(_reduce(tft, tdsl, tdf, "sum"), tdf)
        combines = [s for s in ttele.spans() if s.name == "reduce-combine"]
        assert [s.attrs["partials"] for s in combines] == [2, 2, 8]

    def _fold(self, pkg, d, dtype):
        st = pkg.ScalarType.float32 if dtype == np.float32 else pkg.ScalarType.float64
        x1 = d.placeholder(st, pkg.Shape(()), name="x_1")
        x2 = d.placeholder(st, pkg.Shape(()), name="x_2")
        return (x1 * 0.5 + x2).named("x")

    def test_reduce_rows_fold_order_bitwise(self):
        x = np.random.default_rng(11).standard_normal(257).astype(np.float32)
        jdf, tdf = _both({"x": x}, 5)
        ref = float(tfs.reduce_rows(self._fold(tfs, jdsl, np.float32), jdf))
        out = float(tft.reduce_rows(self._fold(tft, tdsl, np.float32), tdf))
        local = float(tft.reduce_rows(self._fold(tft, tdsl, np.float32), tdf, device=CPU))
        assert out == local
        np.testing.assert_allclose(out, ref, rtol=1e-5)

    def test_reduce_rows_monoid_and_single_row_blocks(self):
        x = (np.arange(72) % 9).astype(np.float32)
        tdf = tft.TensorFrame([tft.TensorFrame.from_dict({"x": x})["x"]], [0, 1, 40, 41, 72])
        x1 = tdsl.placeholder(tft.ScalarType.float32, tft.Shape(()), name="x_1")
        x2 = tdsl.placeholder(tft.ScalarType.float32, tft.Shape(()), name="x_2")
        assert float(tft.reduce_rows((x1 + x2).named("x"), tdf)) == x.sum()
        _, gauges, _ = ttele.metrics_snapshot()
        assert all(v == 0 for (n, _), v in gauges.items() if n == "scheduler_queue_depth")

    def test_map_rows(self):
        x = np.random.default_rng(13).standard_normal(300).astype(np.float32)
        jdf, tdf = _both({"x": x}, 4)
        ref = np.asarray(tfs.map_rows((tfs.row(jdf, "x") * 2.0).named("y"), jdf)["y"].values)
        out = tft.map_rows((tft.row(tdf, "x") * 2.0).named("y"), tdf)
        np.testing.assert_array_equal(out.host_values("y"), ref)

    def test_single_block_and_empty_blocks(self):
        jdf, tdf = _frames([0, 5, 0, 7, 0])
        ref = float(tfs.reduce_blocks(_reduce(tfs, jdsl, jdf, "min"), jdf))
        assert float(tft.reduce_blocks(_reduce(tft, tdsl, tdf, "min"), tdf)) == ref
        assert tft.map_blocks((tft.block(tdf, "x") * 2.0).named("z"), tdf).nrows == 12
        one = tft.TensorFrame.from_dict({"x": np.arange(10.0, dtype=np.float32)})
        assert float(tft.reduce_blocks(_reduce(tft, tdsl, one, "sum"), one)) == 45.0

    def test_empty_frame_still_raises(self):
        df = tft.TensorFrame.from_dict({"x": np.zeros(0, np.float32)})
        with pytest.raises(ValueError, match="empty frame"):
            tft.reduce_blocks(_reduce(tft, tdsl, df, "sum"), df)

    def test_trimmed_map_offsets(self):
        jdf, tdf = _frames([6, 0, 9, 4])
        jref = tfs.map_blocks(tfs.dsl.reduce_sum(tfs.block(jdf, "x"), axes=[0], keep_dims=True)
                              .named("s"), jdf, trim=True)
        out = tft.map_blocks(tdsl.reduce_sum(tft.block(tdf, "x"), axes=[0], keep_dims=True)
                             .named("s"), tdf, trim=True)
        assert [int(o) for o in out.offsets] == [int(o) for o in jref.offsets]
        np.testing.assert_array_equal(out.host_values("s"), np.asarray(jref["s"].values))

    def test_lazy_fused_chain_matches(self):
        x = np.random.default_rng(17).standard_normal(777).astype(np.float32)
        jdf, tdf = _both({"x": x}, 5)

        def chain(pkg, d, frame, **kw):
            lf = frame.lazy(**kw).map_blocks((pkg.block(frame, "x") * 2.0).named("a"))
            a_in = pkg.block(lf, "a", tf_name="a_input")
            return float(lf.reduce_blocks(d.reduce_sum(a_in, axes=[0]).named("a")))

        ref = chain(tfs, jdsl, jdf)
        np.testing.assert_allclose(chain(tft, tdsl, tdf), ref, rtol=1e-5)
        ttele.reset()
        lf = tdf.lazy().map_blocks((tft.block(tdf, "x") * 2.0).named("a"))
        forced = lf.force(devices=[0, 1])
        np.testing.assert_array_equal(forced.host_values("a"), x * 2.0)
        assert set(_labels(ttele, "lazy.force.block")) == {"cpu:0", "cpu:1"}

    def test_function_front_end_matches(self):
        x = np.random.default_rng(19).standard_normal(321).astype(np.float32)
        jdf, tdf = _both({"x": x}, 6)
        ref = np.asarray(tfs.map_blocks(lambda x: {"d": x * 3}, jdf)["d"].values)
        ex = Executor()
        out = tft.map_blocks(lambda x: {"d": x * 3}, tdf, executor=ex)
        np.testing.assert_array_equal(out.host_values("d"), ref)
        rows = tft.map_rows(lambda x: {"d": x + 1}, tdf, devices=[2, 3])
        np.testing.assert_array_equal(rows.host_values("d"), x + 1)

    def test_outputs_anchor_coherently_across_calls(self):
        x = (np.arange(900) % 11).astype(np.float32)
        base = tft.TensorFrame.from_dict({"x": x})
        ragged = tft.TensorFrame([base["x"]], list(np.cumsum([0, 500, 50, 50, 100, 200])))
        a = tft.map_blocks((tft.block(ragged, "x") * 2.0).named("a"), ragged)
        b = tft.map_blocks((tft.block(a, "x") + 1.0).named("b"), a.repartition(3))
        out = tft.map_blocks((tft.block(b, "a") + tft.block(b, "b")).named("c"), b, device=CPU)
        np.testing.assert_allclose(out.host_values("c"), x * 2.0 + (x + 1.0), rtol=1e-6)

    @pytest.mark.parametrize("limit", [32, 0])
    def test_aggregate_exact_and_chunk_fan_out(self, limit):
        rng = np.random.default_rng(23)
        k = rng.integers(0, 9, 500).astype(np.int64)
        v = rng.standard_normal(500).astype(np.float32)
        jdf, tdf = (pkg.TensorFrame.from_dict({"k": k, "v": v}) for pkg in (tfs, tft))
        knobs = dict(aggregate_segment_fast=False, aggregate_exact_size_limit=limit)
        with tfs.config.override(**knobs):
            ref = tfs.aggregate(_reduce(tfs, jdsl, jdf, "sum", "v"), jdf.group_by("k"))
        ex = Executor()
        ttele.reset()
        with tft.config.override(**knobs):
            out = tft.aggregate(_reduce(tft, tdsl, tdf, "sum", "v"), tdf.group_by("k"), executor=ex)
        np.testing.assert_array_equal(out.host_values("k"), np.asarray(ref["k"].values))
        np.testing.assert_allclose(out.host_values("v"), np.asarray(ref["v"].values), rtol=1e-5)
        span = "aggregate.size" if limit else "aggregate.chunk"
        labels = _labels(ttele, span)
        assert len(labels) > 1 and set(labels) <= set(LABELS)
        assert sum(ex.device_dispatches.values()) == len(labels)

    @pytest.mark.parametrize("limit", [32, 0])
    @pytest.mark.parametrize("device", [CPU, None])
    def test_aggregate_gathers_one_size_at_a_time(self, monkeypatch, limit, device):
        # the per-size feeds are gathered when their call dispatches: when
        # the next size gathers, no earlier size's feeds are alive (one
        # device and the block schedule alike)
        import gc
        import importlib
        import weakref

        tagg = importlib.import_module("tensorframes_tpu_torch.aggregate")

        real, alive, gathers = tagg._gather_rows, [], []

        def gather(*a, **kw):
            gc.collect()
            gathers.append(sum(r() is not None for r in alive))
            feeds = real(*a, **kw)
            alive.extend(weakref.ref(f) for f in feeds)
            return feeds

        monkeypatch.setattr(tagg, "_gather_rows", gather)
        rng = np.random.default_rng(29)
        k = rng.integers(0, 40, 600).astype(np.int64)
        v = rng.standard_normal(600).astype(np.float32)
        tdf = tft.TensorFrame.from_dict({"k": k, "v": v})
        with tft.config.override(aggregate_segment_fast=False, aggregate_exact_size_limit=limit):
            out = tft.aggregate(_reduce(tft, tdsl, tdf, "sum", "v"), tdf.group_by("k"),
                                device=device)
        assert len(gathers) > 2 and set(gathers) == {0}
        ref = [v[k == g].astype(np.float64).sum() for g in np.unique(k)]
        np.testing.assert_allclose(out.host_values("v"), ref, rtol=1e-5, atol=1e-5)

    def test_aggregate_segment_plan_pinned_to_first_listed_device(self):
        k = np.arange(40) % 3
        ex = Executor()
        tdf = tft.TensorFrame.from_dict({"k": k, "v": np.arange(40.0)})
        out = tft.aggregate(_reduce(tft, tdsl, tdf, "sum", "v"), tdf.group_by("k"),
                            executor=ex, devices=[5, 2])
        assert ex.device_dispatches == {"cpu:5": 1}
        np.testing.assert_array_equal(out.host_values("v"), [np.arange(40.0)[k == g].sum() for g in range(3)])


def _lazy_chains(n):
    """``(pkg, dsl, frame, lazy x+1 -> z*2 chain)`` for both packages."""
    k, x = np.arange(n) % 3, np.arange(float(n))
    out = []
    for pkg, d in ((tfs, jdsl), (tft, tdsl)):
        df = pkg.TensorFrame.from_dict({"k": k, "x": x})
        lf = df.lazy().map_blocks((pkg.block(df, "x") + 1.0).named("z"))
        out.append((pkg, d, df, lf.map_blocks((pkg.block(lf, "z") * 2.0).named("w"))))
    return out


def _row_ph(pkg, d, name):
    return d.placeholder(pkg.ScalarType.float64, pkg.Shape(()), name=name)


class TestLazyMeshRoutes:
    """A lazy plan on a mesh (``force(mesh=)``: the fused chain once a
    shard; the fused map -> reduce) held to the JAX package's
    `parallel.verbs.fused_map_blocks` / `fused_reduce_blocks` on its 8
    virtual devices, and the mesh calls that force a plan first. Maps,
    min and max exact; float64 sums rtol 1e-12 (the same shards, summed
    in another order)."""

    @pytest.fixture
    def meshes(self):
        from tensorframes_tpu.parallel import data_mesh as j_data_mesh
        from tensorframes_tpu_torch.parallel import data_mesh

        return j_data_mesh(), data_mesh(devices=[CPU] * NDEV)

    @staticmethod
    def _same(jout, tout, cols):
        for c in cols:
            np.testing.assert_array_equal(tout.host_values(c), np.asarray(jout[c].values), err_msg=c)

    @pytest.mark.parametrize("n", [100, 19, 3])
    def test_force_on_the_mesh_equals_jax(self, meshes, n):
        (_, _, _, jlf), (_, _, _, tlf) = _lazy_chains(n)
        ttele.reset()
        tout = tlf.force(mesh=meshes[1])
        self._same(jlf.force(mesh=meshes[0]), tout, ["w", "z", "k", "x"])
        # the whole chain is one program a shard: one shard dispatch (and
        # one for the rows 8 does not divide)
        names = [s.name for s in ttele.spans() if s.kind == "dispatch"]
        assert names == (["mesh.lazy.force"] if n >= NDEV else []) + (
            ["mesh.lazy.force.tail"] if n % NDEV else [])

    @pytest.mark.parametrize("op", ["sum", "min", "max"])
    @pytest.mark.parametrize("n", [100, 19])
    def test_fused_reduce_on_the_mesh_equals_jax(self, meshes, op, n):
        (jp, jd, _, jlf), (tp, td, _, tlf) = _lazy_chains(n)
        j = jlf.reduce_blocks(_reduce(jp, jd, jlf, op, "w"), mesh=meshes[0])
        t = tlf.reduce_blocks(_reduce(tp, td, tlf, op, "w"), mesh=meshes[1])
        if op == "sum":
            np.testing.assert_allclose(float(t), float(np.asarray(j)), rtol=1e-12)
        else:
            assert float(t) == float(np.asarray(j))

    def test_lazy_mode_map_blocks_on_the_mesh_equals_jax(self, meshes):
        outs = []
        for (pkg, _, df, _), mesh in zip(_lazy_chains(37), meshes):
            with pkg.lazy():
                lf = pkg.map_blocks((pkg.block(df, "x") * 3.0).named("y"), df, mesh=mesh)
            assert isinstance(lf, pkg.LazyFrame)
            outs.append(lf.force())
        self._same(outs[0], outs[1], ["y", "k", "x"])

    def test_map_rows_and_reduce_rows_on_the_mesh_equal_jax(self, meshes):
        # the port forces the plan and runs the mesh verb; the JAX
        # package's mesh verbs refuse the forced plan's device-resident
        # columns ("incompatible devices"), so its mesh verbs run over the
        # same columns from the host
        (jp, jd, _, jlf), (tp, td, _, tlf) = _lazy_chains(29)
        forced = jlf.force()
        jlf = jp.TensorFrame.from_dict({c: np.asarray(forced[c].values) for c in forced.columns})
        jm = jp.map_rows((_row_ph(jp, jd, "w") + 1.0).named("y"), jlf, mesh=meshes[0])
        tm = tlf.map_rows((_row_ph(tp, td, "w") + 1.0).named("y"), mesh=meshes[1])
        self._same(jm, tm, ["y", "w", "z", "k", "x"])
        fold = [(_row_ph(p, d, "x_1") + _row_ph(p, d, "x_2")).named("x")
                for p, d in ((jp, jd), (tp, td))]
        feeds = {"x_1": "w", "x_2": "w"}
        j = jp.reduce_rows(fold[0], jlf, mesh=meshes[0], feed_dict=feeds)
        t = tlf.reduce_rows(fold[1], mesh=meshes[1], feed_dict=feeds)
        assert float(t) == float(np.asarray(j))


class TestStreaming:
    def test_chunks_land_on_alternating_devices(self):
        chunks_np = [np.full(50 + 3 * i, float(i), np.float32) for i in range(6)]
        ttele.reset()
        chunks = [tft.TensorFrame.from_dict({"x": c}) for c in chunks_np]
        g = _reduce(tft, tdsl, chunks[0], "sum")
        total = float(tft.reduce_blocks_stream(g, iter(chunks)))
        jchunks = [tfs.TensorFrame.from_dict({"x": c}) for c in chunks_np]
        jtele.reset()
        jtotal = float(tfs.reduce_blocks_stream(_reduce(tfs, jdsl, jchunks[0], "sum"), iter(jchunks)))
        assert total == jtotal == sum(float(i) * (50 + 3 * i) for i in range(6))
        labels = [d for d in _labels(ttele, "reduce_blocks.block") if d]
        jlabels = [d for d in _labels(jtele, "reduce_blocks.block") if d]
        assert labels[:6] == jlabels[:6] == [LABELS[i % NDEV] for i in range(6)]

    def test_stream_explicit_single_device_pin(self):
        chunks = [tft.TensorFrame.from_dict({"x": np.ones(20, np.float32)}) for _ in range(3)]
        ttele.reset()
        total = tft.reduce_blocks_stream(_reduce(tft, tdsl, chunks[0], "sum"), iter(chunks),
                                         devices=[SLOTS[3]])
        assert float(total) == 60.0
        labels = [d for d in _labels(ttele, "reduce_blocks.block") if d]
        assert labels and set(labels) == {"cpu:3"}

    def test_stream_with_empty_chunks(self):
        chunks = [
            tft.TensorFrame.from_dict({"x": np.ones(10, np.float32)}),
            tft.TensorFrame.from_dict({"x": np.zeros(0, np.float32)}),
            tft.TensorFrame.from_dict({"x": np.ones(20, np.float32)}),
        ]
        assert float(tft.reduce_blocks_stream(_reduce(tft, tdsl, chunks[0], "sum"), iter(chunks))) == 30.0

    def test_stream_mesh_and_device(self):
        from tensorframes_tpu_torch.parallel import data_mesh

        chunks = [tft.TensorFrame.from_dict({"x": np.arange(19.0) + i}) for i in range(3)]
        g = _reduce(tft, tdsl, chunks[0], "max")
        assert float(tft.reduce_blocks_stream(g, iter(chunks), mesh=data_mesh(devices=[CPU] * 4))) == 20.0
        assert float(tft.reduce_blocks_stream(g, iter(chunks), device=CPU)) == 20.0
        with pytest.raises(ValueError, match="mesh= or device="):
            tft.reduce_blocks_stream(g, iter(chunks), mesh=data_mesh(devices=[CPU] * 4), device=CPU)


class TestHostSyncDiscipline:
    def test_chained_map_reduce_zero_host_syncs(self):
        x = np.random.default_rng(29).standard_normal(2048).astype(np.float32)
        df = tft.TensorFrame.from_dict({"x": x}, num_blocks=8)
        reset_stats()
        mid = tft.map_blocks((tft.block(df, "x") * 2.0).named("z"), df)
        res = tft.reduce_blocks(_reduce(tft, tdsl, mid, "sum", "z"), mid)
        assert stats().get("host_sync", 0) == 0
        assert isinstance(res, torch.Tensor)
        np.testing.assert_allclose(float(res), float(x.astype(np.float64).sum() * 2), rtol=1e-4)
