"""PyTorch port: `GlobalFrame` (`globalframe.py`), held to the JAX package's
`tensorframes_tpu.globalframe` on the CPU.

The JAX frame is one sharded `jax.Array` a column over its 8 virtual CPU
devices; the port's is one shard tensor a column per device of 8 labelled
CPU slots (``torch.device("cpu", i)``, patched in as the local devices).
The JAX side runs with ``shape_bucketing`` off, so both pad the rows only
to a multiple of 8 (the port has no bucketing): padded rows, shard rows and
pad counts compare directly. Mirrors `tests/test_globalframe.py`'s
classes: construction, parity, fallbacks (counted under JAX's reasons),
precedence, the shrinking mesh, the ``"global"`` auto-route, lazy plans,
streaming, the runtime boundary and observability; plus the relational
``filter_global``.

Tolerances: maps, min, max, integer sums, fallback counts and dispatch
counts exact; float sums and means rtol 1e-5 (float32) / 1e-12 (float64
against JAX's own reassociated sums: both combine 8 shard partials).
"""

import time

import numpy as np
import pytest
import torch

import jax

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu import globalframe as jgf
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch import globalframe as tgf
from tensorframes_tpu_torch.runtime import scheduler as trs
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import reset_port

NDEV = 8
SLOTS = [torch.device("cpu", i) for i in range(NDEV)]


@pytest.fixture(autouse=True)
def _slots(monkeypatch):
    assert len(jax.local_devices()) == NDEV
    reset_port()
    jgf.reset_state()
    monkeypatch.setattr(trs, "_local_devices", lambda: list(SLOTS))
    with tfs.config.override(shape_bucketing=False):
        yield
    reset_port()
    jgf.reset_state()


def _data(n=100, dtype=np.float32, mod=None, seed=0):
    if mod is None:
        return np.random.RandomState(seed).rand(n).astype(dtype)
    return (np.arange(n) % mod).astype(dtype)


def _frames(n=100, blocks=5, **kw):
    x = _data(n, **kw)
    return (tfs.TensorFrame.from_dict({"x": x}, num_blocks=blocks),
            tft.TensorFrame.from_dict({"x": x}, num_blocks=blocks))


def _reduce(pkg, d, df_like, op, col="x"):
    ph = pkg.block(df_like, col, tf_name=col + "_input")
    return getattr(d, f"reduce_{op}")(ph, axes=[0]).named(col)


def _dispatches(tele, suffix=""):
    return [s for s in tele.spans() if s.kind == "dispatch" and s.name.endswith(suffix)]


def _f(x):
    return float(x.detach().cpu()) if isinstance(x, torch.Tensor) else float(np.asarray(x))


class TestConstruction:
    @pytest.mark.parametrize("n", [19, 100, 8, 7, 1])
    def test_to_global_shards_and_pads_as_jax(self, n):
        jdf, tdf = _frames(n, blocks=min(4, n))
        jg, tg = jdf.to_global(), tdf.to_global()
        assert (tg.nrows, tg.data_size, tg.padded_rows, tg.pad_rows) == (
            jg.nrows, jg.data_size, jg.padded_rows, jg.pad_rows)
        assert tg.shard_rows == jg.padded_rows // NDEV
        shards = tg.shards("x")
        assert len(shards) == NDEV and all(s.shape[0] == tg.shard_rows for s in shards)
        np.testing.assert_array_equal(torch.cat(shards).numpy(), np.asarray(jg.column("x").values))
        np.testing.assert_array_equal(tg.to_frame().host_values("x"), tdf.host_values("x"))
        assert tg.num_blocks == 1 and tg.offsets == [0, n] and tg.block_sizes() == [n]
        assert repr(tg).startswith(f"GlobalFrame[{n} rows")

    def test_rejects_ragged_string_empty(self):
        ragged = tft.TensorFrame.from_dict({"r": [np.zeros(i + 1, np.float32) for i in range(4)]})
        with pytest.raises(ValueError, match="dense device-shardable"):
            ragged.to_global()
        strings = tft.TensorFrame.from_dict({"s": ["a", "b", "c"]})
        with pytest.raises(ValueError, match="dense device-shardable"):
            strings.to_global()
        with pytest.raises(ValueError, match="empty"):
            tft.TensorFrame.from_dict({"x": np.zeros(0, np.float32)}).to_global()

    def test_explicit_mesh_and_select(self):
        from tensorframes_tpu_torch.parallel import data_mesh

        df = tft.TensorFrame.from_dict({"x": np.arange(10.0), "y": np.arange(10) * 2})
        gf = df.to_global(mesh=data_mesh(devices=SLOTS[:3]))
        assert gf.data_size == 3 and gf.padded_rows == 12
        sel = gf.select(["y"])
        assert sel.columns == ["y"]
        np.testing.assert_array_equal(sel.to_frame().host_values("y"), np.arange(10) * 2)


class TestParity:
    def test_map_bit_identical_one_dispatch(self):
        jdf, tdf = _frames(100, 5)
        with tfs.config.override(block_scheduler="on"):
            ref = np.asarray(tfs.map_blocks((tfs.block(jdf, "x") * 2.0 + 1.0).named("z"), jdf)["z"].values)
        ttele.reset()
        gout = tdf.to_global().map_blocks((tft.block(tdf, "x") * 2.0 + 1.0).named("z"))
        assert isinstance(gout, tgf.GlobalFrame)
        spans = _dispatches(ttele)
        assert len(spans) == 1 and spans[0].name == "map_blocks.global"
        assert spans[0].attrs["sharding"] == f"data:{NDEV}"
        local = tft.map_blocks((tft.block(tdf, "x") * 2.0 + 1.0).named("z"), tdf, device="cpu")
        np.testing.assert_array_equal(gout.to_frame().host_values("z"), local.host_values("z"))
        np.testing.assert_allclose(gout.to_frame().host_values("z"), ref, rtol=1e-6)

    def test_chained_map_reduce_one_dispatch_per_stage(self):
        jdf, tdf = _frames(1000, 8, dtype=np.float64, mod=131)
        _, tdfi = _frames(1000, 8, dtype=np.int64, mod=131)
        jmapped = jdf.to_global().map_blocks((tfs.block(jdf, "x") * 3.0 - 1.0).named("z"))
        ttele.reset()
        gf = tdf.to_global()
        mapped = gf.map_blocks((tft.block(tdf, "x") * 3.0 - 1.0).named("z"))
        for op in ("min", "max"):
            got = _f(mapped.reduce_blocks(_reduce(tft, tdsl, mapped, op, "z")))
            ref = _f(jmapped.reduce_blocks(_reduce(tfs, jdsl, jmapped, op, "z")))
            assert got == ref == getattr(_data(1000, np.float64, 131) * 3.0 - 1.0, op)()
        isum = int(tdfi.to_global().reduce_blocks(_reduce(tft, tdsl, tdfi, "sum")))
        assert isum == int((np.arange(1000) % 131).sum())
        names = [s.name for s in _dispatches(ttele)]
        assert names.count("map_blocks.global") == 1
        assert names.count("reduce_blocks.global") == 3 and len(names) == 4
        assert all(s.attrs["sharding"] == f"data:{NDEV}" for s in _dispatches(ttele))
        # the map's outputs stayed on their shards
        assert isinstance(mapped, tgf.GlobalFrame) and len(mapped.shards("z")) == NDEV

    @pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
    def test_sum_mean_within_tolerance(self, dtype, rtol):
        jdf, tdf = _frames(1024, 8, dtype=dtype)
        jg, tg = jdf.to_global(), tdf.to_global()
        for op in ("sum", "mean"):
            ref = _f(jg.reduce_blocks(_reduce(tfs, jdsl, jdf, op)))
            got = _f(tg.reduce_blocks(_reduce(tft, tdsl, tdf, op)))
            np.testing.assert_allclose(got, ref, rtol=rtol)
            np.testing.assert_allclose(got, getattr(_data(1024, dtype).astype(np.float64), op)(),
                                       rtol=max(rtol, 1e-6))

    @pytest.mark.parametrize("n", [NDEV - 1, NDEV + 1, 2 * NDEV + 3, 97])
    def test_non_divisible_lead_dims(self, n):
        jdf, tdf = _frames(n, min(3, n), mod=13)
        tg = tdf.to_global()
        np.testing.assert_array_equal(
            tg.map_blocks((tft.block(tdf, "x") + 0.5).named("z")).to_frame().host_values("z"),
            np.asarray(tfs.map_blocks((tfs.block(jdf, "x") + 0.5).named("z"), jdf)["z"].values),
        )
        for op in ("min", "max", "sum", "mean"):
            got = _f(tg.reduce_blocks(_reduce(tft, tdsl, tdf, op)))
            ref = _f(jdf.to_global().reduce_blocks(_reduce(tfs, jdsl, jdf, op)))
            np.testing.assert_allclose(got, ref, rtol=1e-6)

    def test_map_rows_global_one_dispatch(self):
        jdf, tdf = _frames(64, 4)
        jr, tr = tfs.row(jdf, "x"), tft.row(tdf, "x")
        ref = np.asarray(tfs.map_rows((jr * jr).named("y"), jdf)["y"].values)
        ttele.reset()
        gout = tdf.to_global().map_rows((tr * tr).named("y"))
        np.testing.assert_array_equal(gout.to_frame().host_values("y"), ref)
        assert [s.name for s in _dispatches(ttele)] == ["map_rows.global"]

    def test_multi_fetch_reduce(self):
        x = _data(200, mod=29)
        jdf2, tdf2 = (pkg.TensorFrame.from_dict({"x": x, "y": -x}) for pkg in (tfs, tft))

        def multi(pkg, d, df):
            return [d.reduce_min(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x"),
                    d.reduce_max(pkg.block(df, "y", tf_name="y_input"), axes=[0]).named("y")]

        ref = jdf2.to_global().reduce_blocks(multi(tfs, jdsl, jdf2))
        got = tdf2.to_global().reduce_blocks(multi(tft, tdsl, tdf2))
        assert set(got) == set(ref) and all(_f(got[k]) == _f(ref[k]) for k in ref)


class TestFallbacks:
    def _unclassified(self, pkg, d, df):
        return (d.reduce_sum(pkg.block(df, "x", tf_name="x_input"), axes=[0]) + 1.0).named("x")

    def test_unclassified_reduce_falls_back(self):
        jdf, tdf = _frames(50, 5)
        v = tdf.to_global().reduce_blocks(self._unclassified(tft, tdsl, tdf))
        jv = jdf.to_global().reduce_blocks(self._unclassified(tfs, jdsl, jdf))
        np.testing.assert_allclose(_f(v), _f(jv), rtol=1e-6)
        assert tgf.state()["fallbacks"] == jgf.state()["fallbacks"] == {"unclassified-reduce": 1}

    def test_non_row_local_map_falls_back(self):
        jdf, tdf = _frames(40, 1)

        def g(pkg, d, df):
            x = pkg.block(df, "x")
            return (x - d.reduce_sum(x, axes=[0])).named("z")

        gout = tdf.to_global().map_blocks(g(tft, tdsl, tdf))
        jout = jdf.to_global().map_blocks(g(tfs, jdsl, jdf))
        assert isinstance(gout, tgf.GlobalFrame)
        np.testing.assert_allclose(gout.to_frame().host_values("z"),
                                   np.asarray(jout.to_frame()["z"].values), rtol=1e-5, atol=1e-6)
        assert tgf.state()["fallbacks"] == jgf.state()["fallbacks"] == {"not-row-local": 1}

    @pytest.mark.parametrize("case", ["fn-frontend", "bindings", "bytes-passthrough"])
    def test_other_fallback_reasons(self, case):
        x = _data(16)
        tdf = tft.TensorFrame.from_dict({"x": x, "s": [b"a"] * 16})
        gf = tdf.select(["x"]).to_global()
        if case == "fn-frontend":
            out = gf.map_blocks(lambda x: {"z": x + 1.0})
            want = x + 1.0
        elif case == "bindings":
            b = tdsl.placeholder(tft.ScalarType.float32, tft.Shape(()), name="b")
            out = gf.map_blocks((tft.block(tdf, "x") + b).named("z"), bindings={"b": np.float32(2.0)})
            want = x + 2.0
        else:
            s = tdsl.placeholder(tft.ScalarType.string, tft.Shape(()), name="s")
            with pytest.raises(ValueError, match="placeholder 's' wants column 's'"):
                gf.map_blocks(tdsl.identity(s).named("t"))
            assert tgf.state()["fallbacks"] == {case: 1}
            return
        np.testing.assert_allclose(out.to_frame().host_values("z"), want, rtol=1e-6)
        assert tgf.state()["fallbacks"] == {case: 1}

    def test_trim_rejected(self):
        _, tdf = _frames(16)
        with pytest.raises(ValueError, match="trim"):
            tdf.to_global().map_blocks((tft.block(tdf, "x") * 2.0).named("z"), trim=True)

    def test_fallback_counted_once_under_global_mode(self):
        _, tdf = _frames(50, 5)
        knobs = dict(block_scheduler="global", global_frame_min_rows=1)
        with tft.config.override(**knobs):
            tdf.to_global().reduce_blocks(self._unclassified(tft, tdsl, tdf))
        assert tgf.state()["fallbacks"] == {"unclassified-reduce": 1}
        x = tft.block(tdf, "x")
        tgf.reset_state()
        with tft.config.override(**knobs):
            tdf.to_global().map_blocks((x - tdsl.reduce_sum(x, axes=[0])).named("z"))
        assert tgf.state()["fallbacks"] == {"not-row-local": 1}

    def test_reduce_rows_and_aggregate_take_local_path(self):
        jdf, tdf = _frames(60, 3, mod=7)
        r1, r2 = tft.row(tdf, "x", tf_name="x_1"), tft.row(tdf, "x", tf_name="x_2")
        jr1, jr2 = tfs.row(jdf, "x", tf_name="x_1"), tfs.row(jdf, "x", tf_name="x_2")
        assert _f(tdf.to_global().reduce_rows((r1 + r2).named("x"))) == _f(
            jdf.to_global().reduce_rows((jr1 + jr2).named("x")))
        data = {"k": (np.arange(60) % 3).astype(np.int64), "x": _data(60, mod=7)}
        jk, tk = tfs.TensorFrame.from_dict(data), tft.TensorFrame.from_dict(data)
        agg = tk.to_global().group_by("k").aggregate(_reduce(tft, tdsl, tk, "sum"))
        ref = jk.to_global().group_by("k").aggregate(_reduce(tfs, jdsl, jk, "sum"))
        np.testing.assert_array_equal(agg.host_values("k"), np.asarray(ref["k"].values))
        np.testing.assert_allclose(agg.host_values("x"), np.asarray(ref["x"].values), rtol=1e-5)


class TestPrecedence:
    def test_devices_mesh_and_device_rejected_loudly(self):
        _, tdf = _frames(32)
        gf = tdf.to_global()
        z = (tft.block(tdf, "x") * 2.0).named("z")
        for kw, what in ((dict(devices=[0]), "devices="), (dict(mesh=gf.mesh), "mesh="),
                         (dict(device="cpu:3"), "device=")):
            with pytest.raises(ValueError, match=what):
                gf.map_blocks(z, **kw)
            with pytest.raises(ValueError, match=what):
                gf.reduce_blocks(_reduce(tft, tdsl, tdf, "min"), **kw)
            with pytest.raises(ValueError, match=what):
                gf.map_rows((tft.row(tdf, "x") * 2.0).named("y"), **kw)

    def test_local_path_verbs_reject_overrides_too(self):
        _, tdf = _frames(32)
        gf = tdf.to_global()
        fold = (tft.row(tdf, "x", tf_name="x_1") + tft.row(tdf, "x", tf_name="x_2")).named("x")
        with pytest.raises(ValueError, match="devices="):
            gf.reduce_rows(fold, devices=[0])
        with pytest.raises(ValueError, match="mesh="):
            gf.reduce_rows(fold, mesh=gf.mesh)
        tk = tft.TensorFrame.from_dict({"k": np.arange(32) % 2, "x": np.arange(32, dtype=np.float32)})
        gk = tk.to_global().group_by("k")
        with pytest.raises(ValueError, match="devices="):
            gk.aggregate(_reduce(tft, tdsl, tk, "sum"), devices=[0])
        with pytest.raises(ValueError, match="device="):
            gk.aggregate(_reduce(tft, tdsl, tk, "sum"), device="cpu:1")
        assert not tk.group_by("k")._from_global

    def test_global_mode_devices_pin_wins(self):
        _, tdf = _frames(64, 4)
        ttele.reset()
        with tft.config.override(block_scheduler="global", global_frame_min_rows=1):
            out = tft.map_blocks((tft.block(tdf, "x") * 2.0).named("z"), tdf, devices=[0])
        assert isinstance(out, tft.TensorFrame)
        assert not any(s.name.endswith(".global") for s in _dispatches(ttele))


class TestMeshShrink:
    def test_circuit_open_shrinks_mesh(self):
        _, tdf = _frames(64)
        trs.device_health().mark_failure("cpu:7")
        gf = tdf.to_global()
        assert gf.data_size == NDEV - 1
        assert _f(gf.reduce_blocks(_reduce(tft, tdsl, tdf, "min"))) == _data(64).min()

    def test_healthy_mesh_restored_after_reset(self):
        _, tdf = _frames(64)
        trs.device_health().mark_failure("cpu:0")
        assert tdf.to_global().data_size == NDEV - 1
        trs.device_health().reset()
        assert tdf.to_global().data_size == NDEV


class TestGlobalMode:
    def test_auto_route_map_and_reduce(self):
        _, tdf = _frames(100, 5)
        z = (tft.block(tdf, "x") * 2.0 + 1.0).named("z")
        mref = tft.map_blocks(z, tdf, device="cpu").host_values("z")
        sref = _f(tft.reduce_blocks(_reduce(tft, tdsl, tdf, "min"), tdf, device="cpu"))
        ttele.reset()
        with tft.config.override(block_scheduler="global", global_frame_min_rows=1):
            out = tft.map_blocks(z, tdf)
            got = _f(tft.reduce_blocks(_reduce(tft, tdsl, tdf, "min"), tdf))
        assert isinstance(out, tft.TensorFrame) and out.offsets == tdf.offsets
        np.testing.assert_array_equal(out.host_values("z"), mref)
        assert got == sref
        names = [s.name for s in _dispatches(ttele)]
        assert "map_blocks.global" in names and "reduce_blocks.global" in names
        assert "map_blocks.block" not in names

    def test_min_rows_falls_back_to_per_block(self):
        _, tdf = _frames(100, 5)
        ttele.reset()
        with tft.config.override(block_scheduler="global", global_frame_min_rows=10_000):
            out = tft.map_blocks((tft.block(tdf, "x") * 2.0).named("z"), tdf)
        assert isinstance(out, tft.TensorFrame)
        assert not any(s.name.endswith(".global") for s in _dispatches(ttele))
        # and the per-block path was scheduled, as under "auto"
        assert all(s.attrs.get("device") for s in _dispatches(ttele, "map_blocks.block"))

    def test_map_rows_auto_route(self):
        _, tdf = _frames(64, 4)
        y = (tft.row(tdf, "x") + 1.0).named("y")
        ref = tft.map_rows(y, tdf, device="cpu").host_values("y")
        ttele.reset()
        with tft.config.override(block_scheduler="global", global_frame_min_rows=1):
            out = tft.map_rows(y, tdf)
        np.testing.assert_array_equal(out.host_values("y"), ref)
        assert any(s.name == "map_rows.global" for s in _dispatches(ttele))

    def test_mode_and_knob_as_jax(self):
        with tft.config.override(block_scheduler="global"):
            assert trs.global_mode()
        for pkg in (tfs, tft):
            assert pkg.config.get().global_frame_min_rows == 2048
            assert pkg.config.set_tuned("global_frame_min_rows", 512)
            assert pkg.config.tuned()["global_frame_min_rows"] == 512
            pkg.config.reset_tuning()
            with pkg.config.override(global_frame_min_rows=4096):
                assert pkg.config.is_explicit("global_frame_min_rows")
                assert not pkg.config.set_tuned("global_frame_min_rows", 64)
            pkg.config.reset_tuning()


class TestLazy:
    def test_fused_chain_one_dispatch(self):
        _, tdf = _frames(100, 5)
        z = (tft.block(tdf, "x") * 2.0 + 1.0).named("z")
        ref = tft.map_blocks(z, tdf, device="cpu")
        ref2 = tft.map_blocks((tft.block(ref, "z") * 3.0).named("w"), ref, device="cpu")
        gf = tdf.to_global()
        ttele.reset()
        forced = gf.lazy().map_blocks(z).map_blocks((tft.block(ref, "z") * 3.0).named("w")).force()
        assert isinstance(forced, tft.TensorFrame)
        np.testing.assert_array_equal(forced.host_values("w"), ref2.host_values("w"))
        assert [s.name for s in _dispatches(ttele)] == ["lazy.force.global"]

    def test_fused_reduce_one_dispatch(self):
        _, tdf = _frames(100, 5)
        z = (tft.block(tdf, "x") * 2.0 + 1.0).named("z")
        ref = tft.map_blocks(z, tdf, device="cpu")
        rmin = _f(tft.reduce_blocks(_reduce(tft, tdsl, ref, "min", "z"), ref, device="cpu"))
        gf = tdf.to_global()
        ttele.reset()
        got = gf.lazy().map_blocks(z).reduce_blocks(_reduce(tft, tdsl, ref, "min", "z"))
        assert _f(got) == rmin
        assert [s.name for s in _dispatches(ttele)] == ["reduce_blocks.fused.global"]

    def test_lazy_frame_terminals_take_devices_and_mesh(self):
        from tensorframes_tpu_torch.parallel import data_mesh

        _, tdf = _frames(50, 5)
        lf = tdf.lazy().map_blocks((tft.block(tdf, "x") + 1.0).named("a"))
        g = _reduce(tft, tdsl, lf, "max", "a")
        want = _data(50).max() + np.float32(1.0)
        assert _f(lf.reduce_blocks(g, devices=[1, 2])) == want
        assert _f(lf.reduce_blocks(g, mesh=data_mesh(devices=SLOTS[:4]))) == want
        assert _f(lf.reduce_blocks(g)) == want  # "auto": the 8 slots


class TestRelational:
    def test_filter_global_matches_local_and_counts(self):
        from tensorframes_tpu_torch.graph import plan as tplan
        from tensorframes_tpu_torch.graph.plan import col

        x = _data(300)
        tdf = tft.TensorFrame.from_dict({"x": x, "i": np.arange(300)})
        gf = tdf.to_global()
        ttele.reset()
        out = gf.filter(col("x") > 0.5).force()
        keep = x > 0.5
        assert isinstance(out, tgf.GlobalFrame) and out.nrows == int(keep.sum())
        np.testing.assert_array_equal(out.to_frame().host_values("i"), np.arange(300)[keep])
        assert [s.name for s in _dispatches(ttele)] == ["plan.filter.mask"]
        # a sort cannot run on the shards: counted, then local
        srt = gf.sort_by("x").force()
        np.testing.assert_array_equal(srt.host_values("x"), np.sort(x))
        assert tplan.state()["fallbacks"] == {"sort-global": 1}

    def test_filter_to_nothing_stays_local(self):
        from tensorframes_tpu_torch.graph.plan import col

        tdf = tft.TensorFrame.from_dict({"x": np.arange(20.0)})
        out = tdf.to_global().filter(col("x") > 100.0).force()
        assert isinstance(out, tft.TensorFrame) and out.nrows == 0


class TestStreaming:
    def _chunks(self, pkg, seed, sizes):
        rng = np.random.RandomState(seed)
        return [pkg.TensorFrame.from_dict({"x": rng.rand(n).astype(np.float64)}) for n in sizes]

    def test_stream_folds_into_sharded_accumulator(self):
        tchunks = self._chunks(tft, 3, [50, 51, 52, 53])
        jchunks = self._chunks(tfs, 3, [50, 51, 52, 53])
        knobs = dict(block_scheduler="global", global_frame_min_rows=1)
        with tft.config.override(**knobs):
            got_min = tft.reduce_blocks_stream(_reduce(tft, tdsl, tchunks[0], "min"), iter(tchunks))
            got_sum = tft.reduce_blocks_stream(_reduce(tft, tdsl, tchunks[0], "sum"), iter(tchunks))
        with tfs.config.override(**knobs):
            ref_sum = tfs.reduce_blocks_stream(_reduce(tfs, jdsl, jchunks[0], "sum"), iter(jchunks))
        assert _f(got_min) == min(c.host_values("x").min() for c in tchunks)
        np.testing.assert_allclose(_f(got_sum), _f(ref_sum), rtol=1e-12)
        st = tgf.state()
        assert st["dispatches"] >= 4 and st["shards"] == NDEV
        assert st["stream_folds"] == 4  # two chunks a slot, per stream

    def test_small_chunks_fall_back(self):
        chunks = [tft.TensorFrame.from_dict({"x": np.arange(4, dtype=np.float64)}) for _ in range(3)]
        with tft.config.override(block_scheduler="global", global_frame_min_rows=1000):
            got = tft.reduce_blocks_stream(_reduce(tft, tdsl, chunks[0], "max"), iter(chunks))
        assert _f(got) == 3.0 and tgf.state()["dispatches"] == 0

    def test_unclassifiable_reduce_disables_sharding_once(self):
        chunks = self._chunks(tft, 5, [64] * 4)
        g = (tdsl.reduce_sum(tft.block(chunks[0], "x", tf_name="x_input"), axes=[0]) + 1.0).named("x")
        with tft.config.override(block_scheduler="on"):
            ref = tft.reduce_blocks_stream(g, iter(chunks))
        ttele.reset()
        with tft.config.override(block_scheduler="global", global_frame_min_rows=1):
            got = tft.reduce_blocks_stream(g, iter(chunks))
        np.testing.assert_allclose(_f(got), _f(ref), rtol=1e-12)
        st = tgf.state()
        assert st["dispatches"] == 0 and st["fallbacks"] == {"unclassified-reduce": 1}
        devs = {s.attrs.get("device") for s in _dispatches(ttele)
                if s.attrs.get("device") and (s.attrs.get("rows") or 0) > 10}
        assert len(devs) >= 2, devs


class TestRuntimeBoundary:
    def test_deadline_enforced_at_dispatch(self):
        _, tdf = _frames(64)
        gf = tdf.to_global()
        with pytest.raises(tft.DeadlineExceeded):
            with tft.deadline_scope(timeout_s=0.01):
                time.sleep(0.05)
                gf.reduce_blocks(_reduce(tft, tdsl, tdf, "min"))

    def test_admission_no_deadlock_under_limit_one(self):
        _, tdf = _frames(64, 4)
        with tft.config.override(max_concurrent_verbs=1):
            out = tdf.to_global().map_blocks((tft.block(tdf, "x") * 2.0).named("z"))
            v = out.reduce_blocks(_reduce(tft, tdsl, out, "min", "z"))
        assert np.isfinite(_f(v))

    def test_check_numerics_names_global_dispatch(self):
        tdf = tft.TensorFrame.from_dict({"x": np.array([1.0, 0.0, 2.0], np.float32)})
        with tft.config.override(check_numerics=True):
            with pytest.raises(FloatingPointError, match="global"):
                tdf.to_global().map_blocks((tft.block(tdf, "x") / 0.0).named("z"))


class TestObservability:
    def test_diagnostics_section_as_jax(self):
        jdf, tdf = _frames(37, 3)
        jg, tg = jdf.to_global(), tdf.to_global()
        jg.reduce_blocks(_reduce(tfs, jdsl, jdf, "min"))
        tg.reduce_blocks(_reduce(tft, tdsl, tdf, "min"))
        sec, jsec = ttele.diagnostics_data()["globalframe"], jtele.diagnostics_data()["globalframe"]
        assert sec == jsec
        assert sec["frames"] == 1 and sec["dispatches"] == 1 and sec["collectives"] == 1
        assert sec["shards"] == NDEV and sec["pad_rows"] == tg.padded_rows - tg.nrows
        text = tft.diagnostics()
        assert "global frames:" in text and f"{NDEV} shard(s)" in text

    def test_fallback_counter_labels(self):
        _, tdf = _frames(32, 2)
        g = (tdsl.reduce_sum(tft.block(tdf, "x", tf_name="x_input"), axes=[0]) + 1.0).named("x")
        tdf.to_global().reduce_blocks(g)
        assert ttele.flat_counters()["global_fallbacks{reason=unclassified-reduce}"] == 1.0

    def test_warm_reruns_lower_nothing(self):
        from tensorframes_tpu_torch.runtime.executor import default_executor

        ex = default_executor()
        _, tdf = _frames(96, 3, seed=1)
        tdf.to_global().reduce_blocks(_reduce(tft, tdsl, tdf, "min"))
        n0 = ex.compile_count
        for n in (97, 99, 101, 103):
            _, df = _frames(n, 3, seed=n)
            df.to_global().reduce_blocks(_reduce(tft, tdsl, df, "min"))
        assert ex.compile_count == n0
