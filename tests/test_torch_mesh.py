"""PyTorch port: the mesh verbs (``mesh=``, `parallel/verbs.py`) held to the
JAX package's `parallel.verbs` on the CPU.

The port's mesh is ``data_mesh(devices=["cpu"] * 8)``, the stand-in for the
JAX package's 8 virtual CPU devices (`tests/conftest.py`); both split the
rows into 8 equal shards and run the remainder as one more block, so the
shard boundaries, and with them every per-shard result, agree. Mirrors
`tests/test_parallel.py`'s classes: map_blocks, map_rows (dense, ragged,
bindings, the function front end), the trimmed map, reduce_blocks,
reduce_rows, aggregate (the sum fast path, the general chunk path,
multi-key, key dtypes), check_numerics, and programs cached by the mesh's
devices. Mean / variance compare with the unmeshed plan and numpy float64:
the JAX package's `test_mean_variance_meshed` fails on this tree.

Tolerances: maps, min, max, integer results and keys exact; float64 sums
rtol 1e-12 against the JAX package's mesh (the same shards summed in
another order) and numpy.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu.parallel import data_mesh as j_data_mesh
from tensorframes_tpu.parallel import shard_to_mesh as j_shard_to_mesh
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.parallel import data_mesh, mesh_2d, shard_to_mesh
from tensorframes_tpu_torch.parallel import verbs as tverbs
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.utils import telemetry
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

from _torch_runtime import reset_port

CPU = "cpu"
F64, F32 = tft.ScalarType.float64, tft.ScalarType.float32


@pytest.fixture(autouse=True)
def _isolated():
    reset_port()
    yield
    reset_port()


@pytest.fixture(scope="module")
def jmesh():
    return j_data_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return data_mesh(devices=["cpu"] * 8)


def _frames(data, num_blocks=1):
    return tfs.TensorFrame.from_dict(data, num_blocks=num_blocks), tft.TensorFrame.from_dict(
        data, num_blocks=num_blocks
    )


def _jv(col):
    return np.asarray(col.values)


def _same_frames(ref, out, rtol=None):
    assert out.columns == ref.columns
    assert [int(o) for o in out.offsets] == [int(o) for o in ref.offsets]
    for c in ref.columns:
        r, o = np.asarray(ref.host_values(c)), out.host_values(c)
        assert (o.shape, o.dtype) == (r.shape, r.dtype), c
        if rtol is None or r.dtype.kind != "f":
            np.testing.assert_array_equal(o, r, err_msg=c)
        else:
            np.testing.assert_allclose(o, r, rtol=rtol, err_msg=c)


def _scalar_ph(d, name, dtype=None, shape=()):
    st = (tfs if d is jdsl else tft).ScalarType.float64 if dtype is None else dtype
    sh = (tfs if d is jdsl else tft).Shape(shape)
    return d.placeholder(st, sh, name=name)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


class TestMesh:
    def test_shape_and_size_mean_what_they_mean_in_jax(self, jmesh, tmesh):
        assert tmesh.devices.size == jmesh.devices.size == 8
        assert tmesh.shape["data"] == jmesh.shape["data"] == 8
        assert tmesh.axis_names == tuple(jmesh.axis_names) == ("data",)
        assert all(d == torch.device("cpu") for d in tmesh.device_list())

    def test_data_mesh_without_a_card_raises(self):
        if torch.cuda.device_count():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="no|none is visible"):
            data_mesh()
        with pytest.raises(RuntimeError, match="none is visible"):
            mesh_2d(1, 1)

    def test_explicit_cuda_devices_without_a_card_raise(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            data_mesh(devices=["cuda:0"])

    def test_mesh_2d(self):
        m = mesh_2d(2, 4, devices=["cpu"] * 8)
        assert m.shape == {"data": 2, "model": 4} and m.devices.shape == (2, 4)
        with pytest.raises(ValueError, match="need 8 devices"):
            mesh_2d(4, 2, devices=["cpu"] * 3)

    def test_equal_meshes_hash_alike(self):
        assert data_mesh(devices=["cpu"] * 2) == data_mesh(devices=["cpu"] * 2)
        assert data_mesh(devices=["cpu"] * 2) != data_mesh(devices=["cpu"] * 3)
        assert len({data_mesh(devices=["cpu"] * 2), data_mesh(devices=["cpu"] * 2)}) == 1

    @pytest.mark.parametrize("n", [16, 19, 3])
    def test_shard_to_mesh_pads_as_jax_does(self, jmesh, tmesh, n):
        arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        shards = shard_to_mesh(tmesh, torch.from_numpy(arr))
        ref = np.asarray(j_shard_to_mesh(jmesh, arr))
        assert len(shards) == 8 and all(s.device == torch.device("cpu") for s in shards)
        np.testing.assert_array_equal(torch.cat(shards).numpy(), ref)
        np.testing.assert_array_equal(torch.cat(shards).numpy()[:n], arr)


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------


class TestMeshMapBlocks:
    @pytest.mark.parametrize("n", [16, 19, 5, 0])
    def test_elementwise_with_and_without_tail(self, jmesh, tmesh, n):
        jdf, tdf = _frames({"x": np.arange(float(n))})
        ref = tfs.map_blocks((tfs.block(jdf, "x") * 2.0 + 1.0).named("z"), jdf, mesh=jmesh)
        out = tft.map_blocks((tft.block(tdf, "x") * 2.0 + 1.0).named("z"), tdf, mesh=tmesh)
        _same_frames(ref, out)
        assert out.columns == ["z", "x"]

    def test_vector_columns(self, jmesh, tmesh):
        jdf, tdf = _frames({"v": np.arange(32.0).reshape(16, 2)})
        ref = tfs.map_blocks((tfs.block(jdf, "v") + 1.0).named("w"), jdf, mesh=jmesh)
        out = tft.map_blocks((tft.block(tdf, "v") + 1.0).named("w"), tdf, mesh=tmesh)
        _same_frames(ref, out)

    def test_block_local_reduction_per_shard(self, jmesh, tmesh):
        # each device is its own block: a block-level sum sees its shard
        jdf, tdf = _frames({"x": np.arange(19.0)})

        def prog(d, pkg, df):
            x = pkg.block(df, "x")
            return (x - d.reduce_sum(x, axes=[0], keep_dims=True) / 2.0).named("c")

        ref = tfs.map_blocks(prog(jdsl, tfs, jdf), jdf, mesh=jmesh)
        out = tft.map_blocks(prog(tdsl, tft, tdf), tdf, mesh=tmesh)
        _same_frames(ref, out)
        want = np.concatenate(
            [np.arange(16.0) - np.repeat(np.arange(16.0).reshape(8, 2).sum(1) / 2.0, 2),
             np.arange(16.0, 19.0) - np.arange(16.0, 19.0).sum() / 2.0]
        )
        np.testing.assert_array_equal(out.host_values("c"), want)

    def test_matches_the_local_verb_on_an_elementwise_graph(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.random.default_rng(0).normal(size=37)},
                                        num_blocks=3)
        z = tdsl.tanh(tft.block(tdf, "x") * 0.5).named("z")
        local = tft.map_blocks(z, tdf, device=CPU)
        meshed = tft.map_blocks(z, tdf, mesh=tmesh)
        np.testing.assert_array_equal(meshed.host_values("z"), local.host_values("z"))

    def test_bytes_passthrough_rides_on_the_host(self, tmesh):
        tdf = tft.TensorFrame.from_dict(
            {"x": np.arange(10.0), "s": np.array([b"a%d" % i for i in range(10)], dtype=object)}
        )
        s = tdsl.identity(tft.block(tdf, "s")).named("s2")
        z = (tft.block(tdf, "x") + 1.0).named("z")
        out = tft.map_blocks([z, s], tdf, mesh=tmesh)
        np.testing.assert_array_equal(out.host_values("z"), np.arange(10.0) + 1.0)
        assert list(out.host_values("s2")) == [b"a%d" % i for i in range(10)]

    def test_dispatch_spans_name_the_shards(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.arange(19.0)})
        telemetry.reset()
        tft.map_blocks((tft.block(tdf, "x") + 3.0).named("z"), tdf, mesh=tmesh)
        disp = [s for s in telemetry.spans() if s.kind == "dispatch"]
        assert [(s.name, s.attrs["shards"], s.attrs["rows"]) for s in disp] == [
            ("mesh.map_blocks", 8, 16), ("mesh.map_blocks.tail", 1, 3),
        ]
        verbs = [s.name for s in telemetry.spans() if s.kind == "verb"]
        assert "mesh.map_blocks" in verbs and "map_blocks" in verbs
        assert telemetry.flat_counters()["mesh.map_blocks.calls"] == 1.0


class TestMeshTrimmedMap:
    def test_trimmed_per_shard_reduction(self, jmesh, tmesh):
        for n in (16, 19):
            jdf, tdf = _frames({"x": np.arange(float(n))})
            ref = tfs.map_blocks(
                jdsl.reduce_sum(tfs.block(jdf, "x"), axes=[0], keep_dims=True).named("s"),
                jdf, trim=True, mesh=jmesh,
            )
            out = tft.map_blocks(
                tdsl.reduce_sum(tft.block(tdf, "x"), axes=[0], keep_dims=True).named("s"),
                tdf, trim=True, mesh=tmesh,
            )
            _same_frames(ref, out)
            assert out.columns == ["s"] and out.nrows == 8 + (n % 8 > 0)


class TestMeshBindings:
    def test_binding_copied_to_every_device(self, jmesh, tmesh):
        for n in (16, 19):
            jdf, tdf = _frames({"x": np.arange(float(n))})
            jw, tw = _scalar_ph(jdsl, "w"), _scalar_ph(tdsl, "w")
            ref = tfs.map_blocks((tfs.block(jdf, "x") * jw).named("z"), jdf, mesh=jmesh,
                                 bindings={"w": np.float64(2.0)})
            out = tft.map_blocks((tft.block(tdf, "x") * tw).named("z"), tdf, mesh=tmesh,
                                 bindings={"w": np.float64(2.0)})
            _same_frames(ref, out)

    def test_binding_set_changes_do_not_reuse_stale_programs(self, jmesh, tmesh):
        data = {"x": np.arange(16.0), "w": np.ones(16)}
        jdf, tdf = _frames(data)
        outs = []
        for pkg, d, df, mesh in ((tfs, jdsl, jdf, jmesh), (tft, tdsl, tdf, tmesh)):
            w = _scalar_ph(d, "w", shape=(None,))
            z = (pkg.block(df, "x") * d.reduce_sum(w, axes=[0])).named("z")
            bound = pkg.map_blocks(z, df, mesh=mesh, bindings={"w": np.ones(8)})
            fed = pkg.map_blocks(z, df, mesh=mesh)
            outs.append((bound, fed))
        for ref, out in zip(outs[0], outs[1]):
            _same_frames(ref, out)
        np.testing.assert_array_equal(outs[1][0].host_values("z"), 8 * np.arange(16.0))
        np.testing.assert_array_equal(outs[1][1].host_values("z"), 2 * np.arange(16.0))


# ---------------------------------------------------------------------------
# map_rows
# ---------------------------------------------------------------------------


class TestMeshMapRows:
    @pytest.mark.parametrize("n", [16, 19, 3, 0])
    def test_elementwise(self, jmesh, tmesh, n):
        jdf, tdf = _frames({"x": np.arange(float(n))})
        ref = tfs.map_rows((_scalar_ph(jdsl, "x") * 2.0 + 1.0).named("y"), jdf, mesh=jmesh)
        out = tft.map_rows((_scalar_ph(tdsl, "x") * 2.0 + 1.0).named("y"), tdf, mesh=tmesh)
        _same_frames(ref, out)

    def test_vector_cells(self, jmesh, tmesh):
        jdf, tdf = _frames({"v": np.arange(38.0).reshape(19, 2)})
        ref = tfs.map_rows(jdsl.reduce_sum(_scalar_ph(jdsl, "v", shape=(2,)), axes=[0]).named("s"),
                           jdf, mesh=jmesh)
        out = tft.map_rows(tdsl.reduce_sum(_scalar_ph(tdsl, "v", shape=(2,)), axes=[0]).named("s"),
                           tdf, mesh=tmesh)
        _same_frames(ref, out)

    def test_multi_fetch_ordering(self, jmesh, tmesh):
        jdf, tdf = _frames({"x": np.arange(10.0)})
        jx, tx = _scalar_ph(jdsl, "x"), _scalar_ph(tdsl, "x")
        ref = tfs.map_rows([(jx - 1.0).named("b"), (jx + 1.0).named("a")], jdf, mesh=jmesh)
        out = tft.map_rows([(tx - 1.0).named("b"), (tx + 1.0).named("a")], tdf, mesh=tmesh)
        _same_frames(ref, out)

    def test_bindings_copied_to_every_device(self, jmesh, tmesh):
        jdf, tdf = _frames({"x": np.arange(19.0)})
        ref = tfs.map_rows((_scalar_ph(jdsl, "x") * _scalar_ph(jdsl, "c")).named("y"), jdf,
                           mesh=jmesh, bindings={"c": np.float64(3.0)})
        out = tft.map_rows((_scalar_ph(tdsl, "x") * _scalar_ph(tdsl, "c")).named("y"), tdf,
                           mesh=tmesh, bindings={"c": np.float64(3.0)})
        _same_frames(ref, out)

    def test_matches_the_local_verb(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.arange(13.0)})
        y = tdsl.tanh(_scalar_ph(tdsl, "x") * 0.5).named("y")
        np.testing.assert_array_equal(
            tft.map_rows(y, tdf, mesh=tmesh).host_values("y"),
            tft.map_rows(y, tdf, device=CPU).host_values("y"),
        )

    def test_ragged_per_shard(self, jmesh, tmesh):
        cells = [np.arange(1 + (i % 3), dtype=np.float32) for i in range(21)]
        jdf, tdf = _frames({"v": cells})
        jv = _scalar_ph(jdsl, "v", tfs.ScalarType.float32, (None,))
        tv = _scalar_ph(tdsl, "v", F32, (None,))
        ref = tfs.map_rows(jdsl.reduce_sum(jv, axes=[0]).named("s"), jdf, mesh=jmesh)
        reset_stats()
        out = tft.map_rows(tdsl.reduce_sum(tv, axes=[0]).named("s"), tdf, mesh=tmesh)
        counts = stats()
        assert counts["map_rows.plan.ragged"] == 1.0
        # 21 rows in 8 shards of 2-3 rows: each shard's buckets
        assert counts["map_rows.ragged.buckets"] >= 8
        np.testing.assert_allclose(out.host_values("s"), _jv(ref["s"]), rtol=1e-6)
        np.testing.assert_allclose(out.host_values("s"), [c.sum() for c in cells], rtol=1e-6)

    def test_ragged_outputs_in_row_order(self, tmesh):
        cells = [np.arange(1 + (i % 4), dtype=np.float64) for i in range(23)]
        tdf = tft.TensorFrame.from_dict({"v": cells})
        tv = _scalar_ph(tdsl, "v", F64, (None,))
        out = tft.map_rows((tv * 2.0).named("w"), tdf, mesh=tmesh)
        local = tft.map_rows((tv * 2.0).named("w"), tdf, device=CPU)
        for a, b, c in zip(out.column("w").ragged, local.column("w").ragged, cells):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c * 2.0)

    def test_a_while_graph_runs_the_vmap_plan_on_every_shard(self, tmesh):
        tf = pytest.importorskip("tensorflow")
        g = tf.compat.v1.Graph()
        with g.as_default():
            x = tf.compat.v1.placeholder(tf.float64, shape=(3,), name="x")
            out = tf.while_loop(lambda v: tf.reduce_sum(v * v) < 1e4, lambda v: v * 2.0 + 1.0, [x])
            tf.identity(out[0], name="y")
        data = g.as_graph_def().SerializeToString()
        xs = np.random.default_rng(2).integers(-5, 6, (21, 3)).astype(np.float64)
        tdf = tft.TensorFrame.from_dict({"x": xs})
        reset_stats()
        got = tft.map_rows(data, tdf, fetch_names=["y"], mesh=tmesh)
        counts = stats()
        assert counts["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in counts
        ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": xs}), fetch_names=["y"],
                           mesh=j_data_mesh())
        np.testing.assert_array_equal(got.host_values("y"), np.asarray(ref["y"].values))


class TestMeshFnFrontEnd:
    def test_map_blocks_fn(self, jmesh, tmesh):
        jdf, tdf = _frames({"x": np.arange(19.0)})
        ref = tfs.map_blocks(lambda x: {"x2": x * 2.0}, jdf, mesh=jmesh)
        out = tft.map_blocks(lambda x: {"x2": x * 2.0}, tdf, mesh=tmesh)
        _same_frames(ref, out)

    def test_map_blocks_fn_trim(self, jmesh, tmesh):
        jdf, tdf = _frames({"x": np.arange(16.0)})
        ref = tfs.map_blocks(lambda x: {"s": x.sum(keepdims=True)}, jdf, mesh=jmesh, trim=True)
        out = tft.map_blocks(lambda x: {"s": x.sum(0, keepdim=True)}, tdf, mesh=tmesh, trim=True)
        _same_frames(ref, out)

    def test_map_blocks_fn_tail_and_bindings(self, jmesh, tmesh):
        jdf, tdf = _frames({"x": np.arange(19.0)})
        ref = tfs.map_blocks(lambda x, c: {"y": x * c}, jdf, mesh=jmesh,
                             bindings={"c": np.float64(4.0)})
        out = tft.map_blocks(lambda x, c: {"y": x * c}, tdf, mesh=tmesh,
                             bindings={"c": np.float64(4.0)})
        _same_frames(ref, out)

    def test_map_rows_fn(self, jmesh, tmesh):
        jdf, tdf = _frames({"x": np.arange(10.0)})
        ref = tfs.map_rows(lambda x: {"sq": x * x}, jdf, mesh=jmesh)
        out = tft.map_rows(lambda x: {"sq": x * x}, tdf, mesh=tmesh)
        _same_frames(ref, out)

    def test_map_rows_fn_over_ragged_cells(self, tmesh):
        cells = [np.arange(1 + (i % 3), dtype=np.float32) for i in range(17)]
        tdf = tft.TensorFrame.from_dict({"v": cells})
        out = tft.map_rows(lambda v: {"s": v.sum()}, tdf, mesh=tmesh)
        np.testing.assert_allclose(out.host_values("s"), [c.sum() for c in cells])

    def test_empty_frame_takes_names_from_a_meta_call(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.zeros(0)})
        out = tft.map_blocks(lambda x: {"y": x + 1.0}, tdf, mesh=tmesh)
        assert out.columns == ["y", "x"] and out.host_values("y").shape == (0,)

    def test_unknown_binding_raises(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.arange(8.0)})
        with pytest.raises(ValueError, match="typo"):
            tft.map_blocks(lambda x: {"y": x}, tdf, mesh=tmesh, bindings={"typo": np.float64(1)})

    @pytest.mark.parametrize("verb", ["map_blocks", "map_rows"])
    def test_an_empty_dict_raises(self, tmesh, verb):
        # the port keeps the local verbs' check on the mesh path
        tdf = tft.TensorFrame.from_dict({"x": np.arange(8.0)})
        with pytest.raises(ValueError, match="empty dict"):
            getattr(tft, verb)(lambda x: {}, tdf, mesh=tmesh)


# ---------------------------------------------------------------------------
# reduce_blocks / reduce_rows
# ---------------------------------------------------------------------------


def _reduce(d, pkg, df, op="sum", col="x"):
    return getattr(d, f"reduce_{op}")(pkg.block(df, col, tf_name=f"{col}_input"),
                                      axes=[0]).named(col)


class TestMeshReduceBlocks:
    @pytest.mark.parametrize("n", [100, 19, 3])
    def test_sum(self, jmesh, tmesh, n):
        jdf, tdf = _frames({"x": np.arange(float(n))})
        ref = tfs.reduce_blocks(_reduce(jdsl, tfs, jdf), jdf, mesh=jmesh)
        out = tft.reduce_blocks(_reduce(tdsl, tft, tdf), tdf, mesh=tmesh)
        assert float(out) == float(ref) == np.arange(float(n)).sum()

    def test_min_exact(self, jmesh, tmesh):
        vals = np.random.RandomState(7).rand(53)
        jdf, tdf = _frames({"x": vals})
        out = tft.reduce_blocks(_reduce(tdsl, tft, tdf, "min"), tdf, mesh=tmesh)
        assert float(out) == float(tfs.reduce_blocks(_reduce(jdsl, tfs, jdf, "min"), jdf,
                                                     mesh=jmesh)) == vals.min()

    def test_vector_cells(self, jmesh, tmesh):
        jdf, tdf = _frames({"v": np.random.default_rng(1).normal(size=(27, 2))})
        ref = tfs.reduce_blocks(_reduce(jdsl, tfs, jdf, col="v"), jdf, mesh=jmesh)
        out = tft.reduce_blocks(_reduce(tdsl, tft, tdf, col="v"), tdf, mesh=tmesh)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)

    @pytest.mark.parametrize("n", [16, 19])
    def test_multi_fetch_results_not_swapped(self, jmesh, tmesh, n):
        data = {"x": np.arange(float(n), dtype=np.float32), "n": np.ones(n, np.int32)}
        jdf, tdf = _frames(data)
        ref = tfs.reduce_blocks([_reduce(jdsl, tfs, jdf), _reduce(jdsl, tfs, jdf, col="n")], jdf,
                                mesh=jmesh)
        out = tft.reduce_blocks([_reduce(tdsl, tft, tdf), _reduce(tdsl, tft, tdf, col="n")], tdf,
                                mesh=tmesh)
        assert float(out["x"]) == float(ref["x"]) == float(np.arange(n).sum())
        assert int(out["n"]) == int(ref["n"]) == n
        assert out["n"].dtype == torch.int32

    def test_equals_the_local_verb_on_integers(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.arange(1001, dtype=np.int64)}, num_blocks=3)
        g = _reduce(tdsl, tft, tdf, "max")
        assert int(tft.reduce_blocks(g, tdf, mesh=tmesh)) == int(
            tft.reduce_blocks(g, tdf, device=CPU)
        ) == 1000


def _pair(d, pkg, combine):
    x1 = _scalar_ph(d, "x_1")
    x2 = _scalar_ph(d, "x_2")
    return combine(d, x1, x2).named("x")


class TestMeshReduceRows:
    @pytest.mark.parametrize("n", [40, 21, 8, 32])
    def test_fold_sum(self, jmesh, tmesh, n):
        jdf, tdf = _frames({"x": np.arange(float(n))})
        reset_stats()
        out = tft.reduce_rows(_pair(tdsl, tft, lambda d, a, b: d.add(a, b)), tdf, mesh=tmesh)
        assert stats()["reduce_rows.plan.monoid"] == 1.0
        ref = tfs.reduce_rows(_pair(jdsl, tfs, lambda d, a, b: d.add(a, b)), jdf, mesh=jmesh)
        assert float(out) == float(ref) == np.arange(float(n)).sum()

    @pytest.mark.parametrize("n", [40, 21])
    def test_non_associative_fold_in_shard_order(self, jmesh, tmesh, n):
        vals = np.random.default_rng(3).normal(size=n)
        jdf, tdf = _frames({"x": vals})
        reset_stats()
        out = tft.reduce_rows(_pair(tdsl, tft, lambda d, a, b: a * 0.5 + b), tdf, mesh=tmesh)
        assert stats()["reduce_rows.plan.general"] == 1.0
        ref = tfs.reduce_rows(_pair(jdsl, tfs, lambda d, a, b: a * 0.5 + b), jdf, mesh=jmesh)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-12)
        # each shard folds left, then the shard partials, then the tail
        s = n // 8
        parts = []
        for lo, hi in [(d * s, (d + 1) * s) for d in range(8)]:
            acc = vals[lo]
            for v in vals[lo + 1:hi]:
                acc = 0.5 * acc + v
            parts.append(acc)
        main = parts[0]
        for p in parts[1:]:
            main = 0.5 * main + p
        if n % 8:
            tail = vals[8 * s]
            for v in vals[8 * s + 1:]:
                tail = 0.5 * tail + v
            main = 0.5 * main + tail
        np.testing.assert_allclose(float(out), main, rtol=1e-12)


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------


def _agg_both(data, keys, prog, jmesh, tmesh, feed_dict=None):
    jdf, tdf = _frames(data)
    ref = tfs.aggregate(prog(jdsl, tfs, jdf), tfs.group_by(jdf, *keys), mesh=jmesh,
                        feed_dict=feed_dict)
    reset_stats()
    telemetry.reset()
    out = tft.aggregate(prog(tdsl, tft, tdf), tft.group_by(tdf, *keys), mesh=tmesh,
                        feed_dict=feed_dict)
    return ref, out


class TestMeshAggregate:
    @pytest.mark.parametrize("n", [64, 67])
    def test_segment_sum_fast_path(self, jmesh, tmesh, n):
        rng = np.random.RandomState(0)
        data = {"key": rng.randint(0, 7, size=n).astype(np.int64), "x": rng.rand(n)}
        ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df), jmesh, tmesh)
        _same_frames(ref, out, rtol=1e-12)
        spans = [s for s in telemetry.spans() if s.kind == "dispatch"]
        assert spans[0].name == "mesh.aggregate.segment" and spans[0].attrs["shards"] == 8
        for k, s in zip(out.host_values("key"), out.host_values("x")):
            np.testing.assert_allclose(s, data["x"][data["key"] == k].sum(), rtol=1e-12)

    def test_vector_cells_fast_path(self, jmesh, tmesh):
        data = {"key": np.arange(32, dtype=np.int64) % 4, "v": np.arange(64.0).reshape(32, 2)}
        ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df, col="v"),
                             jmesh, tmesh)
        _same_frames(ref, out)

    def test_min_general_path(self, jmesh, tmesh):
        data = {"key": np.array([0, 0, 1, 1], np.int64), "x": np.array([3.0, 1.0, 7.0, 5.0])}
        ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df, "min"),
                             jmesh, tmesh)
        _same_frames(ref, out)
        assert dict(zip(out.host_values("key").tolist(), out.host_values("x").tolist())) == {
            0: 1.0, 1: 5.0}

    def test_min_graph_large_in_one_segment_call(self, jmesh, tmesh):
        rng = np.random.default_rng(3)
        data = {"key": rng.integers(0, 37, 2048).astype(np.int64), "x": rng.normal(size=2048)}
        ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df, "min"),
                             jmesh, tmesh)
        _same_frames(ref, out)
        calls = [s for s in telemetry.spans() if s.kind == "dispatch"]
        assert [(s.name, s.attrs["shards"], s.attrs["rows"]) for s in calls] == [
            ("mesh.aggregate.segment", 8, 2048)]
        assert "aggregate.plan.chunk" not in stats()

    @pytest.mark.parametrize("op,sign", [("max", -1.0), ("min", 1.0)])
    def test_groups_missing_from_shards_combine_by_identity(self, jmesh, tmesh, op, sign):
        # sorted keys: each shard holds a few groups only, so every other
        # shard's table has the monoid's identity in that group's entry (a
        # zero there would win a max of negatives or a min of positives)
        n = 45
        rng = np.random.default_rng(11)
        data = {"key": np.sort(rng.integers(0, 5, n)).astype(np.int64),
                "x": sign * rng.uniform(0.5, 2.0, n)}
        ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df, op),
                             jmesh, tmesh)
        _same_frames(ref, out, rtol=1e-12)
        fn = {"max": np.max, "min": np.min}[op]
        for k, v in zip(out.host_values("key"), out.host_values("x")):
            np.testing.assert_allclose(v, fn(data["x"][data["key"] == k]), rtol=1e-12)

    def test_segment_fast_off_keeps_the_mesh_plan(self, jmesh, tmesh):
        rng = np.random.default_rng(12)
        data = {"key": rng.integers(0, 40, 600).astype(np.int64), "x": rng.normal(size=600)}
        with tft.config.override(aggregate_segment_fast=False, aggregate_exact_size_limit=1):
            ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df, "min"),
                                 jmesh, tmesh)
        _same_frames(ref, out)
        assert [s.name for s in telemetry.spans() if s.kind == "dispatch"] == [
            "mesh.aggregate.segment"]

    def test_mean_of_transform(self, jmesh, tmesh):
        rng = np.random.default_rng(6)
        data = {"key": rng.integers(0, 11, 1000).astype(np.int64), "x": rng.normal(size=1000)}

        def prog(d, p, df):
            return d.reduce_mean(p.block(df, "x", tf_name="x_input") * 2.0 + 1.0,
                                 axes=[0]).named("x")

        ref, out = _agg_both(data, ["key"], prog, jmesh, tmesh)
        _same_frames(ref, out, rtol=1e-12)
        for k, v in zip(out.host_values("key"), out.host_values("x")):
            np.testing.assert_allclose(v, (data["x"][data["key"] == k] * 2 + 1).mean(), rtol=1e-12)

    def test_mean_and_variance_against_the_unmeshed_plan(self, tmesh):
        # the JAX package's meshed version of this fails on this tree: hold
        # the port's mesh to its own unmeshed plan and to numpy float64
        rng = np.random.default_rng(4)
        keys = rng.integers(0, 9, 500).astype(np.int64)
        vals = rng.normal(size=500)
        tdf = tft.TensorFrame.from_dict({"key": keys, "x": vals})
        sq = tft.map_blocks(lambda x: {"x2": x * x, "cnt": x * 0 + 1.0}, tdf, device=CPU)
        fetches = [_reduce(tdsl, tft, sq, col=c) for c in ("x", "x2", "cnt")]
        meshed = tft.aggregate(fetches, tft.group_by(sq, "key"), mesh=tmesh)
        local = tft.aggregate(fetches, tft.group_by(sq, "key"), device=CPU)
        for c in ("key", "cnt", "x", "x2"):
            np.testing.assert_allclose(meshed.host_values(c), local.host_values(c), rtol=1e-12)
        for k, s1, s2, n in zip(*(meshed.host_values(c) for c in ("key", "x", "x2", "cnt"))):
            sel = vals[keys == k]
            np.testing.assert_allclose(s1 / n, sel.mean(), rtol=1e-9)
            np.testing.assert_allclose(s2 / n - (s1 / n) ** 2, sel.var(), rtol=1e-8)

    def test_mixed_sum_min_general_path(self, jmesh, tmesh):
        rng = np.random.default_rng(5)
        vals = rng.normal(size=777)
        data = {"key": rng.integers(0, 13, 777).astype(np.int64), "x": vals, "y": vals * 2.0}
        ref, out = _agg_both(
            data, ["key"],
            lambda d, p, df: [_reduce(d, p, df), _reduce(d, p, df, "min", col="y")], jmesh, tmesh,
        )
        _same_frames(ref, out, rtol=1e-12)

    def test_unclassified_graph_takes_the_exact_plan(self, jmesh, tmesh):
        rng = np.random.default_rng(8)
        data = {"key": rng.integers(0, 6, 90).astype(np.int64), "x": rng.normal(size=90) + 5}

        def prog(d, p, df):
            xi = p.block(df, "x", tf_name="x_input")
            return (d.reduce_sum(xi, axes=[0]) / d.reduce_max(xi, axes=[0])).named("x")

        ref, out = _agg_both(data, ["key"], prog, jmesh, tmesh)
        assert stats()["aggregate.plan.exact"] == 1.0
        _same_frames(ref, out, rtol=1e-12)

    @pytest.mark.parametrize("op", ["sum", "min"])
    def test_empty_frame(self, jmesh, tmesh, op):
        data = {"key": np.zeros(0, np.int64), "x": np.zeros(0)}
        ref, out = _agg_both(data, ["key"], lambda d, p, df: _reduce(d, p, df, op), jmesh, tmesh)
        assert out.nrows == ref.nrows == 0 and out.columns == ref.columns

    def test_string_keys(self, jmesh, tmesh):
        data = {"k": np.array(list("abca") * 4, dtype=object), "x": np.arange(16.0)}
        ref, out = _agg_both(data, ["k"], lambda d, p, df: _reduce(d, p, df), jmesh, tmesh)
        assert [str(v) for v in out.host_values("k")] == [str(v) for v in ref["k"].host_values()]
        np.testing.assert_array_equal(out.host_values("x"), _jv(ref["x"]))

    def test_two_keys(self, jmesh, tmesh):
        data = {"a": np.tile([0, 1], 8), "b": np.repeat([0, 1], 8), "x": np.arange(16.0)}
        ref, out = _agg_both(data, ["a", "b"], lambda d, p, df: _reduce(d, p, df), jmesh, tmesh)
        _same_frames(ref, out)

    @pytest.mark.parametrize("key_dtype", [np.int32, np.int64, np.uint8])
    def test_key_and_value_dtypes(self, jmesh, tmesh, key_dtype):
        rng = np.random.default_rng(9)
        data = {"k": rng.integers(0, 5, 50).astype(key_dtype),
                "x": rng.integers(-9, 9, 50).astype(np.int32)}
        ref, out = _agg_both(data, ["k"], lambda d, p, df: _reduce(d, p, df), jmesh, tmesh)
        _same_frames(ref, out)
        assert out.host_values("k").dtype == np.dtype(key_dtype)


# ---------------------------------------------------------------------------
# numerics, caching, arguments
# ---------------------------------------------------------------------------


class TestMeshCheckNumerics:
    def test_nan_raises_on_the_mesh_map(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.array([1.0, np.nan] * 8, np.float32)})
        with tft.config.override(check_numerics=True):
            with pytest.raises(FloatingPointError, match="mesh"):
                tft.map_blocks((tft.block(tdf, "x") + 1.0).named("z"), tdf, mesh=tmesh)

    def test_inf_raises_on_the_mesh_reduce(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"x": np.array([1.0, np.inf] * 8, np.float32)})
        with tft.config.override(check_numerics=True):
            with pytest.raises(FloatingPointError, match="mesh"):
                tft.reduce_blocks(_reduce(tdsl, tft, tdf), tdf, mesh=tmesh)

    def test_nan_raises_on_the_mesh_aggregate_and_fold(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"k": np.arange(16) % 2, "x": np.array([1.0, np.nan] * 8)})
        with tft.config.override(check_numerics=True):
            with pytest.raises(FloatingPointError, match="mesh"):
                tft.aggregate(_reduce(tdsl, tft, tdf), tft.group_by(tdf, "k"), mesh=tmesh)
            with pytest.raises(FloatingPointError, match="mesh"):
                tft.reduce_rows(_pair(tdsl, tft, lambda d, a, b: d.add(a, b)), tdf, mesh=tmesh)


class TestMeshCaching:
    def test_programs_are_keyed_by_the_mesh_devices(self):
        ex = Executor()
        tdf = tft.TensorFrame.from_dict({"x": np.arange(16.0)})
        z = (tft.block(tdf, "x") + 3.0).named("z")
        m8, m4 = data_mesh(devices=["cpu"] * 8), data_mesh(devices=["cpu"] * 4)
        tft.map_blocks(z, tdf, mesh=m8, executor=ex)
        before = ex.compile_count
        tft.map_blocks(z, tdf, mesh=m8, executor=ex)
        assert ex.compile_count == before  # a rerun lowers nothing
        tft.map_blocks(z, tdf, mesh=m4, executor=ex)
        kinds = sorted({k[0] for k in ex.cache_keys()})
        assert kinds == [f"shmap-{tverbs._mesh_sig(m4)}", f"shmap-{tverbs._mesh_sig(m8)}"]
        assert tverbs._mesh_sig(m8) == "8@" + ",".join(["cpu:0"] * 8)

    @pytest.mark.parametrize("verb", ["aggregate", "reduce_rows", "reduce_blocks", "map_rows"])
    def test_reruns_lower_nothing(self, tmesh, verb):
        ex = Executor()
        tdf = tft.TensorFrame.from_dict({"k": np.tile([0, 1], 8), "x": np.arange(16.0)})
        call = {
            "aggregate": lambda: tft.aggregate(_reduce(tdsl, tft, tdf), tft.group_by(tdf, "k"),
                                               mesh=tmesh, executor=ex),
            "reduce_rows": lambda: tft.reduce_rows(
                _pair(tdsl, tft, lambda d, a, b: a * 0.5 + b), tdf, mesh=tmesh, executor=ex),
            "reduce_blocks": lambda: tft.reduce_blocks(_reduce(tdsl, tft, tdf), tdf, mesh=tmesh,
                                                       executor=ex),
            "map_rows": lambda: tft.map_rows((_scalar_ph(tdsl, "x") * 2.0).named("y"), tdf,
                                             mesh=tmesh, executor=ex),
        }[verb]
        call()
        before = ex.compile_count
        for _ in range(2):
            call()
        assert ex.compile_count == before


class TestMeshArguments:
    def test_mesh_and_device_together_raise(self, tmesh):
        tdf = tft.TensorFrame.from_dict({"k": np.arange(4) % 2, "x": np.arange(4.0)})
        z = (tft.block(tdf, "x") + 1.0).named("z")
        for call in (
            lambda: tft.map_blocks(z, tdf, mesh=tmesh, device=CPU),
            lambda: tft.map_rows((_scalar_ph(tdsl, "x") + 1.0).named("y"), tdf, mesh=tmesh,
                                 device=CPU),
            lambda: tft.reduce_blocks(_reduce(tdsl, tft, tdf), tdf, mesh=tmesh, device=CPU),
            lambda: tft.reduce_rows(_pair(tdsl, tft, lambda d, a, b: d.add(a, b)), tdf,
                                    mesh=tmesh, device=CPU),
            lambda: tft.aggregate(_reduce(tdsl, tft, tdf), tft.group_by(tdf, "k"), mesh=tmesh,
                                  device=CPU),
        ):
            with pytest.raises(ValueError, match="mesh= or device="):
                call()

    def test_mesh_on_a_lazy_plan_raises(self, tmesh):
        # mesh= on a lazy plan runs the plan's mesh route (the fused chain
        # once a shard) and equals the eager mesh verb over the forced
        # frame; only a second placement beside it still raises
        tdf = tft.TensorFrame.from_dict({"k": np.arange(19) % 2, "x": np.arange(19.0)})
        lf = tdf.lazy().map_blocks((tft.block(tdf, "x") + 1.0).named("z"))
        eager = lf.force(device=CPU)
        pairs = (
            (lambda f: tft.map_blocks((tft.block(lf, "z") * 2.0).named("w"), f, mesh=tmesh), "w"),
            (lambda f: tft.map_rows((_scalar_ph(tdsl, "z") + 1.0).named("y"), f, mesh=tmesh), "y"),
        )
        for call, col in pairs:
            got, ref = call(lf), call(eager)
            if isinstance(got, tft.LazyFrame):
                got = got.force()
            np.testing.assert_array_equal(got.host_values(col), ref.host_values(col))
        for call in (
            lambda f: tft.reduce_blocks(_reduce(tdsl, tft, f, col="z"), f, mesh=tmesh),
            lambda f: tft.reduce_rows(_pair(tdsl, tft, lambda d, a, b: d.add(a, b)), f,
                                      mesh=tmesh, feed_dict={"x_1": "z", "x_2": "z"}),
        ):
            assert float(call(lf)) == float(call(eager))
        out = tft.aggregate(_reduce(tdsl, tft, lf, col="z"), tft.group_by(lf, "k"), mesh=tmesh)
        ref = tft.aggregate(_reduce(tdsl, tft, eager, col="z"), tft.group_by(eager, "k"),
                            mesh=tmesh)
        np.testing.assert_array_equal(out.host_values("z"), ref.host_values("z"))
        np.testing.assert_array_equal(lf.force(mesh=tmesh).host_values("z"),
                                      eager.host_values("z"))
        for call in (
            lambda: lf.force(mesh=tmesh, device=CPU),
            lambda: tft.reduce_blocks(_reduce(tdsl, tft, lf, col="z"), lf, mesh=tmesh,
                                      device=CPU),
        ):
            with pytest.raises(ValueError, match="mesh= or device="):
                call()

    def test_the_jax_mesh_verbs_and_the_ports_take_the_same_arguments(self):
        import inspect

        from tensorframes_tpu.parallel import verbs as jverbs

        for name in ("map_blocks", "map_rows", "reduce_blocks", "reduce_rows", "aggregate"):
            jp = list(inspect.signature(getattr(jverbs, name)).parameters)
            tp = list(inspect.signature(getattr(tverbs, name)).parameters)
            assert tp == jp, name
