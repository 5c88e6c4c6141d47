"""PyTorch port: ragged rows through `map_rows`, the dense-column check of
the block-level verbs, and bytes pass-through, held to the JAX package on
the CPU.

Mirrors `tests/test_verbs.py::TestRaggedMapRowsBucketed`, the ragged cases
of `TestMapRows`, `TestBytesCells` and the empty-frame cases. The port
groups rows by cell shape and runs one call per group (counted:
``map_rows.plan.ragged``, ``map_rows.ragged.buckets``); an output whose
groups agree on its cell shape is a dense tensor on the verb's device, any
other is ragged host cells. Tolerances: elementwise results, max/min,
integers and strings exact; float64 per-row sums rtol 1e-12 and float32
rtol 1e-6 (another summation order).
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

CPU = "cpu"
_RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-6}


def _ragged_data(n, shapes=((2,), (5,), (3,)), seed=0, dtype=np.float64, positive=False):
    """Cells of the given shapes in turn; ``positive`` draws them from
    [0.5, 1.5), so that sums have no cancellation and a relative tolerance
    bounds their rounding."""
    rng = np.random.default_rng(seed)
    draw = (lambda s: rng.uniform(0.5, 1.5, s)) if positive else (lambda s: rng.normal(size=s))
    return [draw(shapes[i % len(shapes)]).astype(dtype) for i in range(n)]


def _frames(data, **kw):
    return tfs.TensorFrame.from_dict(data, **kw), tft.TensorFrame.from_dict(data, **kw)


def _assert_column_matches(port_col, ref_col, exact=True):
    assert port_col.is_dense == ref_col.is_dense
    if port_col.is_dense:
        got, want = port_col.host_values(), np.asarray(ref_col.values)
        assert got.dtype == want.dtype and got.shape == want.shape
        if exact or want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=_RTOL[want.dtype], atol=0)
        return
    assert repr(port_col.cell_shape) == repr(ref_col.cell_shape)
    for got, want in zip(port_col.rows(), ref_col.rows()):
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _sum_graph(d, f, col="v"):
    return d.reduce_sum(d.row(f, col), axes=[0]).named("s")


class TestRaggedGraphMapRows:
    def test_ragged_rows(self):
        jdf, tdf = _frames({"v": [np.arange(2.0), np.arange(5.0)]})
        ref = tfs.map_rows(_sum_graph(jdsl, jdf), jdf)
        out = tft.map_rows(_sum_graph(tdsl, tdf), tdf, device=CPU)
        np.testing.assert_array_equal(out.host_values("s"), [1.0, 10.0])
        _assert_column_matches(out["s"], ref["s"])

    @pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
    @pytest.mark.parametrize("num_blocks", [1, 3])
    def test_dense_output_matches_per_row_semantics(self, dtype, num_blocks):
        data = {"v": _ragged_data(50, dtype=dtype, positive=True)}
        if np.issubdtype(dtype, np.integer):
            data = {"v": [(c * 10).astype(dtype) for c in _ragged_data(50)]}
        jdf, tdf = _frames(data, num_blocks=num_blocks)
        ref = tfs.map_rows(_sum_graph(jdsl, jdf), jdf)
        reset_stats()
        out = tft.map_rows(_sum_graph(tdsl, tdf), tdf, device=CPU)
        assert stats() == {
            "map_rows.plan.vmap": 1.0, "map_rows.plan.ragged": 1.0, "map_rows.ragged.buckets": 3,
        }
        # one output cell shape in every bucket: a dense tensor on the device
        assert isinstance(out["s"].values, torch.Tensor)
        _assert_column_matches(out["s"], ref["s"], exact=False)
        want = [np.asarray(c).sum(dtype=np.float64) for c in data["v"]]
        np.testing.assert_allclose(out.host_values("s"), want, rtol=1e-6)

    def test_ragged_output_column(self):
        jdf, tdf = _frames({"v": [np.arange(2.0), np.arange(3.0)]})
        ref = tfs.map_rows((tfs.row(jdf, "v") * 2.0).named("w"), jdf)
        out = tft.map_rows((tft.row(tdf, "v") * 2.0).named("w"), tdf, device=CPU)
        assert not out["w"].is_dense
        np.testing.assert_array_equal(out["w"].row(1), [0.0, 2.0, 4.0])
        _assert_column_matches(out["w"], ref["w"])
        assert out.columns == ref.columns

    @pytest.mark.parametrize("dtype", [np.float32, np.int64])
    def test_row_order_preserved_in_ragged_output(self, dtype):
        data = {"v": [(c * 7).astype(dtype) for c in _ragged_data(17)], "k": np.arange(17)}
        jdf, tdf = _frames(data, num_blocks=4)
        ref = tfs.map_rows((tfs.row(jdf, "v") * 2).named("w"), jdf)
        out = tft.map_rows((tft.row(tdf, "v") * 2).named("w"), tdf, device=CPU)
        for i in range(17):
            np.testing.assert_array_equal(out["w"].row(i), np.asarray(data["v"][i]) * 2)
        _assert_column_matches(out["w"], ref["w"])
        _assert_column_matches(out["k"], ref["k"])

    def test_bucket_count_is_the_number_of_cell_shapes(self):
        # 4 distinct lengths over 1000 rows of uneven bucket sizes: one call
        # per length (the JAX package bounds its compiles the same way)
        rng = np.random.default_rng(1)
        lens = [1 + (i * i) % 4 for i in range(1000)]
        data = {"v": [rng.uniform(0.5, 1.5, n) for n in lens]}
        jdf, tdf = _frames(data)
        reset_stats()
        out = tft.map_rows(_sum_graph(tdsl, tdf), tdf, device=CPU)
        assert stats()["map_rows.ragged.buckets"] == len(set(lens))
        _assert_column_matches(out["s"], tfs.map_rows(_sum_graph(jdsl, jdf), jdf)["s"], exact=False)

    def test_rank2_cells_and_two_ragged_columns(self):
        rng = np.random.default_rng(2)
        a = [rng.uniform(0.5, 1.5, (1 + i % 3, 2)) for i in range(12)]
        b = [rng.uniform(0.5, 1.5, 1 + i % 2) for i in range(12)]
        jdf, tdf = _frames({"a": a, "b": b, "c": np.arange(12.0)}, num_blocks=2)

        def prog(d, f):
            ra = d.reduce_sum(d.row(f, "a"), axes=[0])
            return (d.reduce_sum(ra, axes=[0]) + d.reduce_max(d.row(f, "b"), axes=[0])
                    + d.row(f, "c")).named("y")

        ref = tfs.map_rows(prog(jdsl, jdf), jdf)
        reset_stats()
        out = tft.map_rows(prog(tdsl, tdf), tdf, device=CPU)
        assert stats()["map_rows.ragged.buckets"] == 6  # 3 shapes of a x 2 of b
        _assert_column_matches(out["y"], ref["y"], exact=False)

    def test_bucket_outputs_that_differ_stay_ragged(self):
        # the first bucket's output has one cell shape, the others another:
        # the column must be ragged, never stacked
        data = {"v": [np.arange(3.0), np.arange(3.0) + 1, np.arange(4.0)]}
        jdf, tdf = _frames(data)

        def prog(d, f):
            v = d.row(f, "v")
            return d.concat([v, v], axis=0).named("w")

        ref = tfs.map_rows(prog(jdsl, jdf), jdf)
        out = tft.map_rows(prog(tdsl, tdf), tdf, device=CPU)
        assert not out["w"].is_dense
        assert [c.shape for c in out["w"].rows()] == [(6,), (6,), (8,)]
        _assert_column_matches(out["w"], ref["w"])

    def test_cond_over_a_ragged_row(self):
        tf = pytest.importorskip("tensorflow")
        tf1 = tf.compat.v1
        g = tf1.Graph()
        with g.as_default():
            v = tf1.placeholder(tf.float64, shape=(None,), name="v")
            y = tf.cond(tf.reduce_sum(v) > 0.0, lambda: v * 2.0, lambda: -v)
            tf.identity(tf.reduce_max(y), name="m")
            tf.identity(y, name="y")
        data = g.as_graph_def().SerializeToString()
        cols = {"v": _ragged_data(20, seed=5)}
        jdf, tdf = _frames(cols, num_blocks=2)
        ref = tfs.map_rows(data, jdf, fetch_names=["m", "y"])
        reset_stats()
        out = tft.map_rows(data, tdf, fetch_names=["m", "y"], device=CPU)
        assert stats()["map_rows.plan.ragged"] == 1.0
        assert stats()["map_rows.ragged.buckets"] == 3
        _assert_column_matches(out["m"], ref["m"])
        _assert_column_matches(out["y"], ref["y"])
        for c, m in zip(cols["v"], out.host_values("m")):
            assert m == (c * 2.0 if c.sum() > 0 else -c).max()

    def test_bindings_with_ragged_refused(self):
        for mod, d in ((tft, tdsl), (tfs, jdsl)):
            df = mod.TensorFrame.from_dict({"v": [np.arange(2.0), np.arange(3.0)]})
            w = d.placeholder(d.ScalarType.float64, d.Shape(()), name="w")
            kw = {"device": CPU} if mod is tft else {}
            with pytest.raises(ValueError, match="ragged feed"):
                mod.map_rows((mod.row(df, "v") * w).named("y"), df,
                             bindings={"w": np.float64(2.0)}, **kw)
            with pytest.raises(ValueError, match="ragged feed"):
                mod.map_rows(lambda v, w: {"y": v * w}, df, bindings={"w": np.float64(2.0)}, **kw)

    def test_zero_row_ragged_frame(self):
        for mod in (tft, tfs):
            df = mod.TensorFrame(
                [mod.Column("v", [], dtype=mod.ScalarType.float64)], offsets=[0, 0]
            ).append_shape("v", mod.Shape((None,)))
            assert not df["v"].is_dense
        jdf = tfs.TensorFrame([tfs.Column("v", [], dtype=tfs.ScalarType.float64)], offsets=[0, 0])
        jdf = jdf.append_shape("v", tfs.Shape((None,)))
        tdf = tft.TensorFrame([tft.Column("v", [], dtype=tft.ScalarType.float64)], offsets=[0, 0])
        tdf = tdf.append_shape("v", tft.Shape((None,)))
        ref = tfs.map_rows(_sum_graph(jdsl, jdf), jdf)
        out = tft.map_rows(_sum_graph(tdsl, tdf), tdf, device=CPU)
        assert out.columns == ref.columns
        got = out["s"].values
        assert isinstance(got, torch.Tensor) and tuple(got.shape) == (0,)
        assert got.dtype == torch.float64 and np.asarray(ref["s"].values).shape == (0,)


class TestRaggedFunctionMapRows:
    def test_fn_frontend_ragged(self):
        data = {"v": _ragged_data(23)}
        jdf, tdf = _frames(data, num_blocks=2)
        ref = tfs.map_rows(lambda v: {"m": v.max()}, jdf)
        reset_stats()
        out = tft.map_rows(lambda v: {"m": v.max()}, tdf, device=CPU)
        assert stats() == {"map_rows.plan.ragged": 1.0, "map_rows.ragged.buckets": 3}
        _assert_column_matches(out["m"], ref["m"])
        want = [float(np.asarray(c).max()) for c in data["v"]]
        np.testing.assert_array_equal(out.host_values("m"), want)

    def test_fn_ragged_and_dense_outputs_together(self):
        data = {"v": _ragged_data(11, dtype=np.float32, positive=True),
                "x": np.arange(11, dtype=np.float32)}
        jdf, tdf = _frames(data, num_blocks=3)

        def fn(v, x):
            return {"w": v * x, "n": v.sum() + x}

        ref = tfs.map_rows(fn, jdf)
        out = tft.map_rows(fn, tdf, device=CPU)
        assert out.columns == ref.columns
        _assert_column_matches(out["w"], ref["w"])
        _assert_column_matches(out["n"], ref["n"], exact=False)

    def test_fn_zero_row_ragged_frame(self):
        jdf = tfs.TensorFrame([tfs.Column("x", [], dtype=tfs.ScalarType.float64)], offsets=[0, 0])
        tdf = tft.TensorFrame([tft.Column("x", [], dtype=tft.ScalarType.float64)], offsets=[0, 0])
        ref = tfs.map_rows(lambda x: {"z": x + 1}, jdf)
        out = tft.map_rows(lambda x: {"z": x + 1}, tdf, device=CPU)
        assert np.asarray(ref["z"].values).shape == (0,)
        assert tuple(out["z"].values.shape) == (0,) and out["z"].values.dtype == torch.float64

    def test_bfloat16_ragged_output_cells(self):
        import ml_dtypes

        cells = [np.arange(n, dtype=np.float32).astype(ml_dtypes.bfloat16) for n in (2, 3, 2)]
        tdf = tft.TensorFrame.from_dict({"v": cells})
        out = tft.map_rows(lambda v: {"w": v + v}, tdf, device=CPU)
        assert not out["w"].is_dense
        for got, c in zip(out["w"].rows(), cells):
            assert got.dtype == c.dtype
            np.testing.assert_array_equal(got.astype(np.float32), c.astype(np.float32) * 2)


def _ragged_frame(mod):
    return mod.TensorFrame.from_dict(
        {"v": [np.arange(2.0), np.arange(3.0)], "x": np.arange(2.0), "k": np.arange(2)}
    )


def _block_level_calls(mod, d, df):
    kw = {"device": CPU} if mod is tft else {}
    vi = mod.block(df, "v", tf_name="v_input")
    s = d.reduce_sum(vi, axes=[0]).named("v")
    v1 = d.placeholder(d.ScalarType.float64, d.Shape((None,)), name="v_1")
    v2 = d.placeholder(d.ScalarType.float64, d.Shape((None,)), name="v_2")
    return {
        "map_blocks": lambda: mod.map_blocks((mod.block(df, "v") * 2.0).named("z"), df, **kw),
        "map_blocks_fn": lambda: mod.map_blocks(lambda v: {"z": v * 2.0}, df, **kw),
        "reduce_blocks": lambda: mod.reduce_blocks(s, df, **kw),
        "reduce_rows": lambda: mod.reduce_rows((v1 + v2).named("v"), df, **kw),
        "aggregate": lambda: mod.aggregate(s, mod.group_by(df, "k"), **kw),
    }


@pytest.mark.parametrize(
    "verb", ["map_blocks", "map_blocks_fn", "reduce_blocks", "reduce_rows", "aggregate"]
)
def test_block_level_verbs_require_dense_columns(verb):
    messages = []
    for mod, d in ((tfs, jdsl), (tft, tdsl)):
        with pytest.raises(ValueError, match="is ragged") as err:
            _block_level_calls(mod, d, _ragged_frame(mod))[verb]()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


class TestBytesCells:
    """Bytes and string cells through the map verbs: one scalar cell per
    row, an identity pass-through, never computed on."""

    def _frame(self, mod):
        return mod.TensorFrame([
            mod.Column("tag", [b"a", b"bb", b"ccc"], mod.ScalarType.string),
            mod.Column("x", np.arange(3.0)),
        ])

    def _tag(self, d, name="tag"):
        return d.placeholder(d.ScalarType.string, d.Shape(()), name=name)

    def test_map_blocks_passthrough_with_compute(self):
        jdf, tdf = self._frame(tfs), self._frame(tft)
        ref = tfs.map_blocks(
            [(tfs.block(jdf, "x") + 1.0).named("z"), jdsl.identity(self._tag(jdsl)).named("t")], jdf)
        out = tft.map_blocks(
            [(tft.block(tdf, "x") + 1.0).named("z"), tdsl.identity(self._tag(tdsl)).named("t")],
            tdf, device=CPU)
        assert out.columns == ref.columns == ["t", "z", "tag", "x"]
        assert list(out["t"].host_values()) == [b"a", b"bb", b"ccc"]
        assert out["t"].device is None and out["z"].device == torch.device(CPU)
        assert [bytes(r) for r in out["t"].rows()] == [bytes(r) for r in ref["t"].rows()]
        np.testing.assert_array_equal(out.host_values("z"), np.asarray(ref["z"].values))

    def test_map_rows_passthrough_only(self):
        jdf, tdf = self._frame(tfs), self._frame(tft)
        ref = tfs.map_rows(jdsl.identity(self._tag(jdsl)).named("t"), jdf)
        out = tft.map_rows(tdsl.identity(self._tag(tdsl)).named("t"), tdf, device=CPU)
        assert out.columns == ref.columns
        assert list(out["t"].rows()) == [b"a", b"bb", b"ccc"]

    def test_feed_dict_rename_and_string_dtype_columns(self):
        for strings in ([b"a", b"bb", b"ccc"], np.array(["p", "q", "r"])):
            jdf = tfs.TensorFrame([tfs.Column("tag", strings, tfs.ScalarType.string)])
            tdf = tft.TensorFrame([tft.Column("tag", strings, tft.ScalarType.string)])
            ref = tfs.map_rows(jdsl.identity(self._tag(jdsl, "blob")).named("t"), jdf,
                               feed_dict={"blob": "tag"})
            out = tft.map_rows(tdsl.identity(self._tag(tdsl, "blob")).named("t"), tdf,
                               feed_dict={"blob": "tag"}, device=CPU)
            assert out.columns == ref.columns
            assert out["t"].host_values().tolist() == ref["t"].host_values().tolist()

    def test_passthrough_only_rejects_unknown_bindings(self):
        tdf = self._frame(tft)
        for verb in (tft.map_rows, tft.map_blocks):
            with pytest.raises(ValueError, match="typo"):
                verb(tdsl.identity(self._tag(tdsl)).named("t"), tdf,
                     bindings={"typo": np.float32(5.0)}, device=CPU)

    def test_passthrough_refuses_trim(self):
        tdf = self._frame(tft)
        with pytest.raises(ValueError, match="row-preserving"):
            tft.map_blocks(tdsl.identity(self._tag(tdsl)).named("t"), tdf, trim=True, device=CPU)

    def test_compute_on_bytes_rejected(self):
        from tensorframes_tpu.graph.ir import Graph as JGraph, GraphNode as JNode
        from tensorframes_tpu.proto.graphdef import AttrValue as JAttr
        from tensorframes_tpu_torch.graph.ir import Graph, GraphNode
        from tensorframes_tpu_torch.proto.graphdef import AttrValue

        messages = []
        for mod, G, N, A in ((tfs, JGraph, JNode, JAttr), (tft, Graph, GraphNode, AttrValue)):
            g = G([
                N("tag", "Placeholder", [], {
                    "dtype": A.of_type(mod.ScalarType.string),
                    "shape": A.of_shape(mod.Shape(())),
                }),
                N("t", "StringJoin", ["tag", "tag"], {}),
            ])
            kw = {"device": CPU} if mod is tft else {}
            with pytest.raises(ValueError, match="bytes") as err:
                mod.map_blocks(g, self._frame(mod), fetch_names=["t"], **kw)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
