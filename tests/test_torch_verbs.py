"""PyTorch port: the graph verbs held to the JAX package on the CPU.

The same seeded numpy inputs go through `tensorframes_tpu` and
`tensorframes_tpu_torch` (``device="cpu"``). Tolerances:
- integer results, min and max are exact (no rounding is involved);
- float64 sums: rtol 1e-6, float32 sums and elementwise results: rtol 1e-5
  (the two frameworks sum in different orders);
- the MLP scoring graph (float32 matrix products, softmax): rtol 1e-5,
  atol 1e-6, for the same reason.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu.graph.analysis import analyze_graph as j_analyze
from tensorframes_tpu.models import MLP
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.graph.analysis import analyze_graph as t_analyze
from tensorframes_tpu_torch.graph.ir import Graph as TGraph
from tensorframes_tpu_torch.ops.registry import GraphLoweringError
from tensorframes_tpu_torch.runtime import Executor

CPU = "cpu"

_RTOL = {np.float32: 1e-5, np.float64: 1e-6}


def _data(dtype, n=37, cols=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if cols is None else (n, cols)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-1000, 1000, shape).astype(dtype)
    return (rng.standard_normal(shape) * 10).astype(dtype)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(port, ref, dtype):
    port, ref = _host(port), _host(ref)
    assert port.dtype == ref.dtype
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=_RTOL[dtype], atol=0)


class TestMapBlocks:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
    @pytest.mark.parametrize("num_blocks", [1, 3])
    def test_x_plus_3(self, dtype, num_blocks):
        data = {"x": _data(dtype)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=num_blocks)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=num_blocks)
        jz = (tfs.block(jdf, "x") + 3).named("z")
        tz = (tft.block(tdf, "x") + 3).named("z")
        ref = tfs.map_blocks(jz, jdf)
        out = tft.map_blocks(tz, tdf, device=CPU)
        assert out.columns == ref.columns == ["z", "x"]
        assert out.offsets == [int(o) for o in ref.offsets]
        # x + 3 is one rounding in both: exact
        np.testing.assert_array_equal(out.host_values("z"), ref.host_values("z"))

    def test_graphdef_bytes_from_the_reference(self):
        data = {"x": _data(np.float32, cols=4)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        jg, jf = jdsl.build(
            jdsl.tanh(jdsl.block(jdf, "x") * np.float32(0.5)).named("y")
        )
        ref = tfs.map_blocks(jg.to_bytes(), jdf, fetch_names=jf)
        out = tft.map_blocks(
            jg.to_bytes(), tft.TensorFrame.from_dict(data, num_blocks=2),
            fetch_names=jf, device=CPU,
        )
        _assert_close(out.host_values("y"), ref.host_values("y"), np.float32)

    def test_trim_changes_row_count(self):
        data = {"x": _data(np.float64, cols=3)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=3)

        def prog(d, f):
            return d.reduce_sum(d.block(f, "x"), axes=[0], keep_dims=True).named("s")

        ref = tfs.map_blocks(prog(jdsl, jdf), jdf, trim=True)
        out = tft.map_blocks(prog(tdsl, tdf), tdf, trim=True, device=CPU)
        assert out.columns == ["s"] and out.offsets == [0, 1, 2, 3]
        _assert_close(out.host_values("s"), ref.host_values("s"), np.float64)

    def test_feed_dict_renames(self):
        data = {"a": _data(np.float64)}
        tdf = tft.TensorFrame.from_dict(data)
        ph = tdsl.placeholder(tft.ScalarType.float64, tft.Shape((None,)), name="x")
        out = tft.map_blocks((ph * 2.0).named("y"), tdf, feed_dict={"x": "a"}, device=CPU)
        np.testing.assert_array_equal(out.host_values("y"), data["a"] * 2.0)

    def test_dtype_mismatch_refused(self):
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float32)})
        ph = tdsl.placeholder(tft.ScalarType.float64, tft.Shape((None,)), name="x")
        with pytest.raises(ValueError, match="do not promote"):
            tft.map_blocks((ph + 1.0).named("y"), tdf, device=CPU)

    def test_row_count_change_needs_trim(self):
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float64)})
        s = tdsl.reduce_sum(tft.block(tdf, "x"), axes=[0], keep_dims=True).named("s")
        with pytest.raises(ValueError, match="trim=True"):
            tft.map_blocks(s, tdf, device=CPU)

    def test_unsupported_op_is_named(self):
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float64)})
        # an op neither package lowers (LRN was one until the port took the
        # convolution family)
        t = tdsl._nary("Conv3D", [tft.block(tdf, "x")]).named("e")
        with pytest.raises(GraphLoweringError, match="'Conv3D'"):
            tft.map_blocks(t, tdf, device=CPU)

    def test_executor_builds_once(self):
        ex = Executor()
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float64)}, num_blocks=4)
        z = (tft.block(tdf, "x") + 1.0).named("z")
        tft.map_blocks(z, tdf, executor=ex, device=CPU)
        tft.map_blocks(z, tdf, executor=ex, device=CPU)
        assert (ex.compile_count, ex.cache_misses, ex.cache_hits) == (1, 1, 1)
        assert ex.cache_keys()[0][0] == "block" and ex.cache_keys()[0][-1] == "cpu"


def _op_programs():
    """(name, dtype, builder(dsl, frame) -> fetch): one per lowering rule."""
    f32, f64, i64 = np.float32, np.float64, np.int64

    def bin_(op):
        return lambda d, f: getattr(d, op)(d.block(f, "x"), d.block(f, "y")).named("o")

    def un(op):
        return lambda d, f: d._nary(op, [d.block(f, "x")]).named("o")

    def reducer(op, axes, keep):
        return lambda d, f: getattr(d, op)(d.block(f, "x"), axes, keep).named("o")

    return [
        ("add", f64, bin_("add")),
        ("sub", f32, bin_("sub")),
        ("mul", i64, bin_("mul")),
        ("realdiv", f64, bin_("div")),
        ("int_div_truncates", i64, bin_("div")),
        ("maximum", f32, lambda d, f: d._nary("Maximum", [d.block(f, "x"), d.block(f, "y")]).named("o")),
        ("minimum", i64, lambda d, f: d._nary("Minimum", [d.block(f, "x"), d.block(f, "y")]).named("o")),
        ("neg", i64, un("Neg")),
        ("abs", f32, un("Abs")),
        ("square", f64, un("Square")),
        ("sqrt", f64, lambda d, f: d.sqrt(d._nary("Abs", [d.block(f, "x")])).named("o")),
        ("exp", f32, lambda d, f: d._nary("Exp", [d.block(f, "x") * np.float32(0.1)]).named("o")),
        ("log", f64, lambda d, f: d._nary("Log", [d._nary("Abs", [d.block(f, "x")]) + 1.0]).named("o")),
        ("tanh", f32, un("Tanh")),
        ("sigmoid", f64, un("Sigmoid")),
        ("relu", f32, un("Relu")),
        ("softmax", f32, lambda d, f: d.softmax(d.block(f, "x") * np.float32(0.1)).named("o")),
        ("identity", i64, lambda d, f: d.identity(d.block(f, "x")).named("o")),
        ("sum_axis1", f32, reducer("reduce_sum", [1], False)),
        ("sum_int_keep", i64, reducer("reduce_sum", [-1], True)),
        ("min_axis1", f64, reducer("reduce_min", [1], False)),
        ("max_keep", i64, reducer("reduce_max", [1], True)),
        ("mean_keep", f64, reducer("reduce_mean", [1], True)),
        ("mean_int", i64, reducer("reduce_mean", [1], False)),
        ("matmul_tb", f64, lambda d, f: d.matmul(d.block(f, "x"), d.block(f, "y"), transpose_b=True).named("o")),
        ("bias_add", f32, lambda d, f: d._nary("BiasAdd", [d.block(f, "x"), d.constant(np.arange(4, dtype=np.float32))]).named("o")),
        ("reshape", f64, lambda d, f: d.reshape(d.block(f, "x"), [-1, 2, 2]).named("o")),
        ("cast_f_to_i", f64, lambda d, f: d.cast(d.block(f, "x"), d.ScalarType.int32).named("o")),
        ("cast_i_to_f", i64, lambda d, f: d.cast(d.block(f, "x"), d.ScalarType.float32).named("o")),
        ("folded_const", f64, lambda d, f: (d.block(f, "x") + (d.constant(np.float64(2.0)) * 3.0)).named("o")),
    ]


class TestLoweringRules:
    @pytest.mark.parametrize(
        "name,dtype,prog", _op_programs(), ids=[p[0] for p in _op_programs()]
    )
    def test_rule_matches_reference(self, name, dtype, prog):
        data = {"x": _data(dtype, n=12, cols=4, seed=1), "y": _data(dtype, n=12, cols=4, seed=2)}
        if name == "int_div_truncates":
            small = data["y"] // 37
            data["y"] = np.where(small == 0, 7, small)
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)
        trim = name.startswith(("matmul",))
        ref = tfs.map_blocks(prog(jdsl, jdf), jdf, trim=trim)
        out = tft.map_blocks(prog(tdsl, tdf), tdf, trim=trim, device=CPU)
        r, o = ref.host_values("o"), out.host_values("o")
        assert o.shape == r.shape and o.dtype == r.dtype
        if np.issubdtype(r.dtype, np.integer) or name in ("min_axis1", "maximum"):
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, rtol=_RTOL.get(dtype, 1e-5), atol=1e-7)


class TestReduceBlocks:
    @pytest.mark.parametrize("dtype", [np.int64, np.float32, np.float64])
    @pytest.mark.parametrize("op", ["reduce_sum", "reduce_min", "reduce_max"])
    def test_matches_reference(self, op, dtype):
        data = {"x": _data(dtype, n=1001)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=5)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=5)

        def prog(d, f):
            return getattr(d, op)(d.block(f, "x", tf_name="x_input")).named("x")

        ref = tfs.reduce_blocks(prog(jdsl, jdf), jdf)
        out = tft.reduce_blocks(prog(tdsl, tdf), tdf, device=CPU)
        assert isinstance(out, torch.Tensor) and out.dim() == 0
        if op == "reduce_sum":
            _assert_close(out, ref, dtype)  # int exact; float in rtol
        else:
            np.testing.assert_array_equal(_host(out), _host(ref))  # exact

    def test_vector_cells_and_two_fetches(self):
        data = {"v": _data(np.float64, n=50, cols=3)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=4)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=4)

        def prog(d, f):
            a = d.reduce_sum(d.block(f, "v", tf_name="s_input"), axes=[0]).named("s")
            b = d.reduce_max(d.block(f, "v", tf_name="m_input"), axes=[0]).named("m")
            return [a, b]

        feed = {"s_input": "v", "m_input": "v"}
        ref = tfs.reduce_blocks(prog(jdsl, jdf), jdf, feed_dict=feed)
        out = tft.reduce_blocks(prog(tdsl, tdf), tdf, feed_dict=feed, device=CPU)
        assert sorted(out) == ["m", "s"]
        _assert_close(out["s"], ref["s"], np.float64)
        np.testing.assert_array_equal(_host(out["m"]), _host(ref["m"]))

    def test_placeholder_convention_enforced(self):
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float64)})
        s = tdsl.reduce_sum(tft.block(tdf, "x")).named("total")
        with pytest.raises(ValueError, match="x_input"):
            tft.reduce_blocks(s, tdf, device=CPU)

    def test_empty_frame_refused(self):
        tdf = tft.TensorFrame.from_dict({"x": np.zeros(0)})
        s = tdsl.reduce_sum(tft.block(tdf, "x", tf_name="x_input")).named("x")
        with pytest.raises(ValueError, match="empty"):
            tft.reduce_blocks(s, tdf, device=CPU)


class TestMapRows:
    def test_mlp_scoring_graph_from_reference_bytes(self):
        """`models/mlp.py`'s per-row scoring graph, built by the JAX package
        and shipped as GraphDef bytes, run by the port."""
        model = MLP([16, 32, 32, 4], seed=0)
        g, names = jdsl.build(model.scoring_graph("features", block=False))
        data = {"features": _data(np.float32, n=40, cols=16)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        ref = tfs.map_rows(g.to_bytes(), jdf, fetch_names=names)
        out = tft.map_rows(
            g.to_bytes(), tft.TensorFrame.from_dict(data, num_blocks=3),
            fetch_names=names, device=CPU,
        )
        assert out.columns == ["probs", "features"]
        np.testing.assert_allclose(
            out.host_values("probs"), ref.host_values("probs"), rtol=1e-5, atol=1e-6
        )

    def test_block_scoring_graph_matches_map_rows(self):
        model = MLP([8, 16, 3], seed=1)
        data = {"features": _data(np.float32, n=20, cols=8)}
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)
        gb, nb = jdsl.build(model.scoring_graph("features", block=True))
        gr, nr = jdsl.build(model.scoring_graph("features", block=False))
        blk = tft.map_blocks(gb.to_bytes(), tdf, fetch_names=nb, device=CPU)
        rows = tft.map_rows(gr.to_bytes(), tdf, fetch_names=nr, device=CPU)
        np.testing.assert_allclose(
            blk.host_values("probs"), rows.host_values("probs"), rtol=1e-5, atol=1e-6
        )

    @pytest.mark.parametrize("dtype", [np.int64, np.float64])
    def test_row_graph_matches_reference(self, dtype):
        data = {"v": _data(dtype, n=21, cols=3)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)

        def prog(d, f):
            r = d.row(f, "v")
            return d.reduce_sum(r * r, axes=[0]).named("n2")

        ref = tfs.map_rows(prog(jdsl, jdf), jdf)
        out = tft.map_rows(prog(tdsl, tdf), tdf, device=CPU)
        _assert_close(out.host_values("n2"), ref.host_values("n2"), dtype)


class TestAnalysis:
    @pytest.mark.parametrize("block", [True, False])
    def test_summary_matches_reference(self, block):
        model = MLP([6, 5, 2], seed=0)
        g, names = jdsl.build(model.scoring_graph("features", block=block))
        jsum = j_analyze(g, names)
        tsum = t_analyze(TGraph.from_bytes(g.to_bytes()), names)

        def flat(s):
            return {
                k: (v.dtype.value, v.shape.dims, v.is_input, v.is_output)
                for part in (s.inputs, s.outputs) for k, v in part.items()
            }

        assert flat(tsum) == flat(jsum)

    def test_unknown_dims_follow_the_probes(self):
        tdf = tft.TensorFrame.from_dict({"x": np.zeros((4, 3), np.float32)})
        g, names = tdsl.build(tdsl.reduce_sum(tft.block(tdf, "x"), axes=[1]).named("s"))
        s = t_analyze(g, names)
        assert s.outputs["s"].shape.dims == (None,)
        assert s.outputs["s"].dtype is tft.ScalarType.float32


class TestFunctionFrontEnd:
    def test_map_blocks_fn_matches_reference(self):
        data = {"x": _data(np.float32), "y": _data(np.float32, seed=3)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=3)

        def fn(x, y):
            return {"s": x * 2 + y, "d": x - y}

        ref = tfs.map_blocks(fn, jdf)
        out = tft.map_blocks(fn, tdf, device=CPU)
        assert out.columns == ref.columns
        for c in ("s", "d"):
            _assert_close(out.host_values(c), ref.host_values(c), np.float32)

    def test_trim_and_errors(self):
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float64)}, num_blocks=2)
        out = tft.map_blocks(lambda x: {"m": x.max().reshape(1)}, tdf, trim=True, device=CPU)
        assert out.nrows == 2
        with pytest.raises(ValueError, match="dict"):
            tft.map_blocks(lambda x: x, tdf, device=CPU)
        with pytest.raises(ValueError, match="no matching"):
            tft.map_blocks(lambda nope: {"a": nope}, tdf, device=CPU)


class TestEmptyFrameFunctions:
    """The function front end on an all-empty frame: output names, shapes
    and dtypes from one call on zero-row feeds, as the JAX package takes
    them from `jax.eval_shape`."""

    def _frames(self):
        x = np.zeros((0, 3), np.float32)
        return tfs.TensorFrame.from_dict({"x": x}), tft.TensorFrame.from_dict({"x": x})

    def _assert_same(self, out, ref):
        assert out.columns == ref.columns
        for c in ref.columns:
            r, o = np.asarray(ref[c].values), out.host_values(c)
            assert (o.shape, o.dtype) == (r.shape, r.dtype), c

    def test_map_blocks_fn(self):
        jdf, tdf = self._frames()
        fn = lambda x: {"y": x * 2.0 + 1.0}  # noqa: E731
        out = tft.map_blocks(fn, tdf, device=CPU)
        self._assert_same(out, tfs.map_blocks(fn, jdf))
        assert out.columns == ["y", "x"] and out.host_values("y").shape == (0, 3)
        assert out["y"].device == torch.device(CPU)

    def test_map_rows_fn(self):
        jdf, tdf = self._frames()
        fn = lambda x: {"y": x * 2.0 + 1.0}  # noqa: E731
        out = tft.map_rows(fn, tdf, device=CPU)
        self._assert_same(out, tfs.map_rows(fn, jdf))
        assert out.columns == ["y", "x"] and out.host_values("y").shape == (0, 3)

    def test_trimmed_keepdims_sum(self):
        jdf, tdf = self._frames()
        out = tft.map_blocks(lambda x: {"s": x.sum(0, keepdim=True)}, tdf, trim=True, device=CPU)
        ref = tfs.map_blocks(lambda x: {"s": x.sum(0, keepdims=True)}, jdf, trim=True)
        self._assert_same(out, ref)
        assert out.columns == ["s"] and out.nrows == 0 and out.host_values("s").shape == (0, 3)


class TestBindings:
    """Bound placeholders and function parameters, held to the JAX
    package's `bindings=` on the same inputs (elementwise: exact)."""

    def _x_times_w(self, d, f):
        w = d.placeholder(d.ScalarType.float64, d.Shape(()), name="w")
        return (d.block(f, "x") * w).named("z")

    def test_graph_binding_matches_reference_and_reuses_the_lowering(self):
        data = {"x": _data(np.float64)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=3)
        ex = Executor()
        z = self._x_times_w(tdsl, tdf)
        for w in (10.0, -1.0, 0.5):
            ref = tfs.map_blocks(self._x_times_w(jdsl, jdf), jdf, bindings={"w": np.float64(w)})
            out = tft.map_blocks(z, tdf, bindings={"w": np.float64(w)}, executor=ex, device=CPU)
            np.testing.assert_array_equal(out.host_values("z"), ref.host_values("z"))
        # new bound values, one lowering
        assert ex.compile_count == 1 and ex.cache_hits == 2

    def test_vector_binding_multi_block_and_tensor_binding(self):
        data = {"v": _data(np.float64, n=9, cols=2)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)

        def prog(d, f):
            c = d.placeholder(d.ScalarType.float64, d.Shape((2,)), name="offset")
            return (d.block(f, "v") + c).named("z")

        off = np.array([10.0, 20.0])
        ref = tfs.map_blocks(prog(jdsl, jdf), jdf, bindings={"offset": off})
        for bound in (off, torch.from_numpy(off)):
            out = tft.map_blocks(prog(tdsl, tdf), tdf, bindings={"offset": bound}, device=CPU)
            np.testing.assert_array_equal(out.host_values("z"), ref.host_values("z"))

    def test_map_rows_graph_binding(self):
        data = {"v": _data(np.float64, n=11, cols=3)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)

        def prog(d, f):
            w = d.placeholder(d.ScalarType.float64, d.Shape((3,)), name="w")
            return d.reduce_sum(d.row(f, "v") * w, axes=[0]).named("y")

        w = np.array([1.0, -2.0, 0.5])
        ref = tfs.map_rows(prog(jdsl, jdf), jdf, bindings={"w": w})
        out = tft.map_rows(prog(tdsl, tdf), tdf, bindings={"w": w}, device=CPU)
        _assert_close(out.host_values("y"), ref.host_values("y"), np.float64)

    def test_binding_errors(self):
        tdf = tft.TensorFrame.from_dict({"x": np.arange(4.0).reshape(2, 2)})
        x = tft.block(tdf, "x")
        c = tdsl.placeholder(tft.ScalarType.float64, tft.Shape((2,)), name="c")
        z = (x + c).named("z")
        with pytest.raises(ValueError, match="does not match any placeholder"):
            tft.map_blocks(z, tdf, bindings={"c": np.zeros(2), "nope": np.zeros(2)}, device=CPU)
        with pytest.raises(ValueError, match="dtype"):
            tft.map_blocks(z, tdf, bindings={"c": np.zeros(2, np.int32)}, device=CPU)
        with pytest.raises(ValueError, match="not compatible"):
            tft.map_blocks(z, tdf, bindings={"c": np.zeros(3)}, device=CPU)
        w = tdsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="w")
        with pytest.raises(ValueError, match="every placeholder is bound"):
            tft.map_rows((w * 2.0).named("y"), tdf, bindings={"w": np.float64(1.0)}, device=CPU)


class TestMapRowsFunction:
    """`map_rows(fn, ...)`: the function sees one row's cells under vmap."""

    def test_matches_reference(self):
        data = {"v": _data(np.float32, n=25, cols=4), "s": _data(np.float32, n=25, seed=4)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=3)

        def fn(v, s):
            return {"n": (v * v).sum() + s, "w": v * s}

        ref = tfs.map_rows(fn, jdf)
        out = tft.map_rows(fn, tdf, device=CPU)
        assert out.columns == ref.columns
        for c in ("n", "w"):
            _assert_close(out.host_values(c), ref.host_values(c), np.float32)

    def test_bound_parameter_stays_whole(self):
        data = {"features": _data(np.float32, n=30, cols=6)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)
        w = _data(np.float32, n=6, cols=3, seed=7)

        def fn(features, w):
            return {"y": features @ w}

        ref = tfs.map_rows(fn, jdf, bindings={"w": w})
        out = tft.map_rows(fn, tdf, bindings={"w": w}, device=CPU)
        assert out.host_values("y").shape == (30, 3)
        _assert_close(out.host_values("y"), ref.host_values("y"), np.float32)

    def test_map_blocks_fn_binding_matches_reference(self):
        data = {"x": _data(np.float64, n=10)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=2)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=2)

        def fn(x, scale):
            return {"z": x * scale}

        ref = tfs.map_blocks(fn, jdf, bindings={"scale": np.float64(3.0)})
        out = tft.map_blocks(fn, tdf, bindings={"scale": np.float64(3.0)}, device=CPU)
        np.testing.assert_array_equal(out.host_values("z"), ref.host_values("z"))

    def test_errors(self):
        tdf = tft.TensorFrame.from_dict({"x": _data(np.float64)}, num_blocks=2)
        with pytest.raises(ValueError, match="do not match any function"):
            tft.map_rows(lambda x: {"z": x}, tdf, bindings={"Scale": 1.0}, device=CPU)
        with pytest.raises(ValueError, match="do not match any function"):
            tft.map_blocks(lambda x: {"z": x}, tdf, bindings={"Scale": 1.0}, device=CPU)
        with pytest.raises(ValueError, match="every parameter is bound"):
            tft.map_rows(lambda w: {"z": w}, tdf, bindings={"w": 1.0}, device=CPU)
        with pytest.raises(ValueError, match="dict"):
            tft.map_rows(lambda x: x, tdf, device=CPU)
