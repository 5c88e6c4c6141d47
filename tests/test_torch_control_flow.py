"""PyTorch port: imported TF control flow held to the JAX package on the CPU.

v1 Switch/Merge/Enter/Exit rings, v2 ``If``/``While``, FunctionDefLibrary
inlining (``PartitionedCall``) and TensorLists, through the port's
`graph.control_flow` copy, `ops.control` rules and the verbs.

Two sources of graphs:

- the committed fixtures under ``tests/fixtures/torch_port/`` (written by
  ``make_fixtures.py`` there with TensorFlow), which need no TensorFlow to
  run, as on the card's machine;
- graphs built here with TensorFlow, the cases of `tests/test_control_flow.py`
  (skipped where TensorFlow is missing, as the JAX tests are).

Tolerances: integer and boolean outputs, the branchy graph (halving by 0.5
is exact) and the fixtures' float32 graphs (the same float32 operations in
the same order) are exact; other float32 results rtol 1e-6, as the JAX
tests hold them against TF.
"""

import os

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph.control_flow import functionalize as j_functionalize
from tensorframes_tpu.graph.ir import Graph as JGraph
from tensorframes_tpu_torch.graph.control_flow import (
    GraphLoweringError,
    _fdef_edge,
    functionalize,
    has_control_flow,
)
from tensorframes_tpu_torch.graph.ir import Graph
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

CPU = "cpu"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port")
_CONTROL_OPS = {
    "Switch", "Merge", "Enter", "Exit", "NextIteration", "LoopCond", "If", "StatelessIf",
    "While", "StatelessWhile", "PartitionedCall", "StatefulPartitionedCall",
}


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _rows(n=1000, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n).astype(np.float32) - 0.5) * 40.0


def _both(verb, data, cols, fetches, num_blocks=1, **kw):
    """``verb`` ("map_rows" / "map_blocks") in both packages: (jax, port)
    dicts of numpy outputs."""
    jout = getattr(tfs, verb)(
        data, tfs.TensorFrame.from_dict(cols, num_blocks=num_blocks), fetch_names=fetches, **kw
    )
    tout = getattr(tft, verb)(
        data, tft.TensorFrame.from_dict(cols, num_blocks=num_blocks), fetch_names=fetches,
        device=CPU, **kw,
    )
    return (
        {f: np.asarray(jout[f].values) for f in fetches},
        {f: tout.host_values(f) for f in fetches},
    )


def _assert_same(ref, got, rtol=None):
    for f in ref:
        assert got[f].dtype == ref[f].dtype and got[f].shape == ref[f].shape
        if rtol is None:
            np.testing.assert_array_equal(got[f], ref[f])
        else:
            np.testing.assert_allclose(got[f], ref[f], rtol=rtol)


def _tf1():
    return pytest.importorskip("tensorflow").compat.v1


def _bytes_of(build, v1=False) -> bytes:
    """GraphDef bytes of ``build(tf, tf1)`` run in a fresh TF graph, with
    TF's v1 control flow when ``v1``."""
    tf1 = _tf1()
    tf = pytest.importorskip("tensorflow")
    if v1:
        tf1.disable_control_flow_v2()
    try:
        g = tf1.Graph()
        with g.as_default():
            build(tf, tf1)
        return g.as_graph_def().SerializeToString()
    finally:
        if v1:
            tf1.enable_control_flow_v2()


# ---------------------------------------------------------------------------
# the committed fixtures (no TensorFlow needed)
# ---------------------------------------------------------------------------

_PER_ROW = [
    ("branchy_v1.pb", ["out", "trips"]),
    ("branchy_v2.pb", ["out", "trips"]),
    ("cond_while_v1.pb", ["out"]),
    ("cond_while_v2.pb", ["out"]),
]


@pytest.mark.parametrize("name,fetches", _PER_ROW, ids=[n for n, _ in _PER_ROW])
def test_fixture_map_rows_runs_lifted_and_matches_jax(name, fetches):
    reset_stats()
    ref, got = _both("map_rows", _fixture(name), {"x": _rows()}, fetches, num_blocks=3)
    _assert_same(ref, got)
    assert stats()["map_rows.plan.lifted"] == 1.0
    assert "map_rows.plan.per_row" not in stats()


@pytest.mark.parametrize(
    "name", [n for n, _ in _PER_ROW] + ["block_cond_while.pb", "cell_while_v1.pb",
                                        "group_cond_v1.pb"]
)
def test_fixture_functionalizes_like_the_jax_package(name):
    fetches = {"cell_while_v1.pb": ["y", "trips"], "group_cond_v1.pb": ["x"]}.get(name, ["out"])
    g = Graph.from_bytes(_fixture(name))
    assert has_control_flow(g)
    g2, f2 = functionalize(g, fetches)
    j2, jf = j_functionalize(JGraph.from_bytes(_fixture(name)), fetches)
    assert f2 == jf
    assert g2.to_bytes() == j2.to_bytes()
    assert sorted(g2.subgraphs) == sorted(j2.subgraphs)
    assert not {n.op for n in g2.nodes} & _CONTROL_OPS
    want = {"cell_while_v1.pb": {"_While"}, "group_cond_v1.pb": {"_Cond"}}.get(
        name, {"_Cond", "_While"})
    assert want <= {n.op for n in g2.nodes}


def _block_reference(x: np.ndarray) -> np.ndarray:
    """`block_cond_while.pb` over one block, in numpy."""
    y = x * np.float32(2.0) if x.sum(dtype=np.float32) > 0 else -x
    s, top = np.float32(1.0), np.abs(x).max()
    while s * top < 1000.0:
        s *= np.float32(2.0)
    return y * s


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fixture_block_level_scalar_cond_and_while(sign):
    x = np.float32(sign) * _rows(600, seed=1) + np.float32(sign * 3.0)
    reset_stats()
    ref, got = _both("map_blocks", _fixture("block_cond_while.pb"), {"x": x}, ["out"], num_blocks=3)
    _assert_same(ref, got)
    bounds = np.linspace(0, len(x), 4).astype(int)
    want = np.concatenate([_block_reference(x[a:b]) for a, b in zip(bounds, bounds[1:])])
    np.testing.assert_array_equal(got["out"], want)
    s = stats()
    # one host read of the cond's predicate per block, and one per trip
    # of the loop plus its last test
    assert s["control.cond.host_syncs"] == 3.0
    assert s["control.while.host_syncs"] == s["control.while.trips"] + 3


_W3 = np.array([1.5, -2.0, 0.5], np.float32)


def _cell_while_reference(x: np.ndarray):
    """`cell_while_v1.pb` over all rows at once in numpy: (y, trips)."""
    v, trips = x.copy(), np.zeros(len(x), np.int32)
    active = (v * v).sum(1) < 10000.0
    while active.any():
        v[active] = v[active] * np.float32(2.0) + _W3
        trips[active] += 1
        active &= (v * v).sum(1) < 10000.0
    return v, trips


@pytest.mark.parametrize("num_blocks", [1, 3])
def test_fixture_cell_while_runs_one_call_per_block(num_blocks):
    """The loop of chip_smoke's phase 9: its predicate reduces the row's
    cell and ``w`` is bound, so it does not lift; it runs under vmap, one
    batched loop a block, equal to the JAX package, the per-row plan and
    numpy (integer-valued float32 and halves: exact in any order)."""
    x = np.random.default_rng(5).integers(-8, 9, (50, 3)).astype(np.float32)
    fetches = ["trips", "y"]
    reset_stats()
    ref, got = _both("map_rows", _fixture("cell_while_v1.pb"), {"x": x}, fetches,
                     num_blocks=num_blocks, bindings={"w": _W3})
    counts = stats()
    assert counts["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in counts
    assert counts["control.while.host_syncs"] == counts["control.while.trips"] + num_blocks
    _assert_same(ref, got)
    want_y, want_trips = _cell_while_reference(x)
    np.testing.assert_array_equal(got["y"], want_y)
    np.testing.assert_array_equal(got["trips"], want_trips)
    with tft.config.override(row_vectorize=False):
        reset_stats()
        per_row = tft.map_rows(_fixture("cell_while_v1.pb"),
                               tft.TensorFrame.from_dict({"x": x}, num_blocks=num_blocks),
                               fetch_names=fetches, bindings={"w": _W3}, device=CPU)
        assert stats()["map_rows.plan.per_row"] == 1.0
    for f in fetches:
        np.testing.assert_array_equal(per_row.host_values(f), got[f])


def test_fixture_group_cond_aggregate_runs_one_call_a_size():
    """`group_cond_v1.pb` through the exact aggregate plan: one vmapped call
    a distinct group size, against the JAX package's exact plan."""
    rng = np.random.default_rng(6)
    keys = (rng.random(400) ** 2 * 40).astype(np.int64)
    x = ((rng.random(400) + 0.5) * np.where(keys % 2, -1.0, 1.0)).astype(np.float32)
    cols = {"k": keys, "x": x}
    ref = tfs.aggregate(_fixture("group_cond_v1.pb"),
                        tfs.group_by(tfs.TensorFrame.from_dict(cols), "k"), fetch_names=["x"])
    from tensorframes_tpu_torch.utils import telemetry

    telemetry.reset()
    reset_stats()
    got = tft.aggregate(_fixture("group_cond_v1.pb"),
                        tft.group_by(tft.TensorFrame.from_dict(cols, num_blocks=2), "k"),
                        fetch_names=["x"], device=CPU)
    assert stats()["aggregate.plan.exact"] == 1.0
    sizes = np.bincount(keys)
    calls = [s for s in telemetry.spans() if s.name == "aggregate.size"]
    assert len(calls) == len(np.unique(sizes[sizes > 0]))
    np.testing.assert_array_equal(got.host_values("k"), np.asarray(ref["k"].values))
    np.testing.assert_allclose(got.host_values("x"), np.asarray(ref["x"].values), rtol=1e-5)
    want = [x[keys == k].sum(dtype=np.float64) if k % 2 == 0 else x[keys == k].max()
            for k in got.host_values("k")]
    np.testing.assert_allclose(got.host_values("x"), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# graphs built with TensorFlow: the cases of tests/test_control_flow.py
# ---------------------------------------------------------------------------


def _cond_while(tf, tf1):
    x = tf1.placeholder(tf.float32, shape=(), name="x")
    c = tf.cond(x > 0.0, lambda: x * 2.0, lambda: x - 5.0)
    _, acc_f = tf.while_loop(
        lambda i, acc: i < 3, lambda i, acc: (i + 1, acc * (x + 1.0)),
        [tf.constant(0), tf.constant(1.0)],
    )
    tf.identity(c + acc_f, name="out")


@pytest.mark.parametrize("use_v2", [False, True], ids=["v1-rings", "v2-If-While"])
def test_cond_while_map_rows_matches_jax(use_v2):
    data = _bytes_of(_cond_while, v1=not use_v2)
    x = np.array([2.0, -1.0, 0.5, -3.0, 0.0], dtype=np.float32)
    ref, got = _both("map_rows", data, {"x": x}, ["out"])
    _assert_same(ref, got, rtol=1e-6)
    want = np.where(x > 0, x * 2.0, x - 5.0) + (x + 1.0) ** 3
    np.testing.assert_allclose(got["out"], want, rtol=1e-6)


@pytest.mark.parametrize("use_v2", [False, True], ids=["v1-rings", "v2-If-While"])
def test_functionalize_removes_control_ops(use_v2):
    g = Graph.from_bytes(_bytes_of(_cond_while, v1=not use_v2))
    assert has_control_flow(g)
    g2, _ = functionalize(g, ["out"])
    assert not {n.op for n in g2.nodes} & _CONTROL_OPS
    assert {"_Cond", "_While"} <= {n.op for n in g2.nodes}


def test_map_blocks_vector_cond():
    # block level: the cond's predicate is a reduction over the block
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(None,), name="x")
        tf.identity(tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0, lambda: -x), name="y")

    data = _bytes_of(build, v1=True)
    xs = np.array([1.0, 2.0, -0.5], dtype=np.float32)
    for x in (xs, -xs):
        ref, got = _both("map_blocks", data, {"x": x}, ["y"])
        _assert_same(ref, got)
    np.testing.assert_array_equal(got["y"], xs)


def test_while_loop_vector_carry_runs_per_row():
    # the loop's predicate reduces the row's vector: not row-local, so
    # map_rows runs the per-row graph under vmap (one call per block, the
    # loop batched over the rows); the per-row plan (row_vectorize off)
    # gives the same rows
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(4,), name="x")
        out = tf.while_loop(lambda v: tf.reduce_sum(v) < 100.0, lambda v: v * 2.0, [x])
        tf.identity(out[0], name="y")

    data = _bytes_of(build)
    xs = np.array([[1.0, 2.0, 3.0, 4.0], [30.0, 0.0, 0.0, 1.0], [200.0, 1.0, 1.0, 1.0]], np.float32)
    reset_stats()
    ref, got = _both("map_rows", data, {"x": xs}, ["y"])
    _assert_same(ref, got)
    counts = stats()
    assert counts["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in counts
    # the batched loop reads one host scalar a trip: the first row's sum
    # doubles 10 -> 160 in 4 trips, the longest
    assert counts["control.while.trips"] == 4.0
    assert counts["control.while.host_syncs"] == 5.0
    with tft.config.override(row_vectorize=False):
        reset_stats()
        per_row = tft.map_rows(data, tft.TensorFrame.from_dict({"x": xs}), fetch_names=["y"],
                               device=CPU)
        assert stats()["map_rows.plan.per_row"] == 1.0
    np.testing.assert_array_equal(per_row.host_values("y"), got["y"])
    v = xs[0].copy()
    while v.sum() < 100.0:
        v *= 2.0
    np.testing.assert_array_equal(got["y"][0], v)


def test_v1_cond_inside_while_body():
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")

        def body(i, a):
            inc = tf.cond(a > 4.0, lambda: x, lambda: x * 2.0)
            return i + 1, a + inc

        _, a_f = tf.while_loop(lambda i, a: i < 4, body, [tf.constant(0), tf.constant(0.0)])
        tf.identity(a_f, name="out")

    data = _bytes_of(build, v1=True)
    xs = np.array([1.0, 3.0, -2.0, 0.25], dtype=np.float32)
    reset_stats()
    ref, got = _both("map_rows", data, {"x": xs}, ["out"])
    _assert_same(ref, got, rtol=1e-6)
    # the accumulator grows a row axis; the inner cond selects per row
    assert stats()["map_rows.plan.lifted"] == 1.0
    assert stats()["vectorize.lowered.cond"] >= 1.0

    def ref_row(xv):
        a = 0.0
        for _ in range(4):
            a += xv if a > 4.0 else xv * 2.0
        return a

    np.testing.assert_allclose(got["out"], [ref_row(v) for v in xs], rtol=1e-6)


def test_v1_nested_cond():
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        inner = lambda: tf.cond(x > 10.0, lambda: x * 100.0, lambda: x * 10.0)  # noqa: E731
        tf.identity(tf.cond(x > 0.0, inner, lambda: -x), name="out")

    data = _bytes_of(build, v1=True)
    xs = np.array([20.0, 5.0, -3.0], dtype=np.float32)
    ref, got = _both("map_rows", data, {"x": xs}, ["out"])
    _assert_same(ref, got)
    np.testing.assert_array_equal(got["out"], [2000.0, 50.0, 3.0])


def _concrete(fn, spec_shape):
    tf = pytest.importorskip("tensorflow")
    conc = fn.get_concrete_function(tf.TensorSpec(shape=spec_shape, dtype=tf.float32))
    gd = conc.graph.as_graph_def()
    out_name = conc.outputs[0].name.split(":")[0]
    in_name = conc.inputs[0].name.split(":")[0]
    return gd, in_name, out_name


def test_partitioned_call_inlines():
    tf = pytest.importorskip("tensorflow")

    @tf.function
    def inner(a):
        return a * 3.0 + 1.0

    @tf.function
    def outer(a):
        return inner(a) - 2.0  # nested call -> nested inlining

    gd, in_name, out_name = _concrete(outer, ())
    assert any(n.op in ("PartitionedCall", "StatefulPartitionedCall") for n in gd.node)
    data = gd.SerializeToString()
    g2, _ = functionalize(Graph.from_bytes(data), [out_name])
    assert not any(n.op in ("PartitionedCall", "StatefulPartitionedCall") for n in g2.nodes)
    x = np.array([0.0, 1.0, -2.5], dtype=np.float32)
    ref, got = _both("map_rows", data, {in_name: x}, [out_name])
    _assert_same(ref, got)
    np.testing.assert_allclose(got[out_name], x * 3.0 - 1.0, rtol=1e-6)


def test_library_survives_wire_roundtrip():
    tf = pytest.importorskip("tensorflow")

    @tf.function
    def inner(a):
        return a * 3.0

    @tf.function
    def f(a):
        return inner(a) + 1.0

    gd, _, _ = _concrete(f, ())
    g = Graph.from_bytes(gd.SerializeToString())
    assert g.library, "FunctionDefLibrary should be parsed"
    assert set(Graph.from_bytes(g.to_bytes()).library) == set(g.library)


def test_topk_indices_through_function_call():
    tf = pytest.importorskip("tensorflow")

    @tf.function
    def inner(a):
        _, idx = tf.nn.top_k(a, k=2)
        return tf.cast(idx, tf.float32)

    @tf.function
    def f(a):
        return inner(a) + 0.0

    gd, in_name, out_name = _concrete(f, (4,))
    x = np.array([[3.0, 9.0, 1.0, 7.0]], dtype=np.float32)
    ref, got = _both("map_rows", gd.SerializeToString(), {in_name: x}, [out_name])
    _assert_same(ref, got)
    np.testing.assert_array_equal(got[out_name][0], [1.0, 3.0])


def test_tensor_list_in_while_loop():
    """A TensorArray written in a while loop: TensorListReserve/SetItem/
    Stack/Length as dense lists."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(4,), name="x")
        ta = tf.TensorArray(tf.float32, size=4, element_shape=())

        def body(i, ta):
            return i + 1, ta.write(i, tf.gather(x, i) * 2.0 + tf.cast(i, tf.float32))

        _, ta = tf.while_loop(lambda i, ta: i < 4, body, [tf.constant(0), ta])
        tf.identity(ta.stack() + tf.cast(ta.size(), tf.float32), name="y")

    data = _bytes_of(build)
    ops = {n.op for n in Graph.from_bytes(data).nodes}
    for sub in Graph.from_bytes(data).library.values():
        ops |= {n.op for n in sub.nodes}
    assert {"TensorListReserve", "TensorListSetItem", "TensorListStack"} <= ops
    xs = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref, got = _both("map_rows", data, {"x": xs}, ["y"])
    _assert_same(ref, got)
    np.testing.assert_array_equal(got["y"], xs * 2.0 + np.arange(4) + 4.0)


def test_merge_value_index_rejected():
    tf1 = _tf1()
    tf = pytest.importorskip("tensorflow")
    tf1.disable_control_flow_v2()
    try:
        g = tf1.Graph()
        with g.as_default():
            x = tf1.placeholder(tf.float32, shape=(), name="x")
            tf.identity(tf.cond(x > 0.0, lambda: x, lambda: -x), name="y")
        gd = g.as_graph_def()
    finally:
        tf1.enable_control_flow_v2()
    merge = next(n.name for n in gd.node if n.op == "Merge")
    bad = gd.node.add()
    bad.name = "take_index"
    bad.op = "Identity"
    bad.input.append(f"{merge}:1")
    bad.attr["T"].type = tf.int32.as_datatype_enum
    with pytest.raises(GraphLoweringError, match="value_index"):
        functionalize(Graph.from_bytes(gd.SerializeToString()), ["y", "take_index"])


@pytest.mark.parametrize("where", ["cond", "while"])
def test_interior_fetch_raises_named_error(where):
    """Fetching an interior node of an extracted cond or loop raises
    naming the leak, in both packages."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        if where == "cond":
            c = tf.cond(x > 0.0, lambda: tf.multiply(x, 2.0, name="inner"), lambda: x - 5.0)
        else:
            _, c = tf.while_loop(
                lambda i, acc: i < 3,
                lambda i, acc: (i + 1, tf.multiply(acc, x + 1.0, name="inner")),
                [tf.constant(0), tf.constant(1.0)],
            )
        tf.identity(c, name="out")

    data = _bytes_of(build, v1=True)
    g = Graph.from_bytes(data)
    interior = next(n.name for n in g.nodes if n.name.endswith("inner"))
    with pytest.raises(GraphLoweringError, match="interior"):
        functionalize(g, ["out", interior])
    with pytest.raises(ValueError, match="interior"):
        j_functionalize(JGraph.from_bytes(data), ["out", interior])


# ---------------------------------------------------------------------------
# FunctionDef edge syntax (no TensorFlow)
# ---------------------------------------------------------------------------


def test_fdef_named_output_args_resolve_to_offsets():
    bodynames = {"bn", "tk", "mul"}
    body_ops = {"bn": "FusedBatchNormV3", "tk": "TopKV2", "mul": "Mul"}
    assert _fdef_edge("bn:batch_mean:0", {}, bodynames, "c/", body_ops) == "c/bn:1"
    assert _fdef_edge("bn:batch_variance:0", {}, bodynames, "c/", body_ops) == "c/bn:2"
    assert _fdef_edge("bn:y:0", {}, bodynames, "c/", body_ops) == "c/bn:0"
    assert _fdef_edge("tk:indices:0", {}, bodynames, "c/", body_ops) == "c/tk:1"
    assert _fdef_edge("mul:z:0", {}, bodynames, "c/", body_ops) == "c/mul:0"
    with pytest.raises(GraphLoweringError, match="no output arg"):
        _fdef_edge("tk:bogus:0", {}, {"tk"}, "c/", {"tk": "TopKV2"})


def test_graph_without_control_flow_is_returned_as_is():
    g = Graph.from_bytes(_fixture("var_ref.pb"))
    assert not has_control_flow(g)
    assert functionalize(g, ["z"]) == (g, ["z"])


def test_control_rules_need_a_functionalized_graph():
    """A `_Cond` whose body subgraph is missing (bytes of a functionalized
    graph lose the side table) raises naming the op."""
    g, _ = functionalize(Graph.from_bytes(_fixture("branchy_v2.pb")), ["out"])
    stripped = Graph.from_bytes(g.to_bytes())
    df = tft.TensorFrame.from_dict({"x": np.ones(2, np.float32)})
    with pytest.raises(GraphLoweringError, match="missing subgraph"):
        tft.map_rows(stripped, df, fetch_names=["out"], device=CPU)


def test_aggregate_exact_plan_over_a_graph_with_control_flow():
    """A per-group `tf.cond` on the group's sum takes the exact plan, one
    call a group (`vmap` cannot read the predicate), as the JAX package's
    result."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float64, shape=(None,), name="x_input")
        tf.identity(
            tf.cond(tf.reduce_sum(x) > 0.0, lambda: tf.reduce_sum(x), lambda: tf.reduce_max(x)),
            name="x",
        )

    data = _bytes_of(build)
    rng = np.random.default_rng(0)
    cols = {"k": rng.integers(0, 5, 60), "x": rng.standard_normal(60)}
    ref = tfs.aggregate(data, tfs.group_by(tfs.TensorFrame.from_dict(cols), "k"),
                        fetch_names=["x"])
    reset_stats()
    got = tft.aggregate(data, tft.group_by(tft.TensorFrame.from_dict(cols), "k"),
                        fetch_names=["x"], device=CPU)
    assert stats()["aggregate.plan.exact"] == 1.0
    np.testing.assert_array_equal(got.host_values("k"), np.asarray(ref["k"].values))
    np.testing.assert_allclose(got.host_values("x"), np.asarray(ref["x"].values), rtol=1e-12)
    want = [
        cols["x"][cols["k"] == k].sum() if cols["x"][cols["k"] == k].sum() > 0
        else cols["x"][cols["k"] == k].max() for k in range(5)
    ]
    np.testing.assert_allclose(got.host_values("x"), want, rtol=1e-12)
