"""PyTorch port: per-row control flow at block level (`graph/vectorize.py`),
held to the JAX package and to a numpy per-row reference on the CPU.

- The branchy per-row graph (cond + a ragged-trip while) classifies
  row-local; `map_rows` runs it lifted to block level (one call per block,
  the `map_rows.plan.lifted` counter), and the masked lowerings equal the
  per-row reference exactly, across divergent branches and ragged trip
  counts, including rows that converge at once.
- Non-row-local branches are not lifted (counted by reason,
  ``vectorize.fallback.<reason>``); a graph whose only control flow is
  `_Cond` runs under `torch.func.vmap`, the cond a select per row, bound
  placeholders included. A non-row-local loop body falls back to one call
  per row.
- Shape and dtype drift raise a `GraphLoweringError` naming the carry or
  the branch output.

Every comparison here is exact: halving by 0.5 and the branch arithmetic
give the same float32 values in any order.
"""

import os

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.aggregate import _rowwise_transform
from tensorframes_tpu_torch.graph import vectorize
from tensorframes_tpu_torch.graph.control_flow import functionalize
from tensorframes_tpu_torch.graph.ir import Graph, GraphNode
from tensorframes_tpu_torch.ops.registry import GraphLoweringError, LowerCtx
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

CPU = "cpu"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port")


def _branchy_bytes(v1=False) -> bytes:
    """`tests/test_vectorize.py::_branchy_bytes`, committed by
    ``tests/fixtures/torch_port/make_fixtures.py``."""
    name = "branchy_v1.pb" if v1 else "branchy_v2.pb"
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _ref(xv):
    """Per-row numpy reference of the branchy graph."""
    c = np.where(xv > 0, xv * 2.0, xv - 5.0).astype(np.float32)
    v = xv.copy()
    k = np.zeros(len(xv), np.int32)
    for i in range(len(xv)):
        while abs(v[i]) > 1.0:
            v[i] *= np.float32(0.5)
            k[i] += 1
    return c + v, k


#: Divergent branch takes, a zero-trip row (0.5), a max-trip row (-300
#: needs 9 halvings), and the boundary row 0.0.
_X = np.array([2.0, -1.0, 0.5, -300.0, 0.0, 77.0, 8.0], dtype=np.float32)


def _lifted(v1=False) -> Graph:
    g, _ = functionalize(Graph.from_bytes(_branchy_bytes(v1)), ["out", "trips"])
    return vectorize.lift_to_block_level(g)


def _classify(data: bytes, fetches=("out", "trips")) -> bool:
    g, f = functionalize(Graph.from_bytes(data), list(fetches))
    return _rowwise_transform(g, f, {"x": 1}.get)


def _tf_bytes(build) -> bytes:
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    g = tf1.Graph()
    with g.as_default():
        build(tf, tf1)
    return g.as_graph_def().SerializeToString()


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
def test_branchy_graph_is_row_local(v1):
    reset_stats()
    assert _classify(_branchy_bytes(v1))
    assert not any(k.startswith("vectorize.fallback") for k in stats())


def test_non_row_local_cond_branch_falls_back():
    # tf.stack (Pack) is outside the row-local op set: the branch mixes rows
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        y = tf.cond(x > 0.0, lambda: tf.reduce_sum(tf.stack([x, x])), lambda: x)
        tf.identity(y, name="y")

    data = _tf_bytes(build)
    reset_stats()
    assert not _classify(data, fetches=("y",))
    assert stats()["vectorize.fallback.cond-branch-not-row-local"] == 1.0
    # ... so map_rows cannot lift it, and runs it under vmap (the cond a
    # select per row), one call per block, with the JAX package's result
    x = np.array([1.5, -2.0, 3.0], np.float32)
    reset_stats()
    got = tft.map_rows(data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"], device=CPU)
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}), fetch_names=["y"])
    assert stats()["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in stats()
    np.testing.assert_array_equal(got.host_values("y"), np.asarray(ref["y"].values))
    np.testing.assert_array_equal(got.host_values("y"), [3.0, -2.0, 6.0])


def test_non_row_local_while_body_falls_back():
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        out = tf.while_loop(lambda v: v < 10.0, lambda v: tf.reduce_sum(tf.stack([v, v])), [x])
        tf.identity(out[0], name="y")

    data = _tf_bytes(build)
    reset_stats()
    assert not _classify(data, fetches=("y",))
    assert stats()["vectorize.fallback.while-body-not-row-local"] == 1.0
    x = np.array([1.0, 3.0, 20.0], np.float32)
    got = tft.map_rows(data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"], device=CPU)
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}), fetch_names=["y"])
    np.testing.assert_array_equal(got.host_values("y"), np.asarray(ref["y"].values))
    np.testing.assert_array_equal(got.host_values("y"), [16.0, 12.0, 20.0])


def test_bindings_keep_control_flow_off_the_lifted_plan():
    """A bound placeholder is the same for every row, so it has no row
    axis to lift: the graph runs under vmap with the binding whole, one
    call per block."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        w = tf1.placeholder(tf.float32, shape=(), name="w")
        tf.identity(tf.cond(x > 0.0, lambda: x * w, lambda: x - w), name="y")

    data = _tf_bytes(build)
    x = np.array([1.0, -2.0, 4.0], np.float32)
    reset_stats()
    got = tft.map_rows(
        data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"], device=CPU,
        bindings={"w": np.float32(3.0)},
    )
    assert stats()["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in stats()
    np.testing.assert_array_equal(got.host_values("y"), [3.0, -5.0, 12.0])


# ---------------------------------------------------------------------------
# exactness: the masked lowerings against the per-row reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
def test_map_rows_matches_per_row_reference_and_jax(v1):
    df = tft.TensorFrame.from_dict({"x": _X})
    reset_stats()
    out = tft.map_rows(_branchy_bytes(v1), df, fetch_names=["out", "trips"], device=CPU)
    assert stats()["map_rows.plan.lifted"] == 1.0
    want_out, want_trips = _ref(_X)
    np.testing.assert_array_equal(out.host_values("out"), want_out)
    np.testing.assert_array_equal(out.host_values("trips"), want_trips)
    ref = tfs.map_rows(_branchy_bytes(v1), tfs.TensorFrame.from_dict({"x": _X}),
                       fetch_names=["out", "trips"])
    np.testing.assert_array_equal(out.host_values("out"), np.asarray(ref["out"].values))
    np.testing.assert_array_equal(out.host_values("trips"), np.asarray(ref["trips"].values))
    # one dense loop: its trips are the most any row needs (-300: 9)
    assert stats()["vectorize.while.trips"] == 9
    assert stats()["vectorize.while.host_syncs"] == 10


def test_lifted_map_blocks_matches_reference():
    # the block-level branchy program TF cannot author
    df = tft.TensorFrame.from_dict({"x": _X})
    reset_stats()
    out = tft.map_blocks(_lifted(), df, fetch_names=["out", "trips"], device=CPU)
    want_out, want_trips = _ref(_X)
    np.testing.assert_array_equal(out.host_values("out"), want_out)
    np.testing.assert_array_equal(out.host_values("trips"), want_trips)
    assert stats()["vectorize.lowered.cond"] >= 1 and stats()["vectorize.lowered.while"] >= 1


def test_all_rows_converged_immediately():
    x = np.array([0.5, -0.1, 0.0], np.float32)
    reset_stats()
    out = tft.map_blocks(_lifted(), tft.TensorFrame.from_dict({"x": x}),
                         fetch_names=["out", "trips"], device=CPU)
    want_out, want_trips = _ref(x)
    np.testing.assert_array_equal(out.host_values("trips"), np.zeros(3, np.int32))
    np.testing.assert_array_equal(out.host_values("out"), want_out)
    np.testing.assert_array_equal(out.host_values("trips"), want_trips)
    assert stats()["vectorize.while.trips"] == 0


def test_drifting_block_sizes():
    sizes = [3, 5, 7, 9, 11, 13, 1]
    rng = np.random.RandomState(0)
    base = (rng.rand(sum(sizes)).astype(np.float32) - 0.5) * 40.0
    proto = tft.TensorFrame.from_dict({"x": base})
    df = tft.TensorFrame([proto.column("x")], list(np.cumsum([0] + sizes)))
    out = tft.map_rows(_branchy_bytes(), df, fetch_names=["out", "trips"], device=CPU)
    want_out, want_trips = _ref(base)
    np.testing.assert_array_equal(out.host_values("out"), want_out)
    np.testing.assert_array_equal(out.host_values("trips"), want_trips)


def test_lift_to_block_level_of_a_clone_keeps_the_per_row_graph():
    g, _ = functionalize(Graph.from_bytes(_branchy_bytes()), ["out", "trips"])
    before = g.fingerprint()
    lifted = vectorize.lift_to_block_level(g.clone())
    assert g.fingerprint() == before != lifted.fingerprint()
    assert lifted["x"].shape_attr.dims == (None,)
    assert g["x"].shape_attr.dims == ()


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------


def test_while_carry_drift_names_carry():
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(2,), name="x")
        out = tf.while_loop(
            lambda v: tf.shape(v)[0] < 8, lambda v: tf.concat([v, v], axis=0), [x],
            shape_invariants=[tf.TensorShape([None])],
        )
        tf.identity(out[0], name="y")

    data = _tf_bytes(build)
    df = tft.TensorFrame.from_dict({"x": np.ones((1, 2), np.float32)})
    with pytest.raises(GraphLoweringError, match="drifts from"):
        tft.map_rows(data, df, fetch_names=["y"], device=CPU)


def test_cond_branch_mismatch_names_output():
    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        tf.identity(tf.cond(x > 0.0, lambda: tf.zeros([2]), lambda: tf.zeros([3])), name="y")

    data = _tf_bytes(build)
    df = tft.TensorFrame.from_dict({"x": np.ones(3, np.float32)})
    with pytest.raises(GraphLoweringError, match="then-branch"):
        tft.map_rows(data, df, fetch_names=["y"], device=CPU)


def _node(op="_Cond"):
    return GraphNode("c", op, ["p", "a"], {})


def test_select_cond_broadcasts_sub_lead_outputs_and_checks_dtypes():
    ctx = LowerCtx(torch.device("cpu"))
    pred = torch.tensor([True, False, True])
    (out,) = vectorize.select_cond(ctx, _node(), pred, [torch.arange(3.0)], [np.float32(-1.0)])
    np.testing.assert_array_equal(out.numpy(), [0.0, -1.0, 2.0])
    with pytest.raises(GraphLoweringError, match="dtype"):
        vectorize.select_cond(ctx, _node(), pred, [torch.zeros(3)], [torch.zeros(3, dtype=torch.int32)])
    with pytest.raises(GraphLoweringError, match="do not broadcast"):
        vectorize.select_cond(ctx, _node(), pred, [torch.zeros(3)], [torch.zeros(4)])
    with pytest.raises(GraphLoweringError, match="one value per row"):
        vectorize.select_cond(ctx, _node(), torch.ones(3, 2, dtype=torch.bool),
                              [torch.zeros(3)], [torch.zeros(3)])


def test_masked_while_spreads_a_shared_carry_over_rows():
    """A carry given once for all rows (a shared initial counter) gets the
    row axis, and each row stops at its own trip count."""
    ctx = LowerCtx(torch.device("cpu"))
    limit = torch.tensor([0, 1, 4])

    def cond_fn(k, lim):
        return (k < lim,)

    def body_fn(k, lim):
        return (k + 1, lim)

    def meta_body(k, lim):
        return (k + 1, lim)

    reset_stats()
    k, = vectorize.masked_while(
        ctx, _node("_While"), (np.int64(0), limit), 1, cond_fn, body_fn,
        cond_fn(torch.zeros(3, dtype=torch.int64), limit)[0], meta_body,
    )
    np.testing.assert_array_equal(k.numpy(), [0, 1, 4])
    assert stats()["vectorize.while.trips"] == 4


# ---------------------------------------------------------------------------
# one call per block for cond-only graphs (torch.func.vmap, the cond a
# select per row), bindings included; the row_vectorize knob
# ---------------------------------------------------------------------------

_W3 = np.array([1.5, -2.0, 0.5], np.float32)


def _cell_cond_bytes(pred: str, bound: bool) -> bytes:
    """``y = (P(x) ? x * w : x - w)`` over a float32 ``[3]`` cell, ``P`` a
    `Sum`, a `Max` or a `StridedSlice` of the cell; ``w`` a bound ``[3]``
    placeholder or a constant."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(3,), name="x")
        w = tf1.placeholder(tf.float32, shape=(3,), name="w") if bound else tf.constant(_W3)
        p = {"sum": lambda: tf.reduce_sum(x) > 0.0, "max": lambda: tf.reduce_max(x) > 1.0,
             "slice": lambda: x[1] > 0.0}[pred]()
        tf.identity(tf.cond(p, lambda: x * w, lambda: x - w), name="y")

    return _tf_bytes(build)


def _fill_cond_bytes(bound: bool) -> bytes:
    """A scalar cell whose branches call `Fill`: ``y = x > 0 ? fill([3], x)
    * w : fill([3], x - w)``."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        w = tf1.placeholder(tf.float32, shape=(), name="w") if bound else tf.constant(3.0)
        tf.identity(
            tf.cond(x > 0.0, lambda: tf.fill([3], x) * w, lambda: tf.fill([3], x - w)), name="y"
        )

    return _tf_bytes(build)


def _one_call_case(kind: str, bound: bool):
    """(bytes, x, bindings, numpy result) of an item-15 graph over 9 rows."""
    rng = np.random.default_rng(11)
    if kind == "fill":
        x = rng.standard_normal(9).astype(np.float32)
        w = np.float32(3.0)
        want = np.where(x[:, None] > 0, np.repeat(x[:, None], 3, 1) * w,
                        np.repeat((x - w)[:, None], 3, 1))
        return _fill_cond_bytes(bound), x, ({"w": w} if bound else {}), want
    x = rng.standard_normal((9, 3)).astype(np.float32) * 2.0
    p = {"sum": x.sum(1) > 0, "max": x.max(1) > 1.0, "slice": x[:, 1] > 0}[kind]
    want = np.where(p[:, None], x * _W3, x - _W3)
    return _cell_cond_bytes(kind, bound), x, ({"w": _W3} if bound else {}), want


_ONE_CALL = [(k, b) for k in ("sum", "max", "slice", "fill") for b in (False, True)]


@pytest.mark.parametrize("kind,bound", _ONE_CALL,
                         ids=[f"{k}-{'bound' if b else 'const'}" for k, b in _ONE_CALL])
def test_cond_only_graph_runs_one_call_per_block(kind, bound):
    data, x, bindings, want = _one_call_case(kind, bound)
    df = tft.TensorFrame.from_dict({"x": x}, num_blocks=3)
    reset_stats()
    got = tft.map_rows(data, df, fetch_names=["y"], device=CPU, bindings=bindings)
    counts = stats()
    assert counts["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in counts
    assert counts["vectorize.lowered.cond"] == 3.0  # one select per block
    with tft.config.override(row_vectorize=False):
        reset_stats()
        per_row = tft.map_rows(data, df, fetch_names=["y"], device=CPU, bindings=bindings)
        assert stats()["map_rows.plan.per_row"] == 1.0
        assert stats()["vectorize.fallback.disabled"] == 1.0
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}, num_blocks=3),
                       fetch_names=["y"], bindings=bindings or None)
    np.testing.assert_array_equal(got.host_values("y"), per_row.host_values("y"))
    np.testing.assert_array_equal(got.host_values("y"), np.asarray(ref["y"].values))
    np.testing.assert_array_equal(got.host_values("y"), want.astype(np.float32))


def test_a_loop_stays_per_row_under_bindings_counted_by_reason():
    """A bound placeholder keeps the graph off the lifted plan; its
    `_While` runs under vmap (one call per block, the loop batched over the
    rows), with no fallback counted. The per-row plan is the
    ``row_vectorize=False`` one, counted by its reason."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        w = tf1.placeholder(tf.float32, shape=(), name="w")
        out = tf.while_loop(lambda v: tf.abs(v) > w, lambda v: v * 0.5, [x])
        tf.identity(out[0], name="y")

    data = _tf_bytes(build)
    x = np.array([8.0, -0.5, 40.0], np.float32)
    reset_stats()
    got = tft.map_rows(data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"],
                       device=CPU, bindings={"w": np.float32(1.0)})
    counts = stats()
    assert counts["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in counts
    assert not any(k.startswith("vectorize.fallback") for k in counts)
    assert counts["control.while.trips"] == 6.0  # 40 -> 0.625: six halvings
    np.testing.assert_array_equal(got.host_values("y"), [1.0, -0.5, 0.625])
    with tft.config.override(row_vectorize=False):
        reset_stats()
        per_row = tft.map_rows(data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"],
                               device=CPU, bindings={"w": np.float32(1.0)})
        assert stats()["map_rows.plan.per_row"] == 1.0
        assert stats()["vectorize.fallback.disabled"] == 1.0
    np.testing.assert_array_equal(per_row.host_values("y"), got.host_values("y"))
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}), fetch_names=["y"],
                       bindings={"w": np.float32(1.0)})
    np.testing.assert_array_equal(got.host_values("y"), np.asarray(ref["y"].values))


def test_row_vectorize_knob_counts_in_telemetry_and_gates_the_lifted_plan():
    from tensorframes_tpu_torch.utils import telemetry

    telemetry.reset_counters()
    df = tft.TensorFrame.from_dict({"x": _X})
    tft.map_rows(_branchy_bytes(), df, fetch_names=["out", "trips"], device=CPU)
    labeled = telemetry.labeled_counters()
    assert labeled[("row_vectorize_lowered", (("kind", "cond"),))] == 1.0
    assert labeled[("row_vectorize_lowered", (("kind", "while"),))] == 1.0
    with tft.config.override(row_vectorize=False):
        reset_stats()
        out = tft.map_rows(_branchy_bytes(), df, fetch_names=["out", "trips"], device=CPU)
        assert stats()["map_rows.plan.per_row"] == 1.0
        np.testing.assert_array_equal(out.host_values("out"), _ref(_X)[0])
        # a graph lifted by hand has batched predicates, which now raise
        with pytest.raises(GraphLoweringError, match="row vectorization is disabled"):
            tft.map_blocks(_lifted(), df, fetch_names=["out", "trips"], device=CPU)
    assert telemetry.labeled_counters()[("row_vectorize_fallbacks", (("reason", "disabled"),))] == 1.0


# ---------------------------------------------------------------------------
# one call per block for graphs with a `_While` that does not lift
# (torch.func.vmap, the loop batched over the rows: `vectorize.vmap_while`)
# ---------------------------------------------------------------------------


def _sum_loop_bytes(bound: bool) -> bytes:
    """Phase 9's form: ``v = x`` float32[3]; while ``sum(v * v) < 10000``:
    ``v = v * 2 + w``, ``w`` a bound [3] vector or a constant; the trips as
    an int32 output."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(3,), name="x")
        w = tf1.placeholder(tf.float32, shape=(3,), name="w") if bound else tf.constant(_W3)
        i, v = tf.while_loop(
            lambda i, v: tf.reduce_sum(v * v) < 10000.0, lambda i, v: (i + 1, v * 2.0 + w),
            [tf.constant(0), x],
        )
        tf.identity(v, name="y")
        tf.identity(i, name="trips")

    return _tf_bytes(build)


def _cond_in_loop_bytes() -> bytes:
    """A cond inside the body of a loop whose predicate reduces the cell:
    the select and the batched loop nest."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(2,), name="x")
        out = tf.while_loop(
            lambda v: tf.reduce_max(tf.abs(v)) < 64.0,
            lambda v: tf.cond(tf.reduce_sum(v) > 0.0, lambda: v * 3.0, lambda: v - 5.0),
            [x],
        )
        tf.identity(out[0], name="y")

    return _tf_bytes(build)


def _np_sum_loop(x, w):
    i, v = 0, x.copy()
    while (v * v).sum(dtype=np.float32) < 10000.0:
        i, v = i + 1, v * np.float32(2.0) + w
    return v, i


def _np_cond_in_loop(x):
    v = x.copy()
    while np.abs(v).max() < 64.0:
        v = v * np.float32(3.0) if v.sum(dtype=np.float32) > 0 else v - np.float32(5.0)
    return v


_WHILE_CASES = ["sum-const", "sum-bound", "cond-in-loop"]


@pytest.mark.parametrize("case", _WHILE_CASES)
def test_while_graph_runs_one_call_per_block(case):
    rng = np.random.default_rng(21)
    if case == "cond-in-loop":
        data, fetches, bindings = _cond_in_loop_bytes(), ["y"], {}
        x = rng.integers(-8, 9, (40, 2)).astype(np.float32)
        want = {"y": np.stack([_np_cond_in_loop(r) for r in x])}
    else:
        bound = case == "sum-bound"
        data, fetches = _sum_loop_bytes(bound), ["trips", "y"]
        bindings = {"w": _W3} if bound else {}
        x = rng.integers(-8, 9, (40, 3)).astype(np.float32)
        rows = [_np_sum_loop(r, _W3) for r in x]
        want = {"y": np.stack([v for v, _ in rows]), "trips": np.array([i for _, i in rows], np.int32)}
    df = tft.TensorFrame.from_dict({"x": x}, num_blocks=3)
    reset_stats()
    got = tft.map_rows(data, df, fetch_names=fetches, device=CPU, bindings=bindings)
    counts = stats()
    assert counts["map_rows.plan.vmap"] == 1.0 and "map_rows.plan.per_row" not in counts
    # the lifted plan's classifier counts why the graph does not lift;
    # nothing keeps it off the one-call plan
    assert "vectorize.fallback.disabled" not in counts
    # one batched loop a block: a host read a trip and one to start
    assert counts["control.while.host_syncs"] == counts["control.while.trips"] + 3
    with tft.config.override(row_vectorize=False):
        reset_stats()
        per_row = tft.map_rows(data, df, fetch_names=fetches, device=CPU, bindings=bindings)
        assert stats()["map_rows.plan.per_row"] == 1.0
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}, num_blocks=3),
                       fetch_names=fetches, bindings=bindings or None)
    for f in fetches:
        np.testing.assert_array_equal(got.host_values(f), per_row.host_values(f))
        np.testing.assert_array_equal(got.host_values(f), np.asarray(ref[f].values))
        np.testing.assert_array_equal(got.host_values(f), want[f])


def test_while_whose_predicate_turns_per_row_after_a_trip():
    """The accumulator starts as one constant for every row, so the first
    predicate is not batched; after a trip it is, and the batched loop
    takes over from the carry the rows share. The bound limit keeps the
    graph off the lifted plan."""

    def build(tf, tf1):
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        lim = tf1.placeholder(tf.float32, shape=(), name="lim")
        acc = tf.while_loop(lambda a: a < lim, lambda a: a + x, [tf.constant(1.0)])
        tf.identity(acc[0], name="y")

    data = _tf_bytes(build)
    x = np.array([1.0, 2.0, 5.0, 19.0, 30.0, 7.0], np.float32)
    bound = {"lim": np.float32(20.0)}
    reset_stats()
    got = tft.map_rows(data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"], device=CPU,
                       bindings=bound)
    counts = stats()
    assert counts["map_rows.plan.vmap"] == 1.0
    # one unbatched trip, then the batched loop: 19 in all for the row of
    # 1.0 (1 -> 20)
    assert counts["control.while.trips"] == 19.0
    want = []
    for v in x:
        a = np.float32(1.0)
        while a < 20.0:
            a += v
        want.append(a)
    np.testing.assert_array_equal(got.host_values("y"), np.array(want, np.float32))
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}), fetch_names=["y"],
                       bindings=bound)
    np.testing.assert_array_equal(got.host_values("y"), np.asarray(ref["y"].values))
