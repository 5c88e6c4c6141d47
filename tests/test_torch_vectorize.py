"""PyTorch port: per-row control flow at block level (`graph/vectorize.py`),
held to the JAX package and to a numpy per-row reference on the CPU.

- The branchy per-row graph (cond + a ragged-trip while) classifies
  row-local; `map_rows` runs it lifted to block level (one call per block,
  the `map_rows.plan.lifted` counter), and the masked lowerings equal the
  per-row reference exactly, across divergent branches and ragged trip
  counts, including rows that converge at once.
- Non-row-local branches and loop bodies fall back to one call per row,
  counted by reason (``vectorize.fallback.<reason>``).
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
    # ... so map_rows runs it once per row, with the JAX package's result
    x = np.array([1.5, -2.0, 3.0], np.float32)
    reset_stats()
    got = tft.map_rows(data, tft.TensorFrame.from_dict({"x": x}), fetch_names=["y"], device=CPU)
    ref = tfs.map_rows(data, tfs.TensorFrame.from_dict({"x": x}), fetch_names=["y"])
    assert stats()["map_rows.plan.per_row"] == 1.0
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
    axis to lift: the graph runs once per row."""

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
    assert stats()["map_rows.plan.per_row"] == 1.0
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
