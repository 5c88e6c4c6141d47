"""PyTorch port: variable freezing on imported GraphDefs, held to the JAX
package on the CPU.

The cases of `tests/test_freeze.py` through the port's `graph.freeze` copy,
and the repair of `api._as_graph`: every imported graph (bytes, path or
`Graph`) is functionalized and then frozen, so a stateful graph runs in the
port as in the JAX package. The frozen graphs must serialise to the JAX
package's bytes, and every result here is exact (an add or a product of
the same float values in the same order; the float64 sums of the matmul
case hold three terms).
"""

import os

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph.freeze import freeze_variables as j_freeze
from tensorframes_tpu.graph.ir import Graph as JGraph
from tensorframes_tpu_torch.graph.freeze import freeze_variables, has_variables
from tensorframes_tpu_torch.graph.ir import Graph, GraphNode
from tensorframes_tpu_torch.ops.lowering import build_callable
from tensorframes_tpu_torch.proto.graphdef import AttrValue, TensorProto
from tensorframes_tpu_torch.schema import ScalarType, Shape

CPU = torch.device("cpu")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port")


def _const(name, arr):
    arr = np.asarray(arr)
    return GraphNode(name, "Const", [], {
        "dtype": AttrValue.of_type(ScalarType.from_np_dtype(arr.dtype)),
        "value": AttrValue.of_tensor(TensorProto.from_numpy(arr)),
    })


def _ref_variable_graph():
    """The TF 1.x wire pattern of `tests/test_freeze.py`: VariableV2 +
    Assign + Identity read, ``z = x + v`` with ``v = 3``."""
    f64 = AttrValue.of_type(ScalarType.float64)
    g = Graph()
    g.add(_const("v/init", np.array(3.0)))
    g.add(GraphNode("v", "VariableV2", [], {"dtype": f64, "shape": AttrValue.of_shape(Shape(()))}))
    g.add(GraphNode("v/Assign", "Assign", ["v", "v/init"], {"T": f64}))
    g.add(GraphNode("v/read", "Identity", ["v"], {"T": f64}))
    g.add(GraphNode("init", "NoOp", ["^v/Assign"], {}))
    g.add(GraphNode("x", "Placeholder", [], {
        "dtype": f64, "shape": AttrValue.of_shape(Shape((None,))),
    }))
    g.add(GraphNode("z", "Add", ["x", "v/read"], {"T": f64}))
    return g


def _value(graph, fetch="z", feeds=None):
    names = sorted(feeds or {})
    fn = build_callable(graph, [fetch], names, CPU)
    (out,) = fn(*[torch.from_numpy(np.asarray(feeds[n])) for n in names])
    return out.numpy()


# ---------------------------------------------------------------------------
# ref variables
# ---------------------------------------------------------------------------


def test_freeze_replaces_variable_with_const():
    g = freeze_variables(_ref_variable_graph())
    assert not has_variables(g)
    ops = {n.name: n.op for n in g}
    assert ops["v"] == "Const"
    assert "v/Assign" not in ops and "init" not in ops
    np.testing.assert_array_equal(_value(g, feeds={"x": np.array([1.0, 2.0])}), [4.0, 5.0])
    # the same frozen bytes as the JAX package's freezing
    raw = _ref_variable_graph().to_bytes()
    assert g.to_bytes() == j_freeze(JGraph.from_bytes(raw)).to_bytes()


@pytest.mark.parametrize("route", ["bytes", "path", "graph"])
def test_map_blocks_on_stateful_wire_bytes(route, tmp_path):
    """The `_as_graph` repair: a VariableV2 graph gives [4, 5, 6] in both
    packages, however the graph is handed over."""
    raw = _ref_variable_graph().to_bytes()
    path = tmp_path / "var.pb"
    path.write_bytes(raw)
    given = {"bytes": raw, "path": str(path), "graph": Graph.from_bytes(raw)}[route]
    x = np.array([1.0, 2.0, 3.0])
    got = tft.map_blocks(
        given, tft.TensorFrame.from_dict({"x": x}), fetch_names=["z"], device="cpu"
    ).host_values("z")
    ref = np.asarray(
        tfs.map_blocks(raw, tfs.TensorFrame.from_dict({"x": x}), fetch_names=["z"])["z"].values
    )
    np.testing.assert_array_equal(got, [4.0, 5.0, 6.0])
    np.testing.assert_array_equal(got, ref)


def test_noop_graph_is_same_object():
    g = Graph([_const("c", np.array(1.0))])
    assert freeze_variables(g) is g


def test_initializer_assign_preferred_over_compute_assign():
    f64 = AttrValue.of_type(ScalarType.float64)
    g = Graph()
    g.add(_const("other", np.array(99.0)))
    g.add(_const("v/init", np.array(3.0)))
    g.add(GraphNode("v", "VariableV2", [], {"dtype": f64}))
    g.add(GraphNode("update", "Assign", ["v", "other"], {"T": f64}))
    g.add(GraphNode("v/Assign", "Assign", ["v", "v/init"], {"T": f64}))
    g.add(GraphNode("z", "Identity", ["v"], {"T": f64}))
    assert float(_value(freeze_variables(g))) == 3.0


def test_control_edge_before_data_inputs():
    f64 = AttrValue.of_type(ScalarType.float64)
    g = Graph()
    g.add(GraphNode("dep", "NoOp", [], {}))
    g.add(_const("v/init", np.array(7.0)))
    g.add(GraphNode("v", "VariableV2", [], {"dtype": f64}))
    g.add(GraphNode("v/Assign", "Assign", ["^dep", "v", "v/init"], {"T": f64}))
    g.add(GraphNode("z", "Identity", ["v"], {"T": f64}))
    assert float(_value(freeze_variables(g))) == 7.0


def test_missing_initializer_raises():
    g = Graph([GraphNode("v", "VariableV2", [], {"dtype": AttrValue.of_type(ScalarType.float64)})])
    with pytest.raises(ValueError, match="no Assign"):
        freeze_variables(g)


# ---------------------------------------------------------------------------
# the committed fixtures: ref and resource variables written by TF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,want", [("var_ref.pb", lambda x: x + 3.0), ("var_resource.pb", lambda x: x * 2.0 - 1.0)]
)
def test_fixture_variables_freeze_and_match_jax(name, want):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        raw = f.read()
    g = Graph.from_bytes(raw)
    assert has_variables(g)
    frozen = freeze_variables(g)
    assert not has_variables(frozen)
    assert frozen.to_bytes() == j_freeze(JGraph.from_bytes(raw)).to_bytes()
    x = (np.random.default_rng(0).standard_normal(100) * 10).astype(np.float32)
    got = tft.map_blocks(
        raw, tft.TensorFrame.from_dict({"x": x}, num_blocks=4), fetch_names=["z"], device="cpu"
    ).host_values("z")
    ref = np.asarray(
        tfs.map_blocks(raw, tfs.TensorFrame.from_dict({"x": x}, num_blocks=4),
                       fetch_names=["z"])["z"].values
    )
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want(x).astype(np.float32))


# ---------------------------------------------------------------------------
# resource variables written by TensorFlow here
# ---------------------------------------------------------------------------


def _tf_bytes(build) -> bytes:
    tf1 = pytest.importorskip("tensorflow").compat.v1
    g = tf1.Graph()
    with g.as_default():
        build(tf1)
    return g.as_graph_def().SerializeToString()


def _both_frozen(raw, feeds, fetch="z"):
    """The fetch of the frozen graph in both packages."""
    from tensorframes_tpu.ops.lowering import build_callable as j_build

    names = sorted(feeds)
    ref = j_build(j_freeze(JGraph.from_bytes(raw)), [fetch], names)(*[feeds[n] for n in names])
    got = _value(freeze_variables(Graph.from_bytes(raw)), fetch, feeds)
    return np.asarray(ref[0]), got


def test_variable_plus_placeholder():
    def build(tf):
        v = tf.Variable(3.0, name="v", dtype=tf.float64)
        x = tf.placeholder(tf.float64, shape=[None], name="x")
        tf.add(x, v, name="z")

    ref, got = _both_frozen(_tf_bytes(build), {"x": np.array([1.0, 2.0])})
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [4.0, 5.0])


def test_chained_initializers():
    # b's initializer reads a: freezing must fixpoint across variables
    def build(tf):
        a = tf.Variable(np.array([1.0, 2.0]), name="a")
        b = tf.Variable(a.read_value() * 2.0, name="b")
        x = tf.placeholder(tf.float64, shape=[2], name="x")
        tf.identity(x + a + b, name="z")

    ref, got = _both_frozen(_tf_bytes(build), {"x": np.array([0.5, 0.5])})
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [3.5, 6.5])


def test_matrix_variable_matmul():
    def build(tf):
        w = tf.get_variable(
            "w", shape=[3, 2], dtype=tf.float64,
            initializer=tf.ones_initializer(), use_resource=True,
        )
        x = tf.placeholder(tf.float64, shape=[None, 3], name="x")
        tf.matmul(x, w, name="z")

    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    ref, got = _both_frozen(_tf_bytes(build), {"x": x})
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x.sum(1, keepdims=True).repeat(2, 1))


def test_end_to_end_map_blocks():
    def build(tf):
        v = tf.Variable(np.array([10.0, 20.0]), name="v")
        x = tf.placeholder(tf.float64, shape=[None, 2], name="x")
        tf.add(x, v, name="z")

    raw = _tf_bytes(build)
    x = np.arange(8, dtype=np.float64).reshape(4, 2)
    got = tft.map_blocks(
        raw, tft.TensorFrame.from_dict({"x": x}), fetch_names=["z"], device="cpu"
    ).host_values("z")
    np.testing.assert_array_equal(got, x + [10.0, 20.0])
