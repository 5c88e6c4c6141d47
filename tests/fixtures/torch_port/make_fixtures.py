"""Writes the GraphDef fixtures of the PyTorch port's control-flow and
freezing checks. Needs TensorFlow; the machine with the card has none, so
the ``.pb`` files beside this script are committed, and `chip_smoke.py` and
`tests/test_torch_control_flow.py` read them.

    python tests/fixtures/torch_port/make_fixtures.py

Every graph is built in a `tf.compat.v1.Graph` and serialised with
``as_graph_def().SerializeToString()``:

- ``branchy_v1.pb`` / ``branchy_v2.pb``: the per-row graph of
  `tests/test_vectorize.py::_branchy_bytes`, with TF's v1 control flow
  (Switch/Merge/Enter/Exit rings) and with v2 (``If``/``While``). A float32
  scalar placeholder ``x``; ``out = (x > 0 ? 2x : x - 5) + v`` where ``v``
  is ``x`` halved until ``|v| <= 1``, and ``trips`` (int32) counts the
  halvings.
- ``cond_while_v1.pb`` / ``cond_while_v2.pb``: the graph of
  `tests/test_control_flow.py::_v1_cond_while_bytes`:
  ``out = (x > 0 ? 2x : x - 5) + (x + 1)^3``, the cube by a 3-trip loop.
- ``block_cond_while.pb`` (v1): a block-level graph over a float32 vector
  ``x``: ``y = sum(x) > 0 ? 2x : -x``; a scalar loop doubles ``s`` from
  1.0 until ``s * max|x| >= 1000``; ``out = y * s``.
- ``cell_while_v1.pb`` (v1): a per-row loop that does not lift: ``x``
  and a bound ``w``, both float32[3]; ``v = x`` doubled plus ``w`` while
  ``sum(v * v) < 10000``; ``y = v`` and ``trips`` (int32).
- ``group_cond_v1.pb`` (v1): a block-level graph over ``x_input`` float32
  ``[?]`` for `aggregate`: ``x = sum(x) > 0 ? sum(x) : max(x)``.
- ``var_ref.pb``: a TF 1.x ref variable (``VariableV2`` + ``Assign``)
  ``v = 3.0`` (float32) and ``z = x + v`` over a float32 vector ``x``.
- ``var_resource.pb``: resource variables (``VarHandleOp`` +
  ``AssignVariableOp`` + ``ReadVariableOp``) ``w = 2.0``, ``b = -1.0`` and
  ``z = x * w + b``.
"""

import os

import numpy as np
import tensorflow as tf

tf1 = tf.compat.v1
HERE = os.path.dirname(os.path.abspath(__file__))


def _v1(build):
    """Build with TF's v1 control flow (Switch/Merge rings)."""
    tf1.disable_control_flow_v2()
    try:
        return build()
    finally:
        tf1.enable_control_flow_v2()


def branchy() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        c = tf.cond(x > 0.0, lambda: x * 2.0, lambda: x - 5.0)
        v_f, k_f = tf.while_loop(
            lambda v, k: tf.abs(v) > 1.0, lambda v, k: (v * 0.5, k + 1), [x, tf.constant(0)]
        )
        tf.identity(c + v_f, name="out")
        tf.identity(k_f, name="trips")
    return g.as_graph_def().SerializeToString()


def cond_while() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, shape=(), name="x")
        c = tf.cond(x > 0.0, lambda: x * 2.0, lambda: x - 5.0)
        _, acc = tf.while_loop(
            lambda i, acc: i < 3, lambda i, acc: (i + 1, acc * (x + 1.0)),
            [tf.constant(0), tf.constant(1.0)],
        )
        tf.identity(c + acc, name="out")
    return g.as_graph_def().SerializeToString()


def block_cond_while() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, shape=(None,), name="x")
        y = tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0, lambda: -x)
        top = tf.reduce_max(tf.abs(x))
        s, _ = tf.while_loop(
            lambda s, k: s * top < 1000.0, lambda s, k: (s * 2.0, k + 1),
            [tf.constant(1.0), tf.constant(0)],
        )
        tf.identity(y * s, name="out")
    return g.as_graph_def().SerializeToString()


def cell_while() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, shape=(3,), name="x")
        w = tf1.placeholder(tf.float32, shape=(3,), name="w")
        i, v = tf.while_loop(
            lambda i, v: tf.reduce_sum(v * v) < 10000.0, lambda i, v: (i + 1, v * 2.0 + w),
            [tf.constant(0), x],
        )
        tf.identity(v, name="y")
        tf.identity(i, name="trips")
    return g.as_graph_def().SerializeToString()


def group_cond() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, shape=(None,), name="x_input")
        tf.identity(
            tf.cond(tf.reduce_sum(x) > 0.0, lambda: tf.reduce_sum(x), lambda: tf.reduce_max(x)),
            name="x",
        )
    return g.as_graph_def().SerializeToString()


def var_ref() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        v = tf1.Variable(np.float32(3.0), name="v", use_resource=False)
        x = tf1.placeholder(tf.float32, shape=(None,), name="x")
        tf.add(x, v, name="z")
    return g.as_graph_def().SerializeToString()


def var_resource() -> bytes:
    g = tf1.Graph()
    with g.as_default():
        w = tf1.Variable(np.float32(2.0), name="w", use_resource=True)
        b = tf1.Variable(np.float32(-1.0), name="b", use_resource=True)
        x = tf1.placeholder(tf.float32, shape=(None,), name="x")
        tf.add(x * w, b, name="z")
    return g.as_graph_def().SerializeToString()


FIXTURES = {
    "branchy_v1.pb": lambda: _v1(branchy),
    "branchy_v2.pb": branchy,
    "cond_while_v1.pb": lambda: _v1(cond_while),
    "cond_while_v2.pb": cond_while,
    "block_cond_while.pb": lambda: _v1(block_cond_while),
    "cell_while_v1.pb": lambda: _v1(cell_while),
    "group_cond_v1.pb": lambda: _v1(group_cond),
    "var_ref.pb": var_ref,
    "var_resource.pb": var_resource,
}


def main() -> None:
    for name, make in FIXTURES.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(make())
        print(name)


if __name__ == "__main__":
    main()
