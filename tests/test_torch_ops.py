"""PyTorch port: every lowering rule held to the JAX rule on the CPU.

Each case builds one graph with the JAX DSL (placeholders, constants and
`dsl._nary`), serialises it with `Graph.to_bytes()`, lowers the same bytes
in both packages and feeds both the same seeded numpy inputs. The port's
result must have the reference's shape and dtype.

Tolerances:
- integer and bool results, and every result of a rule that only moves,
  selects or compares values (min, max, argmin/argmax, gather, slices,
  pads, top-k), are exact;
- float results: rtol 1e-5 (float32) or 1e-6 (float64), atol 1e-6
  (float32) or 1e-12 (float64) for values that round near zero (sin of a
  multiple of pi, a sum that cancels); the two frameworks round
  transcendental functions and sums differently.

Where the JAX rule departs from TF, the case id says so (``jax_...``).
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu  # noqa: F401  (x64 on, as in the reference's tests)
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu.graph.ir import Graph as JGraph, GraphNode as JNode
from tensorframes_tpu.ops.lowering import build_callable as j_build
from tensorframes_tpu.ops.registry import registered_ops as j_registered_ops
from tensorframes_tpu.ops.registry import get_rule as j_get_rule
from tensorframes_tpu.proto.graphdef import AttrValue
from tensorframes_tpu.schema import ScalarType as JST, Shape as JShape
from tensorframes_tpu_torch.frame import _to_numpy
from tensorframes_tpu_torch.graph.ir import Graph as TGraph
from tensorframes_tpu_torch.ops.lowering import build_callable as t_build
from tensorframes_tpu_torch.ops.registry import GraphLoweringError, registered_ops

CPU = torch.device("cpu")
_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-6}
_ATOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}

F32, F64, I32, I64, BOOL = np.float32, np.float64, np.int32, np.int64, np.bool_

# the convolution family (held to the JAX rules in tests/test_torch_conv.py)
_CONV_FAMILY = {
    "Conv2D", "DepthwiseConv2dNative", "MaxPool", "MaxPoolV2", "AvgPool",
    "FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3",
    "BatchNormWithGlobalNormalization", "LRN", "ResizeBilinear",
}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(shape, dtype, scale=3.0, seed=0):
    if np.issubdtype(dtype, np.integer):
        return _rng(seed).integers(-9, 10, shape).astype(dtype)
    if dtype is BOOL:
        return _rng(seed).random(shape) < 0.5
    return (_rng(seed).standard_normal(shape) * scale).astype(dtype)


def _const(value, dtype=None):
    return jdsl.constant(np.asarray(value, dtype=dtype))


def _ph(arr: np.ndarray, name: str):
    return jdsl.placeholder(JST.from_np_dtype(arr.dtype), JShape(arr.shape), name=name)


def _lower_both(build, feeds, n_out=1, edit=None):
    """Build with the JAX DSL, ship as bytes, run in both packages.
    ``build(phs)`` returns the fetch tensor; ``edit(graph)`` may add nodes
    before the graph is serialised."""
    phs = {n: _ph(a, n) for n, a in feeds.items()}
    g, _ = jdsl.build(build(phs).named("o"))
    if edit is not None:
        edit(g)
    raw = g.to_bytes()
    fetches = ["o"] if n_out == 1 else [f"o:{i}" for i in range(n_out)]
    names = sorted(feeds)
    ref = j_build(JGraph.from_bytes(raw), fetches, names)(*[feeds[n] for n in names])
    got = t_build(TGraph.from_bytes(raw), fetches, names, CPU)(
        *[torch.from_numpy(np.array(feeds[n])) for n in names]
    )
    return [np.asarray(r) for r in ref], [_to_numpy(o) for o in got]


def _check(ref, got, exact=False):
    assert len(ref) == len(got)
    for r, o in zip(ref, got):
        assert (o.shape, o.dtype) == (r.shape, r.dtype)
        if exact or r.dtype.kind in "biu":
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(
                o, r, rtol=_RTOL[r.dtype], atol=_ATOL[r.dtype], equal_nan=True
            )


def _run(build, feeds, n_out=1, exact=False, edit=None):
    ref, got = _lower_both(build, feeds, n_out, edit)
    _check(ref, got, exact)
    return ref, got


def _op(name, *parents, **attrs):
    extra = {}
    for k, v in attrs.items():
        if isinstance(v, bool):
            extra[k] = AttrValue.of_bool(v)
        elif isinstance(v, int):
            extra[k] = AttrValue.of_int(v)
        elif isinstance(v, float):
            extra[k] = AttrValue("f", v)
        elif isinstance(v, str):
            extra[k] = AttrValue.of_string(v)
        elif isinstance(v, list):
            extra[k] = AttrValue.of_ints(v)
        else:
            extra[k] = AttrValue.of_type(v)
    return jdsl._nary(name, list(parents), extra_attrs=extra)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_holds_every_jax_standard_op_but_the_convolution_family():
    """The convolution family came in with the frozen-model slice, and the
    control-flow rules with it: the port now lowers every op name the JAX
    package's `ops/standard.py` and `ops/control.py` register."""
    modules = {"tensorframes_tpu.ops.standard", "tensorframes_tpu.ops.control"}
    jax_ops = {n for n in j_registered_ops() if j_get_rule(n).fn.__module__ in modules}
    assert _CONV_FAMILY <= jax_ops
    assert set(registered_ops()) == jax_ops == set(j_registered_ops())


def _unlowerable(op):
    """A graph holding ``op`` that its rule cannot lower, and its feeds."""
    x = np.zeros((2, 3), np.float32)
    img = np.zeros((1, 4, 4, 2), np.float32)
    w = np.zeros((1, 1, 2, 2), np.float32)
    size = np.array([2, 2], np.int32)
    if op == "Conv2D":
        return _op(op, _ph(img, "x"), _ph(w, "w"), strides=[1, 1, 1, 1], padding="EXPLICIT"), \
            {"x": img, "w": w}
    if op == "DepthwiseConv2dNative":
        return _op(op, _ph(img, "x"), _ph(w, "w"), strides=[1, 1, 1, 1], padding="SAME",
                   data_format="NCHW"), {"x": img, "w": w}
    if op == "LRN":
        return _op(op, _ph(img, "x"), depth_radius=-1), {"x": img}
    if op == "ResizeBilinear":  # the size must be a constant
        return _op(op, _ph(img, "x"), _ph(size, "size")), {"x": img, "size": size}
    if op == "TensorListReserve":  # the extents must be constants
        return _op(op, _ph(size, "size"), _const(3, np.int32)), {"size": size}
    # pooling of a 2-d tensor, a batch norm or a _While missing its inputs
    # or its body subgraph
    return _op(op, _ph(x, "x")), {"x": x}


@pytest.mark.parametrize("op", sorted(_CONV_FAMILY) + ["_While", "TensorListReserve"])
def test_ops_outside_the_port_raise_naming_the_op(op):
    """These ops were outside the port until the frozen-model slice; each
    now raises `GraphLoweringError` naming the op on a graph it cannot
    lower, never an untyped error."""
    fetch, feeds = _unlowerable(op)
    g, _ = jdsl.build(fetch.named("o"))
    names = sorted(feeds)
    with pytest.raises(GraphLoweringError, match=repr(op)):
        fn = t_build(TGraph.from_bytes(g.to_bytes()), ["o"], names, CPU)
        fn(*[torch.from_numpy(feeds[n]) for n in names])


# ---------------------------------------------------------------------------
# sources / identity
# ---------------------------------------------------------------------------


def test_identity_family_and_control_only_nodes():
    x = _normal((3, 2), F32)
    y = _normal((4,), I64)
    _run(lambda p: _op("IdentityN", p["x"], p["y"]), {"x": x, "y": y}, n_out=2, exact=True)
    for op in ("CheckNumerics", "PreventGradient", "StopGradient", "Snapshot"):
        _run(lambda p: _op(op, p["x"]), {"x": x}, exact=True)

    def with_assert_and_noop(g):
        # Assert and NoOp produce nothing; they reach the fetch only
        # through control edges
        g.add(JNode("chk", "Assert", ["x"]))
        g.add(JNode("done", "NoOp", ["^chk"]))
        g["o"].inputs.append("^done")

    ref, got = _run(lambda p: jdsl.identity(p["x"]), {"x": x}, exact=True,
                    edit=with_assert_and_noop)
    np.testing.assert_array_equal(got[0], x)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------


def _unary_input(op, dtype):
    if np.issubdtype(dtype, np.integer):
        x = _normal((4, 5), dtype)
        return np.where(x == 0, 3, x).astype(dtype) if op in ("Reciprocal", "Inv") else x
    if dtype is BOOL:
        return _normal((4, 5), BOOL)
    x = _normal((4, 5), dtype)
    if op in ("Sqrt", "Rsqrt", "Log", "Log1p"):
        return np.abs(x) + dtype(0.1)
    if op in ("Asin", "Acos"):
        return (np.tanh(x)).astype(dtype)
    if op == "Tan":
        return (np.tanh(x) * 1.2).astype(dtype)
    if op in ("Round", "Rint"):
        # halves round to even, as jnp.round does
        return np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49, 3.7], dtype)
    if op == "Softplus":
        # above torch's softplus threshold of 20 too: the rule must follow
        # jax.nn.softplus (logaddexp), not turn linear
        return np.concatenate([x.ravel(), np.array([20.5, 25.0, 40.0, -30.0], dtype)])
    if op in ("IsNan", "IsInf", "IsFinite"):
        return np.array([1.0, np.nan, np.inf, -np.inf, -2.0, 0.0], dtype)
    return x


_FLOAT_UNARY = [
    "Neg", "Abs", "Square", "Sqrt", "Rsqrt", "Exp", "Log", "Log1p", "Expm1",
    "Sign", "Floor", "Ceil", "Round", "Rint", "Reciprocal", "Inv", "Tanh",
    "Sigmoid", "Relu", "Relu6", "Elu", "Selu", "Softplus", "Softsign", "Erf",
    "Erfc", "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
    "IsNan", "IsInf", "IsFinite", "OnesLike", "ZerosLike",
]
# integer inputs: the ops TF takes them for, and float functions whose
# JAX rule maps int32 -> float32 and int64 -> float64 (Elu, Selu: float64)
_INT_UNARY = [
    "Neg", "Abs", "Square", "Sign", "Floor", "Ceil", "Round", "Relu", "Relu6",
    "OnesLike", "ZerosLike", "jax_Reciprocal", "jax_Inv", "jax_Sqrt",
    "jax_Exp", "jax_Elu", "jax_Softplus", "jax_Erf",
]
_UNARY_CASES = (
    [(op, dt) for op in _FLOAT_UNARY for dt in (F32, F64)]
    + [(op, dt) for op in _INT_UNARY for dt in (I32, I64)]
    + [("LogicalNot", BOOL)]
)


@pytest.mark.parametrize(
    "op,dtype", _UNARY_CASES, ids=[f"{o}-{np.dtype(d).name}" for o, d in _UNARY_CASES]
)
def test_unary(op, dtype):
    op = op.removeprefix("jax_")
    x = _unary_input(op, dtype)
    _run(lambda p: _op(op, p["x"]), {"x": x})


# ---------------------------------------------------------------------------
# elementwise binary, n-ary, select, clip
# ---------------------------------------------------------------------------


def _binary_inputs(op, dtype):
    x, y = _normal((4, 5), dtype, seed=1), _normal((4, 5), dtype, seed=2)
    if dtype is BOOL:
        return x, y
    if op in ("Div", "TruncateDiv", "FloorDiv", "FloorMod", "Mod", "RealDiv"):
        y = np.where(y == 0, 3, y).astype(dtype)
    if op == "Pow":
        if np.issubdtype(dtype, np.integer):
            x, y = np.clip(x, -4, 4), np.abs(y) % 4
        else:
            x, y = np.abs(x) + dtype(0.5), np.clip(y, -3, 3)
    if op in ("Maximum", "Minimum", "Equal", "NotEqual", "LessEqual", "GreaterEqual"):
        y = np.where(np.arange(y.size).reshape(y.shape) % 3 == 0, x, y)  # ties
    return x.astype(dtype), y.astype(dtype)


_ARITH = ["Add", "AddV2", "Sub", "Mul", "Div", "TruncateDiv", "FloorDiv",
          "FloorMod", "Mod", "Maximum", "Minimum", "Pow", "SquaredDifference",
          "jax_RealDiv", "jax_Atan2"]
_COMPARE = ["Equal", "NotEqual", "Less", "LessEqual", "Greater", "GreaterEqual"]
_BINARY_CASES = (
    [(op, dt) for op in _ARITH + _COMPARE for dt in (F32, F64, I32, I64)]
    + [(op, BOOL) for op in ("LogicalAnd", "LogicalOr", "Equal")]
)


@pytest.mark.parametrize(
    "op,dtype", _BINARY_CASES, ids=[f"{o}-{np.dtype(d).name}" for o, d in _BINARY_CASES]
)
def test_binary(op, dtype):
    op = op.removeprefix("jax_")
    x, y = _binary_inputs(op, dtype)
    exact = op in ("Maximum", "Minimum")
    _run(lambda p: _op(op, p["x"], p["y"]), {"x": x, "y": y}, exact=exact)


@pytest.mark.parametrize("dtype", [F32, F64, I32, I64])
def test_nary_select_and_clip(dtype):
    x, y, z = (_normal((4, 5), dtype, seed=s) for s in (1, 2, 3))
    c = _normal((4, 5), BOOL, seed=4)
    feeds = {"x": x, "y": y, "z": z, "c": c}
    for op in ("AddN", "AccumulateNV2"):
        _run(lambda p: _op(op, p["x"], p["y"], p["z"]), feeds)
    for op in ("Select", "SelectV2"):
        _run(lambda p: _op(op, p["c"], p["x"], p["y"]), feeds, exact=True)
    # SelectV2 broadcasts a row condition against the matrix
    _run(lambda p: _op("SelectV2", _const([True, False, True, False, True]), p["x"], p["y"]),
         feeds, exact=True)
    lo, hi = np.asarray(-2, dtype), np.asarray(3, dtype)
    _run(lambda p: _op("ClipByValue", p["x"], _const(lo), _const(hi)), feeds, exact=True)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

_REDUCE_CASES = [
    (op, dt, axes, keep)
    for op, dts in (
        ("Sum", (F32, F64, I32, I64)), ("Prod", (F32, F64, I32, I64)),
        ("Min", (F32, I64)), ("Max", (F64, I32)), ("Mean", (F32, I64)),
        ("All", (BOOL,)), ("Any", (BOOL,)),
    )
    for dt in dts
    for axes, keep in (([0], False), ([1], True), ([0, -1], False), ([], False))
]


@pytest.mark.parametrize(
    "op,dtype,axes,keep", _REDUCE_CASES,
    ids=[f"{o}-{np.dtype(d).name}-{a}-{k}" for o, d, a, k in _REDUCE_CASES],
)
def test_reductions(op, dtype, axes, keep):
    x = _normal((5, 6), dtype)
    if op == "Prod" and dtype in (F32, F64):
        x = (1.0 + x / 30.0).astype(dtype)  # a product of 30 values near 1
    if op == "Prod" and dtype in (I32, I64):
        x = np.clip(x, -2, 2).astype(dtype)
    exact = op in ("Min", "Max", "All", "Any")
    _run(
        lambda p: _op(op, p["x"], _const(axes, I32), keep_dims=keep), {"x": x}, exact=exact
    )


@pytest.mark.parametrize("op", ["ArgMax", "ArgMin"])
@pytest.mark.parametrize("dtype", [F32, F64, I32, I64])
@pytest.mark.parametrize("axis,out_t", [(0, JST.int64), (1, JST.int32)])
def test_arg_reductions_first_index_wins_a_tie(op, dtype, axis, out_t):
    x = np.clip(_normal((6, 7), dtype), -2, 2).astype(dtype)  # many ties
    _run(
        lambda p: _op(op, p["x"], _const(axis, I32), output_type=out_t), {"x": x}, exact=True
    )


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

# ids past the end (5, 7) and negative (-1, -3) are dropped; segment 3 is
# empty
_SEG_IDS = np.array([0, 1, 5, 0, 2, -1, 4, 7, 1, -3], np.int32)


@pytest.mark.parametrize("op", ["UnsortedSegmentSum", "UnsortedSegmentMax", "UnsortedSegmentMin"])
@pytest.mark.parametrize("dtype", [F32, F64, I32, I64])
def test_unsorted_segment_ops_drop_bad_ids_and_fill_empty_segments(op, dtype):
    data = _normal((10, 3), dtype)
    feeds = {"d": data, "ids": _SEG_IDS}
    ref, got = _run(
        lambda p: _op(op, p["d"], p["ids"], _const(5, I32)), feeds,
        exact=op != "UnsortedSegmentSum",
    )
    if op != "UnsortedSegmentSum":  # the empty segment holds the identity
        if dtype in (F32, F64):
            lo, hi = -np.inf, np.inf
        else:
            lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
        np.testing.assert_array_equal(got[0][3], np.full(3, hi if op.endswith("Min") else lo))


def test_segment_ops_over_matrix_cells_with_int64_ids():
    data = _normal((12, 3, 2), F64)
    ids = np.array([0, 2, 2, 1, 0, 9, 2, 2, -1, 0, 1, 1], np.int64)
    for op in ("UnsortedSegmentSum", "UnsortedSegmentMax", "UnsortedSegmentMin"):
        _run(lambda p: _op(op, p["d"], p["ids"], _const(4, I32)), {"d": data, "ids": ids},
             exact=op != "UnsortedSegmentSum")


def test_float_segment_sum_of_many_rows_loses_no_small_addends():
    """Two million float32 squares into 3 segments, against a float64 sum.
    The port adds chunks of rows, then the chunk sums; one float32
    accumulator per segment over all rows would be off by 2e-4 here
    (small addends rounded away against a large running sum)."""
    from tensorframes_tpu_torch.ops.standard import segment_reduce

    rng = _rng()
    x = rng.random((1 << 21, 2)).astype(F32) ** 2
    ids = rng.integers(0, 3, 1 << 21)
    got = segment_reduce(torch.from_numpy(x), torch.from_numpy(ids), 3, "sum").numpy()
    want = np.stack(
        [np.bincount(ids, weights=x[:, j].astype(F64), minlength=3) for j in range(2)], 1
    )
    assert got.dtype == F32
    np.testing.assert_allclose(got, want, rtol=_RTOL[np.dtype(F32)])


@pytest.mark.parametrize("dtype", [F32, I64])
def test_segment_sum_sorted_constant_ids(dtype):
    data = _normal((6, 2), dtype)
    ids = _const([0, 0, 1, 1, 1, 3], I32)  # segment 2 is empty
    _run(lambda p: _op("SegmentSum", p["d"], ids), {"d": data})


# ---------------------------------------------------------------------------
# shape and layout
# ---------------------------------------------------------------------------

X3 = _normal((2, 3, 4), F32)
X2 = _normal((4, 6), F64, seed=5)


def _shape_cases():
    return [
        ("Shape", lambda p: _op("Shape", p["x"], out_type=JST.int32), 1),
        ("Shape_int64", lambda p: _op("Shape", p["x"], out_type=JST.int64), 1),
        ("ShapeN", lambda p: _op("ShapeN", p["x"], p["y"], out_type=JST.int32), 2),
        ("Size", lambda p: _op("Size", p["x"], out_type=JST.int32), 1),
        ("Rank", lambda p: _op("Rank", p["x"]), 1),
        ("Range_int", lambda p: _op("Range", _const(2, I32), _const(11, I32), _const(3, I32)), 1),
        ("Range_float", lambda p: _op("Range", _const(0.5, F32), _const(2.0, F32), _const(0.25, F32)), 1),
        ("Reshape_from_Shape",
         lambda p: _op("Reshape", p["y"], _op("Shape", p["y"], out_type=JST.int32)), 1),
        ("ExpandDims_0", lambda p: _op("ExpandDims", p["x"], _const(0, I32)), 1),
        ("ExpandDims_-1", lambda p: _op("ExpandDims", p["x"], _const(-1, I32)), 1),
        ("Squeeze_dims", lambda p: _op("Squeeze", _op("ExpandDims", p["x"], _const(1, I32)),
                                       squeeze_dims=[1]), 1),
        ("Squeeze_all", lambda p: _op("Squeeze", _op("ExpandDims", p["x"], _const(2, I32))), 1),
        ("Transpose", lambda p: _op("Transpose", p["x"], _const([2, 0, 1], I32)), 1),
        ("Fill", lambda p: _op("Fill", _const([2, 3], I32), _const(1.5, F32)), 1),
        ("Tile", lambda p: _op("Tile", p["x"], _const([2, 1, 3], I32)), 1),
        ("Tile_more_reps_than_dims", lambda p: _op("Tile", p["y"], _const([2, 1, 3], I32)), 1),
        ("Concat", lambda p: _op("Concat", _const(1, I32), p["x"], p["x"]), 1),
        ("ConcatV2", lambda p: _op("ConcatV2", p["x"], p["x"], _const(-1, I32)), 1),
        ("Pack_0", lambda p: _op("Pack", p["x"], p["x"], axis=0), 1),
        ("Stack_2", lambda p: _op("Stack", p["x"], p["x"], axis=2), 1),
        ("Unpack", lambda p: _op("Unpack", p["x"], axis=1, num=3), 3),
        ("Split", lambda p: _op("Split", _const(2, I32), p["x"], num_split=2), 2),
        ("SplitV_inferred", lambda p: _op("SplitV", p["x"], _const([1, -1, 2], I32),
                                          _const(2, I32)), 3),
        ("Slice", lambda p: _op("Slice", p["x"], _const([1, 0, 1], I32), _const([1, -1, 2], I32)), 1),
        ("BroadcastTo", lambda p: _op("BroadcastTo", p["z"], _const([3, 2, 4], I32)), 1),
        ("Reshape", lambda p: _op("Reshape", p["x"], _const([4, -1], I32)), 1),
    ]


@pytest.mark.parametrize("name,build,n_out", _shape_cases(), ids=[c[0] for c in _shape_cases()])
def test_shape_and_layout(name, build, n_out):
    feeds = {"x": X3, "y": X2, "z": _normal((4,), F32, seed=6)}
    _run(build, feeds, n_out=n_out, exact=True)


def test_shape_results_stay_static():
    """Shape feeds a Reshape target: the port must read it as a constant."""
    g, _ = jdsl.build(
        _op("Fill", _op("Shape", _ph(X2, "y"), out_type=JST.int32), _const(2.0, F64)).named("o")
    )
    fn = t_build(TGraph.from_bytes(g.to_bytes()), ["o"], ["y"], CPU)
    np.testing.assert_array_equal(_to_numpy(fn(torch.from_numpy(X2))[0]), np.full(X2.shape, 2.0))


_STRIDED = [  # (id, begin, end, strides, masks)
    ("plain", [1, 0, 0], [2, 3, 4], [1, 1, 1], {}),
    ("negative_strides", [1, 2, 3], [0, 0, 0], [-1, -1, -2], {}),
    ("masked_full_reverse", [0, 0], [0, 0], [-1, -1], dict(begin_mask=3, end_mask=3)),
    ("shrink_axis", [1], [2], [1], dict(shrink_axis_mask=1)),
    ("negative_shrink", [-1, 0], [0, 3], [1, 2], dict(shrink_axis_mask=1)),
    ("ellipsis", [0, 1], [0, 3], [1, 1], dict(ellipsis_mask=1)),
    ("ellipsis_then_reverse", [0, 0], [0, 0], [1, -1], dict(ellipsis_mask=1, begin_mask=2, end_mask=2)),
    ("new_axis", [0, 0], [0, 2], [1, 1], dict(new_axis_mask=1)),
    ("out_of_range_ends_step_-2", [10, 1], [-10, 3], [-2, 1], {}),
    ("empty", [2, 0], [1, 3], [1, 1], {}),
    ("empty_negative", [0, 0], [1, 3], [-1, 1], {}),
]


@pytest.mark.parametrize("name,begin,end,strides,masks", _STRIDED, ids=[c[0] for c in _STRIDED])
def test_strided_slice(name, begin, end, strides, masks):
    x = _normal((4, 5, 6), I64)
    _run(
        lambda p: _op("StridedSlice", p["x"], _const(begin, I32), _const(end, I32),
                      _const(strides, I32), **masks),
        {"x": x}, exact=True,
    )


@pytest.mark.parametrize("dtype", [F32, I32])
@pytest.mark.parametrize(
    "op,pads,extra",
    [
        ("Pad", [[1, 2], [0, 1], [0, 0]], {}),
        ("PadV2", [[0, 0], [2, 1], [1, 1]], {"value": 5}),
        ("MirrorPad", [[1, 2], [2, 0], [0, 3]], {"mode": "REFLECT"}),
        ("MirrorPad", [[2, 3], [0, 4], [1, 0]], {"mode": "SYMMETRIC"}),
        ("MirrorPad", [[3, 3], [0, 0], [0, 0]], {"mode": "REFLECT"}),  # lead axis only
    ],
    ids=["Pad", "PadV2", "MirrorPad_REFLECT", "MirrorPad_SYMMETRIC", "MirrorPad_REFLECT_axis0"],
)
def test_pads(op, pads, extra, dtype):
    x = _normal((4, 5, 6), dtype)
    args = [_const(pads, I32)]
    if "value" in extra:
        args.append(_const(extra["value"], dtype))
    attrs = {"mode": extra["mode"]} if "mode" in extra else {}
    _run(lambda p: _op(op, p["x"], *args, **attrs), {"x": x}, exact=True)


# ---------------------------------------------------------------------------
# gather / scatter / one-hot / top-k / cumsum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, F64, I32, I64])
def test_gather_past_either_end_fills_and_negative_wraps(dtype):
    params = _normal((5, 3), dtype)
    feeds = {"p": params, "i": np.array([0, 4, -1, 5, -7, 2], np.int32)}
    ref, got = _run(lambda p: _op("GatherV2", p["p"], p["i"], _const(0, I32)), feeds, exact=True)
    np.testing.assert_array_equal(got[0][2], params[-1])
    # jnp.take: NaN for a float index past the end, the int type's min else
    fill = np.nan if dtype in (F32, F64) else np.iinfo(dtype).min
    np.testing.assert_array_equal(got[0][3], np.full(3, fill, dtype))
    # a 2-D index along axis 1, and the TF 1.x Gather (axis 0)
    feeds2 = {"p": params, "i": np.array([[0, 2], [1, -1]], np.int64)}
    _run(lambda p: _op("GatherV2", p["p"], p["i"], _const(1, I32)), feeds2, exact=True)
    _run(lambda p: _op("Gather", p["p"], p["i"]), feeds2, exact=True)


def test_gather_nd_and_scatter_nd_duplicates_add():
    params = _normal((4, 5), F32)
    idx = np.array([[0, 1], [3, 4], [-1, 2], [2, -5]], np.int32)
    _run(lambda p: _op("GatherNd", p["p"], p["i"]), {"p": params, "i": idx}, exact=True)
    _run(lambda p: _op("GatherNd", p["p"], p["i"]), {"p": params, "i": idx[:, :1]}, exact=True)
    upd = _normal((3, 4), F64)
    sidx = np.array([[0], [2], [0]], np.int64)  # row 0 twice: the updates add
    ref, got = _run(lambda p: _op("ScatterNd", p["i"], p["u"], _const([4, 4], I32)),
                    {"i": sidx, "u": upd})
    np.testing.assert_allclose(got[0][0], upd[0] + upd[2])


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [F32, I64])
def test_one_hot(axis, dtype):
    x = np.array([[0, 2, -1], [5, 3, 1]], np.int32)  # -1 and 5: all off
    on, off = _const(5, dtype), _const(-1, dtype)
    _run(lambda p: _op("OneHot", p["x"], _const(4, I32), on, off, axis=axis), {"x": x}, exact=True)


@pytest.mark.parametrize("dtype", [F32, I32, I64])
@pytest.mark.parametrize("op", ["TopK", "TopKV2"])
def test_top_k_ties_keep_the_lower_index_first(op, dtype):
    x = np.array([[3, 1, 3, 2, 3, 0], [0, 0, 0, 1, 1, 2], [5, 4, 3, 2, 1, 0]], dtype)
    if op == "TopK":
        build = lambda p: _op("TopK", p["x"], k=4)  # noqa: E731
    else:
        build = lambda p: _op("TopKV2", p["x"], _const(4, I32))  # noqa: E731
    _run(build, {"x": x}, n_out=2, exact=True)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,axis", [(F32, 1), (I32, 0), (F64, -1)])
def test_cumsum(exclusive, reverse, dtype, axis):
    x = _normal((4, 5), dtype)
    _run(lambda p: _op("Cumsum", p["x"], _const(axis, I32), exclusive=exclusive, reverse=reverse),
         {"x": x})


# ---------------------------------------------------------------------------
# NN without convolutions, casts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, F64])
def test_nn_ops(dtype):
    x = _normal((4, 7), dtype)
    _run(lambda p: _op("LeakyRelu", p["x"], alpha=0.1), {"x": x})
    _run(lambda p: _op("LeakyRelu", p["x"]), {"x": x})  # TF's default alpha 0.2
    _run(lambda p: _op("LogSoftmax", p["x"]), {"x": x})
    _run(lambda p: _op("L2Loss", p["x"]), {"x": x})
    _run(lambda p: _op("Softmax", p["x"]), {"x": x})


@pytest.mark.parametrize("src,dst", [(F32, JST.int64), (I64, JST.float32), (BOOL, JST.int32),
                                     (F64, JST.bool_)])
def test_cast(src, dst):
    x = _normal((3, 4), src)
    _run(lambda p: _op("Cast", p["x"], DstT=dst), {"x": x}, exact=True)


def test_kmeans_assignment_ops_lower_in_both():
    """The k-means partial graph (ArgMin, ConcatV2, UnsortedSegmentSum)."""
    pts, centers = _normal((50, 4), F32, seed=1), _normal((3, 4), F32, seed=2)

    def build(p):
        x, c = p["x"], p["c"]
        p2 = jdsl.reduce_sum(jdsl.square(x), axes=[1], keep_dims=True)
        d = p2 - 2.0 * jdsl.matmul(x, c, transpose_b=True) + jdsl.reduce_sum(jdsl.square(c), axes=[1])
        assign = jdsl.cast(jdsl.argmin(d, axis=1), JST.int32)
        ones = jdsl.reduce_sum(x * 0.0, axes=[1], keep_dims=True) + 1.0
        return jdsl.unsorted_segment_sum(jdsl.concat([x, ones], axis=1), assign, 3)

    _run(build, {"x": pts, "c": centers})
