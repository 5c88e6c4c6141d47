"""PyTorch port: the convolution family held to the JAX rules on the CPU.

Conv2D, DepthwiseConv2dNative, MaxPool/MaxPoolV2, AvgPool,
FusedBatchNorm/V2/V3, BatchNormWithGlobalNormalization, LRN and
ResizeBilinear. Each case builds one graph with the JAX DSL, serialises it,
lowers the same bytes in both packages and feeds both the same seeded numpy
inputs. Sizes are odd where TF's ``SAME`` padding puts the extra row or
column at the bottom and right.

Tolerances: max pooling only selects values, so it is exact. Every other
float32 result is held to rtol 1e-5 and atol 1e-5: convolutions, windows and
normalisations sum up to a few dozen products of values of order 1 in
another order in each framework (XLA's CPU convolution against ATen's), so
an output near zero may differ by a few ulps of its summands. float64 cases
use rtol 1e-10, atol 1e-12.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu  # noqa: F401  (x64 on, as in the reference's tests)
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu.graph.ir import Graph as JGraph
from tensorframes_tpu.ops.lowering import build_callable as j_build
from tensorframes_tpu.proto.graphdef import AttrValue
from tensorframes_tpu.schema import ScalarType as JST, Shape as JShape
from tensorframes_tpu_torch.frame import _to_numpy
from tensorframes_tpu_torch.graph.ir import Graph as TGraph
from tensorframes_tpu_torch.ops.lowering import build_callable as t_build
from tensorframes_tpu_torch.ops.registry import GraphLoweringError

CPU = torch.device("cpu")
F32, F64, I32 = np.float32, np.float64, np.int32
_TOL = {np.dtype(F32): (1e-5, 1e-5), np.dtype(F64): (1e-10, 1e-12)}


def _normal(shape, dtype=F32, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-20, 21, shape).astype(dtype)
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _ph(arr, name):
    return jdsl.placeholder(JST.from_np_dtype(arr.dtype), JShape(arr.shape), name=name)


def _op(name, *parents, **attrs):
    extra = {}
    for k, v in attrs.items():
        if isinstance(v, JST):
            extra[k] = AttrValue.of_type(v)
        elif isinstance(v, bool):
            extra[k] = AttrValue.of_bool(v)
        elif isinstance(v, int):
            extra[k] = AttrValue.of_int(v)
        elif isinstance(v, float):
            extra[k] = AttrValue("f", v)
        elif isinstance(v, str):
            extra[k] = AttrValue.of_string(v)
        else:
            extra[k] = AttrValue.of_ints(list(v))
    return jdsl._nary(name, list(parents), extra_attrs=extra)


def _run(build, feeds, n_out=1, exact=False):
    """Build with the JAX DSL, ship as bytes, run in both packages and
    compare every output."""
    phs = {n: _ph(a, n) for n, a in feeds.items()}
    g, _ = jdsl.build(build(phs).named("o"))
    raw = g.to_bytes()
    fetches = ["o"] if n_out == 1 else [f"o:{i}" for i in range(n_out)]
    names = sorted(feeds)
    ref = j_build(JGraph.from_bytes(raw), fetches, names)(*[feeds[n] for n in names])
    got = t_build(TGraph.from_bytes(raw), fetches, names, CPU)(
        *[torch.from_numpy(np.array(feeds[n])) for n in names]
    )
    for r, o in zip(ref, got):
        r, o = np.asarray(r), _to_numpy(o)
        assert (o.shape, o.dtype) == (r.shape, r.dtype)
        if exact:
            np.testing.assert_array_equal(o, r)
        else:
            rtol, atol = _TOL[r.dtype]
            np.testing.assert_allclose(o, r, rtol=rtol, atol=atol)
    return [np.asarray(r) for r in ref]


def _nhwc(strides_hw, fmt):
    s = list(strides_hw)
    return [1, s[0], s[1], 1] if fmt == "NHWC" else [1, 1, s[0], s[1]]


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kernel", [(3, 3), (2, 4)])
def test_conv2d(padding, stride, fmt, kernel):
    x = _normal((2, 9, 7, 3) if fmt == "NHWC" else (2, 3, 9, 7))
    w = _normal(kernel + (3, 4), seed=1)
    _run(
        lambda p: _op("Conv2D", p["x"], p["w"], T=JST.float32, strides=_nhwc((stride, stride), fmt),
                      padding=padding, data_format=fmt),
        {"x": x, "w": w},
    )


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_dilated_and_uneven_strides(padding):
    x = _normal((1, 11, 10, 2))
    w = _normal((3, 3, 2, 5), seed=2)
    _run(
        lambda p: _op("Conv2D", p["x"], p["w"], T=JST.float32, strides=[1, 1, 1, 1],
                      dilations=[1, 2, 2, 1], padding=padding),
        {"x": x, "w": w},
    )
    _run(
        lambda p: _op("Conv2D", p["x"], p["w"], T=JST.float32, strides=[1, 2, 3, 1],
                      padding=padding),
        {"x": x, "w": w},
    )


def test_conv2d_float64():
    x, w = _normal((2, 6, 5, 3), F64), _normal((3, 3, 3, 2), F64, seed=3)
    _run(lambda p: _op("Conv2D", p["x"], p["w"], T=JST.float64, strides=[1, 2, 2, 1],
                       padding="SAME"), {"x": x, "w": w})


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("multiplier", [1, 2])
def test_depthwise_conv(padding, stride, multiplier):
    """Output channel c*M + m comes from input channel c."""
    x = _normal((2, 9, 8, 3))
    w = _normal((3, 3, 3, multiplier), seed=4)
    _run(
        lambda p: _op("DepthwiseConv2dNative", p["x"], p["w"], T=JST.float32,
                      strides=[1, stride, stride, 1], padding=padding),
        {"x": x, "w": w},
    )


def test_depthwise_conv_refuses_what_the_jax_rule_computes_as_nhwc():
    x, w = _normal((1, 3, 5, 5)), _normal((3, 3, 3, 1), seed=5)
    for attrs in ({"data_format": "NCHW"}, {"dilations": [1, 2, 2, 1]}):
        g, _ = jdsl.build(_op("DepthwiseConv2dNative", _ph(x, "x"), _ph(w, "w"),
                              strides=[1, 1, 1, 1], padding="SAME", **attrs).named("o"))
        fn = t_build(TGraph.from_bytes(g.to_bytes()), ["o"], ["w", "x"], CPU)
        with pytest.raises(GraphLoweringError, match="DepthwiseConv2dNative"):
            fn(torch.from_numpy(w), torch.from_numpy(x))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["MaxPool", "MaxPoolV2", "AvgPool"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (2, 2), (2, 3)])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_pooling(op, padding, k, stride, fmt):
    x = _normal((2, 9, 8, 3) if fmt == "NHWC" else (2, 3, 9, 8), scale=3.0)
    _run(
        lambda p: _op(op, p["x"], T=JST.float32, ksize=_nhwc((k, k), fmt),
                      strides=_nhwc((stride, stride), fmt), padding=padding,
                      data_format=fmt),
        {"x": x}, exact=op != "AvgPool",
    )


def test_avg_pool_same_divides_by_in_bounds_count():
    # a 2x2 window over an odd size: TF pads only the bottom/right edge,
    # and those windows average fewer elements
    x = np.arange(25, dtype=F32).reshape(1, 5, 5, 1)
    ref = _run(
        lambda p: _op("AvgPool", p["x"], ksize=[1, 2, 2, 1], strides=[1, 2, 2, 1],
                      padding="SAME"),
        {"x": x},
    )
    assert ref[0][0, 2, 2, 0] == 24.0  # the corner window holds one element
    assert ref[0][0, 0, 2, 0] == (4.0 + 9.0) / 2


def test_max_pool_rectangular_window():
    x = _normal((1, 7, 9, 2), scale=3.0)
    _run(lambda p: _op("MaxPool", p["x"], ksize=[1, 3, 2, 1], strides=[1, 2, 1, 1],
                       padding="SAME"), {"x": x}, exact=True)


# ---------------------------------------------------------------------------
# normalisations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_fused_batch_norm(op, training, fmt):
    c = 4
    x = _normal((3, 5, 6, c) if fmt == "NHWC" else (3, c, 5, 6), scale=2.0)
    vals = {
        "x": x,
        "scale": _normal((c,), seed=1) + 1.0,
        "offset": _normal((c,), seed=2),
        "mean": _normal((c,), seed=3) * 0.1,
        "var": np.abs(_normal((c,), seed=4)) + 0.5,
    }
    _run(
        lambda p: _op(op, p["x"], p["scale"], p["offset"], p["mean"], p["var"],
                      T=JST.float32, epsilon=1e-3, is_training=training, data_format=fmt),
        vals, n_out=3,
    )


def test_fused_batch_norm_default_epsilon():
    c = 3
    vals = {"x": _normal((2, 4, 4, c)), "s": np.ones(c, F32), "b": np.zeros(c, F32),
            "m": np.zeros(c, F32), "v": np.full(c, 1e-4, F32)}
    _run(lambda p: _op("FusedBatchNorm", p["x"], p["s"], p["b"], p["m"], p["v"]), vals, n_out=3)


@pytest.mark.parametrize("scale_after", [True, False])
def test_batch_norm_with_global_normalization(scale_after):
    c = 5
    vals = {
        "x": _normal((2, 3, 4, c), scale=2.0),
        "mean": _normal((c,), seed=1) * 0.1,
        "var": np.abs(_normal((c,), seed=2)) + 0.5,
        "beta": _normal((c,), seed=3),
        "gamma": _normal((c,), seed=4) + 1.0,
    }
    _run(
        lambda p: _op("BatchNormWithGlobalNormalization", p["x"], p["mean"], p["var"],
                      p["beta"], p["gamma"], variance_epsilon=1e-3,
                      scale_after_normalization=scale_after),
        vals,
    )


@pytest.mark.parametrize(
    "attrs",
    [{}, {"depth_radius": 2, "bias": 2.0, "alpha": 1e-3, "beta": 0.75}, {"depth_radius": 0}],
    ids=["defaults", "alexnet", "radius0"],
)
def test_lrn(attrs):
    x = _normal((2, 3, 4, 7), scale=2.0)
    _run(lambda p: _op("LRN", p["x"], **attrs), {"x": x})


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode",
    [{}, {"align_corners": True}, {"half_pixel_centers": True}],
    ids=["asymmetric", "align_corners", "half_pixel"],
)
@pytest.mark.parametrize("size", [(9, 13), (3, 2), (1, 1)], ids=["up", "down", "one"])
@pytest.mark.parametrize("dtype", [F32, I32])
def test_resize_bilinear(mode, size, dtype):
    """Always float32 out, for any input type."""
    x = _normal((2, 5, 6, 3), dtype, scale=4.0)
    ref = _run(
        lambda p: _op("ResizeBilinear", p["x"], jdsl.constant(np.array(size, I32)), **mode),
        {"x": x},
    )
    assert ref[0].dtype == np.float32 and ref[0].shape == (2,) + size + (3,)
