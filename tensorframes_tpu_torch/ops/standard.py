"""Standard op set: torch lowerings for the TF GraphDef ops of the port.

The PyTorch counterpart of `tensorframes_tpu/ops/standard.py`: every rule
of that module (`ops.control` holds the control-flow ones). An op without a
rule raises `GraphLoweringError` naming it at build time.

The JAX rules are the reference, also where they depart from TF:
- binary ops do NOT promote dtypes (the graph's ``T`` attr fixes one dtype);
- ``Div`` on integers truncates toward zero, ``RealDiv`` is true division;
- a float function of an integer tensor (Sqrt, Exp, Reciprocal, RealDiv,
  Atan2, ...) computes in float32 for int32 and narrower, in float64 for
  int64, as `jax.numpy` does with x64 on; Elu and Selu always give float64;
- reductions take ``reduction_indices`` as a constant input plus a
  ``keep_dims`` attr; empty indices reduce over every axis and Sum/Prod
  keep the input dtype;
- segment ops drop ids outside ``[0, num_segments)``; an empty segment of
  Max/Min holds -inf/+inf (floats) or the integer type's min/max;
- Gather returns NaN (floats) or the integer type's min for an index past
  either end and wraps a negative index, as `jnp.take` does.

Shape, ShapeN, Size, Rank and Range return host numpy like Const, so a
downstream `LowerCtx.static` still recovers them.

The convolution family (Conv2D, DepthwiseConv2dNative, MaxPool/MaxPoolV2,
AvgPool) takes NHWC tensors and HWIO filters, as TF graphs do, and runs
them on ATen's (cuDNN's on the card) NCHW kernels through ``channels_last``
views: an NHWC tensor permuted to NCHW is already ``channels_last``, so no
layout copy is made. TF's ``SAME`` padding puts the odd row or column at
the bottom and right, which ATen's symmetric padding cannot express; such
a pad is made explicit with `F.pad` (-inf for MaxPool), and AvgPool divides
by the count of in-bounds elements, as the JAX rule does.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.ir import GraphNode
from ..schema import ScalarType
from .registry import GraphLoweringError, LowerCtx, register

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _reduction_axes(ctx: LowerCtx, node: GraphNode, x, indices) -> Tuple[int, ...]:
    rank = x.dim()
    axes = ctx.static_int_list(indices, node, "reduction_indices")
    return tuple(sorted({a % rank for a in axes})) if axes else tuple(range(rank))


def _keep_dims(node: GraphNode) -> bool:
    return bool(node.attr("keep_dims", node.attr("keepdims", False)))


def _data_format(node: GraphNode) -> str:
    df = node.attr("data_format", b"NHWC")
    return df.decode() if isinstance(df, bytes) else str(df)


def _inexact(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the float type `jax.numpy` computes a float function of it
    in: floats stay, int64 becomes float64, narrower ints and bool float32."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x
    return x.to(torch.float64 if x.dtype is torch.int64 else torch.float32)


def _static_axis(ctx: LowerCtx, value, node: GraphNode, what: str) -> int:
    return int(ctx.static(value, node, what))


# ---------------------------------------------------------------------------
# sources / identity
# ---------------------------------------------------------------------------


@register("Const")
def _const(ctx, node, inputs):
    av = node.attrs.get("value")
    if av is None or av.kind != "tensor":
        raise GraphLoweringError(f"Const node {node.name!r} has no value attr")
    return av.value.to_numpy()  # stays host-side until an op needs a tensor


@register("Identity", "StopGradient", "PreventGradient", "CheckNumerics", "Snapshot")
def _identity(ctx, node, inputs):
    return inputs[0]


@register("IdentityN")
def _identity_n(ctx, node, inputs):
    return tuple(inputs)


@register("NoOp", "Assert")
def _noop(ctx, node, inputs):
    # Assert only orders its consumers (control edges); the shapes it
    # guards are facts of the lowered call, so like NoOp it yields nothing
    return ()


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------


def _keep_int(fn):
    """Floor/Ceil/Round of an integer tensor is the tensor itself."""
    return lambda x: fn(x) if x.dtype.is_floating_point else x


def _float_fn(fn):
    return lambda x: fn(_inexact(x))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus turns
    # linear above its threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


_UNARY = {
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Square": torch.square,
    "Sqrt": _float_fn(torch.sqrt),
    "Rsqrt": torch.rsqrt,
    "Exp": _float_fn(torch.exp),
    "Log": _float_fn(torch.log),
    "Log1p": _float_fn(torch.log1p),
    "Expm1": _float_fn(torch.expm1),
    "Sign": torch.sign,
    "Floor": _keep_int(torch.floor),
    "Ceil": _keep_int(torch.ceil),
    # torch.round rounds half to even, as jnp.round does
    "Round": _keep_int(torch.round),
    "Rint": _keep_int(torch.round),
    "Reciprocal": _float_fn(torch.reciprocal),
    "Inv": _float_fn(torch.reciprocal),
    "Tanh": _float_fn(torch.tanh),
    "Sigmoid": torch.sigmoid,
    "Relu": torch.relu,
    "Relu6": lambda x: torch.clamp(x, 0, 6),
    "Elu": lambda x: F.elu(x if x.dtype.is_floating_point else x.double()),
    "Selu": lambda x: F.selu(x if x.dtype.is_floating_point else x.double()),
    "Softplus": _float_fn(_softplus),
    "Softsign": _float_fn(F.softsign),
    "Erf": _float_fn(torch.special.erf),
    "Erfc": _float_fn(torch.special.erfc),
    "Sin": _float_fn(torch.sin),
    "Cos": _float_fn(torch.cos),
    "Tan": _float_fn(torch.tan),
    "Asin": _float_fn(torch.asin),
    "Acos": _float_fn(torch.acos),
    "Atan": _float_fn(torch.atan),
    "Sinh": _float_fn(torch.sinh),
    "Cosh": _float_fn(torch.cosh),
    "IsNan": torch.isnan,
    "IsInf": torch.isinf,
    "IsFinite": torch.isfinite,
    "LogicalNot": torch.logical_not,
    "OnesLike": torch.ones_like,
    "ZerosLike": torch.zeros_like,
}

for _name, _fn in _UNARY.items():
    register(_name)(
        lambda ctx, node, inputs, _fn=_fn: _fn(ctx.tensor(inputs[0]))
    )


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------


def _tf_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return torch.true_divide(x, y)
    return torch.div(x, y, rounding_mode="trunc")  # C truncation


_BINARY = {
    "Add": torch.add,
    "AddV2": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": _tf_div,
    "RealDiv": lambda x, y: torch.true_divide(_inexact(x), _inexact(y)),
    "TruncateDiv": _tf_div,
    "FloorDiv": lambda x, y: torch.div(x, y, rounding_mode="floor"),
    # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod
    "FloorMod": torch.remainder,
    "Mod": torch.remainder,
    "Maximum": torch.maximum,
    "Minimum": torch.minimum,
    "Pow": torch.pow,
    "SquaredDifference": lambda x, y: torch.square(x - y),
    "Atan2": lambda x, y: torch.atan2(_inexact(x), _inexact(y)),
    "Equal": torch.eq,
    "NotEqual": torch.ne,
    "Less": torch.lt,
    "LessEqual": torch.le,
    "Greater": torch.gt,
    "GreaterEqual": torch.ge,
    "LogicalAnd": torch.logical_and,
    "LogicalOr": torch.logical_or,
}

for _name, _fn in _BINARY.items():
    register(_name)(
        lambda ctx, node, inputs, _fn=_fn: _fn(
            ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
        )
    )


@register("AddN", "AccumulateNV2")
def _add_n(ctx, node, inputs):
    out = ctx.tensor(inputs[0])
    for x in inputs[1:]:
        out = out + ctx.tensor(x)
    return out


@register("Select", "SelectV2")
def _select(ctx, node, inputs):
    cond, a, b = (ctx.tensor(v) for v in inputs[:3])
    return torch.where(cond.to(torch.bool), a, b)


@register("ClipByValue")
def _clip(ctx, node, inputs):
    x, lo, hi = (ctx.tensor(v) for v in inputs[:3])
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# reductions (constant axes input + keep_dims attr)
# ---------------------------------------------------------------------------


def _reducer(reduce_fn):
    def rule(ctx, node, inputs):
        x = ctx.tensor(inputs[0])
        axes = _reduction_axes(ctx, node, x, inputs[1])
        if not axes:  # a scalar reduces to itself
            return reduce_fn(x.unsqueeze(0), (0,), False)
        return reduce_fn(x, axes, _keep_dims(node))

    return rule


def _prod(x: torch.Tensor, axes, keep: bool) -> torch.Tensor:
    # torch.prod takes one dim; reducing the highest first keeps the
    # lower axis numbers valid
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, a, keepdim=keep, dtype=x.dtype)
    return x


def _mean(x: torch.Tensor, axes, keep: bool) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return torch.mean(x, axes, keepdim=keep)
    # TF Mean on integers: integer division of the sum by the count
    count = 1
    for a in axes:
        count *= x.shape[a]
    total = torch.sum(x, axes, keepdim=keep, dtype=x.dtype)
    return torch.div(total, count, rounding_mode="trunc")


# TF reductions keep the input dtype (torch.sum would widen int32 to int64)
register("Sum")(_reducer(lambda x, a, k: torch.sum(x, a, keepdim=k, dtype=x.dtype)))
register("Prod")(_reducer(_prod))
register("Min")(_reducer(lambda x, a, k: torch.amin(x, a, keepdim=k)))
register("Max")(_reducer(lambda x, a, k: torch.amax(x, a, keepdim=k)))
register("All")(_reducer(lambda x, a, k: torch.all(x.to(torch.bool), a, keepdim=k)))
register("Any")(_reducer(lambda x, a, k: torch.any(x.to(torch.bool), a, keepdim=k)))
register("Mean")(_reducer(_mean))


def _arg_reduce(torch_fn):
    def rule(ctx, node, inputs):
        x = ctx.tensor(inputs[0])
        axis = _static_axis(ctx, inputs[1], node, "dimension") if len(inputs) > 1 else 0
        out_t = node.attr("output_type", ScalarType.int64)
        # torch.argmax/argmin return the first index of a tie, as jnp does
        return torch_fn(x, dim=axis).to(out_t.torch_dtype)

    return rule


register("ArgMax")(_arg_reduce(torch.argmax))
register("ArgMin")(_arg_reduce(torch.argmin))


# ---------------------------------------------------------------------------
# segment ops (k-means / aggregate family)
# ---------------------------------------------------------------------------


def _segment_identity(dtype: torch.dtype, reduce: str):
    """The value an empty segment holds, as in `jax.ops.segment_*`."""
    if reduce == "sum":
        return 0
    if reduce == "prod":
        return 1
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    if dtype is torch.bool:
        return reduce != "amax"
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


# A float segment sum adds at most this many rows into one accumulator in
# arrival order; the chunk sums are then added by a tree reduction.
_SUM_CHUNK_ROWS = 4096
# ... as long as the chunk sums take at most this many elements.
_SUM_CHUNK_ELEMS = 1 << 24


def _float_segment_sum(data: torch.Tensor, ids: torch.Tensor, segments: int) -> torch.Tensor:
    """Segment sum of floats in two levels: ``index_add`` into one row of
    ``segments`` accumulators per chunk of `_SUM_CHUNK_ROWS` rows, then a
    `torch.sum` over the chunks.

    One level would add every row of a segment into one float32
    accumulator, in the order the device's atomics land: for millions of
    rows that loses small addends to rounding (a bias, not noise) and
    serialises the atomics on a handful of addresses."""
    n, rest = data.shape[0], tuple(data.shape[1:])
    width = segments * max(1, int(np.prod(rest)))
    chunks = min(-(-n // _SUM_CHUNK_ROWS), max(1, _SUM_CHUNK_ELEMS // width))
    out = torch.zeros((segments,) + rest, dtype=data.dtype, device=data.device)
    if chunks <= 1:
        return out.index_add(0, ids, data)
    rows_per_chunk = -(-n // chunks)
    slot = torch.arange(n, device=data.device) // rows_per_chunk * segments + ids
    part = torch.zeros((chunks * segments,) + rest, dtype=data.dtype, device=data.device)
    part = part.index_add(0, slot, data)
    return torch.sum(part.reshape((chunks, segments) + rest), 0)


def segment_reduce(
    data: torch.Tensor, ids: torch.Tensor, num: int, reduce: str
) -> torch.Tensor:
    """``out[s] = reduce(data[i] for ids[i] == s)`` over ``num`` segments.

    Ids outside ``[0, num)`` are dropped, as JAX drops them: they are sent
    to one spare segment past the end, which is cut off, so no device
    assert sees them. Out of place, so it also runs under
    `torch.func.vmap`."""
    rest = tuple(data.shape[1:])
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num), ids, num)
    if reduce == "sum" and data.dtype.is_floating_point:
        return _float_segment_sum(data, ids, num + 1)[:num]
    out = torch.full(
        (num + 1,) + rest, _segment_identity(data.dtype, reduce),
        dtype=data.dtype, device=data.device,
    )
    if reduce == "sum":
        out = out.index_add(0, ids, data)
    else:
        index = ids.reshape((-1,) + (1,) * len(rest)).expand(data.shape)
        out = out.scatter_reduce(0, index, data, reduce, include_self=True)
    return out[:num]


def _segment_rule(reduce: str):
    def rule(ctx, node, inputs):
        num = _static_axis(ctx, inputs[2], node, "num_segments")
        return segment_reduce(ctx.tensor(inputs[0]), ctx.tensor(inputs[1]), num, reduce)

    return rule


register("UnsortedSegmentSum")(_segment_rule("sum"))
register("UnsortedSegmentMax")(_segment_rule("amax"))
register("UnsortedSegmentMin")(_segment_rule("amin"))


@register("SegmentSum")
def _segment_sum(ctx, node, inputs):
    ids = ctx.static(inputs[1], node, "segment_ids (data-dependent segment "
                     "count; use UnsortedSegmentSum with static num_segments)")
    num = int(ids.max()) + 1 if ids.size else 0
    return segment_reduce(ctx.tensor(inputs[0]), ctx.tensor(ids), num, "sum")


# ---------------------------------------------------------------------------
# linear algebra / NN
# ---------------------------------------------------------------------------


@register("MatMul", "BatchMatMul", "BatchMatMulV2")
def _matmul(ctx, node, inputs):
    a, b = ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
    if node.attr("transpose_a", node.attr("adj_x", False)):
        a = a.transpose(-1, -2)
    if node.attr("transpose_b", node.attr("adj_y", False)):
        b = b.transpose(-1, -2)
    # full float32: the package turns TF32 off (tensorframes_tpu_torch/__init__)
    return torch.matmul(a, b)


@register("L2Loss")
def _l2loss(ctx, node, inputs):
    x = ctx.tensor(inputs[0])
    return torch.sum(torch.square(x), dtype=x.dtype) / 2


@register("BiasAdd")
def _bias_add(ctx, node, inputs):
    x, b = ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
    if _data_format(node) == "NCHW" and x.dim() == 4:
        return x + b.reshape(1, -1, 1, 1)
    return x + b


@register("Softmax")
def _softmax(ctx, node, inputs):
    return torch.softmax(ctx.tensor(inputs[0]), dim=-1)


@register("LogSoftmax")
def _log_softmax(ctx, node, inputs):
    return torch.log_softmax(ctx.tensor(inputs[0]), dim=-1)


@register("LeakyRelu")
def _leaky_relu(ctx, node, inputs):
    alpha = float(node.attr("alpha", 0.2))
    return F.leaky_relu(ctx.tensor(inputs[0]), negative_slope=alpha)


# ---------------------------------------------------------------------------
# convolution family (Inception): NHWC graphs on ATen's NCHW kernels
# ---------------------------------------------------------------------------


def _data_inputs(ctx, node: GraphNode, inputs, n: int) -> List[torch.Tensor]:
    """The first ``n`` inputs as tensors, or an error naming the op."""
    if len(inputs) < n:
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r} takes {n} inputs, got {len(inputs)}"
        )
    return [ctx.tensor(v) for v in inputs[:n]]


def _padding(node: GraphNode) -> str:
    p = node.attr("padding", b"VALID")
    p = (p.decode() if isinstance(p, bytes) else str(p)).upper()
    if p not in ("SAME", "VALID"):
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r}: padding {p!r} is not lowered "
            "(SAME or VALID)"
        )
    return p


def _same_pad(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """TF ``SAME`` padding of one spatial dim: (before, after), the odd
    element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(node, hw, kernel, strides, dilations=(1, 1)) -> List[Tuple[int, int]]:
    if _padding(node) == "VALID":
        return [(0, 0), (0, 0)]
    return [_same_pad(*a) for a in zip(hw, kernel, strides, dilations)]


def _ints_attr(node: GraphNode, key: str, default=None) -> List[int]:
    av = node.attrs.get(key)
    if av is None:
        if default is None:
            raise GraphLoweringError(f"{node.op!r} node {node.name!r} has no {key!r} attr")
        return list(default)
    return [int(v) for v in av.value.i]


def _spatial(node: GraphNode, values: List[int], what: str) -> Tuple[int, int]:
    """The (H, W) entries of a 4-entry strides/ksize/dilations list in the
    node's data format; the batch and channel entries must be 1."""
    fmt = _data_format(node)
    if fmt not in ("NHWC", "NCHW") or len(values) != 4:
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r}: {what} {values} in data format "
            f"{fmt!r} is not lowered (4 entries, NHWC or NCHW)"
        )
    hw, nc = ((1, 2), (0, 3)) if fmt == "NHWC" else ((2, 3), (0, 1))
    if any(values[d] != 1 for d in nc):
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r}: {what} {values} acts on the batch "
            "or channel dim, which is not lowered"
        )
    return values[hw[0]], values[hw[1]]


def _nchw(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """An NCHW view of ``x``; of an NHWC tensor it is ``channels_last``."""
    return x.permute(0, 3, 1, 2) if fmt == "NHWC" else x


def _from_nchw(y: torch.Tensor, fmt: str) -> torch.Tensor:
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


def _symmetric(pads) -> bool:
    return all(lo == hi for lo, hi in pads)


def _conv(node, x, w_oihw, fmt, strides, dilations=(1, 1), groups=1) -> torch.Tensor:
    xn = _nchw(x, fmt)
    pads = _spatial_pads(node, xn.shape[2:], w_oihw.shape[2:], strides, dilations)
    if _symmetric(pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        (pt, pb), (pl, pr) = pads
        xn, padding = F.pad(xn, (pl, pr, pt, pb)), 0
    y = F.conv2d(xn, w_oihw, stride=strides, padding=padding, dilation=dilations, groups=groups)
    return _from_nchw(y, fmt)


@register("Conv2D")
def _conv2d(ctx, node, inputs):
    x, w = _data_inputs(ctx, node, inputs, 2)
    fmt = _data_format(node)
    strides = _spatial(node, _ints_attr(node, "strides"), "strides")
    dilations = _spatial(node, _ints_attr(node, "dilations", (1, 1, 1, 1)), "dilations")
    # HWIO filter -> OIHW; full float32 (the package turns TF32 off)
    return _conv(node, x, w.permute(3, 2, 0, 1), fmt, strides, dilations)


@register("DepthwiseConv2dNative")
def _depthwise_conv(ctx, node, inputs):
    x, w = _data_inputs(ctx, node, inputs, 2)
    # the JAX rule takes NHWC without dilations; the port refuses the rest
    # instead of computing them as NHWC
    if _data_format(node) != "NHWC" or any(
        d != 1 for d in _ints_attr(node, "dilations", (1, 1, 1, 1))
    ):
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r}: only NHWC without dilations is "
            "lowered, as in the JAX package"
        )
    strides = _spatial(node, _ints_attr(node, "strides"), "strides")
    # w: [H, W, C, M] -> groups of one input channel each; output channel
    # c*M + m belongs to group c, so the filter reshapes channel-major
    h, wd, c, m = w.shape
    w_oihw = w.reshape(h, wd, 1, c * m).permute(3, 2, 0, 1)
    return _conv(node, x, w_oihw, "NHWC", strides, groups=c)


def _pool_geometry(ctx, node, inputs):
    """(fmt, NCHW view, kernel, strides, pads) of a pooling node; MaxPoolV2
    may carry ksize and strides as constant inputs instead of attrs."""
    x = ctx.tensor(inputs[0])
    fmt = _data_format(node)
    if x.dim() != 4:
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r}: input of rank {x.dim()}; pooling "
            "is lowered for 4-d tensors"
        )
    if "ksize" in node.attrs:
        ksize, strides = _ints_attr(node, "ksize"), _ints_attr(node, "strides")
    else:
        if len(inputs) < 3:
            raise GraphLoweringError(
                f"{node.op!r} node {node.name!r} has neither ksize/strides "
                "attrs nor inputs"
            )
        ksize = ctx.static_int_list(inputs[1], node, "ksize")
        strides = ctx.static_int_list(inputs[2], node, "strides")
    kernel = _spatial(node, ksize, "ksize")
    strides = _spatial(node, strides, "strides")
    xn = _nchw(x, fmt)
    return fmt, xn, kernel, strides, _spatial_pads(node, xn.shape[2:], kernel, strides)


def _explicit_pad(xn: torch.Tensor, pads, value: float) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    return F.pad(xn, (pl, pr, pt, pb), value=value)


@register("MaxPool", "MaxPoolV2")
def _max_pool(ctx, node, inputs):
    fmt, xn, kernel, strides, pads = _pool_geometry(ctx, node, inputs)
    if _symmetric(pads):  # ATen pads with -inf itself
        y = F.max_pool2d(xn, kernel, strides, padding=tuple(lo for lo, _ in pads))
    else:
        y = F.max_pool2d(_explicit_pad(xn, pads, float("-inf")), kernel, strides)
    return _from_nchw(y, fmt)


@register("AvgPool")
def _avg_pool(ctx, node, inputs):
    """The window sum over the in-bounds elements divided by their count."""
    fmt, xn, kernel, strides, pads = _pool_geometry(ctx, node, inputs)
    if _symmetric(pads):
        y = F.avg_pool2d(
            xn, kernel, strides, padding=tuple(lo for lo, _ in pads),
            count_include_pad=False,
        )
    else:
        total = F.avg_pool2d(_explicit_pad(xn, pads, 0.0), kernel, strides, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(xn.shape[2:]), dtype=xn.dtype, device=xn.device)
        count = F.avg_pool2d(_explicit_pad(ones, pads, 0.0), kernel, strides, divisor_override=1)
        y = total / count
    return _from_nchw(y, fmt)


@register("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_batch_norm(ctx, node, inputs):
    """``(y, mean, variance)``; with ``is_training`` the batch's mean and
    biased variance replace the given ones."""
    x, scale, offset, mean, var = _data_inputs(ctx, node, inputs, 5)
    eps = float(node.attr("epsilon", 1e-4))
    nchw = _data_format(node) == "NCHW"
    if bool(node.attr("is_training", False)):
        var, mean = torch.var_mean(x, dim=(0, 2, 3) if nchw else (0, 1, 2), correction=0)
    if nchw:
        scale, offset, mean, var = (v.reshape(1, -1, 1, 1) for v in (scale, offset, mean, var))
    inv = scale * torch.rsqrt(var + eps)
    y = (x - mean) * inv + offset
    return (y, mean.reshape(-1), var.reshape(-1))


@register("BatchNormWithGlobalNormalization")
def _batch_norm_global(ctx, node, inputs):
    x, mean, var, beta, gamma = _data_inputs(ctx, node, inputs, 5)
    eps = float(node.attr("variance_epsilon", 1e-4))
    inv = torch.rsqrt(var + eps)
    if bool(node.attr("scale_after_normalization", True)):
        inv = inv * gamma
    return x * inv + (beta - mean * inv)


@register("LRN")
def _lrn(ctx, node, inputs):
    """Local response normalisation over the last (channel) axis, a
    symmetric window of ``2 r + 1`` channels."""
    x = ctx.tensor(inputs[0])
    r = int(node.attr("depth_radius", 5))
    if r < 0:
        raise GraphLoweringError(
            f"'LRN' node {node.name!r}: depth_radius {r} must be at least 0"
        )
    bias = float(node.attr("bias", 1.0))
    alpha = float(node.attr("alpha", 1.0))
    beta = float(node.attr("beta", 0.5))
    c = x.shape[-1]
    sq = F.pad(torch.square(x), (r, r))
    summed = sq.narrow(-1, 0, c)
    for j in range(1, 2 * r + 1):
        summed = summed + sq.narrow(-1, j, c)
    return x / torch.pow(bias + alpha * summed, beta)


@register("ResizeBilinear")
def _resize_bilinear(ctx, node, inputs):
    """TF1 bilinear resize with its coordinate conventions: legacy
    asymmetric (default), ``align_corners`` or ``half_pixel_centers``.
    The output is float32 whatever the input type."""
    x = _data_inputs(ctx, node, inputs, 1)[0].to(torch.float32)  # NHWC
    if len(inputs) < 2:
        raise GraphLoweringError(f"'ResizeBilinear' node {node.name!r} has no size input")
    out_h, out_w = ctx.static_int_list(inputs[1], node, "size")
    align = bool(node.attr("align_corners", False))
    half_pixel = bool(node.attr("half_pixel_centers", False))

    def src(out_n: int, in_n: int) -> torch.Tensor:
        o = torch.arange(out_n, dtype=torch.float32, device=x.device)
        if align and out_n > 1:
            return o * ((in_n - 1) / (out_n - 1))
        if half_pixel:
            return torch.clamp_min((o + 0.5) * (in_n / out_n) - 0.5, 0.0)
        return o * (in_n / out_n)

    def lerp_axis(arr: torch.Tensor, out_n: int, axis: int) -> torch.Tensor:
        in_n = arr.shape[axis]
        coords = src(out_n, in_n)
        lo = torch.floor(coords).to(torch.int64).clamp(0, in_n - 1)
        hi = torch.clamp_max(lo + 1, in_n - 1)
        shape = [1] * arr.dim()
        shape[axis] = out_n
        w = (coords - lo).reshape(shape)
        a, b = arr.index_select(axis, lo), arr.index_select(axis, hi)
        return a * (1 - w) + b * w

    return lerp_axis(lerp_axis(x, out_h, 1), out_w, 2)


# ---------------------------------------------------------------------------
# shape / layout
# ---------------------------------------------------------------------------


def _out_type(node: GraphNode) -> np.dtype:
    return node.attr("out_type", ScalarType.int32).np_dtype


@register("Shape")
def _shape(ctx, node, inputs):
    # a shape is known when the call runs (per row under vmap): host numpy
    return np.asarray(tuple(np.shape(inputs[0])), dtype=_out_type(node))


@register("ShapeN")
def _shape_n(ctx, node, inputs):
    return tuple(np.asarray(tuple(np.shape(x)), dtype=_out_type(node)) for x in inputs)


@register("Size")
def _size(ctx, node, inputs):
    return np.asarray(int(np.prod(np.shape(inputs[0]))), dtype=_out_type(node))


@register("Rank")
def _rank(ctx, node, inputs):
    return np.asarray(len(np.shape(inputs[0])), dtype=np.int32)


@register("Range")
def _range(ctx, node, inputs):
    start = ctx.static(inputs[0], node, "start")
    limit = ctx.static(inputs[1], node, "limit")
    delta = ctx.static(inputs[2], node, "delta")
    return np.arange(start, limit, delta)


@register("Reshape")
def _reshape(ctx, node, inputs):
    target = ctx.static_int_list(inputs[1], node, "shape")
    return ctx.tensor(inputs[0]).reshape(target)


@register("ExpandDims")
def _expand_dims(ctx, node, inputs):
    return ctx.tensor(inputs[0]).unsqueeze(_static_axis(ctx, inputs[1], node, "dim"))


@register("Squeeze")
def _squeeze(ctx, node, inputs):
    dims = node.attr("squeeze_dims", node.attr("axis", None))
    if dims is not None and getattr(dims, "i", None) is not None:
        dims = list(dims.i)
    x = ctx.tensor(inputs[0])
    return torch.squeeze(x, tuple(dims)) if dims else torch.squeeze(x)


@register("Transpose")
def _transpose(ctx, node, inputs):
    return ctx.tensor(inputs[0]).permute(ctx.static_int_list(inputs[1], node, "perm"))


@register("Fill")
def _fill(ctx, node, inputs):
    dims = ctx.static_int_list(inputs[0], node, "dims")
    return ctx.tensor(inputs[1]).expand(dims).contiguous()


@register("Tile")
def _tile(ctx, node, inputs):
    return torch.tile(ctx.tensor(inputs[0]), ctx.static_int_list(inputs[1], node, "multiples"))


@register("Concat")
def _concat(ctx, node, inputs):
    axis = _static_axis(ctx, inputs[0], node, "concat_dim")
    return torch.cat([ctx.tensor(x) for x in inputs[1:]], dim=axis)


@register("ConcatV2")
def _concat_v2(ctx, node, inputs):
    axis = _static_axis(ctx, inputs[-1], node, "axis")
    return torch.cat([ctx.tensor(x) for x in inputs[:-1]], dim=axis)


@register("Pack", "Stack")  # "Stack" is the legacy TF 1.x alias
def _pack(ctx, node, inputs):
    return torch.stack([ctx.tensor(x) for x in inputs], dim=int(node.attr("axis", 0)))


@register("Unpack")
def _unpack(ctx, node, inputs):
    x = ctx.tensor(inputs[0])
    axis = int(node.attr("axis", 0))
    num = int(node.attr("num", x.shape[axis]))
    if num != x.shape[axis]:
        raise GraphLoweringError(
            f"Unpack {node.name!r}: num={num} but axis {axis} has {x.shape[axis]}"
        )
    return tuple(torch.unbind(x, dim=axis))


def _even_split(x: torch.Tensor, num: int, axis: int, node: GraphNode):
    n = x.shape[axis]
    if num <= 0 or n % num:
        raise GraphLoweringError(
            f"{node.op} {node.name!r}: axis {axis} of size {n} does not split "
            f"into {num} equal parts"
        )
    return tuple(torch.split(x, n // num, dim=axis))


@register("Split")
def _split(ctx, node, inputs):
    axis = _static_axis(ctx, inputs[0], node, "split_dim")
    return _even_split(ctx.tensor(inputs[1]), int(node.attr("num_split", 1)), axis, node)


@register("SplitV")
def _split_v(ctx, node, inputs):
    sizes = ctx.static_int_list(inputs[1], node, "size_splits")
    axis = _static_axis(ctx, inputs[2], node, "split_dim")
    x = ctx.tensor(inputs[0])
    if -1 in sizes:  # one size may be inferred from the remainder
        known = sum(s for s in sizes if s >= 0)
        sizes = [s if s >= 0 else x.shape[axis] - known for s in sizes]
    return tuple(torch.split(x, sizes, dim=axis))


@register("Slice")
def _slice(ctx, node, inputs):
    begin = ctx.static_int_list(inputs[1], node, "begin")
    size = ctx.static_int_list(inputs[2], node, "size")
    x = ctx.tensor(inputs[0])
    for axis, (b, s) in enumerate(zip(begin, size)):
        x = x.narrow(axis, b, x.shape[axis] - b if s == -1 else s)
    return x


def _apply_slice(x: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    """``x`` sliced along ``dim`` by a Python slice, negative steps too
    (torch indexing refuses them): a negative step flips the axis and
    takes the mirrored positive slice."""
    n = x.shape[dim]
    start, stop, step = sl.indices(n)
    count = len(range(start, stop, step))
    if step > 0:
        return x.narrow(dim, start, 0) if count == 0 else x.narrow(
            dim, start, (count - 1) * step + 1
        )[(slice(None),) * dim + (slice(None, None, step),)]
    if count == 0:
        return x.narrow(dim, 0, 0)
    x = x.flip(dim)
    first = n - 1 - start
    return x.narrow(dim, first, (count - 1) * -step + 1)[
        (slice(None),) * dim + (slice(None, None, -step),)
    ]


@register("StridedSlice")
def _strided_slice(ctx, node, inputs):
    x = ctx.tensor(inputs[0])
    begin = ctx.static_int_list(inputs[1], node, "begin")
    end = ctx.static_int_list(inputs[2], node, "end")
    strides = ctx.static_int_list(inputs[3], node, "strides")
    bm = int(node.attr("begin_mask", 0))
    em = int(node.attr("end_mask", 0))
    ellipsis_mask = int(node.attr("ellipsis_mask", 0))
    new_axis_mask = int(node.attr("new_axis_mask", 0))
    shrink_mask = int(node.attr("shrink_axis_mask", 0))
    # the numpy-style index the JAX rule builds, entry by entry
    idx: List[Any] = []
    for i in range(len(begin)):
        if ellipsis_mask & (1 << i):
            idx.append(Ellipsis)
        elif new_axis_mask & (1 << i):
            idx.append(None)
        elif shrink_mask & (1 << i):
            idx.append(begin[i])
        else:
            b = None if bm & (1 << i) else begin[i]
            e = None if em & (1 << i) else end[i]
            idx.append(slice(b, e, strides[i]))
    # ... applied one entry at a time, numpy's rules: an Ellipsis covers
    # the dims no other entry consumes, None inserts an axis, an int
    # selects (and drops) one
    ellipsis_span = x.dim() - sum(1 for e in idx if e is not None and e is not Ellipsis)
    dim = 0  # the axis of the partly indexed x the next entry acts on
    for e in idx:
        if e is Ellipsis:
            dim += ellipsis_span
        elif e is None:
            x = x.unsqueeze(dim)
            dim += 1
        elif isinstance(e, int):
            n = x.shape[dim]
            if not -n <= e < n:
                raise GraphLoweringError(
                    f"StridedSlice {node.name!r}: index {e} out of range for "
                    f"an axis of size {n}"
                )
            x = x.select(dim, e)
        else:
            x = _apply_slice(x, dim, e)
            dim += 1
    return x


def _pad_widths(ctx, node, value) -> List[Tuple[int, int]]:
    paddings = ctx.static(value, node, "paddings")
    return [(int(a), int(b)) for a, b in paddings]


@register("Pad", "PadV2")
def _pad(ctx, node, inputs):
    x = ctx.tensor(inputs[0])
    widths = _pad_widths(ctx, node, inputs[1])
    const = inputs[2] if len(inputs) > 2 else 0
    if isinstance(const, torch.Tensor):
        const = 0 if const.device.type == "meta" else const.item()
    else:
        const = np.asarray(const).item()
    flat = [w for a, b in reversed(widths) for w in (a, b)]  # last dim first
    return F.pad(x, flat, mode="constant", value=const)


@register("MirrorPad")
def _mirror_pad(ctx, node, inputs):
    """REFLECT (edge not repeated) and SYMMETRIC (edge repeated) on any
    axis, from flips and concatenation: F.pad reflects only the last
    1-3 dims."""
    x = ctx.tensor(inputs[0])
    mode = node.attr("mode", b"REFLECT")
    mode = (mode.decode() if isinstance(mode, bytes) else mode).lower()
    skip = 1 if mode == "reflect" else 0
    for axis, (a, b) in enumerate(_pad_widths(ctx, node, inputs[1])):
        n = x.shape[axis]
        if a + skip > n or b + skip > n:
            raise GraphLoweringError(
                f"MirrorPad {node.name!r}: paddings ({a}, {b}) too large for "
                f"an axis of size {n} in {mode.upper()} mode"
            )
        parts = []
        if a:
            parts.append(x.narrow(axis, skip, a).flip(axis))
        parts.append(x)
        if b:
            parts.append(x.narrow(axis, n - skip - b, b).flip(axis))
        x = torch.cat(parts, dim=axis) if len(parts) > 1 else x
    return x


@register("BroadcastTo")
def _broadcast_to(ctx, node, inputs):
    return ctx.tensor(inputs[0]).expand(ctx.static_int_list(inputs[1], node, "shape"))


# ---------------------------------------------------------------------------
# gather / scatter / top-k / cumsum
# ---------------------------------------------------------------------------


def _wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def _out_of_range_fill(dtype: torch.dtype):
    """`jnp.take`'s value for an index past either end."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype is torch.bool:
        return True
    return torch.iinfo(dtype).min


@register("GatherV2", "Gather")
def _gather(ctx, node, inputs):
    params, indices = ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
    axis = _static_axis(ctx, inputs[2], node, "axis") if len(inputs) > 2 else 0
    axis %= params.dim()
    n = params.shape[axis]
    idx = _wrap_index(indices, n)
    valid = (idx >= 0) & (idx < n)
    picked = torch.index_select(params, axis, torch.where(valid, idx, 0).reshape(-1))
    out_shape = params.shape[:axis] + indices.shape + params.shape[axis + 1:]
    picked = picked.reshape(out_shape)
    mask_shape = (1,) * axis + tuple(indices.shape) + (1,) * (params.dim() - axis - 1)
    return torch.where(
        valid.reshape(mask_shape), picked, _out_of_range_fill(params.dtype)
    )


def _nd_index(indices: torch.Tensor, shape) -> Tuple[torch.Tensor, ...]:
    """The index tuple ``tuple(moveaxis(indices, -1, 0))`` with negative
    entries wrapped."""
    return tuple(
        _wrap_index(indices[..., j], shape[j]) for j in range(indices.shape[-1])
    )


@register("GatherNd")
def _gather_nd(ctx, node, inputs):
    params, indices = ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
    # jnp indexing clamps an index past the end into range
    idx = tuple(
        i.clamp(0, params.shape[j] - 1)
        for j, i in enumerate(_nd_index(indices, params.shape))
    )
    return params[idx]


@register("ScatterNd")
def _scatter_nd(ctx, node, inputs):
    indices, updates = ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
    shape = tuple(ctx.static_int_list(inputs[2], node, "shape"))
    out = torch.zeros(shape, dtype=updates.dtype, device=updates.device)
    # duplicates add up, as `.at[idx].add` does
    return out.index_put(_nd_index(indices, shape), updates, accumulate=True)


@register("OneHot")
def _one_hot(ctx, node, inputs):
    x = ctx.tensor(inputs[0])
    depth = _static_axis(ctx, inputs[1], node, "depth")
    on = ctx.tensor(inputs[2] if len(inputs) > 2 else np.float32(1.0))
    off = ctx.tensor(inputs[3] if len(inputs) > 3 else np.float32(0.0))
    axis = int(node.attr("axis", -1))
    pos = axis if axis >= 0 else x.dim() + 1 + axis
    classes = torch.arange(depth, device=x.device).reshape(
        (1,) * pos + (depth,) + (1,) * (x.dim() - pos)
    )
    # an index outside [0, depth) matches no class: its row is all off
    hot = x.unsqueeze(pos).to(torch.int64) == classes
    return torch.where(hot, on, off.to(on.dtype))


@register("TopK", "TopKV2")
def _top_k(ctx, node, inputs):
    k = (
        _static_axis(ctx, inputs[1], node, "k")
        if len(inputs) > 1
        else int(node.attr("k", 1))
    )
    # a stable descending sort keeps the lower index first among equal
    # values, as lax.top_k does (torch.topk leaves ties unspecified)
    values, indices = torch.sort(ctx.tensor(inputs[0]), dim=-1, descending=True, stable=True)
    return (values[..., :k], indices[..., :k].to(torch.int32))


@register("Cumsum")
def _cumsum(ctx, node, inputs):
    x = ctx.tensor(inputs[0])
    axis = _static_axis(ctx, inputs[1], node, "axis") % max(x.dim(), 1)
    exclusive = bool(node.attr("exclusive", False))
    reverse = bool(node.attr("reverse", False))
    if reverse:
        x = x.flip(axis)
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if exclusive:
        n = out.shape[axis]
        out = torch.cat(
            [torch.zeros_like(out.narrow(axis, 0, min(n, 1))), out.narrow(axis, 0, max(n - 1, 0))],
            dim=axis,
        )
    if reverse:
        out = out.flip(axis)
    return out


@register("Cast")
def _cast(ctx, node, inputs):
    dst = node.attr("DstT")
    if dst is None:
        raise GraphLoweringError(f"Cast {node.name!r} missing DstT")
    return ctx.tensor(inputs[0]).to(dst.torch_dtype)
