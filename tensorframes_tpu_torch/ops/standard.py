"""Standard op set: torch lowerings for the TF GraphDef ops of this slice.

The PyTorch counterpart of `tensorframes_tpu/ops/standard.py`, covering the
ops the graph verbs, the MLP scoring graph and the DSL core use. Every
other op raises `GraphLoweringError` naming it at build time; the remaining
rules of the JAX package are listed in ROADMAP.md.

TF 1.x semantics kept from the JAX rules:
- binary ops do NOT promote dtypes (the graph's ``T`` attr fixes one dtype);
- ``Div`` on integers truncates toward zero, ``RealDiv`` is true division;
- reductions take ``reduction_indices`` as a constant input plus a
  ``keep_dims`` attr; empty indices reduce over every axis (as the JAX
  rule does) and the result keeps the input dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..graph.ir import GraphNode
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


# ---------------------------------------------------------------------------
# sources / identity
# ---------------------------------------------------------------------------


@register("Const")
def _const(ctx, node, inputs):
    av = node.attrs.get("value")
    if av is None or av.kind != "tensor":
        raise GraphLoweringError(f"Const node {node.name!r} has no value attr")
    return av.value.to_numpy()  # stays host-side until an op needs a tensor


@register("Identity", "StopGradient", "Snapshot")
def _identity(ctx, node, inputs):
    return inputs[0]


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

_UNARY = {
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Square": torch.square,
    "Sqrt": torch.sqrt,
    "Exp": torch.exp,
    "Log": torch.log,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "Relu": torch.relu,
}

for _name, _fn in _UNARY.items():
    register(_name)(
        lambda ctx, node, inputs, _fn=_fn: _fn(ctx.tensor(inputs[0]))
    )


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
    "RealDiv": torch.true_divide,
    "Maximum": torch.maximum,
    "Minimum": torch.minimum,
}

for _name, _fn in _BINARY.items():
    register(_name)(
        lambda ctx, node, inputs, _fn=_fn: _fn(
            ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
        )
    )


# ---------------------------------------------------------------------------
# reductions (constant axes input + keep_dims attr)
# ---------------------------------------------------------------------------


def _reducer(reduce_fn):
    def rule(ctx, node, inputs):
        x = ctx.tensor(inputs[0])
        axes = _reduction_axes(ctx, node, x, inputs[1])
        if not axes:  # a scalar reduces to itself
            return x
        return reduce_fn(x, axes, _keep_dims(node))

    return rule


# TF reductions keep the input dtype (torch.sum would widen int32 to int64)
register("Sum")(_reducer(lambda x, a, k: torch.sum(x, a, keepdim=k, dtype=x.dtype)))
register("Min")(_reducer(lambda x, a, k: torch.amin(x, a, keepdim=k)))
register("Max")(_reducer(lambda x, a, k: torch.amax(x, a, keepdim=k)))


def _mean(x: torch.Tensor, axes, keep: bool) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return torch.mean(x, axes, keepdim=keep)
    # TF Mean on integers: integer division of the sum by the count
    count = 1
    for a in axes:
        count *= x.shape[a]
    total = torch.sum(x, axes, keepdim=keep, dtype=x.dtype)
    return torch.div(total, count, rounding_mode="trunc")


register("Mean")(_reducer(_mean))


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


@register("BiasAdd")
def _bias_add(ctx, node, inputs):
    x, b = ctx.tensor(inputs[0]), ctx.tensor(inputs[1])
    if _data_format(node) == "NCHW" and x.dim() == 4:
        return x + b.reshape(1, -1, 1, 1)
    return x + b


@register("Softmax")
def _softmax(ctx, node, inputs):
    return torch.softmax(ctx.tensor(inputs[0]), dim=-1)


# ---------------------------------------------------------------------------
# shape / type
# ---------------------------------------------------------------------------


@register("Reshape")
def _reshape(ctx, node, inputs):
    target = ctx.static_int_list(inputs[1], node, "shape")
    return ctx.tensor(inputs[0]).reshape(target)


@register("Cast")
def _cast(ctx, node, inputs):
    dst = node.attr("DstT")
    if dst is None:
        raise GraphLoweringError(f"Cast {node.name!r} missing DstT")
    return ctx.tensor(inputs[0]).to(dst.torch_dtype)
