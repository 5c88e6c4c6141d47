"""Lowering rules for functionalized control flow and dense TensorLists.

The PyTorch counterpart of `tensorframes_tpu/ops/control.py`.
`graph.control_flow` rewrites imported TF control flow (v1
Switch/Merge/Enter/Exit rings and v2 functional If/While) into `_Cond` and
`_While` pseudo-nodes whose bodies live in the graph's ``subgraphs`` side
table; the rules find them through ``ctx.graph``. Each body is lowered with
`build_callable` once per lowering (kept in ``ctx.memo``), so nested control
flow, function calls and the whole op registry work inside bodies.

Eager PyTorch runs control flow on the host, where the JAX package compiles
`lax.cond`/`lax.while_loop`:

- a scalar `_Cond` reads its predicate on the host (one device sync a
  call) and runs only the branch it takes;
- a scalar `_While` is a Python loop that reads the predicate each trip
  (one sync a trip);
- a predicate with one value per row (a per-row graph run at block level)
  goes to `graph.vectorize`: both branches and a select, or one masked
  dense loop.

On the ``meta`` device (the shape probes of `graph.analysis`) nothing can be
read back: `_Cond` runs both branches and checks that their shapes and
dtypes agree, `_While` runs its body once and checks that the carry keeps
its shape. Both checks also run, once per input signature, before the first
real call, so a graph is refused the same way whichever branch its data
takes. Host syncs and trips are counted in `utils.profiling`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import vectorize as _vec
from ..schema import ScalarType
from ..utils.profiling import count as _count
from .registry import GraphLoweringError, register

_META = torch.device("meta")


def _sub(ctx, node, attr_key):
    key = node.attr(attr_key)
    key = key.decode() if isinstance(key, bytes) else key
    graph = ctx.graph
    if graph is None or key not in graph.subgraphs:
        raise GraphLoweringError(
            f"{node.op!r} node {node.name!r} references missing subgraph "
            f"{key!r}; was the graph functionalized by graph.control_flow?"
        )
    return graph.subgraphs[key]


def _body(ctx, node, attr_key, device=None):
    """The lowered callable of one body subgraph on ``device`` (default:
    the ctx's), built once per lowering."""
    from .lowering import build_callable

    device = ctx.device if device is None else device
    key = ("body", node.name, attr_key, str(device))
    fn = ctx.memo.get(key)
    if fn is None:
        sub = _sub(ctx, node, attr_key)
        fn = build_callable(sub.graph, sub.fetches, sub.feeds, device, ctx.row_axis)
        ctx.memo[key] = fn
    return fn


def _meta_body(ctx, node, attr_key):
    return _body(ctx, node, attr_key, _META)


def _first_call(ctx, node, values) -> bool:
    """True once per (node, input shapes and dtypes) of this lowering: the
    meta checks of a real call run then and are skipped afterwards."""
    key = ("checked", node.name, tuple(_vec._aval(v) for v in values))
    if key in ctx.memo:
        return False
    ctx.memo[key] = True
    return True


def _host_bool(pred) -> bool:
    """A scalar predicate on the host; a device tensor costs one sync."""
    return bool(pred.reshape(()) if isinstance(pred, torch.Tensor) else np.asarray(pred).reshape(()))


@register("_Cond")
def _cond(ctx, node, inputs):
    pred, *operands = inputs
    tfn = _body(ctx, node, "cond_then")
    efn = _body(ctx, node, "cond_else")
    if _vec.is_batched(pred):
        # a per-row graph run at block level: the cond selects per row,
        # evaluating both (pure) branches
        return _vec.select_cond(ctx, node, pred, tfn(*operands), efn(*operands))
    if ctx.is_meta:
        return _vec.check_branch_avals(node, tfn, efn, operands, ctx.row_axis)
    if _first_call(ctx, node, inputs):
        _vec.check_branch_avals(
            node, _meta_body(ctx, node, "cond_then"), _meta_body(ctx, node, "cond_else"),
            operands, ctx.row_axis,
        )
    if isinstance(pred, torch.Tensor):
        _count("control.cond.host_syncs")
    taken = tfn if _host_bool(pred) else efn
    return tuple(ctx.tensor(v) for v in taken(*operands))


@register("_While")
def _while(ctx, node, inputs):
    cond_fn = _body(ctx, node, "while_cond")
    body_fn = _body(ctx, node, "while_body")
    n_vars = int(node.attr("n_vars"))
    meta_body_fn = body_fn if ctx.is_meta else _meta_body(ctx, node, "while_body")
    carry = tuple(inputs)
    if ctx.row_axis:
        carry = _vec.grow_row_axis(ctx, node, meta_body_fn, carry, n_vars)
    pred = cond_fn(*carry)[0]
    if _vec.is_batched(pred):
        # a per-row loop run at block level: one convergence-masked
        # dense loop over the block
        return _vec.masked_while(
            ctx, node, carry, n_vars, cond_fn, body_fn, pred, meta_body_fn
        )
    if ctx.is_meta:
        _vec.check_while_carry(node, body_fn, carry, n_vars)
        return tuple(ctx.tensor(c) for c in carry[:n_vars])
    if _first_call(ctx, node, carry):
        _vec.check_while_carry(node, meta_body_fn, carry, n_vars)
    trips = syncs = 0
    while True:
        syncs += isinstance(pred, torch.Tensor)
        if not _host_bool(pred):
            break
        carry = tuple(body_fn(*carry))
        trips += 1
        pred = cond_fn(*carry)[0]
    _count("control.while.trips", trips)
    _count("control.while.host_syncs", syncs)
    # invariant captures ride the carry but are not node outputs
    return tuple(ctx.tensor(c) for c in carry[:n_vars])


# ---------------------------------------------------------------------------
# TensorList ops: what Keras RNN layers put inside their while loops. A list
# is a dense (num_elements, *element_shape) tensor with static extents, as
# in the JAX package; updates are out of place, so a list another node
# still reads is never written.
# ---------------------------------------------------------------------------


@register("TensorListReserve")
def _tl_reserve(ctx, node, inputs):
    eshape = ctx.static_int_list(inputs[0], node, "element_shape")
    n = int(ctx.static(inputs[1], node, "num_elements"))
    if any(d < 0 for d in eshape) or n < 0:
        raise GraphLoweringError(
            f"TensorListReserve (node {node.name!r}) has dynamic "
            f"element_shape {eshape} / num_elements {n}; lists need "
            "static extents (frozen Keras RNN graphs satisfy this)"
        )
    st = node.attr("element_dtype")
    dtype = st.torch_dtype if isinstance(st, ScalarType) else torch.float32
    return torch.zeros((n, *eshape), dtype=dtype, device=ctx.device)


def _list_index(ctx, lst: torch.Tensor, idx) -> torch.Tensor:
    """``idx`` as a 1-element int64 index into ``lst``, clamped into range
    as `lax.dynamic_slice` clamps it."""
    i = ctx.tensor(idx).to(torch.int64).reshape(1)
    return i.clamp(0, max(lst.shape[0] - 1, 0))


@register("TensorListSetItem")
def _tl_set_item(ctx, node, inputs):
    lst, idx, item = ctx.tensor(inputs[0]), inputs[1], ctx.tensor(inputs[2])
    return lst.index_copy(0, _list_index(ctx, lst, idx), item.to(lst.dtype).unsqueeze(0))


@register("TensorListGetItem")
def _tl_get_item(ctx, node, inputs):
    lst = ctx.tensor(inputs[0])
    return lst.index_select(0, _list_index(ctx, lst, inputs[1]))[0]


@register("TensorListStack", "TensorListFromTensor")
def _tl_passthrough(ctx, node, inputs):
    # the dense representation IS the stacked tensor (FromTensor's second
    # input is the element_shape hint; Stack's is ignored too)
    return ctx.tensor(inputs[0])


@register("TensorListLength")
def _tl_length(ctx, node, inputs):
    return np.int32(np.shape(inputs[0])[0])
