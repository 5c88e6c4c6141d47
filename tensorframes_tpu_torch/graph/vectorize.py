"""Masked dense lowerings for per-row control flow.

The PyTorch counterpart of `tensorframes_tpu/graph/vectorize.py`. A per-row
graph with `tf.cond`/`tf.while_loop` is functionalized into `_Cond`/`_While`
pseudo-nodes (`graph.control_flow`). Run at block level (the graph lifted by
`lift_to_block_level`), their predicates carry the block's row axis, and
`ops.control` hands them to this module:

* `select_cond`: both branches evaluated, then `torch.where` on the per-row
  predicate. Legal because `freeze_variables` leaves branch bodies pure.
* `masked_while`: one dense loop over the whole block while ANY row's
  predicate holds; a per-row convergence mask freezes the rows whose
  predicate went false, so ragged per-row trip counts run in
  max-trips-over-rows dense trips. Eager PyTorch has no device-side loop,
  so each trip reads ``active.any()`` on the host once.

`subgraphs_row_local` is the classification hook `aggregate._rowwise_transform`
calls for control-flow nodes: a `_Cond`/`_While` is row-local exactly when
every branch/cond/body subgraph passes the same row-local walk at the
enclosing graph's lead rank. `api.map_rows` uses it to pick the lifted plan.

`check_branch_avals` and `check_while_carry` probe the bodies on the ``meta``
device (where the JAX package uses `jax.eval_shape`) and name the offending
branch output or carry.

Vectorization is always on, as in the JAX package by default; the JAX
``config.row_vectorize`` knob is not ported. Decisions are counted in
`utils.profiling` (``vectorize.lowered.<kind>``, ``vectorize.fallback.<reason>``,
``vectorize.while.trips``, ``vectorize.while.host_syncs``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops.registry import GraphLoweringError
from ..proto.graphdef import AttrValue
from ..schema import ScalarType, Shape
from ..utils.profiling import count as _count

__all__ = [
    "CONTROL_OPS",
    "lift_to_block_level",
    "subgraphs_row_local",
    "select_cond",
    "masked_while",
    "check_branch_avals",
    "check_while_carry",
]

# Control-flow pseudo-nodes this pass can vectorize, mapped to their
# subgraph attr keys and the fallback-reason label each subgraph gets
# when it fails the row-local walk.
_SUB_ATTRS = {
    "_Cond": (("cond_then", "cond-branch"), ("cond_else", "cond-branch")),
    "_While": (("while_cond", "while-cond"), ("while_body", "while-body")),
}

#: Node ops `aggregate._rowwise_transform` defers to `subgraphs_row_local`
#: instead of rejecting outright.
CONTROL_OPS = frozenset(_SUB_ATTRS)

_META = torch.device("meta")


def _note_fallback(reason: str) -> None:
    _count(f"vectorize.fallback.{reason}")


def lift_to_block_level(graph):
    """Stamp a leading unknown row axis onto every placeholder's declared
    shape, in place, and return the graph.

    TensorFlow cannot author per-row control flow at block level
    (`tf.cond`/`tf.while_loop` demand a scalar predicate), so a block-level
    branchy program is authored per row and lifted: after the lift the
    predicates carry the block's row axis and the masked lowerings of this
    module take over. Lift a `Graph.clone()` to keep the per-row graph."""
    for ph in graph.placeholders():
        cell = ph.shape_attr
        dims = (None,) + tuple(cell.dims) if cell is not None else (None,)
        ph.attrs["shape"] = AttrValue.of_shape(Shape(dims))
    graph._fingerprint = None  # the attrs changed under the cached hash
    return graph


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


def subgraphs_row_local(graph, node, lead_rank: int) -> bool:
    """True when every subgraph of control-flow ``node`` is row-local at
    the enclosing graph's ``lead_rank``.

    Subgraph placeholders (``__sw{k}``/``__var{i}``/``__cap{j}``) carry
    slices of the outer graph's row axis, so each one is checked at the
    OUTER lead rank; nested control flow recurses through the same walk.
    Counts a fallback reason on every rejection."""
    from ..aggregate import _rowwise_transform

    for attr_key, label in _SUB_ATTRS[node.op]:
        key = node.attr(attr_key)
        key = key.decode() if isinstance(key, bytes) else key
        sub = getattr(graph, "subgraphs", {}).get(key)
        if sub is None:
            _note_fallback(f"{label}-missing")
            return False
        if not _rowwise_transform(sub.graph, list(sub.fetches), lambda _name: lead_rank):
            _note_fallback(f"{label}-not-row-local")
            return False
    return True


# ---------------------------------------------------------------------------
# shapes and meta probes
# ---------------------------------------------------------------------------


def _aval(v) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, torch dtype) of a tensor or a host numpy value."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    arr = np.asarray(v)
    return tuple(arr.shape), ScalarType.from_np_dtype(arr.dtype).torch_dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _meta(v):
    """A tensor's shape-only stand-in; host numpy stays numpy, so a body
    that reads it as a static value (a reshape target) still can."""
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype, device=_META)
    return v


def _broadcasts_to(shape, target) -> bool:
    try:
        return tuple(torch.broadcast_shapes(shape, target)) == tuple(target)
    except RuntimeError:
        return False


def check_branch_avals(
    node, tfn: Callable, efn: Callable, operands: Sequence, row_axis: bool = False
) -> Tuple:
    """Run both branches of a `_Cond` on ``meta`` (``tfn``/``efn`` must be
    built for the meta device) and raise, naming the output, unless they
    produce the same shapes and dtypes. Returns the then-branch's meta
    outputs. With ``row_axis`` (a lifted per-row graph) the shapes need
    only broadcast together: one branch may give a value for every row
    and the other one value for all."""
    ops = [_meta(v) for v in operands]
    touts, eouts = tuple(tfn(*ops)), tuple(efn(*ops))
    for i, (t, e) in enumerate(zip(touts, eouts)):
        (ts, td), (es, ed) = _aval(t), _aval(e)
        if row_axis:
            ok = td == ed and (
                _broadcasts_to(ts, es) or _broadcasts_to(es, ts)
            )
        else:
            ok = ts == es and td == ed
        if not ok:
            raise GraphLoweringError(
                f"_Cond (node {node.name!r}) output {i}: then-branch "
                f"produces {_dtype_name(td)}{list(ts)} but else-branch "
                f"produces {_dtype_name(ed)}{list(es)}; both branches of a "
                "cond must produce the same shape and dtype"
            )
    return touts


def check_while_carry(node, body_fn: Callable, carry: Sequence, n_vars: int) -> None:
    """Run a `_While` body once on ``meta`` (``body_fn`` built for the meta
    device) and raise, naming the carry, unless it keeps every carry's
    shape and dtype."""
    outs = tuple(body_fn(*[_meta(c) for c in carry]))
    for i, (c, o) in enumerate(zip(carry, outs)):
        if _aval(o) != _aval(c):
            raise GraphLoweringError(_carry_drift_msg(node, i, n_vars, c, o))


def grow_row_axis(ctx, node, body_fn: Callable, carry: Sequence, n_vars: int) -> Tuple:
    """In a lifted per-row graph, give each `_While` carry the row axis the
    body gives it (an accumulator that starts as one constant and grows a
    value per row), as `vmap`'s batching of a loop does: probe the body on
    ``meta`` (``body_fn`` built for it) until no carry grows. Any other
    change of shape or dtype raises, naming the carry."""
    carry = list(carry)
    for _ in range(len(carry) + 1):
        outs = tuple(body_fn(*[_meta(c) for c in carry]))
        grew = False
        for i, (c, o) in enumerate(zip(carry, outs)):
            (cs, cd), (os_, od) = _aval(c), _aval(o)
            if (cs, cd) == (os_, od):
                continue
            if od != cd or len(os_) != len(cs) + 1 or not _broadcasts_to(cs, os_):
                raise GraphLoweringError(_carry_drift_msg(node, i, n_vars, c, o))
            carry[i] = ctx.tensor(c).expand(os_).contiguous()
            grew = True
        if not grew:
            break
    return tuple(carry)


def _carry_drift_msg(node, i, n_vars, c, o) -> str:
    kind = "loop var" if i < n_vars else "invariant capture"
    edge = node.inputs[i] if i < len(node.inputs) else "<missing>"
    (cs, cd), (os_, od) = _aval(c), _aval(o)
    return (
        f"_While (node {node.name!r}) carry {i} ({kind}, input "
        f"{edge!r}) drifts from {_dtype_name(cd)}{list(cs)} to "
        f"{_dtype_name(od)}{list(os_)} across iterations; loop "
        "carries must keep a fixed shape and dtype"
    )


# ---------------------------------------------------------------------------
# masked dense lowerings (called from ops/control.py when the predicate
# carries the block's row axis)
# ---------------------------------------------------------------------------


def _pred_rows(node, shape) -> int:
    """Row count of a batched predicate."""
    shape = tuple(shape)
    if len(shape) < 1 or math.prod(shape) != shape[0]:
        raise GraphLoweringError(
            f"{node.op} (node {node.name!r}) predicate has shape "
            f"{shape}; a vectorized predicate must carry exactly one "
            "value per row (lead axis only, unit trailing dims)"
        )
    return int(shape[0])


def _flat_rows(node, pred: torch.Tensor) -> torch.Tensor:
    """A batched predicate as one boolean per row."""
    return pred.reshape((_pred_rows(node, pred.shape),)).to(torch.bool)


def select_cond(ctx, node, pred, then_outs, else_outs) -> Tuple:
    """Both-branches-evaluated + per-output select on the batched
    predicate. Branch outputs may sit below the lead rank (a value the
    branch computed identically for every row); they broadcast against the
    row-axis mask like any sub-lead constant in a row-local graph."""
    mask = _flat_rows(node, ctx.tensor(pred))
    n = mask.shape[0]
    outs = []
    for i, (t, e) in enumerate(zip(then_outs, else_outs)):
        t, e = ctx.tensor(t), ctx.tensor(e)
        if t.dtype != e.dtype:
            raise GraphLoweringError(
                f"_Cond (node {node.name!r}) output {i}: then-branch "
                f"dtype {_dtype_name(t.dtype)} != else-branch dtype "
                f"{_dtype_name(e.dtype)}; both branches of a cond must "
                "produce the same dtype"
            )
        rank = max(t.dim(), e.dim(), 1)
        m = mask.reshape((n,) + (1,) * (rank - 1))
        try:
            torch.broadcast_shapes(m.shape, t.shape, e.shape)
        except RuntimeError:
            raise GraphLoweringError(
                f"_Cond (node {node.name!r}) output {i}: then-branch "
                f"shape {tuple(t.shape)} and else-branch shape "
                f"{tuple(e.shape)} do not broadcast against the {n}-row "
                "predicate; both branches must produce per-row-compatible "
                "shapes"
            ) from None
        outs.append(torch.where(m, t, e))
    if not ctx.is_meta:
        _count("vectorize.lowered.cond")
    return tuple(outs)


def _broadcast_lead(ctx, c, n: int) -> torch.Tensor:
    """Give every carry the row axis: tensors already leading with the
    block's row count pass through; sub-lead carries (a shared initial
    accumulator, an invariant capture) are replicated per row."""
    c = ctx.tensor(c)
    if c.dim() >= 1 and c.shape[0] == n:
        return c
    return c.expand((n,) + tuple(c.shape)).contiguous()


def _check_broadcast_carry(node, carry, outs, n_vars: int) -> None:
    """The scalar path's carry contract, relaxed to broadcast
    compatibility: a body output may sit sub-lead and be spread across
    rows by the mask select."""
    for i, (c, o) in enumerate(zip(carry, outs)):
        (cs, cd), (os_, od) = _aval(c), _aval(o)
        if od != cd or not _broadcasts_to(os_, cs):
            raise GraphLoweringError(_carry_drift_msg(node, i, n_vars, c, o))


def masked_while(
    ctx, node, carry: Sequence, n_vars: int, cond_fn: Callable, body_fn: Callable,
    pred0, meta_body_fn: Callable,
) -> Tuple:
    """Lower a `_While` whose predicate ``pred0`` carries the row axis to
    one dense loop over the whole block.

    Every carry broadcasts to the row axis (rows evolve independently);
    the loop runs while any row's predicate holds, and a per-row mask
    freezes the rows that converged. ``meta_body_fn`` (the body built for
    the meta device) checks the carry contract before the loop runs. On
    the meta device the body runs once and the loop is not run."""
    n = _pred_rows(node, _aval(pred0)[0])
    carry = tuple(_broadcast_lead(ctx, c, n) for c in carry)
    _check_broadcast_carry(
        node, carry, tuple(meta_body_fn(*[_meta(c) for c in carry])), n_vars
    )
    if ctx.is_meta:
        return carry[:n_vars]

    def pred(c) -> torch.Tensor:
        p = ctx.tensor(cond_fn(*c)[0]).to(torch.bool)
        if p.numel() == 1:
            return p.reshape(()).expand(n)
        return _flat_rows(node, p)

    active = pred(carry)
    trips = 0
    # one host read a trip: eager PyTorch has no device-side loop
    while bool(active.any()):
        new = body_fn(*carry)
        carry = tuple(
            torch.where(active.reshape((n,) + (1,) * (old.dim() - 1)), ctx.tensor(nv), old)
            for nv, old in zip(new, carry)
        )
        active = torch.logical_and(active, pred(carry))
        trips += 1
    _count("vectorize.lowered.while")
    _count("vectorize.while.trips", trips)
    _count("vectorize.while.host_syncs", trips + 1)
    return carry[:n_vars]


def is_batched(pred: Any) -> bool:
    """A predicate with more than one element: per-row control flow."""
    return math.prod(_aval(pred)[0]) != 1
