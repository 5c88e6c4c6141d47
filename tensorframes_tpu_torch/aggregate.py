"""Keyed-aggregation planner: the two execution plans behind
`api.aggregate`.

The PyTorch counterpart of `tensorframes_tpu/aggregate.py`, with the plans
the JAX package runs under its default config:

- `_aggregate_segment`: the row-wise transform of every fetch runs over
  all rows in one call, then one segment sum / min / max / prod per fetch
  (a mean is the segment sum over the group counts). Taken by graphs
  `_chunk_combiners` classifies.
- `_aggregate_exact`: rows sorted by group id once; for each distinct
  group size, the groups of that size are gathered to
  ``(groups, size, *cell)`` on the device and run through the lowered
  callable under `torch.func.vmap` (one call a group for a graph with
  control flow, whose predicates `vmap` cannot read). Taken by every
  other graph.

Not ported: the chunked plan (unreachable under the JAX package's default
config) and the TPU-only one-hot segment sum.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .frame import Column, TensorFrame, as_tensor, factorize_keys
from .graph import vectorize as _vec
from .graph.analysis import GraphSummary
from .graph.ir import Graph, base_name as _base
from .ops.lowering import build_callable
from .ops.standard import segment_reduce
from .runtime import faults as _flt
from .schema import ScalarType
from .utils import telemetry as _tele


def _factorized(grouped, device: torch.device):
    """``(key_out, inverse on device, num_groups)``: numeric keys moved to
    ``device`` and factorized there, string keys factorized on the host
    (`frame.factorize_keys`)."""
    frame = grouped.frame
    keys = []
    for k in grouped.keys:
        col = frame.column(k)
        numeric = col.is_dense and col.dtype is not ScalarType.string
        keys.append(as_tensor(col.values, device) if numeric else col.host_values())
    key_out, inverse = factorize_keys(grouped.keys, keys, device)
    return key_out, inverse, len(next(iter(key_out.values())))


def _keyed_output(
    key_out: Dict[str, Union[torch.Tensor, np.ndarray]],
    results: Dict[str, torch.Tensor],
    bases: List[str],
) -> TensorFrame:
    """Key columns, then the outputs sorted by name (`DebugRowOps.scala:583-598`).
    A string key is a host string column, empty for an empty frame."""
    cols = [
        Column(k, v, ScalarType.string if isinstance(v, np.ndarray) and v.dtype == object else None)
        for k, v in key_out.items()
    ]
    cols += [Column(b, results[b]) for b in sorted(bases)]
    return TensorFrame(cols)


# Reduce roots the segment plan can compute, and their segment reducers.
_CHUNK_COMBINERS = {
    "Sum": "sum",
    "Min": "min",
    "Max": "max",
    "Prod": "prod",
    "Mean": "mean",
}

# Ops that act row-locally (each output row depends only on the matching
# input row and on sub-lead-rank constants).
_ROWWISE_OPS = {
    "Identity", "StopGradient", "PreventGradient", "CheckNumerics",
    "Snapshot", "Cast",
    "Abs", "Neg", "Exp", "Log", "Log1p", "Sqrt", "Rsqrt", "Square",
    "Sign", "Floor", "Ceil", "Round", "Relu", "Relu6", "Elu", "Selu",
    "Softplus", "Softsign", "Sigmoid", "Tanh", "Sin", "Cos", "Tan",
    "Erf", "Reciprocal",
    "Add", "AddV2", "Sub", "Mul", "Div", "RealDiv", "TruncateDiv",
    "FloorDiv", "Maximum", "Minimum", "Pow", "SquaredDifference", "Mod",
    "FloorMod",
    "Greater", "GreaterEqual", "Less", "LessEqual", "Equal", "NotEqual",
    "LogicalAnd", "LogicalOr", "LogicalNot", "Select", "SelectV2",
}


def _rowwise_transform(graph: Graph, roots, ph_rank: Callable) -> bool:
    """Every node reachable from ``roots`` is a Placeholder (block rank via
    ``ph_rank(name)``, None = unknown -> reject), a Const, or an op in
    `_ROWWISE_OPS`; all placeholders agree on one lead rank; and every
    constant stays below it (or has a size-1 lead).

    Functionalized control flow (`_Cond`/`_While`) is deferred, not
    rejected: once the lead rank is known, `graph.vectorize` re-runs this
    walk over each branch/cond/body subgraph at that rank. A control node
    whose subgraphs are row-local lowers to a masked dense program (cond
    -> select, while -> convergence-masked loop) and is row-local itself;
    rejections are counted by reason (``vectorize.fallback.<reason>``)."""
    seen: set = set()
    stack = [_base(r) for r in roots]
    const_shapes: List[tuple] = []
    ranks: set = set()
    control_nodes: List = []
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        try:
            node = graph[name]
        except KeyError:
            return False
        if node.op in ("Placeholder", "PlaceholderV2"):
            r = ph_rank(name)
            if r is None:
                return False
            ranks.add(int(r))
            continue
        if node.op == "Const":
            const_shapes.append(tuple(node.attrs["value"].value.to_numpy().shape))
            continue
        if node.op in _vec.CONTROL_OPS:
            # the verdict needs the lead rank: defer it, but walk the
            # node's own inputs (pred, loop vars, captures) now
            control_nodes.append(node)
        elif node.op not in _ROWWISE_OPS:
            return False
        stack.extend(src for src, _ in node.data_inputs())
    if len(ranks) != 1:
        return False
    lead_rank = ranks.pop()
    if not all(
        len(cs) < lead_rank or (len(cs) == lead_rank and (not cs or cs[0] == 1))
        for cs in const_shapes
    ):
        return False
    return all(_vec.subgraphs_row_local(graph, n, lead_rank) for n in control_nodes)


def _chunk_combiners(
    graph: Graph, fetch_list: List[str], summary: GraphSummary,
    require_direct: bool = False,
) -> Optional[Dict[str, str]]:
    """Classify each fetch as ``Reduce(rowwise(placeholder), axis=0)``.

    Returns base -> combiner tag when every fetch is a recognized monoid
    reduce over the lead axis of a row-local transform of its
    placeholder, else None (the exact whole-group plan).

    ``require_direct`` additionally demands each reduce consume its
    placeholder DIRECTLY (no transform in between): `reduce_blocks_stream`
    recombines partials through the same graph when it tree-folds, where
    an interposed transform would be re-applied to the partials."""
    out: Dict[str, str] = {}
    for f in fetch_list:
        try:
            node = graph[_base(f)]
        except KeyError:
            return None
        if node.op not in _CHUNK_COMBINERS:
            return None
        if bool(node.attr("keep_dims", node.attr("keepdims", False))):
            return None
        if node.op == "Mean" and not summary.outputs[_base(f)].dtype.is_floating:
            # integer Mean truncates (TF semantics), so it takes the exact plan
            return None
        data_in = node.data_inputs()
        if len(data_in) != 2:
            return None
        if require_direct and graph[data_in[0][0]].op not in (
            "Placeholder", "PlaceholderV2"
        ):
            return None
        idx_node = graph[data_in[1][0]]
        if idx_node.op != "Const":
            return None
        if idx_node.attrs["value"].value.to_numpy().ravel().tolist() != [0]:
            return None
        if not _rowwise_transform(
            graph,
            [data_in[0][0]],
            lambda name: (
                len(summary.inputs[name].shape.dims) if name in summary.inputs else None
            ),
        ):
            return None
        out[_base(f)] = _CHUNK_COMBINERS[node.op]
    return out


_SEGMENT_OF = {"sum": "sum", "min": "amin", "max": "amax", "prod": "prod"}


def _aggregate_segment(
    ex,
    graph: Graph,
    fetch_list: List[str],
    combiners: Dict[str, str],
    feed_names: List[str],
    mapping: Dict[str, str],
    grouped,
    device: torch.device,
) -> TensorFrame:
    """Sort-free keyed aggregation for classified monoid graphs: the
    row-wise transforms over all rows in one call, then one device segment
    reduce per fetch over int64 group ids. Float sums differ from the
    exact plan's by summation order only."""
    frame = grouped.frame
    key_out, gid, num_groups = _factorized(grouped, device)
    bases = [_base(f) for f in fetch_list]
    # the data operand of each root reduce = the row-wise transform output
    roots = [graph[b].data_inputs()[0][0] for b in bases]
    transform = ex.callable_for(graph, roots, feed_names, device)
    feeds = [as_tensor(frame.column(mapping[n]).values, device) for n in feed_names]

    def segment():
        outs = transform(*feeds)
        counts = (
            torch.bincount(gid, minlength=num_groups)
            if "mean" in combiners.values()
            else None
        )
        results: Dict[str, torch.Tensor] = {}
        for b, o in zip(bases, outs):
            comb = combiners[b]
            if comb == "mean":
                s = segment_reduce(o, gid, num_groups, "sum")
                results[b] = s / counts.to(o.dtype).reshape((-1,) + (1,) * (s.dim() - 1))
            else:
                results[b] = segment_reduce(o, gid, num_groups, _SEGMENT_OF[comb])
        return results

    def thunk():
        with _tele.dispatch_span(
            "aggregate.segment", program=graph.fingerprint(), rows=frame.nrows,
            groups=num_groups, torch_device=device,
        ):
            return segment()

    # one whole-frame dispatch: no block to split, so a transient retry only
    results = _flt.scope("aggregate").dispatch(thunk, what="aggregate segment dispatch")
    _flt.maybe_check_numerics(
        bases, [results[b] for b in bases], "aggregate (segment fast path)"
    )
    return _keyed_output(key_out, results, bases)


def _aggregate_exact(
    ex,
    graph: Graph,
    fetch_list: List[str],
    summary: GraphSummary,
    feed_names: List[str],
    mapping: Dict[str, str],
    grouped,
    device: torch.device,
) -> TensorFrame:
    """Whole groups through the lowered graph, one vmapped call per
    distinct group size: no associativity assumed."""
    from .api import _empty_output

    frame = grouped.frame
    key_out, inverse, num_groups = _factorized(grouped, device)
    order = torch.argsort(inverse, stable=True)
    counts = torch.bincount(inverse, minlength=num_groups).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    col_data = {
        n: as_tensor(frame.column(mapping[n]).values, device)[order] for n in feed_names
    }
    if any(n.op in _vec.CONTROL_OPS for n in graph.toposort(fetch_list)):
        # torch.func.vmap cannot read a batched predicate: one call a group
        fn = ex.callable_for(graph, fetch_list, feed_names, device)

        def vfn(*cols):
            outs = [fn(*[c[g] for c in cols]) for g in range(cols[0].shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))
    else:
        vfn = ex.cached(
            "vmap-agg", graph, fetch_list, feed_names, device,
            lambda d: torch.func.vmap(build_callable(graph, fetch_list, feed_names, d)),
        )
    bases = [_base(f) for f in fetch_list]
    results: Dict[str, Optional[torch.Tensor]] = {b: None for b in bases}
    fscope = _flt.scope("aggregate")
    fp = graph.fingerprint()
    for size in np.unique(counts[counts > 0]):
        gids = np.nonzero(counts == size)[0]
        rows = torch.from_numpy(starts[gids][:, None] + np.arange(size)[None, :]).to(device)
        feeds = [col_data[n][rows] for n in feed_names]  # (g, size, *cell) each

        def thunk(feeds=feeds, size=size, g=len(gids)):
            with _tele.dispatch_span(
                "aggregate.size", program=fp, rows=int(size) * g, size=int(size),
                torch_device=device,
            ):
                return vfn(*feeds)

        outs = fscope.dispatch(thunk, what=f"aggregate groups of size {int(size)}")
        _flt.maybe_check_numerics(bases, outs, f"aggregate groups of size {size}")
        gids_t = torch.from_numpy(gids).to(device)
        for b, o in zip(bases, outs):
            if results[b] is None:
                results[b] = torch.zeros(
                    (num_groups,) + tuple(o.shape[1:]), dtype=o.dtype, device=device
                )
            results[b][gids_t] = o
    for b in bases:
        if results[b] is None:  # empty frame: zero groups
            results[b] = _empty_output(summary, b, False, device)
    return _keyed_output(key_out, results, bases)
