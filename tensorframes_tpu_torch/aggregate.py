"""Keyed-aggregation planner: the three execution plans behind
`api.aggregate`.

The PyTorch counterpart of `tensorframes_tpu/aggregate.py`:

- `_aggregate_segment`: the row-wise transform of every fetch runs over
  all rows in one call, then the sums of every sum and mean fetch and the
  group counts in one launch of the keyed-sums kernel (`ops.keyed_sums`)
  where it takes the table, else a segment sum a fetch and a `bincount`,
  and one segment min / max / prod per other fetch (a mean is the segment
  sum over the group counts). Where every fetch is a sum or mean of a fed
  column or of its square (`_column_loads`) and the kernel takes them, the
  transform does not run: the kernel reads each column once and squares
  it as it loads. Taken by graphs
  `_chunk_combiners` classifies while ``config.aggregate_segment_fast`` is
  on (the default).
- `_aggregate_exact`: rows sorted by group id once; for each distinct
  group size, the groups of that size are gathered to
  ``(groups, size, *cell)`` on the device and run through the lowered
  callable under `torch.func.vmap`, control flow included (a cond selects
  per group, a loop runs masked: `graph.vectorize`). Taken by every other
  graph.
- `_aggregate_chunked`: power-of-two chunks of each sorted group, one
  vmapped call per chunk size, then a monoid combine of each group's
  partials. Taken instead of the exact plan by a classified graph with
  more distinct group sizes than ``config.aggregate_exact_size_limit``.

Under the block scheduler the exact and chunk plans' per-size calls spread
over the cards, weighted by their rows (`_fan_out`): each call's feeds are
gathered on the anchor and copied to its card, and its outputs come back to
the anchor. `parallel.verbs.aggregate` runs the segment plan once a shard.
Not ported: the TPU-only one-hot segment sum.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .frame import Column, TensorFrame, as_tensor, factorize_keys
from .graph import vectorize as _vec
from .graph.analysis import GraphSummary
from .graph.ir import Graph, base_name as _base
from .ops import keyed_sums as _ks
from .ops.lowering import build_callable
from .ops.standard import segment_reduce
from .runtime import costmodel as _cm
from .runtime import faults as _flt
from .runtime import scheduler as _rs
from .schema import ScalarType
from .utils import telemetry as _tele
from .utils.profiling import count as _count


def _factorized(grouped, device: torch.device):
    """``(key_out, inverse on device, num_groups)``: numeric keys moved to
    ``device`` and factorized there, string keys factorized on the host
    (`frame.factorize_keys`). Every plan's key stage: an
    ``aggregate.keys`` span, timed on the card on a CUDA ``device``."""
    frame = grouped.frame
    with _tele.span("aggregate.keys", kind="stage", torch_device=device):
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


_SEGMENT_OF = {"sum": "sum", "mean": "sum", "min": "amin", "max": "amax", "prod": "prod"}
_PLACEHOLDER_OPS = ("Placeholder", "PlaceholderV2")


def _through_identity(graph: Graph, name: str):
    """The node ``name`` names, past any chain of ``Identity`` nodes."""
    node = graph[name]
    while node.op == "Identity":
        node = graph[node.data_inputs()[0][0]]
    return node


def _load_of(graph: Graph, name: str, mapping: Dict[str, str]):
    """``(column, op)`` where the transform output ``name`` is a fed
    column as it is (``"identity"``) or its square (``"square"``: a
    ``Square`` of it, or a ``Mul`` of it by itself), through ``Identity``
    chains: what the keyed-sums kernel applies as it loads
    (`ops.keyed_sums.LOAD_OPS`). None for any other transform. ``mapping``:
    placeholder -> column."""
    node = _through_identity(graph, name)
    if node.op in _PLACEHOLDER_OPS:
        return (mapping[node.name], "identity") if node.name in mapping else None
    ins = [src for src, _ in node.data_inputs()]
    if not ((node.op == "Square" and len(ins) == 1) or (node.op == "Mul" and len(ins) == 2)):
        return None
    fed = [_through_identity(graph, src) for src in ins]
    cols = {mapping.get(n.name) if n.op in _PLACEHOLDER_OPS else None for n in fed}
    return (cols.pop(), "square") if len(cols) == 1 and None not in cols else None


def _column_loads(graph: Graph, bases: List[str], combiners: Dict[str, str],
                  mapping: Dict[str, str], columns: Dict[str, object]):
    """The keyed-sums launch on the fed columns themselves, or None:
    ``(sources, outputs)``, the distinct columns the fetches read (names of
    ``columns``) and each fetch's ``(source index, op)``. Where every fetch
    is a sum or mean of `_load_of`'s (a column, or its square): a function
    of the graph and the feeds alone. Placeholders fed from one column read
    it once."""
    if any(combiners[b] not in ("sum", "mean") for b in bases):
        return None
    loads = [_load_of(graph, graph[b].data_inputs()[0][0], mapping) for b in bases]
    if None in loads or any(c not in columns for c, _ in loads):
        return None
    sources = list(dict.fromkeys(c for c, _ in loads))
    return sources, [(sources.index(c), op) for c, op in loads]


def _segment_tables(graph: Graph, bases: List[str], combiners: Dict[str, str],
                    mapping: Dict[str, str], columns: Dict[str, torch.Tensor], transform,
                    gid: torch.Tensor, num_groups: int, counted: bool):
    """Each fetch's ``(num_groups, *cell)`` table over the group ids ``gid``
    (both segment plans' per-device step), from the fed ``columns`` (column
    -> tensor) and ``transform()``, the row-wise transform's outputs over
    them. The ``sum`` and ``mean`` fetches are one keyed-sums launch where
    `ops.keyed_sums.takes_launch` takes it, which also gives the int64 group
    counts: on the columns themselves, squared as they load, where
    `_column_loads` reads the fetches off them (the transform does not run;
    counted ``aggregate.segment.fused``), else on the transform's outputs
    (counted ``aggregate.segment.kernel``). The launch is counted in the
    cost ledger as its own program kind, ``keyed_sums``. Else each is a
    segment sum (counted ``aggregate.segment.torch``), and the counts a
    `bincount` where ``counted``. A segment min / max / prod a fetch for the
    others. Returns ``(tables, counts)``, counts None where neither gave
    them."""
    summed = [i for i, b in enumerate(bases) if combiners[b] in ("sum", "mean")]
    loads = _column_loads(graph, bases, combiners, mapping, columns)
    outs = None
    if loads is None:
        outs = transform()
        sources, outputs = [outs[i] for i in summed], [(j, "identity") for j in range(len(summed))]
    else:
        sources, outputs = [columns[c] for c in loads[0]], loads[1]
    tables: List[Optional[torch.Tensor]] = [None] * len(bases)
    counts = None
    kernel = bool(summed) and _ks.takes_launch(sources, num_groups, outputs)
    if summed:
        _count(f"aggregate.segment.{'fused' if loads else 'kernel'}" if kernel
               else "aggregate.segment.torch")
    if kernel:
        if outs is None:
            _tele.launching()  # the dispatch's first launch: its device timing starts here
        sums, counts = _ks.keyed_sums(sources, gid, num_groups, outputs)
        _cm.note_exec(("keyed_sums", graph.fingerprint()), [gid, *sources], [*sums, counts],
                      flops=_ks.launch_flops(sources, outputs))
        for i, t in zip(summed, sums):
            tables[i] = t
    elif outs is None:
        outs = transform()
    if counts is None and counted:
        # factorized ids: every one in [0, num_groups)
        counts = torch.bincount(gid, minlength=num_groups)
    for i, b in enumerate(bases):
        if tables[i] is None:
            tables[i] = segment_reduce(outs[i], gid, num_groups, _SEGMENT_OF[combiners[b]])
    return tables, counts


def _per_count(t: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """A mean's table: its sums over the group counts."""
    return t / counts.to(t.dtype).reshape((-1,) + (1,) * (t.dim() - 1))


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
    row-wise transforms over all rows in one call, then the tables over
    int64 group ids (`_segment_tables`; on the card the sums of a column
    and of its square skip the transform). Float sums differ from the
    exact plan's by summation order only."""
    frame = grouped.frame
    key_out, gid, num_groups = _factorized(grouped, device)
    bases = [_base(f) for f in fetch_list]
    # the data operand of each root reduce = the row-wise transform output
    roots = [graph[b].data_inputs()[0][0] for b in bases]
    transform = ex.callable_for(graph, roots, feed_names, device)
    # a column fed to several placeholders is made a tensor once
    columns = {c: as_tensor(frame.column(c).values, device)
               for c in dict.fromkeys(mapping[n] for n in feed_names)}

    def segment():
        tables, counts = _segment_tables(
            graph, bases, combiners, mapping, columns,
            lambda: transform(*[columns[mapping[n]] for n in feed_names]), gid, num_groups,
            "mean" in combiners.values())
        return {
            b: _per_count(t, counts) if combiners[b] == "mean" else t
            for b, t in zip(bases, tables)
        }

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


def _group_plan(grouped, mapping: Dict[str, str], feed_names: List[str], device: torch.device):
    """The sorted plans' prologue: keys factorized, rows sorted by group
    id once on ``device``. Returns ``(key_out, num_groups, counts,
    starts, col_data)``: host group sizes and start offsets, and every
    feed column in sorted row order on ``device``."""
    frame = grouped.frame
    key_out, inverse, num_groups = _factorized(grouped, device)
    order = torch.argsort(inverse, stable=True)
    counts = torch.bincount(inverse, minlength=num_groups).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    col_data = {
        n: as_tensor(frame.column(mapping[n]).values, device)[order] for n in feed_names
    }
    return key_out, num_groups, counts, starts, col_data


def _vmapped(ex, graph: Graph, fetch_list: List[str], feed_names: List[str], device):
    """The block graph under `torch.func.vmap` over a lead axis of groups
    (or chunks): ``(n, size, *cell)`` feeds, ``(n, *out)`` outputs. Control
    flow selects and loops per group (`graph.vectorize`)."""
    return ex.cached(
        "vmap-agg", graph, fetch_list, feed_names, device,
        lambda d: torch.func.vmap(build_callable(graph, fetch_list, feed_names, d)),
    )


def _gather_rows(col_data, feed_names, starts: np.ndarray, size: int, device):
    """``(len(starts), size, *cell)`` feeds: ``size`` sorted rows from each
    start (the row index is built on ``device``)."""
    rows = (torch.from_numpy(starts).to(device)[:, None]
            + torch.arange(size, device=device)[None, :])
    return [col_data[n][rows] for n in feed_names]


def _fan_out(calls, vfn_for, device, devs, ex, span: str, program, bases) -> List:
    """Dispatch the independent per-size calls ``calls`` (``(rows, size,
    feeds_for)``, in order; ``feeds_for()`` gathers the call's feeds on
    ``device`` when it dispatches, so one size's gathered feeds are alive
    at a time), each through a fault scope: on ``device``, or under a
    block schedule over ``devs`` (weighted by rows, each call's feeds
    copied to its card at call time, so a failover retry runs where the
    call was re-placed). Every call is issued before any output is read;
    outputs come back on ``device``."""
    fscope = _flt.scope("aggregate")
    sched = None
    if devs is not None:
        weights = [r for r, _, _ in calls]
        sched = _rs.BlockSchedule(devs, _rs.plan(weights, len(devs)), executor=ex, weights=weights)
    outs_all = []
    for si, (rows, size, feeds_for) in enumerate(calls):

        def thunk(si=si, rows=rows, size=size, feeds_for=feeds_for):
            dev = device if sched is None else sched.device(si)
            feeds = feeds_for()
            if sched is None:
                with _tele.dispatch_span(
                    span, program=program, rows=rows, size=size, torch_device=dev,
                ):
                    return vfn_for(dev)(*feeds)
            with _tele.dispatch_span(
                span, program=program, rows=rows, size=size, torch_device=dev,
                device=sched.label(si),
            ):
                return sched.bind(si, vfn_for(dev))(*feeds)

        what = "groups" if span == "aggregate.size" else "chunks"
        outs = fscope.dispatch(
            thunk, what=f"aggregate {what} of size {int(size)}", sched=sched, index=si,
        )
        _flt.maybe_check_numerics(bases, outs, f"aggregate {what} of size {size}")
        outs_all.append(tuple(outs) if sched is None else tuple(as_tensor(o, device) for o in outs))
    return outs_all


def _aggregate_exact(
    vfn_for, feed_names, col_data, counts, starts, num_groups, bases, device, program,
    devs=None, ex=None,
) -> Dict[str, torch.Tensor]:
    """Whole groups through the vmapped graph, one call per distinct group
    size: no associativity assumed."""
    results: Dict[str, torch.Tensor] = {}
    sizes = np.unique(counts[counts > 0])
    gid_sets = [np.nonzero(counts == size)[0] for size in sizes]
    calls = [
        (int(size) * len(gids), int(size),
         lambda st=starts[gids], n=int(size): _gather_rows(col_data, feed_names, st, n, device))
        for size, gids in zip(sizes, gid_sets)
    ]
    outs_all = _fan_out(calls, vfn_for, device, devs, ex, "aggregate.size", program, bases)
    for gids, outs in zip(gid_sets, outs_all):
        gids_t = torch.from_numpy(gids).to(device)
        for b, o in zip(bases, outs):
            if b not in results:
                results[b] = torch.zeros(
                    (num_groups,) + tuple(o.shape[1:]), dtype=o.dtype, device=device
                )
            results[b][gids_t] = o
    return results


def _chunks(counts: np.ndarray, starts: np.ndarray):
    """Binary decomposition of every sorted group into power-of-two chunks,
    largest first, in row order. Returns ``(by_size, group_of_slot,
    slot_size)``: ``by_size[p] = (chunk starts, slots)`` for each chunk
    size ``p``; a group's chunks take consecutive slots."""
    nchunks = np.zeros(len(counts), np.int64)
    top = int(counts.max()).bit_length() if len(counts) else 0
    for k in range(top):
        nchunks += (counts >> k) & 1
    base = np.concatenate([[0], np.cumsum(nchunks)[:-1]]).astype(np.int64)
    seen = np.zeros(len(counts), np.int64)
    by_size = {}
    slot_size = np.zeros(int(nchunks.sum()), np.int64)
    for k in reversed(range(top)):
        p = 1 << k
        gs = np.nonzero(counts & p)[0]
        if not len(gs):
            continue
        st = starts[gs] + (counts[gs] & ~(2 * p - 1))  # the higher chunks first
        slots = base[gs] + seen[gs]
        seen[gs] += 1
        by_size[p] = (st, slots)
        slot_size[slots] = p
    return by_size, np.repeat(np.arange(len(counts)), nchunks), slot_size


def _monoid_combine(tab: torch.Tensor, group_of_slot: torch.Tensor, num_groups: int,
                    comb: str, weights: torch.Tensor) -> torch.Tensor:
    """Each group's chunk partials combined by the fetch's derived monoid;
    a mean is weighted by its chunks' row counts (in float64, as the JAX
    package's ``reduceat``)."""
    if comb != "mean":
        return segment_reduce(tab, group_of_slot, num_groups, _SEGMENT_OF[comb])
    w = weights.reshape((-1,) + (1,) * (tab.dim() - 1))
    num = segment_reduce(tab.to(torch.float64) * w, group_of_slot, num_groups, "sum")
    den = segment_reduce(weights, group_of_slot, num_groups, "sum")
    return (num / den.reshape((-1,) + (1,) * (tab.dim() - 1))).to(tab.dtype)


def _aggregate_chunked(
    vfn_for, feed_names, col_data, counts, starts, num_groups, bases, combiners, device,
    program=None, devs=None, ex=None,
) -> Dict[str, torch.Tensor]:
    """Keyed aggregation by power-of-two chunks and a monoid combine.

    The exact plan makes one call per distinct group size: a distribution
    of all-distinct sizes makes one a group. Here each sorted group splits
    into power-of-two chunks (the binary digits of its size, in row order);
    all chunks of one size run as ONE call of the vmapped graph over
    ``(n, size, *cell)`` feeds, every size dispatched before any result is
    read (spread over ``devs`` under the block scheduler); then each
    group's partials combine by its fetch's monoid (`_chunk_combiners`),
    size-weighted for a mean. O(log max size) calls, whatever the
    distribution."""
    if num_groups == 0:
        return {}
    by_size, group_of_slot, slot_size = _chunks(counts, starts)
    nslots = len(slot_size)
    ps = sorted(by_size, reverse=True)
    calls = [
        (len(by_size[p][1]) * p, p,
         lambda st=by_size[p][0], n=p: _gather_rows(col_data, feed_names, st, n, device))
        for p in ps
    ]
    outs_all = _fan_out(calls, vfn_for, device, devs, ex, "aggregate.chunk", program, bases)
    partials: Dict[str, torch.Tensor] = {}
    for p, outs in zip(ps, outs_all):
        idx = torch.from_numpy(by_size[p][1]).to(device)
        for b, o in zip(bases, outs):
            if b not in partials:
                partials[b] = torch.empty(
                    (nslots,) + tuple(o.shape[1:]), dtype=o.dtype, device=device
                )
            partials[b][idx] = o
    gos = torch.from_numpy(group_of_slot).to(device)
    weights = torch.from_numpy(slot_size.astype(np.float64)).to(device)
    return {
        b: _monoid_combine(partials[b], gos, num_groups, combiners[b], weights)
        for b in bases
    }


def _aggregate_sorted(
    ex,
    graph: Graph,
    fetch_list: List[str],
    summary: GraphSummary,
    feed_names: List[str],
    mapping: Dict[str, str],
    grouped,
    device: torch.device,
    classified: Optional[Dict[str, str]],
    devs=None,
) -> TensorFrame:
    """The plans over rows sorted by group on ``device``: the exact plan,
    or, for a classified graph with more distinct group sizes than
    ``config.aggregate_exact_size_limit``, the chunk plan, their per-size
    calls spread over ``devs`` when the block scheduler placed the call.
    Counted as ``aggregate.plan.exact`` / ``aggregate.plan.chunk``."""
    from . import config as _config
    from .api import _empty_output

    key_out, num_groups, counts, starts, col_data = _group_plan(
        grouped, mapping, feed_names, device
    )
    vfns: Dict = {}

    def vfn_for(dev):
        if dev not in vfns:
            vfns[dev] = _vmapped(ex, graph, fetch_list, feed_names, dev)
        return vfns[dev]

    bases = [_base(f) for f in fetch_list]
    combiners = None
    if len(np.unique(counts[counts > 0])) > _config.get().aggregate_exact_size_limit:
        # only a provably chunk-safe graph chunks; any other keeps the
        # exact plan, at one call a distinct size
        combiners = classified
    plan = "exact" if combiners is None else "chunk"
    _count(f"aggregate.plan.{plan}")
    fp = graph.fingerprint()
    with _tele.span(f"aggregate.plan.{plan}", kind="stage", program=fp):
        if combiners is None:
            results = _aggregate_exact(
                vfn_for, feed_names, col_data, counts, starts, num_groups, bases, device, fp,
                devs, ex,
            )
        else:
            results = _aggregate_chunked(
                vfn_for, feed_names, col_data, counts, starts,
                num_groups, bases, combiners, device, program=fp, devs=devs, ex=ex,
            )
    for b in bases:
        if b not in results:  # empty frame: zero groups
            results[b] = _empty_output(summary, b, False, device)
    return _keyed_output(key_out, results, bases)
