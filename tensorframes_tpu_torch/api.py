"""The five verbs: `map_blocks`, `map_rows`, `reduce_blocks`, `reduce_rows`
and `aggregate` (with `group_by`), plus `block`, `row` and `analyze`.

The PyTorch counterpart of `tensorframes_tpu/api.py`. A graph (DSL tensor,
`Graph`, GraphDef bytes or file path) is analyzed, its placeholders are
matched to columns (or to per-call ``bindings``), and a lowered callable
runs once per block on ``device`` (default: the CUDA card). Outputs stay on
that device as tensors; `Column.host_values` is the one way back to numpy.

Not in the port yet: the mesh/scheduler/lazy/global routes, string
pass-through, shape bucketing (eager PyTorch has no per-shape compile to
bound) and the chunked aggregate plan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .aggregate import (
    _aggregate_exact,
    _aggregate_segment,
    _chunk_combiners,
    _rowwise_transform,
)
from .device import DeviceLike, resolve_device
from .frame import Column, TensorFrame, as_tensor
from .graph import builder as dsl
from .graph import vectorize as _vec
from .graph.analysis import GraphSummary, analyze_graph
from .graph.control_flow import functionalize
from .graph.freeze import freeze_variables
from .graph.ir import Graph, base_name
from .ops.lowering import build_callable
from .runtime.executor import Executor, default_executor
from .schema import ScalarType, Shape
from .utils.profiling import count as _count

__all__ = [
    "map_blocks",
    "map_rows",
    "reduce_blocks",
    "reduce_rows",
    "aggregate",
    "group_by",
    "GroupedFrame",
    "block",
    "row",
    "analyze",
    "print_schema",
]

Fetches = Union[dsl.Tensor, Sequence[dsl.Tensor], Graph, bytes, str]
Bindings = Optional[Dict[str, Union[np.ndarray, torch.Tensor]]]

# ---------------------------------------------------------------------------
# graph normalization + placeholder <-> column matching
# ---------------------------------------------------------------------------


def _as_graph(
    fetches: Fetches, fetch_names: Optional[Sequence[str]]
) -> Tuple[Graph, List[str]]:
    if isinstance(fetches, dsl.Tensor):
        return dsl.build(fetches)
    if isinstance(fetches, (list, tuple)) and all(
        isinstance(f, dsl.Tensor) for f in fetches
    ):
        return dsl.build(list(fetches))
    if isinstance(fetches, Graph):
        g = fetches
    elif isinstance(fetches, bytes):
        g = Graph.from_bytes(fetches)
    elif isinstance(fetches, str):
        g = Graph.from_file(fetches)
    else:
        raise TypeError(f"cannot interpret fetches of type {type(fetches)!r}")
    if not fetch_names:
        raise ValueError("imported graphs need explicit fetch_names=[...]")
    # TF control flow (v1 Switch/Merge rings, v2 If/While, function calls)
    # becomes _Cond/_While pseudo-nodes first; then stateful graphs are
    # frozen, where the reference froze them (core.py:42-56)
    g, fetch_list = functionalize(g, list(fetch_names))
    return freeze_variables(g), list(fetch_list)


_REDUCE_SUFFIXES = ("_input", "_1", "_2")


def _default_column(ph_name: str, frame: TensorFrame) -> str:
    """Placeholder ``x_input``/``x_1``/``x_2`` reads column ``x`` unless a
    column carries the placeholder's literal name."""
    if ph_name in frame.info:
        return ph_name
    for suf in _REDUCE_SUFFIXES:
        if ph_name.endswith(suf) and ph_name[: -len(suf)] in frame.info:
            return ph_name[: -len(suf)]
    return ph_name


def _normalize_bindings(bindings: Bindings) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
    return {
        k: v if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in (bindings or {}).items()
    }


def _binding_type(arr) -> ScalarType:
    if isinstance(arr, torch.Tensor):
        return ScalarType.from_torch_dtype(arr.dtype)
    return ScalarType.from_np_dtype(np.dtype(arr.dtype))


def _check_bindings(summary: GraphSummary, bindings: Dict) -> None:
    """Validate per-call bound arrays against their placeholders. A bound
    array is an argument of the lowered callable, not a baked constant, so
    one lowering serves every call whatever the bound values."""
    for name, arr in bindings.items():
        if name not in summary.inputs:
            raise ValueError(
                f"binding {name!r} does not match any placeholder "
                f"(placeholders: {sorted(summary.inputs)})"
            )
        ph = summary.inputs[name]
        st = _binding_type(arr)
        if st is not ph.dtype:
            raise ValueError(
                f"binding {name!r} has dtype {st.name} but placeholder wants "
                f"{ph.dtype.name} (TF graphs do not promote dtypes)"
            )
        if not Shape(tuple(arr.shape)).check_more_precise_than(ph.shape):
            raise ValueError(
                f"binding {name!r} with shape {tuple(arr.shape)} is not "
                f"compatible with placeholder shape {ph.shape}"
            )


def _ph_overrides(
    graph: Graph,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]],
    block_level: bool,
    bindings: Dict,
) -> Dict[str, Shape]:
    """Column (and binding) shapes are usually more precise than
    placeholder attrs (imported graphs carry [?,?]); inject them for
    tighter analysis."""
    feed_dict = feed_dict or {}
    overrides: Dict[str, Shape] = {}
    for ph in graph.placeholders():
        if ph.name in bindings:
            shape = Shape(tuple(bindings[ph.name].shape))
        else:
            col_name = feed_dict.get(ph.name, _default_column(ph.name, frame))
            if col_name not in frame.info:
                continue
            info = frame.info[col_name]
            shape = info.block_shape if block_level else info.cell_shape
        attr = ph.shape_attr
        # an incompatible shape leaves the attr for the checks to name
        if attr is None or shape.check_more_precise_than(attr):
            overrides[ph.name] = shape
    return overrides


def _match_columns(
    summary: GraphSummary,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]],
    block_level: bool,
    bindings: Dict,
) -> Dict[str, str]:
    """Map placeholder name -> column name; validate dtype + shape. Bound
    placeholders are fed their binding instead and are left out."""
    feed_dict = feed_dict or {}
    mapping: Dict[str, str] = {}
    for ph_name, ph in summary.inputs.items():
        if ph_name in bindings:
            continue
        col_name = feed_dict.get(ph_name, _default_column(ph_name, frame))
        if col_name not in frame.info:
            raise ValueError(
                f"placeholder {ph_name!r} wants column {col_name!r} which is "
                f"not in the frame (columns: {frame.columns}); use feed_dict "
                "to rename"
            )
        info = frame.info[col_name]
        if info.dtype is not ph.dtype:
            raise ValueError(
                f"placeholder {ph_name!r} has dtype {ph.dtype.name} but "
                f"column {col_name!r} has dtype {info.dtype.name} (TF graphs "
                "do not promote dtypes)"
            )
        col_shape = info.block_shape if block_level else info.cell_shape
        if not col_shape.check_more_precise_than(ph.shape):
            raise ValueError(
                f"column {col_name!r} with shape {col_shape} is not compatible"
                f" with shape {ph.shape} requested by placeholder {ph_name!r}"
            )
        mapping[ph_name] = col_name
    return mapping


def _prepare(
    fetches, frame, feed_dict, fetch_names, block_level, bindings=None, validate=None
):
    """Graph, fetches, analysis and placeholder -> column mapping. A
    verb's naming convention (``validate``) is checked before the columns
    are matched, so a misnamed placeholder is reported as such."""
    bindings = bindings if bindings is not None else {}
    graph, fetch_list = _as_graph(fetches, fetch_names)
    overrides = _ph_overrides(graph, frame, feed_dict, block_level, bindings)
    summary = analyze_graph(graph, fetch_list, placeholder_shapes=overrides)
    _check_bindings(summary, bindings)
    if validate is not None:
        validate(summary, fetch_list)
    mapping = _match_columns(summary, frame, feed_dict, block_level, bindings)
    return graph, fetch_list, summary, mapping


def _empty_output(
    summary: GraphSummary, base: str, drop_lead: bool, device: torch.device
) -> torch.Tensor:
    """Zero-row output for an all-empty frame, typed from the analysis."""
    info = summary.outputs[base]
    dims = info.shape.dims[1:] if drop_lead else info.shape.dims
    shape = (0,) + tuple(0 if d is None else d for d in dims)
    return torch.zeros(shape, dtype=info.dtype.torch_dtype, device=device)


def _concat(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _output_frame(
    frame: TensorFrame,
    out_cols: List[Column],
    append_input: bool,
    offsets: Optional[List[int]] = None,
) -> TensorFrame:
    """Graph outputs first, sorted by name, then the input columns they do
    not shadow."""
    cols = sorted(out_cols, key=lambda c: c.name)
    if append_input:
        shadow = {c.name for c in cols}
        cols += [frame.column(n) for n in frame.columns if n not in shadow]
    return TensorFrame(cols, offsets if offsets is not None else frame.offsets)


def _feeds(frame, mapping, feed_names, lo, hi, device, bound=None) -> List[torch.Tensor]:
    """One block's feeds: its column slices on ``device``, and the bound
    tensors (already on ``device``) as they are."""
    bound = bound or {}
    return [
        bound[n] if n in bound else as_tensor(frame.column(mapping[n]).values[lo:hi], device)
        for n in feed_names
    ]


def _bound_tensors(bindings: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every binding on ``device``, once per call: every block reuses it."""
    return {k: as_tensor(v, device) for k, v in bindings.items()}


def _block_rows(outs: Dict[str, torch.Tensor], rows: int, trim: bool) -> int:
    """Row count of one block's named outputs. Every output needs a lead
    (row) dim; without ``trim`` it must be the block's ``rows``, with
    ``trim`` the outputs must agree on it."""
    sizes = set()
    for name, o in outs.items():
        if o.dim() == 0:
            raise ValueError(
                f"map_blocks: output {name!r} must have a lead (row) dim"
                + ("" if trim else "; use trim=True for reductions")
            )
        if not trim and o.shape[0] != rows:
            raise ValueError(
                f"map_blocks: output {name!r} has lead dim {o.shape[0]} but "
                f"the block has {rows} rows; use trim=True for "
                "row-count-changing maps"
            )
        sizes.add(int(o.shape[0]))
    if len(sizes) > 1:
        raise ValueError("map_blocks(trim): outputs disagree on row count")
    return sizes.pop()


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------


@torch.inference_mode()
def map_blocks(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    trim: bool = False,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    bindings: Bindings = None,
    device: DeviceLike = None,
) -> TensorFrame:
    """Apply a graph, or a plain function of columns returning a dict of
    named outputs, to each block on ``device``.

    Without ``trim`` every output keeps the block's row count and the
    input columns ride along; with ``trim=True`` the row count may change
    and the input columns are dropped. ``bindings`` feeds named
    placeholders (or function parameters) one array for every block; new
    values on a later call reuse the same lowering.
    """
    dev = resolve_device(device)
    bindings = _normalize_bindings(bindings)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_blocks_fn

        return _map_blocks_fn(fetches, frame, trim, dev, bindings)
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, True, bindings
    )
    ex = executor or default_executor()
    feed_names = sorted(summary.inputs)
    fn = ex.callable_for(graph, fetch_list, feed_names, dev)
    bound = _bound_tensors(bindings, dev)

    acc: Dict[str, List[torch.Tensor]] = {base_name(f): [] for f in fetch_list}
    out_sizes: List[int] = []
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            out_sizes.append(0)
            continue  # an empty block contributes nothing
        outs = fn(*_feeds(frame, mapping, feed_names, lo, hi, dev, bound))
        named = {base_name(f): o for f, o in zip(fetch_list, outs)}
        out_sizes.append(_block_rows(named, hi - lo, trim))
        for base, o in named.items():
            acc[base].append(o)

    out_cols = [
        Column(
            base,
            _concat(parts) if parts else _empty_output(summary, base, True, dev),
        )
        for base, parts in acc.items()
    ]
    offsets = list(np.cumsum([0] + out_sizes)) if trim else frame.offsets
    return _output_frame(frame, out_cols, append_input=not trim, offsets=offsets)


# ---------------------------------------------------------------------------
# map_rows
# ---------------------------------------------------------------------------


def _row_plan(ex, graph, fetch_list, feed_names, summary, bindings, dev):
    """`map_rows`' plan for this graph, counted: ``run(feeds, rows)`` gives
    one block's outputs, each with the row axis (see `map_rows`)."""
    if not any(n.op in _vec.CONTROL_OPS for n in graph.toposort(fetch_list)):
        _count("map_rows.plan.vmap")
        in_dims = tuple(None if n in bindings else 0 for n in feed_names)
        vfn = ex.cached(
            f"vmap-rows-[{','.join(sorted(bindings))}]" if bindings else "vmap-rows",
            graph, fetch_list, feed_names, dev,
            lambda: torch.func.vmap(
                build_callable(graph, fetch_list, feed_names, dev), in_dims=in_dims
            ),
        )
        return lambda feeds, rows: vfn(*feeds)

    block_rank = {n: summary.inputs[n].shape.rank + 1 for n in feed_names}
    if not bindings and _rowwise_transform(graph, fetch_list, block_rank.get):
        _count("map_rows.plan.lifted")
        fn = ex.cached(
            "lifted-rows", graph, fetch_list, feed_names, dev,
            lambda: build_callable(
                _vec.lift_to_block_level(graph.clone()), fetch_list, feed_names, dev,
                row_axis=True,
            ),
        )
        cell_ranks = [summary.outputs[base_name(f)].shape.rank for f in fetch_list]

        def lifted(feeds, rows):
            # an output the branches computed alike for every row has no
            # row axis yet
            return tuple(
                o if o.dim() > r else o.expand((rows,) + tuple(o.shape))
                for o, r in zip(fn(*feeds), cell_ranks)
            )

        return lifted

    _count("map_rows.plan.per_row")
    fn = ex.callable_for(graph, fetch_list, feed_names, dev)
    per_row = [n not in bindings for n in feed_names]

    def rows_one_by_one(feeds, rows):
        outs = [
            fn(*[f[i] if r else f for f, r in zip(feeds, per_row)]) for i in range(rows)
        ]
        return tuple(torch.stack(col) for col in zip(*outs))

    return rows_one_by_one


@torch.inference_mode()
def map_rows(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    bindings: Bindings = None,
    device: DeviceLike = None,
) -> TensorFrame:
    """Apply a per-row graph, or a plain function of row cells returning
    a dict of named outputs, to every row, one call per block where the
    graph allows it (the reference ran one session per row). Three plans:

    - ``vmap``, for a graph without control flow: the per-row callable
      vectorized over the block's rows with `torch.func.vmap`;
    - ``lifted``, for a graph with `_Cond`/`_While` that is row-local
      (`aggregate._rowwise_transform`) and has no bindings: the graph
      lifted to block level, so its predicates carry the row axis and
      `graph.vectorize` selects per row and loops under a per-row mask,
      as JAX's batching rules do under `vmap`;
    - ``per_row``, for any other graph with control flow: the callable
      once per row (`torch.func.vmap` cannot read a batched predicate).

    Bound placeholders are the same for every row. The plan taken is
    counted (``map_rows.plan.<plan>``)."""
    dev = resolve_device(device)
    bindings = _normalize_bindings(bindings)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_rows_fn

        return _map_rows_fn(fetches, frame, dev, bindings)
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, False, bindings
    )
    feed_names = sorted(summary.inputs)
    if bindings and not mapping:
        raise ValueError(
            "map_rows: every placeholder is bound, so nothing varies per "
            "row; use map_blocks (or run the graph once and broadcast)"
        )
    ex = executor or default_executor()
    run_block = _row_plan(ex, graph, fetch_list, feed_names, summary, bindings, dev)
    bound = _bound_tensors(bindings, dev)
    out_names = [base_name(f) for f in fetch_list]
    acc: Dict[str, List[torch.Tensor]] = {n: [] for n in out_names}
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            continue
        outs = run_block(_feeds(frame, mapping, feed_names, lo, hi, dev, bound), hi - lo)
        for n, o in zip(out_names, outs):
            acc[n].append(o)
    out_cols = [
        Column(
            n,
            _concat(parts) if parts else _empty_output(summary, n, False, dev),
        )
        for n, parts in acc.items()
    ]
    return _output_frame(frame, out_cols, append_input=True)


# ---------------------------------------------------------------------------
# reduce_blocks
# ---------------------------------------------------------------------------


def _validate_reduce_blocks(summary: GraphSummary, fetch_list: List[str]) -> None:
    """Output ``x`` <-> placeholder ``x_input``: same dtype, and the
    placeholder is the output shape plus a lead block dim, so partials can
    be fed back for the combine."""
    allowed = {base_name(f) + "_input" for f in fetch_list}
    extra = set(summary.inputs) - allowed
    if extra:
        raise ValueError(
            f"reduce_blocks: placeholders {sorted(extra)} do not follow the "
            f"x -> x_input convention for outputs {sorted(allowed)}"
        )
    for f in fetch_list:
        base = base_name(f)
        ph_name = base + "_input"
        if ph_name not in summary.inputs:
            raise ValueError(
                f"reduce_blocks: output {base!r} requires a placeholder "
                f"named {ph_name!r} (inputs: {sorted(summary.inputs)})"
            )
        ph, out = summary.inputs[ph_name], summary.outputs[base]
        if ph.dtype is not out.dtype:
            raise ValueError(
                f"reduce_blocks: {base!r} has dtype {out.dtype.name} but "
                f"{ph_name!r} has dtype {ph.dtype.name}"
            )
        if ph.shape.rank != out.shape.rank + 1 or not (
            out.shape.check_more_precise_than(ph.shape.tail)
        ):
            raise ValueError(
                f"reduce_blocks: placeholder {ph_name!r} (shape {ph.shape}) "
                f"must be output {base!r} (shape {out.shape}) plus a lead "
                "block dim"
            )


def _combine_partials(fn, feed_src: List[int], partials: List[Tuple]) -> Tuple:
    """Stack every block's partials on the device and run the same graph
    once more over them: the contract demands an associative reduce, so
    one combine replaces the reference's pairwise merges."""
    stacked = [torch.stack([p[i] for p in partials]) for i in feed_src]
    return fn(*stacked)


def _results(bases: List[str], values):
    """One tensor for one fetch, a dict of tensors for several."""
    return values[0] if len(bases) == 1 else dict(zip(bases, values))


@torch.inference_mode()
def reduce_blocks(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
):
    """Per-block reduce, then one combine over the stacked partials.
    Returns one tensor for one fetch, a dict of tensors for several; the
    results stay on ``device``."""
    dev = resolve_device(device)
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, True, validate=_validate_reduce_blocks
    )
    ex = executor or default_executor()
    feed_names = sorted(summary.inputs)
    fn = ex.callable_for(graph, fetch_list, feed_names, dev)
    # feed_src[j] = the fetch whose partial re-feeds feed_names[j]
    fetch_of_feed = {base_name(f) + "_input": i for i, f in enumerate(fetch_list)}
    feed_src = [fetch_of_feed[n] for n in feed_names]

    partials: List[Tuple] = []
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            continue  # the reduction identity would poison the combine
        partials.append(fn(*_feeds(frame, mapping, feed_names, lo, hi, dev)))
    if not partials:
        raise ValueError("reduce_blocks on an empty frame")
    final = (
        partials[0]
        if len(partials) == 1
        else _combine_partials(fn, feed_src, partials)
    )
    return _results([base_name(f) for f in fetch_list], final)


# ---------------------------------------------------------------------------
# reduce_rows
# ---------------------------------------------------------------------------


def _validate_reduce_rows(summary: GraphSummary, fetch_list: List[str]) -> None:
    """`reduceRowsSchema` (`DebugRowOps.scala:172-262`): output ``x`` <->
    placeholders ``x_1``/``x_2``, all three the same dtype and cell shape."""
    allowed = {base_name(f) + s for f in fetch_list for s in ("_1", "_2")}
    extra = set(summary.inputs) - allowed
    if extra:
        raise ValueError(
            f"reduce_rows: placeholders {sorted(extra)} do not follow the "
            "x -> x_1/x_2 convention"
        )
    for f in fetch_list:
        base = base_name(f)
        for suf in ("_1", "_2"):
            if base + suf not in summary.inputs:
                raise ValueError(
                    f"reduce_rows: output {base!r} requires placeholders "
                    f"{base}_1 and {base}_2 (inputs: {sorted(summary.inputs)})"
                )
        p1, p2 = summary.inputs[base + "_1"], summary.inputs[base + "_2"]
        out = summary.outputs[base]
        if not (p1.dtype is p2.dtype is out.dtype):
            raise ValueError(f"reduce_rows: dtype mismatch around {base!r}")
        if not (
            out.shape.check_more_precise_than(p1.shape)
            and out.shape.check_more_precise_than(p2.shape)
        ):
            raise ValueError(
                f"reduce_rows: shapes around {base!r} must all agree "
                f"(out {out.shape}, {base}_1 {p1.shape}, {base}_2 {p2.shape})"
            )


# A pair graph whose fetch is one of these ops applied to exactly x_1 and
# x_2 is a monoid fold: one torch reduction over the rows folds a block.
_MONOID_REDUCTIONS = {
    "Add": lambda x: torch.sum(x, 0, dtype=x.dtype),
    "AddV2": lambda x: torch.sum(x, 0, dtype=x.dtype),
    "Mul": lambda x: torch.prod(x, 0, dtype=x.dtype),
    "Maximum": lambda x: torch.amax(x, 0),
    "Minimum": lambda x: torch.amin(x, 0),
}


def _monoid_reductions(graph: Graph, bases: List[str], summary: GraphSummary):
    """The reduction of each fetch when every fetch is a monoid fold
    (`_MONOID_REDUCTIONS`) of numbers, else None (the general plan)."""
    out = []
    for b in bases:
        node = graph[b]
        if node.op not in _MONOID_REDUCTIONS or summary.outputs[b].dtype is ScalarType.bool_:
            return None
        if sorted(node.data_inputs()) != [(b + "_1", 0), (b + "_2", 0)]:
            return None
        out.append(_MONOID_REDUCTIONS[node.op])
    return out


@torch.inference_mode()
def reduce_rows(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
):
    """Pairwise fold over all rows: ``x = f(x_1, x_2)`` with the carry in
    ``x_1`` and the next row in ``x_2``.

    Each block folds left in row order, then the block partials fold left
    in block order, as the reference folds (`DebugRowOps.scala:486-508`),
    so a non-associative graph gives the reference's result. Two plans:

    - the monoid plan, for a fetch that is Add/AddV2/Mul/Maximum/Minimum
      of exactly ``x_1`` and ``x_2``: one torch reduction per block (and
      one over the partials). Integer, min and max results are exact;
      float sums and products differ by summation order only;
    - the general plan, for any other pair graph: the lowered pair
      callable once per row, the carry kept on ``device``.
    """
    dev = resolve_device(device)
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, False, validate=_validate_reduce_rows
    )
    bases = [base_name(f) for f in fetch_list]
    for b in bases:
        c1, c2 = mapping[b + "_1"], mapping[b + "_2"]
        if c1 != c2:
            raise ValueError(
                f"reduce_rows: {b}_1 reads column {c1!r} but {b}_2 reads "
                f"{c2!r}; a fold's carry and next-row must come from the "
                "same column"
            )
    monoid = _monoid_reductions(graph, bases, summary)
    _count("reduce_rows.plan.monoid" if monoid else "reduce_rows.plan.general")
    if monoid is None:
        ex = executor or default_executor()
        pair = ex.callable_for(
            graph, fetch_list, [b + s for b in bases for s in ("_1", "_2")], dev
        )

    def fold(rows: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Left fold of the lead axis of each base's tensor."""
        if monoid is not None:
            return tuple(r(x) for r, x in zip(monoid, rows))
        carry = tuple(x[0] for x in rows)
        for i in range(1, len(rows[0])):
            carry = pair(*[v for c, x in zip(carry, rows) for v in (c, x[i])])
        return carry

    partials: List[Tuple[torch.Tensor, ...]] = []
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            continue
        rows = [as_tensor(frame.column(mapping[b + "_1"]).values[lo:hi], dev) for b in bases]
        # a single-row block's partial is its row
        partials.append(tuple(x[0] for x in rows) if hi - lo == 1 else fold(rows))
    if not partials:
        raise ValueError("reduce_rows on an empty frame")
    if len(partials) == 1:
        return _results(bases, partials[0])
    return _results(
        bases, fold([torch.stack([p[i] for p in partials]) for i in range(len(bases))])
    )


# ---------------------------------------------------------------------------
# aggregate (keyed)
# ---------------------------------------------------------------------------


class GroupedFrame:
    """`group_by(frame, *keys)`: the RelationalGroupedDataset analogue."""

    def __init__(self, frame: TensorFrame, keys: Sequence[str]):
        self.frame = frame
        self.keys = list(keys)
        for k in self.keys:
            if not frame.info[k].cell_shape.is_scalar:
                raise ValueError(f"group key {k!r} must be a scalar column")


def group_by(frame: TensorFrame, *keys: str) -> GroupedFrame:
    return GroupedFrame(frame, keys)


@torch.inference_mode()
def aggregate(
    fetches,
    grouped: GroupedFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
) -> TensorFrame:
    """Keyed aggregation with the `reduce_blocks` naming conventions: the
    key columns (distinct keys in sorted order), then one row per group of
    each output, all on ``device``.

    A graph `_chunk_combiners` classifies (a Sum/Min/Max/Prod/float Mean
    over axis 0 of a row-wise transform of its placeholder) takes the
    segment plan; any other graph the exact plan, whole groups through the
    graph (`DebugRowOps.aggregate`, `DebugRowOps.scala:554-599`).
    """
    dev = resolve_device(device)
    frame = grouped.frame
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, True, validate=_validate_reduce_blocks
    )
    ex = executor or default_executor()
    feed_names = sorted(summary.inputs)
    classified = _chunk_combiners(graph, fetch_list, summary)
    if frame.nrows > 0 and classified is not None:
        _count("aggregate.plan.segment")
        return _aggregate_segment(
            ex, graph, fetch_list, classified, feed_names, mapping, grouped, dev
        )
    _count("aggregate.plan.exact")
    return _aggregate_exact(
        ex, graph, fetch_list, summary, feed_names, mapping, grouped, dev
    )


# ---------------------------------------------------------------------------
# placeholders + schema
# ---------------------------------------------------------------------------


def block(frame: TensorFrame, col_name: str, tf_name: Optional[str] = None):
    """Block placeholder for a column (`tfs.block`)."""
    return dsl.block(frame, col_name, tf_name)


def row(frame: TensorFrame, col_name: str, tf_name: Optional[str] = None):
    """Row placeholder for a column (`tfs.row`)."""
    return dsl.row(frame, col_name, tf_name)


def analyze(frame: TensorFrame) -> TensorFrame:
    """Scan the data and refine column shapes (dense columns already know
    theirs)."""
    return frame.analyze()


def print_schema(frame: TensorFrame) -> None:
    frame.print_schema()
