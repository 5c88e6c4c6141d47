"""The five verbs: `map_blocks`, `map_rows`, `reduce_blocks`, `reduce_rows`
and `aggregate` (with `group_by`), plus `block`, `row`, `analyze`,
`append_shape`, `explain`, `explain_detailed`, `block_to_row` and the
fluent frame methods (``df.map_blocks(...)``, ``grouped.agg(...)``).

The PyTorch counterpart of `tensorframes_tpu/api.py`. A graph (DSL tensor,
`Graph`, GraphDef bytes or file path) is analyzed, its placeholders are
matched to columns (or to per-call ``bindings``), and a lowered callable
runs once per block on ``device`` (default: the CUDA card). Outputs stay on
that device as tensors; `Column.host_values` is the one way back to numpy.
Block-level verbs need dense columns; `map_rows` also runs over ragged
ones, one call per shape bucket. Bytes columns pass through a map as an
identity and are never computed on. A pandas DataFrame in gives a pandas
DataFrame out.

`map_blocks`, `map_rows` and `reduce_blocks` take ``timeout_s=``
(`runtime.deadline.deadline_entry`): the budget is checked before every
block and before the combine, and a top-level call takes an admission slot.
`reduce_blocks_stream` (`streaming.py`) folds an iterator of frames.

Not in the port yet: the mesh/scheduler/lazy/global routes, shape
bucketing (eager PyTorch has no per-shape compile to bound) and the chunked
aggregate plan.
"""

from __future__ import annotations

import functools
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
from .frame import Column, TensorFrame, _to_numpy, as_tensor
from .graph import builder as dsl
from .graph import vectorize as _vec
from .graph.analysis import GraphSummary, analyze_graph
from .graph.control_flow import functionalize
from .graph.freeze import freeze_variables
from .graph.ir import Graph, base_name
from .ops.lowering import build_callable
from .runtime import deadline as _dl
from .runtime.deadline import deadline_entry as _deadline_entry
from .runtime.executor import Executor, default_executor
from .schema import ColumnInfo, ScalarType, Shape
from .utils.profiling import count as _count

__all__ = [
    "map_blocks",
    "map_rows",
    "reduce_blocks",
    "reduce_blocks_stream",
    "reduce_rows",
    "aggregate",
    "group_by",
    "GroupedFrame",
    "block",
    "row",
    "analyze",
    "print_schema",
    "append_shape",
    "explain",
    "explain_detailed",
    "block_to_row",
]

Fetches = Union[dsl.Tensor, Sequence[dsl.Tensor], Graph, bytes, str]
Bindings = Optional[Dict[str, Union[np.ndarray, torch.Tensor]]]

# the ops of `GroupedFrame.agg` specs (`tensorframes_tpu/graph/plan.py:63`)
AGG_OPS = ("sum", "mean", "min", "max")


def _is_pandas(obj) -> bool:
    return type(obj).__module__.startswith("pandas")


def _pandas_in_out(verb):
    """A verb that takes a pandas DataFrame where it takes a frame and then
    returns one (the reference's local-debug path, `core.py:171-183`)."""

    @functools.wraps(verb)
    def wrapper(fetches, frame, *args, **kwargs):
        if not _is_pandas(frame):
            return verb(fetches, frame, *args, **kwargs)
        out = verb(fetches, TensorFrame.from_pandas(frame), *args, **kwargs)
        return out.to_pandas() if isinstance(out, TensorFrame) else out

    return wrapper


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
    graph, fetch_list, frame, feed_dict, block_level, bindings=None, validate=None
):
    """Analysis and placeholder -> column mapping of a graph `_as_graph`
    normalized. A verb's naming convention (``validate``) is checked before
    the columns are matched, so a misnamed placeholder is reported as
    such."""
    bindings = bindings if bindings is not None else {}
    overrides = _ph_overrides(graph, frame, feed_dict, block_level, bindings)
    summary = analyze_graph(graph, fetch_list, placeholder_shapes=overrides)
    _check_bindings(summary, bindings)
    if validate is not None:
        validate(summary, fetch_list)
    mapping = _match_columns(summary, frame, feed_dict, block_level, bindings)
    return summary, mapping


def _require_dense(frame: TensorFrame, cols: Sequence[str], verb: str) -> None:
    for c in cols:
        if not frame.column(c).is_dense:
            raise ValueError(
                f"{verb}: column {c!r} is ragged (rows have varying shapes); "
                "block-level ops need uniform cells — use map_rows, or fix "
                "the data"
            )


# ---------------------------------------------------------------------------
# bytes/string cells: identity pass-through (the reference's Binary scope)
# ---------------------------------------------------------------------------


def _split_string_passthrough(
    graph: Graph, fetch_list: List[str]
) -> Tuple[Graph, List[str], Dict[str, str]]:
    """Partition fetches into device fetches and bytes pass-throughs.

    The reference supports Binary cells at one scope: a single scalar cell
    carried through, never computed on (`datatypes.scala:577-581`). A fetch
    that is an Identity chain over a string placeholder becomes a host-side
    copy of the column; a fetch that computes on string data raises.
    Returns the device-only subgraph, the device fetches, and ``{fetch base
    -> string placeholder name}``."""
    str_phs = {
        ph.name for ph in graph.placeholders() if ph.dtype_attr is ScalarType.string
    }
    if not str_phs:
        return graph, fetch_list, {}
    passthrough: Dict[str, str] = {}
    device_fetches: List[str] = []
    for f in fetch_list:
        cur, ph = base_name(f), None
        while True:
            node = graph[cur]
            if node.op in ("Placeholder", "PlaceholderV2"):
                ph = node.name if node.name in str_phs else None
                break
            if node.op in ("Identity", "Snapshot", "StopGradient"):
                cur = node.data_inputs()[0][0]
                continue
            break
        if ph is not None:
            passthrough[base_name(f)] = ph
        else:
            device_fetches.append(f)
    if device_fetches:
        keep = {n.name for n in graph.toposort(device_fetches)}
        touched = keep & str_phs
        if touched:
            raise ValueError(
                f"fetches {sorted(base_name(f) for f in device_fetches)} compute "
                f"on bytes-column data (via {sorted(touched)}); bytes cells "
                "support identity pass-through only (the reference's "
                "one-scalar-cell Binary scope, datatypes.scala:577-581)"
            )
        dev_graph = Graph([n for n in graph.nodes if n.name in keep])
    else:
        dev_graph = Graph([])
    return dev_graph, device_fetches, passthrough


def _string_passthrough_columns(
    passthrough: Dict[str, str], frame: TensorFrame, feed_dict: Optional[Dict[str, str]]
) -> List[Column]:
    """Resolve and validate the bytes columns; each output column holds
    the input's row values, on the host."""
    feed_dict = feed_dict or {}
    cols = []
    for base, ph in passthrough.items():
        col_name = feed_dict.get(ph, _default_column(ph, frame))
        if col_name not in frame.info:
            raise ValueError(
                f"placeholder {ph!r} wants column {col_name!r} which is not "
                f"in the frame (columns: {frame.columns})"
            )
        info = frame.info[col_name]
        if info.dtype is not ScalarType.string:
            raise ValueError(
                f"placeholder {ph!r} is a bytes placeholder but column "
                f"{col_name!r} has dtype {info.dtype.name}"
            )
        if info.cell_shape.rank != 0:
            raise ValueError(
                f"bytes column {col_name!r} must hold one scalar cell per "
                "row (the reference's Binary scope, datatypes.scala:577-581)"
            )
        col = frame.column(col_name)
        if col.is_dense:  # a fixed-width numpy string array
            cols.append(Column(base, col.values.astype(object), ScalarType.string))
        else:  # string cells are never written to: share them
            cols.append(col.with_info(ColumnInfo(base, ScalarType.string, Shape(()))))
    return cols


def _with_string_passthrough(
    str_pass, frame, feed_dict, fetch_list, bindings, verb: str, run_graph
) -> TensorFrame:
    """The verb's output when some fetches are bytes pass-throughs: the
    device fetches through ``run_graph()`` (when any are left), the bytes
    columns copied on the host, then the input columns."""
    str_cols = _string_passthrough_columns(str_pass, frame, feed_dict)
    if fetch_list:
        out = run_graph()
        dev_cols = [out.column(base_name(f)) for f in fetch_list]
    else:
        if bindings:
            # no compute graph runs, so no placeholder can take a binding:
            # a misspelt key must not be dropped
            raise ValueError(
                f"{verb}: bindings {sorted(bindings)} match no placeholder "
                "(the graph is pure string pass-through)"
            )
        dev_cols = []
    return _output_frame(frame, dev_cols + str_cols, append_input=True)


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


@_pandas_in_out
@_deadline_entry("map_blocks")
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
    values on a later call reuse the same lowering. A fetch that is the
    identity of a bytes column copies that column on the host.
    """
    dev = resolve_device(device)
    bindings = _normalize_bindings(bindings)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_blocks_fn

        return _map_blocks_fn(fetches, frame, trim, dev, bindings)
    graph, fetch_list = _as_graph(fetches, fetch_names)
    graph, fetch_list, str_pass = _split_string_passthrough(graph, fetch_list)
    if str_pass:
        if trim:
            raise ValueError(
                "map_blocks(trim): bytes pass-through requires a row-preserving map"
            )
        return _with_string_passthrough(
            str_pass, frame, feed_dict, fetch_list, bindings, "map_blocks",
            lambda: _map_blocks_graph(
                graph, fetch_list, frame, feed_dict, False, executor, bindings, dev
            ),
        )
    return _map_blocks_graph(graph, fetch_list, frame, feed_dict, trim, executor, bindings, dev)


def _map_blocks_graph(graph, fetch_list, frame, feed_dict, trim, executor, bindings, dev):
    summary, mapping = _prepare(graph, fetch_list, frame, feed_dict, True, bindings)
    _require_dense(frame, list(mapping.values()), "map_blocks")
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
        _dl.check("map_blocks")
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


@_pandas_in_out
@_deadline_entry("map_rows")
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
    counted (``map_rows.plan.<plan>``). Over ragged columns the rows are
    grouped by cell shape and the plan runs once per group, whatever the
    blocks (``map_rows.plan.ragged``, ``map_rows.ragged.buckets``); an
    output whose groups agree on its cell shape is dense on ``device``,
    any other is ragged on the host. A fetch that is the identity of a
    bytes column copies that column on the host."""
    dev = resolve_device(device)
    bindings = _normalize_bindings(bindings)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_rows_fn

        return _map_rows_fn(fetches, frame, dev, bindings)
    graph, fetch_list = _as_graph(fetches, fetch_names)
    graph, fetch_list, str_pass = _split_string_passthrough(graph, fetch_list)
    if str_pass:
        return _with_string_passthrough(
            str_pass, frame, feed_dict, fetch_list, bindings, "map_rows",
            lambda: _map_rows_graph(graph, fetch_list, frame, feed_dict, executor, bindings, dev),
        )
    return _map_rows_graph(graph, fetch_list, frame, feed_dict, executor, bindings, dev)


def _map_rows_graph(graph, fetch_list, frame, feed_dict, executor, bindings, dev):
    summary, mapping = _prepare(graph, fetch_list, frame, feed_dict, False, bindings)
    feed_names = sorted(summary.inputs)
    dense = all(frame.column(c).is_dense for c in mapping.values())
    if bindings and not dense:
        raise ValueError(
            "map_rows: bindings are not supported with ragged feed "
            "columns; densify the columns or bake the values as constants"
        )
    if bindings and not mapping:
        raise ValueError(
            "map_rows: every placeholder is bound, so nothing varies per "
            "row; use map_blocks (or run the graph once and broadcast)"
        )
    ex = executor or default_executor()
    run_block = _row_plan(ex, graph, fetch_list, feed_names, summary, bindings, dev)
    out_names = [base_name(f) for f in fetch_list]
    if not dense:
        from .fn_frontend import _run_ragged_bucketed

        per_out = _run_ragged_bucketed(
            run_block, [frame.column(mapping[n]) for n in feed_names], frame.nrows, dev,
            out_names,
        )
        out_cols = [
            per_out[n] if n in per_out else Column(n, _empty_output(summary, n, False, dev))
            for n in out_names
        ]
        return _output_frame(frame, out_cols, append_input=True)
    bound = _bound_tensors(bindings, dev)
    acc: Dict[str, List[torch.Tensor]] = {n: [] for n in out_names}
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            continue
        _dl.check("map_rows")
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


def _stack_parts(parts: List) -> Union[np.ndarray, torch.Tensor]:
    """Stack partials: on the device of the first tensor among them when
    any is a tensor (host partials, spilled or restored from a checkpoint,
    move there), else with host numpy."""
    dev = next((p.device for p in parts if isinstance(p, torch.Tensor)), None)
    if dev is None:
        return np.stack([np.asarray(p) for p in parts])
    return torch.stack([as_tensor(p, dev) for p in parts])


def _results(bases: List[str], values):
    """One tensor for one fetch, a dict of tensors for several."""
    return values[0] if len(bases) == 1 else dict(zip(bases, values))


@_pandas_in_out
@_deadline_entry("reduce_blocks")
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
    graph, fetch_list = _as_graph(fetches, fetch_names)
    summary, mapping = _prepare(
        graph, fetch_list, frame, feed_dict, True, validate=_validate_reduce_blocks
    )
    _require_dense(frame, list(mapping.values()), "reduce_blocks")
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
        _dl.check("reduce_blocks")
        partials.append(fn(*_feeds(frame, mapping, feed_names, lo, hi, dev)))
    if not partials:
        raise ValueError("reduce_blocks on an empty frame")
    # a verb whose budget ran out during the blocks must not start the
    # combine
    _dl.check("reduce_blocks")
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


@_pandas_in_out
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
    graph, fetch_list = _as_graph(fetches, fetch_names)
    summary, mapping = _prepare(
        graph, fetch_list, frame, feed_dict, False, validate=_validate_reduce_rows
    )
    _require_dense(frame, list(mapping.values()), "reduce_rows")
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
    """`group_by(frame, *keys)`: the RelationalGroupedDataset analogue. Any
    scalar column is a key: numbers factorize on the verb's device, strings
    and other objects on the host (the reference grouped by any Catalyst
    column type)."""

    def __init__(self, frame: TensorFrame, keys: Sequence[str]):
        self.frame = frame
        self.keys = list(keys)
        for k in self.keys:
            if not frame.info[k].cell_shape.is_scalar:
                raise ValueError(f"group key {k!r} must be a scalar column")

    def aggregate(self, fetches, **kw) -> TensorFrame:
        return aggregate(fetches, self, **kw)

    def agg(self, device: DeviceLike = None, **specs) -> TensorFrame:
        """Keyed aggregation from ``out=('op', column)`` specs, ops among
        `AGG_OPS`: each lowers to a reduce over axis 0 of its column."""
        fetches, feed = _agg_spec_exprs(self.frame, specs)
        return aggregate(fetches, self, feed_dict=feed, device=device)


def group_by(frame: TensorFrame, *keys: str) -> GroupedFrame:
    return GroupedFrame(frame, keys)


def _agg_spec_exprs(frame: TensorFrame, specs: Dict[str, Tuple[str, str]]):
    """``out=(op, column)`` specs as the DSL reduce fetches and the
    feed_dict `aggregate` takes."""
    fetches = []
    feed: Dict[str, str] = {}
    for out, spec in sorted(specs.items()):
        if (
            not isinstance(spec, (tuple, list)) or len(spec) != 2
            or not all(isinstance(s, str) for s in spec)
        ):
            raise TypeError(f"agg spec {out}={spec!r}: want a ('op', 'column') pair")
        op, colname = spec
        if op not in AGG_OPS:
            raise ValueError(f"agg op {op!r} is not one of {list(AGG_OPS)}")
        ph = dsl.block(frame, colname, tf_name=f"{out}_input")
        fetches.append(getattr(dsl, f"reduce_{op}")(ph, axes=[0]).named(out))
        feed[f"{out}_input"] = colname
    return fetches, feed


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
    graph (`DebugRowOps.aggregate`, `DebugRowOps.scala:554-599`). A string
    key's column comes back as host strings.
    """
    dev = resolve_device(device)
    frame = grouped.frame
    graph, fetch_list = _as_graph(fetches, fetch_names)
    summary, mapping = _prepare(
        graph, fetch_list, frame, feed_dict, True, validate=_validate_reduce_blocks
    )
    _require_dense(frame, list(mapping.values()), "aggregate")
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
    """Block placeholder for a column (`tfs.block`); takes a pandas
    DataFrame too."""
    if _is_pandas(frame):
        frame = TensorFrame.from_pandas(frame)
    return dsl.block(frame, col_name, tf_name)


def row(frame: TensorFrame, col_name: str, tf_name: Optional[str] = None):
    """Row placeholder for a column (`tfs.row`); takes a pandas DataFrame
    too."""
    if _is_pandas(frame):
        frame = TensorFrame.from_pandas(frame)
    return dsl.row(frame, col_name, tf_name)


def analyze(frame: TensorFrame) -> TensorFrame:
    """Scan the data and refine column shapes (`ExperimentalOperations.analyze`)."""
    return frame.analyze()


def print_schema(frame: TensorFrame) -> None:
    frame.print_schema()


def append_shape(frame: TensorFrame, col: str, shape) -> TensorFrame:
    """`tfs.append_shape` (`ExperimentalOperations.scala:53-68`)."""
    return frame.append_shape(col, shape if isinstance(shape, Shape) else Shape(shape))


def explain(frame: TensorFrame) -> str:
    """The frame's schema as text (`DebugRowOps.scala:535-552`)."""
    return frame.info.explain()


def explain_detailed(frame: TensorFrame):
    """The frame's per-column metadata, the `FrameInfo` itself
    (`ExperimentalOperations.scala:27`)."""
    return frame.info


def block_to_row(frame: TensorFrame) -> TensorFrame:
    """Each block as one row: every column's rank grows by one, its new
    lead dim the block's row count. Blocks of unequal size give a ragged
    column. The cells are host arrays."""
    cells: Dict[str, list] = {name: [] for name in frame.columns}
    for blk in frame.blocks():
        for name in frame.columns:
            col = blk[name]
            if not col.is_dense:
                raise ValueError(
                    f"block_to_row: column {name!r} is ragged; analyze/pad first"
                )
            values = col.values
            cells[name].append(_to_numpy(values) if isinstance(values, torch.Tensor) else values)
    return TensorFrame([Column(n, cells[n], frame[n].dtype) for n in frame.columns])


# ---------------------------------------------------------------------------
# fluent methods (the reference's Scala implicits: ``df.mapBlocks(...)``,
# ``grouped.aggregate(...)``, `dsl/Implicits.scala:25-124`)
# ---------------------------------------------------------------------------


def _install_fluent_methods() -> None:
    slice_block = TensorFrame.block

    def _block(self, arg, tf_name=None):
        # df.block(i) slices block i; df.block("col") is a placeholder
        return dsl.block(self, arg, tf_name) if isinstance(arg, str) else slice_block(self, arg)

    TensorFrame.map_blocks = lambda self, fetches, **kw: map_blocks(fetches, self, **kw)
    TensorFrame.map_rows = lambda self, fetches, **kw: map_rows(fetches, self, **kw)
    TensorFrame.reduce_blocks = lambda self, fetches, **kw: reduce_blocks(fetches, self, **kw)
    TensorFrame.reduce_rows = lambda self, fetches, **kw: reduce_rows(fetches, self, **kw)
    TensorFrame.group_by = lambda self, *keys: GroupedFrame(self, keys)
    TensorFrame.block = _block
    TensorFrame.row = lambda self, col, tf_name=None: dsl.row(self, col, tf_name)


_install_fluent_methods()


from .streaming import reduce_blocks_stream  # noqa: E402  (streaming imports api)
