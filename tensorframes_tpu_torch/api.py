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
`reduce_blocks_stream` (`streaming.py`) folds an iterator of frames. Every
verb call is one ``verb`` span with its input's rows
(`utils.profiling.verb_entry`).

Every block dispatch runs inside a ``dispatch`` span labeled with its
program fingerprint (`utils.telemetry.dispatch_span`) and through a
`runtime.faults.FaultScope`: a transient error is retried with backoff,
and a block that runs out of memory is split in half (up to
``config.oom_split_depth`` times) — a row-local map concatenates the
halves, a classified monoid reduce (`aggregate._chunk_combiners`) combines
them, anything else re-raises the original error. With
``config.check_numerics`` on, every block's outputs are checked for NaN
and Inf (`runtime.faults.maybe_check_numerics`).

On a `LazyFrame` (`lazy.py`), or on a plain frame under ``with
tft.lazy():`` for graph fetches without ``trim``, ``bindings`` or bytes
placeholders, `map_blocks` defers; `reduce_blocks` fuses the pending chain
with the reduce; `map_rows`, `reduce_rows` and `aggregate` force the plan
first. `scan` opens a dataset as a relational plan (`RelationalFrame`).

Placement (`_Place`): a verb's items are row ranges, each on a device.
Without ``mesh=`` the items are the frame's blocks: on ``device`` when it
is given, else spread over the cards by the block scheduler
(`runtime.scheduler`: ``devices=``, or ``config.block_scheduler``, whose
default "auto" spreads over two or more cards) or on the one card. With
``mesh=`` (`parallel.data_mesh()`: every visible card; an explicit device
list, ``data_mesh(devices=["cpu"] * 8)``, on the CPU) the items are JAX's
shard bounds, shard i on mesh device i and the remainder on the first
(`parallel.verbs`). One block loop serves every placement; results
converge on the anchor (the one device, slot 0, the mesh's first device).
``mesh=``, ``devices=`` and ``device=`` exclude each other (``ValueError``).
A `GlobalFrame` (`TensorFrame.to_global`) runs its verbs on its shards
(`globalframe`), and ``block_scheduler="global"`` routes eligible verbs on
large plain frames there.

Not in the port: shape bucketing, on purpose (eager PyTorch has no
per-shape compile to bound).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .aggregate import (
    _aggregate_segment,
    _aggregate_sorted,
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
from .runtime import faults as _flt
from .runtime.deadline import deadline_entry as _deadline_entry
from .runtime.executor import Executor, default_executor
from .runtime.faults import maybe_check_numerics
from .schema import ColumnInfo, ScalarType, Shape
from .utils import telemetry as _tele
from .utils.profiling import count as _count
from .utils.profiling import verb_entry as _verb_entry

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
    "scan",
]

Fetches = Union[dsl.Tensor, Sequence[dsl.Tensor], Graph, bytes, str]
Bindings = Optional[Dict[str, Union[np.ndarray, torch.Tensor]]]

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
        from .lazy import LazyFrame

        if isinstance(out, LazyFrame):
            # pandas in -> pandas out is the eager path: a lazy() mode
            # around it must not hand a deferred plan to a pandas caller
            out = out.force()
        return out.to_pandas() if isinstance(out, TensorFrame) else out

    return wrapper


def _spanning_in_out(verb):
    """A verb that takes a `parallel.multihost.SpanningFrame` (rows in
    several processes) where it takes a frame: it runs over this process's
    rows with the frame's mesh (`multihost.run_verb`)."""

    @functools.wraps(verb)
    def wrapper(fetches, frame, *args, **kwargs):
        if not getattr(frame, "_spanning", False):
            return verb(fetches, frame, *args, **kwargs)
        from .parallel import multihost as _mh

        return _mh.run_verb(verb, fetches, frame, args, kwargs)

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


def _check_mesh_args(verb: str, mesh, device, devices=None) -> None:
    """``mesh=``, ``devices=`` and ``device=`` each place the call; two
    together raise."""
    if mesh is not None and device is not None:
        raise ValueError(
            f"{verb}: pass mesh= or device=, not both; a mesh places each "
            "shard on its own device"
        )
    if devices is not None and mesh is not None:
        raise ValueError(
            "devices= and mesh= are mutually exclusive; the mesh owns "
            "block placement"
        )
    if devices is not None and device is not None:
        raise ValueError(
            f"{verb}: pass devices= or device=, not both; device= pins one "
            "device, devices= lets the block scheduler place the blocks"
        )


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


def _feed_source(frame, mapping, feed_names, bindings=None):
    """``feeds_for(lo, hi, dev)``: `_feeds` of this call's frame and
    columns on ``dev``, the bindings copied to each device once (looked up
    at call time, so a replaced `_feeds` takes effect)."""
    if not bindings:
        return lambda lo, hi, dev: _feeds(frame, mapping, feed_names, lo, hi, dev)
    bound = _per_device(lambda d: _bound_tensors(bindings, d))
    return lambda lo, hi, dev: _feeds(frame, mapping, feed_names, lo, hi, dev, bound(dev))


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
# block dispatch: spans, classified retries, OOM splits
# ---------------------------------------------------------------------------


def _concat_halves(left, right, n_left, n_right):
    """Split-combine of a row-local map: the halves' outputs, concatenated."""
    return tuple(torch.cat([a, b]) for a, b in zip(left, right))


_UNSET = object()


class _Split:
    """An OOM split recipe — ``merge(left, right, n_left, n_right)`` or
    None (the block cannot split) — resolved at the first resource fault:
    the row-local walk behind it costs a graph walk, and its control-flow
    checks count fallback reasons, so the clean path never runs it."""

    __slots__ = ("_resolve", "_merge")

    def __init__(self, resolve):
        self._resolve = resolve
        self._merge = _UNSET

    def merge(self):
        if self._merge is _UNSET:
            self._merge = self._resolve()
        return self._merge


_CONCAT = _Split(lambda: _concat_halves)


def _rowwise_split(graph, fetches, ph_ranks) -> _Split:
    """Concatenate the halves when every fetch is a row-local function of
    the placeholders (`aggregate._rowwise_transform`)."""
    return _Split(
        lambda: _concat_halves
        if _rowwise_transform(graph, list(fetches), ph_ranks.get)
        else None
    )


def _reduce_split(graph, fetch_list, summary) -> _Split:
    """Combine the halves' partials by `faults.combine_split_partials` over
    `aggregate._chunk_combiners`' tags in fetch order, when the reduce
    graph classifies."""

    def resolve():
        classified = _chunk_combiners(graph, fetch_list, summary)
        if classified is None:
            return None
        tags = [classified[base_name(f)] for f in fetch_list]
        return lambda left, right, nl, nr: _flt.combine_split_partials(
            tags, left, right, nl, nr
        )

    return _Split(resolve)


def _dispatch_rows(
    verb, span_name, fp, run, feeds_for, fscope, bi, lo, hi, place,
    split=None, refuse="not-row-local", forensics=True, depth=0,
):
    """Dispatch rows ``[lo, hi)`` of item ``bi``: ``run(feeds_for(lo, hi,
    dev), hi - lo, bi)`` inside a dispatch span, through ``fscope``
    (transient errors retry with backoff; under a block schedule the
    failed item's device is evicted first). The item's device ``dev`` and
    its feeds are taken inside each attempt, so a retry after an eviction
    runs where the schedule re-placed the item. A ``resource`` error
    splits the range in half and merges the halves by the `_Split` recipe
    ``split``; without a recipe it re-raises, its forensic snapshot naming
    ``refuse``. Returns the outputs as a tuple.

    The split runs after the ``except`` clause has ended: a CUDA
    out-of-memory error's traceback holds the failed attempt's frames,
    and their tensors would make the halves run out of memory too."""
    sched = place.sched

    def thunk():
        dev = place.device(bi)
        feeds = feeds_for(lo, hi, dev)
        if sched is None:
            with _tele.dispatch_span(
                span_name, program=fp, block=bi, rows=hi - lo, torch_device=dev
            ):
                return run(feeds, hi - lo, bi)
        with _tele.dispatch_span(
            span_name, program=fp, block=bi, rows=hi - lo, torch_device=dev,
            device=sched.label(bi),
        ):
            return sched.bind(bi, lambda *f: run(f, hi - lo, bi))(*feeds)

    try:
        return tuple(fscope.dispatch(
            thunk, what=f"{verb} block {bi} rows [{lo}:{hi})", sched=sched, index=bi,
        ))
    except Exception as e:
        if _flt.classify(e) != _flt.RESOURCE:
            raise
        combine = split.merge() if split is not None else None
        if combine is None or not _flt.split_allowed(hi - lo, depth):
            if forensics:
                why = refuse if combine is None else "split-depth-exhausted"
                _flt.record_oom(verb, fp, hi - lo, depth, f"reraise:{why}", e)
            raise
        mid = (lo + hi) // 2
        if forensics:
            _flt.record_oom(verb, fp, hi - lo, depth, f"split:[{lo}:{mid})+[{mid}:{hi})", e)
        _flt.note_split(verb)
    del thunk
    left = _dispatch_rows(
        verb, span_name, fp, run, feeds_for, fscope, bi, lo, mid, place,
        split, refuse, forensics, depth + 1,
    )
    right = _dispatch_rows(
        verb, span_name, fp, run, feeds_for, fscope, bi, mid, hi, place,
        split, refuse, forensics, depth + 1,
    )
    return combine(left, right, mid - lo, hi - mid)


# ---------------------------------------------------------------------------
# placement: one block loop for one device, a block schedule and a mesh
# ---------------------------------------------------------------------------


def _shards(nrows: int, ndev: int) -> Tuple[int, List[Tuple[int, int]], Tuple[int, int]]:
    """``(s, shard row ranges, tail row range)``: JAX's mesh layout,
    ``ndev`` shards of ``nrows // ndev`` rows, then the remainder."""
    s = nrows // ndev
    return s, [(d * s, (d + 1) * s) for d in range(ndev)], (s * ndev, nrows)


def _block_items(frame) -> List[Tuple[int, int, int]]:
    """``(block, lo, hi)`` of every non-empty block: an empty one
    contributes nothing, and a reduce's identity would poison the
    combine."""
    off = frame.offsets
    return [(bi, off[bi], off[bi + 1]) for bi in range(len(off) - 1) if off[bi] != off[bi + 1]]


class _Place:
    """Where one verb call's items run. ``items`` are ``(i, lo, hi)`` row
    ranges in dispatch order, item ``i`` on `device(i)`:

    - one device: the frame's non-empty blocks (``i`` the block index),
      all on ``anchor``;
    - a block schedule (``sched``, `runtime.scheduler.BlockSchedule`): the
      same blocks, block ``i`` on the device the schedule holds for it
      when it dispatches (a failover re-places it);
    - a mesh (``mesh``): JAX's shard bounds (`_shards`), shard ``i`` on
      mesh device ``i``, then the remainder (item ``ndev``) on the first
      device; the shards dispatch together (`_mesh_loop`). A
      `GlobalFrame`'s resident shards are such a placement with no
      remainder (`globalframe._shard_loop`).

    Results converge on ``anchor``: the one device, schedule slot 0, the
    mesh's first device."""

    __slots__ = ("items", "anchor", "sched", "mesh", "devs")

    def __init__(self, items, anchor, sched=None, mesh=None, devs=None):
        self.items = items
        self.anchor = anchor
        self.sched = sched
        self.mesh = mesh
        if devs is None:
            devs = list(sched.devices) if sched is not None else [anchor]
        self.devs = devs

    @property
    def spread(self) -> bool:
        """True when items may lie on more than one device."""
        return self.sched is not None or self.mesh is not None

    def device(self, i: int) -> torch.device:
        if self.sched is not None:
            d = self.sched.device(i)
            return self.anchor if d is None else d  # unplaced: weighs nothing
        if self.mesh is not None and i < len(self.devs):
            return self.devs[i]
        return self.anchor

    def is_shard(self, i: int) -> bool:
        return self.mesh is not None and i < len(self.devs)

    def gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Concatenate item outputs on the anchor."""
        if not self.spread:
            return _concat(parts)
        return _concat([as_tensor(p, self.anchor) for p in parts])


def _place(frame, device, devices, mesh, ex, weights=None) -> _Place:
    """The placement of one verb call (see `_Place`): the mesh's shards,
    the one ``device`` given, a block schedule (`scheduler.schedule_weights`
    over ``weights``, by default the block sizes), or the one card. A
    mesh over several processes, or a `SpanningFrame`'s rows, place this
    process's shards (`parallel.multihost.local_place`)."""
    if mesh is not None:
        if mesh.process_count > 1 or getattr(frame, "_span_mesh", None) is not None:
            from .parallel import multihost as _mh

            return _mh.local_place(frame, mesh)
        devs = mesh.device_list()
        _, ranges, (tlo, thi) = _shards(frame.nrows, len(devs))
        items = [(d, lo, hi) for d, (lo, hi) in enumerate(ranges) if hi > lo]
        if thi > tlo:
            items.append((len(devs), tlo, thi))
        return _Place(items, devs[0], mesh=mesh, devs=devs)
    items = _block_items(frame)
    if device is None:
        from .runtime import scheduler as _rs

        sched = _rs.schedule_weights(
            frame.block_sizes() if weights is None else weights,
            devices=devices, executor=ex,
        )
        if sched is not None:
            return _Place(items, sched.anchor_device(), sched=sched)
    return _Place(items, resolve_device(device))


def _programs(place: _Place, make, mesh_make=None):
    """``prog(i)``: the program of item ``i``, ``make(dev)`` for its
    device (``mesh_make(dev)`` for a mesh shard), built once a device."""
    memo: Dict = {}
    mesh_make = mesh_make or make

    def prog(i):
        dev = place.device(i)
        key = (dev, place.is_shard(i))
        fn = memo.get(key)
        if fn is None:
            fn = memo[key] = (mesh_make if key[1] else make)(dev)
        return fn

    return prog


def _per_device(make):
    """``get(dev)``: ``make(dev)`` once a device (bound tensors, feeds)."""
    memo: Dict = {}

    def get(dev):
        v = memo.get(dev)
        if v is None:
            v = memo[dev] = make(dev)
        return v

    return get


def _loop(
    place: _Place, verb: str, span_name: str, fp, run, feeds_for, check,
    fscope=None, split=None, refuse="not-row-local", forensics=True,
    what: Optional[str] = None, mesh_name: Optional[str] = None,
    mesh_label: str = "mesh", mesh_attrs: Optional[Dict] = None,
) -> List[Tuple]:
    """THE block loop of every verb: each item's outputs, in item order.

    ``run(feeds, rows, i)`` computes item ``i`` from ``feeds_for(lo, hi,
    dev)``; ``check(outs, what)`` vets each item's outputs (numerics,
    shapes). With a fault scope each item dispatches through
    `_dispatch_rows` (span, retries, failover, OOM splits) in one
    `telemetry.dispatch_run`; without one (the function front end) it is
    called as it is, in a ``<verb>.block`` dispatch span of one run (no
    retry, no split). A mesh dispatches its shards together (`_mesh_loop`;
    ``mesh_label`` names the shards in messages, ``mesh_attrs`` adds to
    the dispatch span)."""
    what = what or verb
    if place.mesh is not None:
        return _mesh_loop(
            place, mesh_name or f"mesh.{verb}", fp, run, feeds_for, check, what,
            mesh_label, mesh_attrs,
        )
    out = []
    if fscope is None:
        # no executor launches here: the block's timing starts at the call
        name = span_name or f"{verb}.block"
        with _tele.dispatch_run(place.anchor):
            for i, lo, hi in place.items:
                _dl.check(verb)
                dev = place.device(i)
                with _tele.dispatch_span(name, block=i, rows=hi - lo, torch_device=dev):
                    feeds = feeds_for(lo, hi, dev)
                    if place.sched is not None:
                        feeds = place.sched.put(i, feeds)
                    _tele.launching()
                    outs = run(feeds, hi - lo, i)
                check(outs, f"{what} block {i}")
                out.append(outs)
        return out
    with _tele.dispatch_run(place.anchor):
        for i, lo, hi in place.items:
            _dl.check(verb)
            outs = _dispatch_rows(
                verb, span_name, fp, run, feeds_for, fscope, i, lo, hi, place,
                split=split, refuse=refuse, forensics=forensics,
            )
            check(outs, f"{what} block {i}")
            out.append(outs)
    return out


def _mesh_loop(
    place: _Place, name: str, fp, run, feeds_for, check, what: str, label: str = "mesh",
    attrs: Optional[Dict] = None,
) -> List[Tuple]:
    """A mesh's items: every shard issued in one ``name`` dispatch
    (`parallel.verbs._mesh_call`: a ``verb`` span, a dispatch span with
    ``shards=`` and ``attrs`` — whose ``rows``, when given, replaces the
    items' row count —, transient retries), then the remainder in
    ``name.tail`` on the first device."""
    from .parallel.verbs import _mesh_call

    ndev = len(place.devs)
    shards = [it for it in place.items if it[0] < ndev]
    attrs = dict(attrs or {})
    rows = attrs.pop("rows", sum(hi - lo for _, lo, hi in shards))
    out = []
    if shards:
        res = _mesh_call(
            name, fp, rows, ndev,
            lambda: [run(feeds_for(lo, hi, place.devs[d]), hi - lo, d) for d, lo, hi in shards],
            place.anchor, **attrs,
        )
        for (d, _, _), outs in zip(shards, res):
            check(outs, f"{what} ({label} shard {d})")
            out.append(outs)
    for i, lo, hi in place.items[len(shards):]:
        outs = _mesh_call(
            name + ".tail", fp, hi - lo, 1,
            lambda: run(feeds_for(lo, hi, place.anchor), hi - lo, i), place.anchor,
        )
        check(outs, f"{what} ({label} tail)")
        out.append(outs)
    return out


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------


@_pandas_in_out
@_spanning_in_out
@_deadline_entry("map_blocks")
@torch.no_grad()
def map_blocks(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    trim: bool = False,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    bindings: Bindings = None,
    device: DeviceLike = None,
    mesh=None,
    devices=None,
) -> TensorFrame:
    """Apply a graph, or a plain function of columns returning a dict of
    named outputs, to each block: on ``device``, spread over the cards by
    the block scheduler (``devices=``, or ``config.block_scheduler``), or
    with ``mesh=`` one shard a device of the mesh (see `_Place`).

    Without ``trim`` every output keeps the block's row count and the
    input columns ride along; with ``trim=True`` the row count may change
    and the input columns are dropped. ``bindings`` feeds named
    placeholders (or function parameters) one array for every block; new
    values on a later call reuse the same lowering. A fetch that is the
    identity of a bytes column copies that column on the host.

    On a `LazyFrame` — or on a plain frame under ``with tft.lazy():`` with
    graph fetches (function, ``trim`` and ``bindings`` calls and bytes
    placeholders stay eager: they cannot be spliced) — the verb DEFERS: it
    returns a `LazyFrame` carrying the chain as one pending fused graph.
    On a `GlobalFrame` it runs on the frame's shards (`globalframe`).
    """
    from . import globalframe as _gf
    from .lazy import LazyFrame, lazy_active

    if isinstance(frame, _gf.GlobalFrame):
        return _gf.map_blocks_global(
            fetches, frame, feed_dict=feed_dict, trim=trim, fetch_names=fetch_names,
            executor=executor, mesh=mesh, bindings=bindings, devices=devices, device=device,
        )
    _check_mesh_args("map_blocks", mesh, device, devices)
    if isinstance(frame, LazyFrame):
        return frame.map_blocks(
            fetches, feed_dict=feed_dict, trim=trim, fetch_names=fetch_names,
            executor=executor, bindings=bindings, device=device, mesh=mesh,
            devices=devices,
        )
    if (
        lazy_active()
        and isinstance(frame, TensorFrame)
        and not trim
        and not bindings
        and not (callable(fetches) and not isinstance(fetches, dsl.Tensor))
    ):
        lazy_graph, lazy_fetches = _as_graph(fetches, fetch_names)
        if not any(
            ph.dtype_attr is ScalarType.string for ph in lazy_graph.placeholders()
        ):
            # _fuse_stage directly: the graph is already normalized
            return LazyFrame(
                frame, executor=executor, device=device, mesh=mesh, devices=devices
            )._fuse_stage("map_blocks", lazy_graph, lazy_fetches, feed_dict)
        # bytes pass-through cannot splice: stays eager under the mode
    bindings = _normalize_bindings(bindings)
    ex = executor or default_executor()
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_blocks_fn

        return _map_blocks_fn(
            fetches, frame, trim, bindings, lambda: _place(frame, device, devices, mesh, ex)
        )
    graph, fetch_list = _as_graph(fetches, fetch_names)
    graph, fetch_list, str_pass = _split_string_passthrough(graph, fetch_list)

    def run_graph(trim):
        if not trim and not bindings and mesh is None and device is None:
            # block_scheduler="global": row-local graphs on a large frame
            # run on its shards, one call a card
            routed = _gf.maybe_map_blocks(graph, fetch_list, frame, feed_dict, ex, devices)
            if routed is not _gf.SKIP:
                return routed
        return _map_blocks_graph(
            graph, fetch_list, frame, feed_dict, trim, ex, bindings,
            lambda: _place(frame, device, devices, mesh, ex),
        )

    if str_pass:
        # bytes columns ride on the host in every topology
        if trim:
            raise ValueError(
                "map_blocks(trim): bytes pass-through requires a row-preserving map"
            )
        return _with_string_passthrough(
            str_pass, frame, feed_dict, fetch_list, bindings, "map_blocks",
            lambda: run_graph(False),
        )
    return run_graph(trim)


def _map_blocks_graph(graph, fetch_list, frame, feed_dict, trim, ex, bindings, placement):
    summary, mapping = _prepare(graph, fetch_list, frame, feed_dict, True, bindings)
    _require_dense(frame, list(mapping.values()), "map_blocks")
    place = placement()
    feed_names = sorted(summary.inputs)
    mesh_make = None
    if place.mesh is not None:
        from .parallel.verbs import _mesh_sig

        kind = f"shmap-{_mesh_sig(place.mesh)}"
        mesh_make = lambda d: ex.cached(  # noqa: E731
            kind, graph, fetch_list, feed_names, d,
            lambda dd: build_callable(graph, fetch_list, feed_names, dd),
        )
    prog = _programs(
        place, lambda d: ex.callable_for(graph, fetch_list, feed_names, d), mesh_make
    )
    # a row-local graph's block may split on OOM (halves concatenate)
    split = None
    if not trim and not bindings:
        split = _rowwise_split(
            graph, fetch_list, {p: ph.shape.rank for p, ph in summary.inputs.items()}
        )
    bases = [base_name(f) for f in fetch_list]
    out_sizes: Dict[int, int] = {}

    def check(outs, what):
        maybe_check_numerics(fetch_list, outs, what)

    parts = _loop(
        place, "map_blocks", "map_blocks.block", graph.fingerprint(),
        lambda feeds, rows, i: prog(i)(*feeds),
        _feed_source(frame, mapping, feed_names, bindings), check,
        fscope=_flt.scope("map_blocks"), split=split,
    )
    for (i, lo, hi), outs in zip(place.items, parts):
        out_sizes[i] = _block_rows(dict(zip(bases, outs)), hi - lo, trim)
    out_cols = [
        Column(
            b,
            place.gather([p[j] for p in parts]) if parts
            else _empty_output(summary, b, True, place.anchor),
        )
        for j, b in enumerate(bases)
    ]
    return _output_frame(
        frame, out_cols, append_input=not trim,
        offsets=_trim_offsets(frame, place, out_sizes) if trim else frame.offsets,
    )


def _trim_offsets(frame, place: _Place, sizes: Dict[int, int]) -> List[int]:
    """A trimmed map's block offsets: a block (or a mesh item) a block of
    its output rows, an empty block an empty one."""
    if place.mesh is not None:
        return list(np.cumsum([0] + [sizes[i] for i, _, _ in place.items]))
    return list(np.cumsum([0] + [sizes.get(bi, 0) for bi in range(frame.num_blocks)]))


# ---------------------------------------------------------------------------
# map_rows
# ---------------------------------------------------------------------------


def _row_plan_kind(graph, fetch_list, feed_names, summary, bindings) -> str:
    """`map_rows`' plan for this graph (see `map_rows`): ``vmap``,
    ``lifted`` or ``per_row``; a fallback's reason is counted."""
    if not any(n.op in _vec.CONTROL_OPS for n in graph.toposort(fetch_list)):
        return "vmap"
    if not _vec.enabled():
        _vec.note_fallback("disabled", probe=False)
        return "per_row"
    block_rank = {n: summary.inputs[n].shape.rank + 1 for n in feed_names}
    if not bindings and _rowwise_transform(graph, fetch_list, block_rank.get):
        return "lifted"
    return "vmap"


def _row_runner(plan, ex, graph, fetch_list, feed_names, summary, bindings, dev, prefix=""):
    """``run(feeds, rows)`` of ``plan`` on ``dev``: one block's outputs,
    each with the row axis. ``prefix`` namespaces the executor cache kinds
    (a mesh's shard programs)."""
    if plan == "lifted":
        fn = ex.cached(
            prefix + "lifted-rows", graph, fetch_list, feed_names, dev,
            lambda d: build_callable(
                _vec.lift_to_block_level(graph.clone()), fetch_list, feed_names, d,
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
    if plan == "vmap":
        # bound placeholders whole (in_dims None)
        in_dims = tuple(None if n in bindings else 0 for n in feed_names)
        kind = f"vmap-rows-[{','.join(sorted(bindings))}]" if bindings else "vmap-rows"
        vfn = ex.cached(
            prefix + kind, graph, fetch_list, feed_names, dev,
            lambda d: torch.func.vmap(
                build_callable(graph, fetch_list, feed_names, d), in_dims=in_dims
            ),
        )
        return lambda feeds, rows: vfn(*feeds)
    # per_row: the callable once a row, bound placeholders whole
    fn = ex.cached(
        prefix + "block", graph, fetch_list, feed_names, dev,
        lambda d: build_callable(graph, list(fetch_list), list(feed_names), d),
    )
    per_row = [n not in bindings for n in feed_names]

    def rows_one_by_one(feeds, rows):
        outs = [
            fn(*[f[i] if r else f for f, r in zip(feeds, per_row)]) for i in range(rows)
        ]
        return tuple(torch.stack(col) for col in zip(*outs))

    return rows_one_by_one


@_pandas_in_out
@_spanning_in_out
@_deadline_entry("map_rows")
@torch.no_grad()
def map_rows(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    bindings: Bindings = None,
    device: DeviceLike = None,
    mesh=None,
    devices=None,
) -> TensorFrame:
    """Apply a per-row graph, or a plain function of row cells returning
    a dict of named outputs, to every row, one call per block (the
    reference ran one session per row). Three plans:

    - ``lifted``, for a graph with `_Cond`/`_While` that is row-local
      (`aggregate._rowwise_transform`) and has no bindings: the graph
      lifted to block level, so its predicates carry the row axis and
      `graph.vectorize` selects per row and loops under a per-row mask,
      as JAX's batching rules do under `vmap`;
    - ``vmap``, for any other graph: the per-row callable vectorized over
      the block's rows with `torch.func.vmap`, a cond evaluating both
      branches and selecting per row, a loop running while any row's
      predicate holds (`graph.vectorize.vmap_while`);
    - ``per_row``, for a graph with control flow when
      ``config.row_vectorize`` is off: the callable once per row (the
      reason is counted, ``vectorize.fallback.disabled``).

    Bound placeholders are the same for every row. The plan taken is
    counted (``map_rows.plan.<plan>``). Over ragged columns the rows are
    grouped by cell shape and the plan runs once per group, whatever the
    blocks (``map_rows.plan.ragged``, ``map_rows.ragged.buckets``); an
    output whose groups agree on its cell shape is dense on ``device``,
    any other is ragged on the host. A fetch that is the identity of a
    bytes column copies that column on the host. A `LazyFrame` is forced
    first (one fused callable per block). Placement as `map_blocks`'s
    (``device=``, ``devices=``, ``mesh=``; a mesh runs ragged rows through
    the bucket plan once a shard); a `GlobalFrame` runs one vmapped call
    a shard."""
    from . import globalframe as _gf
    from .lazy import LazyFrame

    if isinstance(frame, _gf.GlobalFrame):
        return _gf.map_rows_global(
            fetches, frame, feed_dict=feed_dict, fetch_names=fetch_names,
            executor=executor, mesh=mesh, bindings=bindings, devices=devices, device=device,
        )
    _check_mesh_args("map_rows", mesh, device, devices)
    if isinstance(frame, LazyFrame):
        frame = frame.force(device=device, mesh=mesh, devices=devices)
    bindings = _normalize_bindings(bindings)
    ex = executor or default_executor()

    def placement():
        return _place(frame, device, devices, mesh, ex)

    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_rows_fn

        return _map_rows_fn(fetches, frame, bindings, placement)
    graph, fetch_list = _as_graph(fetches, fetch_names)
    graph, fetch_list, str_pass = _split_string_passthrough(graph, fetch_list)

    def run_graph():
        return _map_rows_graph(
            graph, fetch_list, frame, feed_dict, ex, bindings, placement,
            route=not bindings and mesh is None and device is None, devices=devices,
        )

    if str_pass:
        return _with_string_passthrough(
            str_pass, frame, feed_dict, fetch_list, bindings, "map_rows", run_graph
        )
    return run_graph()


def _map_rows_graph(graph, fetch_list, frame, feed_dict, ex, bindings, placement,
                    route=False, devices=None):
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
    if route:
        # block_scheduler="global": one vmapped call a shard of a large frame
        from . import globalframe as _gf

        routed = _gf.maybe_map_rows(
            graph, fetch_list, frame, feed_dict, ex, devices, pre=(summary, mapping)
        )
        if routed is not _gf.SKIP:
            return routed
    place = placement()
    plan = _row_plan_kind(graph, fetch_list, feed_names, summary, bindings)
    _count(f"map_rows.plan.{plan}")
    prefix = ""
    if place.mesh is not None:
        from .parallel.verbs import _mesh_sig

        prefix = f"shmap-rows-{_mesh_sig(place.mesh)}-"
    prog = _programs(
        place,
        lambda d: _row_runner(plan, ex, graph, fetch_list, feed_names, summary, bindings, d),
        lambda d: _row_runner(plan, ex, graph, fetch_list, feed_names, summary, bindings, d, prefix),
    )
    out_names = [base_name(f) for f in fetch_list]
    if not dense:
        columns = [frame.column(mapping[n]) for n in feed_names]
        if place.mesh is not None:
            from .parallel.verbs import _ragged_per_shard

            per_out = _ragged_per_shard(
                [prog(d) for d in range(len(place.devs))], columns, frame.nrows,
                place.devs, out_names,
            )
        else:
            from .fn_frontend import _run_ragged_bucketed

            # the bucket plan runs on the anchor
            per_out = _run_ragged_bucketed(
                _row_runner(plan, ex, graph, fetch_list, feed_names, summary, bindings, place.anchor),
                columns, frame.nrows, place.anchor, out_names,
            )
        out_cols = [
            per_out[n] if n in per_out else Column(n, _empty_output(summary, n, False, place.anchor))
            for n in out_names
        ]
        return _output_frame(frame, out_cols, append_input=True)
    # every plan is row-independent (bound placeholders stay whole): an
    # OOM split is always valid
    parts = _loop(
        place, "map_rows", "map_rows.block", graph.fingerprint(),
        lambda feeds, rows, i: prog(i)(feeds, rows),
        _feed_source(frame, mapping, feed_names, bindings),
        lambda outs, what: maybe_check_numerics(out_names, outs, what),
        fscope=_flt.scope("map_rows"), split=_CONCAT,
    )
    out_cols = [
        Column(
            n,
            place.gather([p[j] for p in parts]) if parts
            else _empty_output(summary, n, False, place.anchor),
        )
        for j, n in enumerate(out_names)
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


def _dispatch_combine(kind, fp, fscope, fn, feed_src, partials, dev) -> Tuple:
    """`_combine_partials` as one dispatch: a span labeled with the
    program (no rows: the combine consumes partials, not rows) and a
    transient retry. A resource error re-raises: there is no row range to
    halve."""

    def thunk():
        with _tele.dispatch_span(
            kind, program=fp, partials=len(partials), torch_device=dev
        ):
            return _combine_partials(fn, feed_src, partials)

    return tuple(fscope.dispatch(thunk, what=f"{kind} of {len(partials)} partials"))


def _assoc_reduce(graph, fetch_list, summary) -> bool:
    """True when re-feeding partials through ``graph`` is an associative
    monoid combine (sum / min / max / prod consuming its placeholder
    directly): the partials of one device may then combine first."""
    comb = _chunk_combiners(graph, fetch_list, summary, require_direct=True)
    return comb is not None and "mean" not in comb.values()


def _combine_placed(kind, fp, fscope, combine_for, feed_src, partials, owners, place, assoc):
    """Combine per-item partials (`_dispatch_combine`; ``combine_for(dev)``
    is the combine program on ``dev``) where the placement left them, as
    JAX's ``_combine_partials_scheduled``: under a block schedule an
    ``assoc`` graph combines each device's partials on that device, then
    the per-device results once on the anchor; anything else (and a mesh)
    moves every partial to the anchor and combines them once, in item
    order."""
    anchor = place.anchor
    if assoc and place.sched is not None:
        groups: Dict[int, List[Tuple]] = {}
        for p, o in zip(partials, owners):
            groups.setdefault(o, []).append(p)
        if len(groups) > 1:
            stage = []
            for slot in sorted(groups):
                ps = groups[slot]
                dev = place.sched.devices[slot]
                stage.append(ps[0] if len(ps) == 1 else _dispatch_combine(
                    kind, fp, fscope, combine_for(dev), feed_src, ps, dev
                ))
            partials = stage
    if place.spread:
        partials = [tuple(as_tensor(x, anchor) for x in p) for p in partials]
    return _dispatch_combine(kind, fp, fscope, combine_for(anchor), feed_src, partials, anchor)


def _stack_parts(parts: List, anchor=None) -> Union[np.ndarray, torch.Tensor]:
    """Stack partials: on ``anchor`` (default: the device of the first
    tensor among them) when any is a tensor (host partials, spilled or
    restored from a checkpoint, and partials of other cards move there),
    else with host numpy."""
    dev = next((p.device for p in parts if isinstance(p, torch.Tensor)), None)
    if dev is None:
        return np.stack([np.asarray(p) for p in parts])
    return torch.stack([as_tensor(p, anchor or dev) for p in parts])


def _across_processes(place: _Place, partials: List[Tuple], outputs) -> List[Tuple]:
    """Over a mesh of several processes, every process's partials in
    global shard order (`parallel.multihost.gather_partials`; ``outputs``:
    the fetches' analyzed outputs), after the block loop and its retries:
    this process's alone otherwise."""
    if place.mesh is None or place.mesh.process_count == 1:
        return partials
    from .parallel import multihost as _mh

    return _mh.gather_partials(partials, place.mesh, place.anchor, outputs)


def _results(bases: List[str], values):
    """One tensor for one fetch, a dict of tensors for several."""
    return values[0] if len(bases) == 1 else dict(zip(bases, values))


@_pandas_in_out
@_spanning_in_out
@_deadline_entry("reduce_blocks")
@torch.no_grad()
def reduce_blocks(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
    mesh=None,
    devices=None,
):
    """Per-block reduce, then one combine over the stacked partials.
    Returns one tensor for one fetch, a dict of tensors for several; the
    results stay on the anchor device. Placement as `map_blocks`'s; under
    a block schedule an associative monoid graph combines each card's
    partials there first (`_combine_placed`). On a `LazyFrame` this is a
    terminal action: the reduce's per-block stage fuses into the pending
    chain, and the whole pipeline runs as ONE callable per block. On a
    `GlobalFrame` a classified reduce runs once a shard and combines once
    on the anchor (`globalframe`)."""
    from . import globalframe as _gf
    from .lazy import LazyFrame

    if isinstance(frame, _gf.GlobalFrame):
        return _gf.reduce_blocks_global(
            fetches, frame, feed_dict=feed_dict, fetch_names=fetch_names,
            executor=executor, mesh=mesh, devices=devices, device=device,
        )
    _check_mesh_args("reduce_blocks", mesh, device, devices)
    if isinstance(frame, LazyFrame):
        return frame.reduce_blocks(
            fetches, feed_dict, fetch_names, executor, device=device, mesh=mesh,
            devices=devices,
        )
    ex = executor or default_executor()
    graph, fetch_list = _as_graph(fetches, fetch_names)
    if mesh is None and device is None:
        # block_scheduler="global": a classified reduce of a large frame
        # runs once a shard
        routed = _gf.maybe_reduce_blocks(graph, fetch_list, frame, feed_dict, ex, devices)
        if routed is not _gf.SKIP:
            return routed
    summary, mapping = _prepare(
        graph, fetch_list, frame, feed_dict, True, validate=_validate_reduce_blocks
    )
    _require_dense(frame, list(mapping.values()), "reduce_blocks")
    place = _place(frame, device, devices, mesh, ex)
    feed_names = sorted(summary.inputs)

    def make(d):
        return ex.callable_for(graph, fetch_list, feed_names, d)

    mesh_make = None
    if place.mesh is not None:
        from .parallel.verbs import _mesh_sig

        kind = f"shred-{_mesh_sig(place.mesh)}"
        mesh_make = lambda d: ex.cached(  # noqa: E731
            kind, graph, fetch_list, feed_names, d,
            lambda dd: build_callable(graph, fetch_list, feed_names, dd),
        )
    prog = _programs(place, make, mesh_make)
    # feed_src[j] = the fetch whose partial re-feeds feed_names[j]
    fetch_of_feed = {base_name(f) + "_input": i for i, f in enumerate(fetch_list)}
    feed_src = [fetch_of_feed[n] for n in feed_names]
    fscope = _flt.scope("reduce_blocks")
    fp = graph.fingerprint()
    partials = _loop(
        place, "reduce_blocks", "reduce_blocks.block", fp,
        lambda feeds, rows, i: prog(i)(*feeds),
        _feed_source(frame, mapping, feed_names),
        lambda outs, what: maybe_check_numerics(fetch_list, outs, what),
        fscope=fscope, split=_reduce_split(graph, fetch_list, summary),
        refuse="unclassifiable-reduce",
    )
    partials = _across_processes(
        place, partials, [summary.outputs[base_name(f)] for f in fetch_list])
    if not partials:
        raise ValueError("reduce_blocks on an empty frame")
    # a verb whose budget ran out during the blocks must not start the
    # combine
    _dl.check("reduce_blocks")
    if len(partials) == 1:
        final = tuple(as_tensor(x, place.anchor) for x in partials[0]) if place.spread else partials[0]
    else:
        owners = [place.sched.slot(i) for i, _, _ in place.items] if place.sched else None
        final = _combine_placed(
            "reduce-combine", fp, fscope, _per_device(make), feed_src, partials, owners,
            place, place.sched is not None and _assoc_reduce(graph, fetch_list, summary),
        )
    if place.mesh is not None:
        maybe_check_numerics(fetch_list, final, "reduce_blocks (mesh)")
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


def _fold_columns(mapping: Dict[str, str], bases: List[str]) -> List[str]:
    """The column each fetch folds: its ``x_1`` and ``x_2`` must read the
    same one."""
    for b in bases:
        c1, c2 = mapping[b + "_1"], mapping[b + "_2"]
        if c1 != c2:
            raise ValueError(
                f"reduce_rows: {b}_1 reads column {c1!r} but {b}_2 reads "
                f"{c2!r}; a fold's carry and next-row must come from the "
                "same column"
            )
    return [mapping[b + "_1"] for b in bases]


def _pair_feeds(bases: List[str]) -> List[str]:
    return [b + s for b in bases for s in ("_1", "_2")]


def _fold(rows: List[torch.Tensor], monoid, pair) -> Tuple[torch.Tensor, ...]:
    """Left fold of the lead axis of each base's tensor: one reduction a
    fetch for a monoid, else the pair callable row by row."""
    if monoid is not None:
        return tuple(r(x) for r, x in zip(monoid, rows))
    carry = tuple(x[0] for x in rows)
    for i in range(1, len(rows[0])):
        carry = pair(*[v for c, x in zip(carry, rows) for v in (c, x[i])])
    return carry


@_pandas_in_out
@_spanning_in_out
@_verb_entry("reduce_rows")
@torch.no_grad()
def reduce_rows(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
    mesh=None,
    devices=None,
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

    Placement as `map_blocks`'s: under a block schedule or a mesh each
    block (shard) folds on its device, and the partials fold on the anchor
    in block order, never regrouped by device. A `LazyFrame` is forced
    first (one fused callable per block); a `GlobalFrame` folds over
    `to_frame()` by contract.
    """
    from . import globalframe as _gf
    from .lazy import LazyFrame

    if isinstance(frame, _gf.GlobalFrame):
        # a left fold in row order: the local boundary, one block; the
        # frame still owns its placement, so overrides raise
        _gf._reject_overrides("reduce_rows", mesh, devices, device, frame)
        frame = frame.to_frame()
    _check_mesh_args("reduce_rows", mesh, device, devices)
    if isinstance(frame, LazyFrame):
        frame = frame.force(device=device, mesh=mesh, devices=devices)
    ex = executor or default_executor()
    graph, fetch_list = _as_graph(fetches, fetch_names)
    summary, mapping = _prepare(
        graph, fetch_list, frame, feed_dict, False, validate=_validate_reduce_rows
    )
    _require_dense(frame, list(mapping.values()), "reduce_rows")
    bases = [base_name(f) for f in fetch_list]
    cols = _fold_columns(mapping, bases)
    monoid = _monoid_reductions(graph, bases, summary)
    _count("reduce_rows.plan.monoid" if monoid else "reduce_rows.plan.general")
    # single-row blocks never dispatch (their partial is their row): they
    # weigh nothing in the schedule
    place = _place(
        frame, device, devices, mesh, ex,
        weights=[0 if n == 1 else n for n in frame.block_sizes()],
    )
    pair_feeds = _pair_feeds(bases)
    pair_of = _per_device(lambda d: ex.callable_for(graph, fetch_list, pair_feeds, d))
    pair_prog = None
    if monoid is None:
        mesh_make = None
        if place.mesh is not None:
            from .parallel.verbs import _mesh_sig

            kind = f"shfold-{_mesh_sig(place.mesh)}"
            mesh_make = lambda d: ex.cached(  # noqa: E731
                kind, graph, fetch_list, pair_feeds, d,
                lambda dd: build_callable(graph, fetch_list, pair_feeds, dd),
            )
        pair_prog = _programs(place, pair_of, mesh_make)

    def run(rows, n, i):
        if n == 1:  # a single-row block's partial is its row
            return tuple(x[0] for x in rows)
        return _fold(rows, monoid, pair_prog(i) if pair_prog is not None else None)

    def rows_for(lo, hi, dev):
        return [as_tensor(frame.column(c).values[lo:hi], dev) for c in cols]

    # classified transient retries only: the verb's contract is a LEFT
    # FOLD in row order, so an OOM cannot split the block (regrouping
    # would change a non-associative result) and surfaces as it is
    fscope = _flt.scope("reduce_rows")
    partials = _loop(
        place, "reduce_rows", "reduce_rows.block", graph.fingerprint(), run, rows_for,
        lambda outs, what: maybe_check_numerics(bases, outs, what), fscope=fscope,
    )
    partials = _across_processes(place, partials, [summary.outputs[b] for b in bases])
    if not partials:
        raise ValueError("reduce_rows on an empty frame")
    anchor = place.anchor
    if len(partials) == 1:
        final = tuple(as_tensor(x, anchor) for x in partials[0])
    else:
        final = _fold(
            [torch.stack([as_tensor(p[i], anchor) for p in partials]) for i in range(len(bases))],
            monoid, pair_of(anchor) if monoid is None else None,
        )
    if place.mesh is not None:
        maybe_check_numerics(bases, final, "reduce_rows (mesh)")
    return _results(bases, final)


# ---------------------------------------------------------------------------
# aggregate (keyed)
# ---------------------------------------------------------------------------


class GroupedFrame:
    """`group_by(frame, *keys)`: the RelationalGroupedDataset analogue. Any
    scalar column is a key: numbers factorize on the verb's device, strings
    and other objects on the host (the reference grouped by any Catalyst
    column type). Over a `LazyFrame`, `aggregate` forces the plan on its
    device first: aggregation needs concrete key columns. Over a
    `GlobalFrame` it groups `to_frame()`, and `aggregate` refuses
    placement overrides (the frame owns its placement)."""

    def __init__(self, frame: TensorFrame, keys: Sequence[str]):
        from . import globalframe as _gf

        self._from_global = isinstance(frame, _gf.GlobalFrame)
        self._global = frame if self._from_global else None
        if self._from_global:
            frame = frame.to_frame()
        self.frame = frame
        self.keys = list(keys)
        for k in self.keys:
            if not frame.info[k].cell_shape.is_scalar:
                raise ValueError(f"group key {k!r} must be a scalar column")

    def aggregate(self, fetches, **kw) -> TensorFrame:
        return aggregate(fetches, self, **kw)

    def agg(self, device: DeviceLike = None, **specs) -> TensorFrame:
        """Keyed aggregation from ``out=('op', column)`` specs, ops among
        `graph.plan.AGG_OPS`: each lowers to a reduce over axis 0 of its
        column."""
        fetches, feed = _agg_spec_exprs(self.frame, specs)
        return aggregate(fetches, self, feed_dict=feed, device=device)


def group_by(frame: TensorFrame, *keys: str) -> GroupedFrame:
    return GroupedFrame(frame, keys)


def _agg_spec_exprs(frame: TensorFrame, specs: Dict[str, Tuple[str, str]]):
    """``out=(op, column)`` specs as the DSL reduce fetches and the
    feed_dict `aggregate` takes (the eager `GroupedFrame.agg` and the
    relational groupby plan node share it)."""
    from .graph import plan as _plan

    fetches = []
    feed: Dict[str, str] = {}
    for out, spec in sorted(specs.items()):
        if (
            not isinstance(spec, (tuple, list)) or len(spec) != 2
            or not all(isinstance(s, str) for s in spec)
        ):
            raise TypeError(f"agg spec {out}={spec!r}: want a ('op', 'column') pair")
        op, colname = spec
        if op not in _plan.AGG_OPS:
            raise ValueError(f"agg op {op!r} is not one of {list(_plan.AGG_OPS)}")
        ph = dsl.block(frame, colname, tf_name=f"{out}_input")
        fetches.append(getattr(dsl, f"reduce_{op}")(ph, axes=[0]).named(out))
        feed[f"{out}_input"] = colname
    return fetches, feed


@_verb_entry("aggregate")
@torch.no_grad()
def aggregate(
    fetches,
    grouped: GroupedFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
    mesh=None,
    devices=None,
) -> TensorFrame:
    """Keyed aggregation with the `reduce_blocks` naming conventions: the
    key columns (distinct keys in sorted order), then one row per group of
    each output, all on the anchor device.

    A graph `_chunk_combiners` classifies (a Sum/Min/Max/Prod/float Mean
    over axis 0 of a row-wise transform of its placeholder) takes the
    segment plan while ``config.aggregate_segment_fast`` is on; otherwise
    rows are sorted by group and whole groups run through the graph, one
    vmapped call per distinct group size (the exact plan,
    `DebugRowOps.aggregate`, `DebugRowOps.scala:554-599`), or, for a
    classified graph with more than ``config.aggregate_exact_size_limit``
    distinct sizes, in power-of-two chunks combined per group (the chunk
    plan). A string key's column comes back as host strings.

    Placement: the segment plan is one whole-frame dispatch, on ``device``,
    on the first of ``devices=`` (a pin), or on the card; the exact and
    chunk plans' per-size calls spread over the cards like blocks
    (weighted by their rows) under the block scheduler. With ``mesh=`` the
    rows shard across the mesh's devices (`parallel.verbs.aggregate`).
    """
    from .lazy import LazyFrame

    if getattr(grouped, "_from_global", False):
        from . import globalframe as _gf

        _gf._reject_overrides("aggregate", mesh, devices, device, grouped._global)
    if getattr(grouped.frame, "_spanning", False):
        from .parallel import multihost as _mh

        grouped = _mh.spanning_grouped(grouped, "aggregate")
    _check_mesh_args("aggregate", mesh, device, devices)
    if isinstance(grouped.frame, LazyFrame):
        grouped = GroupedFrame(
            grouped.frame.force(device=device, mesh=mesh, devices=devices), grouped.keys
        )
    if mesh is not None:
        from .parallel import verbs as _pverbs

        return _pverbs.aggregate(fetches, grouped, mesh, feed_dict, fetch_names, executor)
    frame = grouped.frame
    graph, fetch_list = _as_graph(fetches, fetch_names)
    summary, mapping = _prepare(
        graph, fetch_list, frame, feed_dict, True, validate=_validate_reduce_blocks
    )
    _require_dense(frame, list(mapping.values()), "aggregate")
    ex = executor or default_executor()
    feed_names = sorted(summary.inputs)
    # one classification serves the segment plan and the chunk plan
    classified = _chunk_combiners(graph, fetch_list, summary)
    from . import config as _config

    devs = None
    if device is not None:
        dev = resolve_device(device)
    else:
        from .runtime import scheduler as _rs

        devs = _rs.resolve(devices=devices, executor=ex)
        dev = devs[0] if devs is not None else resolve_device(None)
    if _config.get().aggregate_segment_fast and frame.nrows > 0 and classified is not None:
        _count("aggregate.plan.segment")
        if devices is not None:
            # a devices= pin commits the one dispatch to its first device
            _rs._bump(ex, "device_dispatches", _rs.device_label(dev), 1)
        return _aggregate_segment(
            ex, graph, fetch_list, classified, feed_names, mapping, grouped, dev
        )
    return _aggregate_sorted(
        ex, graph, fetch_list, summary, feed_names, mapping, grouped, dev, classified, devs
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


def scan(source, format: str = "auto", columns=None, chunk_groups: int = 1,
         device: DeviceLike = None):
    """Lazily scan an on-disk dataset (Parquet / Arrow IPC) as a
    `RelationalFrame` — the relational plan's ingest leaf. Composes with
    `filter` / `select` / `map_blocks` / `group_by(...).agg(...)`; the plan
    optimizer pushes predicates and the pruned column set INTO the decode
    (skipping whole Parquet row groups from footer stats), so a selective
    plan decodes the rows that survive, not the whole dataset. ``source``
    is a path / path list / `ingest.Dataset`; ``device`` is where the
    plan's maps and aggregations run (default: the CUDA card)."""
    from .graph import plan as _plan
    from .ingest import Dataset
    from .lazy import RelationalFrame

    ds = (
        source
        if isinstance(source, Dataset)
        else Dataset(source, format=format, chunk_groups=chunk_groups)
    )
    payload: Dict[str, object] = {"dataset": ds}
    if columns is not None:
        payload["columns"] = tuple(columns)
    return RelationalFrame(_plan.PlanNode("scan", (), payload), device=device)


def explain(frame: TensorFrame) -> str:
    """The frame's schema as text (`DebugRowOps.scala:535-552`).

    For a `LazyFrame`, renders the fused plan with per-stage provenance
    (deferred verbs, feeds, pending outputs) above the schema. For a
    `RelationalFrame` (or its `LazyPlan`), renders the pre- AND
    post-optimization DAG with per-node costed estimates and every rewrite
    decision (accepted and rejected) — WITHOUT executing."""
    from .lazy import LazyFrame, LazyPlan, RelationalFrame

    if isinstance(frame, RelationalFrame):
        return frame.explain_plan()
    if isinstance(frame, LazyPlan):
        if frame.relational is not None:
            return RelationalFrame(frame.relational).explain_plan()
        return repr(frame)
    if isinstance(frame, LazyFrame):
        return frame.explain_plan()
    return frame.info.explain()


def explain_detailed(frame: TensorFrame):
    """The frame's per-column metadata, the `FrameInfo` itself
    (`ExperimentalOperations.scala:27`). For a `LazyFrame`, the structured
    `LazyPlan` (stages, fused graph, column sources, feeds, virtual
    schema)."""
    from .lazy import LazyFrame

    if isinstance(frame, LazyFrame):
        return frame.plan()
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
    # relational verbs: compose lazily as plan-DAG nodes (graph.plan);
    # force() runs them through the cost-based optimizer
    TensorFrame.filter = lambda self, pred, selectivity=None: self.lazy().filter(
        pred, selectivity=selectivity
    )
    TensorFrame.sort_by = lambda self, *keys, descending=False: self.lazy().sort_by(
        *keys, descending=descending
    )
    TensorFrame.join = lambda self, other, on, how="inner": self.lazy().join(
        other, on, how=how
    )


_install_fluent_methods()


from .streaming import reduce_blocks_stream  # noqa: E402  (streaming imports api)
