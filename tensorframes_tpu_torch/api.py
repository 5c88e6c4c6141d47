"""The verbs: `map_blocks`, `map_rows`, `reduce_blocks`, plus `block`,
`row` and `analyze`.

The PyTorch counterpart of `tensorframes_tpu/api.py`, for this slice of the
port. A graph (DSL tensor, `Graph`, GraphDef bytes or file path) is
analyzed, its placeholders are matched to columns, and a lowered callable
runs once per block on ``device`` (default: the CUDA card). Outputs stay on
that device as tensors; `Column.host_values` is the one way back to numpy.

Not in this slice: the mesh/scheduler/lazy/global routes, bindings, string
pass-through, shape bucketing (eager PyTorch has no per-shape compile to
bound), `reduce_rows` and `aggregate`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .frame import Column, TensorFrame, as_tensor
from .graph import builder as dsl
from .graph.analysis import GraphSummary, analyze_graph
from .graph.ir import Graph, base_name
from .ops.lowering import build_callable
from .runtime.executor import Executor, default_executor
from .schema import Shape

__all__ = [
    "map_blocks",
    "map_rows",
    "reduce_blocks",
    "block",
    "row",
    "analyze",
    "print_schema",
]

Fetches = Union[dsl.Tensor, Sequence[dsl.Tensor], Graph, bytes, str]

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
    return g, list(fetch_names)


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


def _ph_overrides(
    graph: Graph,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]],
    block_level: bool,
) -> Dict[str, Shape]:
    """Column shapes are usually more precise than placeholder attrs
    (imported graphs carry [?,?]); inject them for tighter analysis."""
    feed_dict = feed_dict or {}
    overrides: Dict[str, Shape] = {}
    for ph in graph.placeholders():
        col_name = feed_dict.get(ph.name, _default_column(ph.name, frame))
        if col_name in frame.info:
            info = frame.info[col_name]
            shape = info.block_shape if block_level else info.cell_shape
            attr = ph.shape_attr
            if attr is None or shape.check_more_precise_than(attr):
                overrides[ph.name] = shape
    return overrides


def _match_columns(
    summary: GraphSummary,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]],
    block_level: bool,
) -> Dict[str, str]:
    """Map placeholder name -> column name; validate dtype + shape."""
    feed_dict = feed_dict or {}
    mapping: Dict[str, str] = {}
    for ph_name, ph in summary.inputs.items():
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


def _prepare(fetches, frame, feed_dict, fetch_names, block_level):
    graph, fetch_list = _as_graph(fetches, fetch_names)
    overrides = _ph_overrides(graph, frame, feed_dict, block_level)
    summary = analyze_graph(graph, fetch_list, placeholder_shapes=overrides)
    mapping = _match_columns(summary, frame, feed_dict, block_level)
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


def _feeds(frame, mapping, feed_names, lo, hi, device) -> List[torch.Tensor]:
    return [
        as_tensor(frame.column(mapping[n]).values[lo:hi], device)
        for n in feed_names
    ]


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
    device: DeviceLike = None,
) -> TensorFrame:
    """Apply a graph, or a plain function of columns returning a dict of
    named outputs, to each block on ``device``.

    Without ``trim`` every output keeps the block's row count and the
    input columns ride along; with ``trim=True`` the row count may change
    and the input columns are dropped.
    """
    dev = resolve_device(device)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        from .fn_frontend import _map_blocks_fn

        return _map_blocks_fn(fetches, frame, trim, dev)
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, block_level=True
    )
    ex = executor or default_executor()
    feed_names = sorted(summary.inputs)
    fn = ex.callable_for(graph, fetch_list, feed_names, dev)

    acc: Dict[str, List[torch.Tensor]] = {base_name(f): [] for f in fetch_list}
    out_sizes: List[int] = []
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            out_sizes.append(0)
            continue  # an empty block contributes nothing
        outs = fn(*_feeds(frame, mapping, feed_names, lo, hi, dev))
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


@torch.inference_mode()
def map_rows(
    fetches,
    frame: TensorFrame,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    device: DeviceLike = None,
) -> TensorFrame:
    """Apply a per-row graph to every row: the lowered callable is
    vectorized over the block's rows with `torch.func.vmap`, one call per
    block (the reference ran one session per row)."""
    dev = resolve_device(device)
    graph, fetch_list, summary, mapping = _prepare(
        fetches, frame, feed_dict, fetch_names, block_level=False
    )
    ex = executor or default_executor()
    feed_names = sorted(summary.inputs)
    vfn = ex.cached(
        "vmap-rows", graph, fetch_list, feed_names, dev,
        lambda: torch.func.vmap(
            build_callable(graph, fetch_list, feed_names, dev)
        ),
    )
    out_names = [base_name(f) for f in fetch_list]
    acc: Dict[str, List[torch.Tensor]] = {n: [] for n in out_names}
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            continue
        outs = vfn(*_feeds(frame, mapping, feed_names, lo, hi, dev))
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
        fetches, frame, feed_dict, fetch_names, block_level=True
    )
    _validate_reduce_blocks(summary, fetch_list)
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
    if len(fetch_list) == 1:
        return final[0]
    return {base_name(f): v for f, v in zip(fetch_list, final)}


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
