"""Plain-function front end, and the shape-bucketed plan for ragged rows.

The PyTorch counterpart of `tensorframes_tpu/fn_frontend.py`. The
function's parameter names pick the columns, or a binding of the same
name; it must return a dict of named output tensors, whose names become
column names. `map_blocks` calls it once per block with that block's
columns as tensors on the verb's device; `map_rows` calls it once per block
under `torch.func.vmap`, so it sees one row's cells (bound parameters stay
whole, ``in_dims=None``). Where the JAX package traces and jits the
function, the port calls it eagerly: a model's own kernels (the
flash-attention kernel of `models.TransformerLM`) launch inside the call.

On an all-empty frame the function runs once on zero-row feeds on the
``meta`` device, the counterpart of JAX's `jax.eval_shape`, so the output
names and dtypes are known without a row of data.

Ragged rows (`_run_ragged_bucketed`, shared with the graph `map_rows`):
rows are grouped by their joint cell shapes, each group is stacked once on
the host, copied once to the device and run in one vectorized call, and
the outputs go back in row order. JAX's power-of-two padding of group sizes
is left out: it only bounds XLA compiles.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .frame import Column, TensorFrame, _to_numpy, as_tensor
from .utils.profiling import count as _count

_META = torch.device("meta")


def _fn_feed_columns(
    fn: Callable, frame: TensorFrame, bindings: Dict
) -> List[str]:
    params = [
        p.name
        for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    ]
    missing = [p for p in params if p not in frame.info and p not in bindings]
    if missing:
        raise ValueError(
            f"function front-end: parameters {missing} have no matching "
            f"columns (columns: {frame.columns})"
        )
    unknown = sorted(set(bindings) - set(params))
    if unknown:
        raise ValueError(
            f"bindings {unknown} do not match any function parameter "
            f"(parameters: {params})"
        )
    return params


def _fn_outputs_to_dict(res, what: str) -> Dict[str, torch.Tensor]:
    if not isinstance(res, dict):
        raise ValueError(
            f"{what}: a function graph must return a dict of named output "
            "arrays (output names become column names)"
        )
    if not res:
        raise ValueError(
            f"{what}: the function graph returned an empty dict; it must "
            "return at least one named output array"
        )
    return res


def _identity(params: List[str]) -> Dict[str, str]:
    """Parameter -> column: a parameter reads the column of its name."""
    return {p: p for p in params}


def _empty_fn_outputs(
    fn: Callable,
    frame: TensorFrame,
    params: List[str],
    bound: Dict,
    device: torch.device,
    rows: int = 0,
) -> Dict[str, torch.Tensor]:
    """Zero-row outputs of a function over an all-empty frame: one call on
    ``meta`` feeds of ``rows`` rows (a column's unknown dims collapse to 0;
    bound parameters keep their shapes). The lead dim is forced to 0, since
    a trimmed reduction of zero rows may still report one row (a keepdims
    sum). A vmapped function is probed with one row: `torch.func.vmap` of
    a zero-size batch fails in some ops. The outputs are zero-row tensors
    on ``device``."""
    feeds = []
    for p in params:
        if p in bound:
            feeds.append(bound[p].to(_META))
            continue
        info = frame.info[p]
        dims = tuple(0 if d is None else d for d in info.cell_shape.dims)
        feeds.append(torch.empty((rows,) + dims, dtype=info.dtype.torch_dtype, device=_META))
    outs = fn(*feeds)
    return {
        n: torch.zeros((0,) + tuple(o.shape[1:]), dtype=o.dtype, device=device)
        for n, o in outs.items()
    }


def _map_blocks_fn(
    fn: Callable,
    frame: TensorFrame,
    trim: bool,
    bindings: Dict,
    placement: Callable,
) -> TensorFrame:
    """`map_blocks` of a function over the verb's placement (`api._Place`:
    one device, a block schedule or a mesh, whose shards dispatch together
    as ``mesh.map_blocks.fn``); output names come from the returned dict."""
    from . import api as _api

    params = _fn_feed_columns(fn, frame, bindings)
    _api._require_dense(frame, [p for p in params if p not in bindings], "map_blocks")

    def call(*feeds):
        return _fn_outputs_to_dict(fn(*feeds), "map_blocks")

    place = placement()
    parts = _api._loop(
        place, "map_blocks", None, None, lambda feeds, rows, i: call(*feeds),
        _api._feed_source(frame, _identity(params), params, bindings),
        lambda outs, what: None, mesh_name="mesh.map_blocks.fn",
    )
    return _fn_output_frame(
        frame, parts, place, call, params, bindings, trim, lambda outs, rows: _api._block_rows(outs, rows, trim)
    )


def _fn_output_frame(frame, parts, place, call, params, bindings, trim, rows_of, probe_rows=0):
    """The function front end's output frame: each item's dict of outputs
    concatenated on the anchor, or, over an all-empty frame, zero-row
    outputs named by one call on the meta device."""
    from . import api as _api

    sizes = {i: rows_of(outs, hi - lo) for (i, lo, hi), outs in zip(place.items, parts)}
    if parts:
        out_cols = [Column(n, place.gather([p[n] for p in parts])) for n in parts[0]]
    else:
        bound = _api._bound_tensors(bindings, place.anchor)
        empties = _empty_fn_outputs(call, frame, params, bound, place.anchor, rows=probe_rows)
        out_cols = [Column(n, v) for n, v in empties.items()]
    offsets = _api._trim_offsets(frame, place, sizes) if trim else frame.offsets
    return _api._output_frame(frame, out_cols, append_input=not trim, offsets=offsets)


# ---------------------------------------------------------------------------
# ragged rows: shape buckets
# ---------------------------------------------------------------------------


def _bucket_rows(columns: Sequence[Column], nrows: int) -> List[np.ndarray]:
    """Row indices of each bucket, in row order within a bucket: the rows
    whose ragged cells share their shapes in every ragged column. A rank-1
    column keys on its cell lengths (one `np.fromiter`); the joint key is
    grouped by one stable argsort."""
    keys = []
    for col in columns:
        if col.is_dense:
            continue
        cells = col.ragged
        if len(cells) and cells[0].ndim == 1:
            keys.append(np.fromiter(map(len, cells), dtype=np.int64, count=nrows))
        else:
            ids: Dict[Tuple, int] = {}
            keys.append(np.fromiter(
                (ids.setdefault(c.shape, len(ids)) for c in cells), dtype=np.int64, count=nrows
            ))
    if not keys:
        return [np.arange(nrows)]
    if len(keys) == 1:
        key = keys[0]
    else:
        key = np.unique(np.stack(keys, axis=1), axis=0, return_inverse=True)[1].reshape(-1)
    order = np.argsort(key, kind="stable")
    return np.split(order, np.flatnonzero(np.diff(key[order])) + 1)


def _run_buckets(
    run: Callable,
    columns: Sequence[Column],
    buckets: List[np.ndarray],
    device: torch.device,
    out_names: Optional[List[str]] = None,
) -> Dict[str, List[Tuple[np.ndarray, torch.Tensor]]]:
    """One vectorized call per bucket: ``run(feeds, rows)`` over the
    bucket's cells stacked on the host into ``(rows, *cell)`` and copied to
    ``device`` once (a dense column is copied once for all buckets and
    gathered there). Returns name -> [(row indices, output on device)]."""
    sources = []
    for col in columns:
        if col.is_dense:
            sources.append(as_tensor(col.values, device))
        elif len(col.ragged) and col.ragged[0].ndim == 1:
            # rank 1: one flat buffer; a bucket is one gather from it
            lens = np.fromiter(map(len, col.ragged), dtype=np.int64, count=len(col.ragged))
            sources.append((np.concatenate(col.ragged), np.cumsum(lens) - lens, lens))
        else:
            sources.append(col.ragged)
    chunks: Dict[str, List[Tuple[np.ndarray, torch.Tensor]]] = {}
    for idx in buckets:
        feeds = []
        for src in sources:
            if isinstance(src, torch.Tensor):
                feeds.append(src[torch.from_numpy(idx).to(device)])
            elif isinstance(src, tuple):
                flat, starts, lens = src
                feeds.append(as_tensor(flat[starts[idx][:, None] + np.arange(lens[idx[0]])], device))
            else:
                feeds.append(as_tensor(np.stack([src[i] for i in idx]), device))
        outs = run(feeds, len(idx))
        if not isinstance(outs, dict):
            outs = dict(zip(out_names, outs))
        for name, o in outs.items():
            chunks.setdefault(name, []).append((idx, o))
    return chunks


def _assemble_ragged(
    chunks: Dict[str, List[Tuple[np.ndarray, torch.Tensor]]], nrows: int
) -> Dict[str, Column]:
    """Bucket outputs back in row order. An output whose buckets all give
    one cell shape is scattered into a dense column on the device (one
    `index_copy_` per bucket); any other becomes ragged host cells."""
    out: Dict[str, Column] = {}
    for name, pairs in chunks.items():
        shapes = {tuple(o.shape[1:]) for _, o in pairs}
        o0 = pairs[0][1]
        if len(shapes) == 1:
            res = torch.empty((nrows,) + shapes.pop(), dtype=o0.dtype, device=o0.device)
            for idx, o in pairs:
                res.index_copy_(0, torch.from_numpy(idx).to(o.device), o)
            out[name] = Column(name, res)
            continue
        cells: List[Optional[np.ndarray]] = [None] * nrows
        for idx, o in pairs:
            for i, cell in zip(idx.tolist(), _to_numpy(o)):
                cells[i] = cell
        out[name] = Column._from_cells(name, cells, o0.dim() - 1)
    return out


def _run_ragged_bucketed(
    run: Callable,
    columns: Sequence[Column],
    nrows: int,
    device: torch.device,
    out_names: Optional[List[str]] = None,
) -> Dict[str, Column]:
    """Shape-bucketed execution of ragged rows (SURVEY §7's plan): bucket
    the rows by joint cell shape, one vectorized call per bucket, outputs
    back in row order. Counted: ``map_rows.plan.ragged`` once a call and
    ``map_rows.ragged.buckets`` by the number of buckets."""
    buckets = _bucket_rows(columns, nrows) if nrows else []
    _count("map_rows.plan.ragged")
    _count("map_rows.ragged.buckets", len(buckets))
    return _assemble_ragged(_run_buckets(run, columns, buckets, device, out_names), nrows)


def _map_rows_fn(
    fn: Callable,
    frame: TensorFrame,
    bindings: Dict,
    placement: Callable,
) -> TensorFrame:
    """`map_rows` of a function of row cells: one vmapped call per item of
    the verb's placement over dense columns (a mesh's shards together as
    ``mesh.map_rows.fn``), one per shape bucket over ragged ones (per shard
    on a mesh); output names come from the returned dict."""
    from . import api as _api

    params = _fn_feed_columns(fn, frame, bindings)
    col_params = [p for p in params if p not in bindings]
    if bindings and not col_params:
        raise ValueError(
            "map_rows: every parameter is bound, so nothing varies per "
            "row; use map_blocks (or call the function directly)"
        )
    dense = all(frame.column(p).is_dense for p in col_params)
    if bindings and not dense:
        raise ValueError(
            "map_rows: bindings are not supported with ragged feed "
            "columns; densify the columns or bake the values as constants"
        )
    vfn = torch.func.vmap(
        lambda *cells: _fn_outputs_to_dict(fn(*cells), "map_rows"),
        in_dims=tuple(None if p in bindings else 0 for p in params),
    )
    place = placement()
    if not dense and frame.nrows:
        columns = [frame.column(p) for p in params]
        if place.mesh is not None:
            from .parallel.verbs import _ragged_per_shard

            runs = [lambda feeds, rows: vfn(*feeds)] * len(place.devs)
            per_out = _ragged_per_shard(runs, columns, frame.nrows, place.devs)
        else:
            per_out = _run_ragged_bucketed(
                lambda feeds, rows: vfn(*feeds), columns, frame.nrows, place.anchor,
            )
        return _api._output_frame(frame, list(per_out.values()), append_input=True)
    parts = _api._loop(
        place, "map_rows", None, None, lambda feeds, rows, i: vfn(*feeds),
        _api._feed_source(frame, _identity(params), params, bindings),
        lambda outs, what: None, mesh_name="mesh.map_rows.fn",
    )
    return _fn_output_frame(
        frame, parts, place, vfn, params, bindings, False, lambda outs, rows: rows, probe_rows=1,
    )
