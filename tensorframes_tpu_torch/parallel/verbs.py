"""Mesh verbs: the five operations over a device mesh (``mesh=`` on the verbs).

The PyTorch counterpart of `tensorframes_tpu/parallel/verbs.py`, with its
topology:

- ``map_blocks`` / ``map_rows``: the rows split into ``ndev`` equal shards,
  one a device; each shard runs the verb's program built for its device,
  and the outputs are concatenated on the mesh's first device. Ragged
  ``map_rows`` runs the shape-bucket plan per shard (`_ragged_per_shard`).
- ``reduce_blocks`` / ``reduce_rows``: each shard reduces (or folds) its
  rows; the partials are gathered to the first device, stacked, and the
  same graph is applied once more (JAX's ``all_gather`` and final apply).
- ``aggregate``: a graph `aggregate._chunk_combiners` classifies takes a
  segment table a fetch per shard, combined across shards in shard order by
  the fetch's monoid (JAX's ``psum`` for a sum); any other graph takes the
  exact plan on the first device. The JAX package runs a classified graph
  that is not a bare lead-axis sum through its chunk plan with each chunk
  call split across the mesh; here the segment tables give the same
  results with no sort (the chunk route measured 7-13x slower than the
  local segment plan on an H100).

Rows that the device count does not divide (``nrows % ndev``) run as one
extra block on the first device, and their partial joins the combine: block
boundaries are arbitrary in the reference too. Eager PyTorch issues every
shard's work before any result is read, so the cards run at once.

Every mesh dispatch goes through `_mesh_call`: a ``verb`` span with
``.calls`` / ``.seconds`` / ``.rows`` counters and a ``dispatch`` span
labeled with the program and the shard count, and classified transient
retries. A resource error surfaces as it is: halving the rows would change
the shard layout, and the mesh owns the placement. The executor's cache key
names the mesh's devices (`_mesh_sig`), and ``config.check_numerics``
checks every shard's and the tail's outputs.

Left out: the mesh shape bucketing of the JAX package (`_bucketed_or_split`,
`shape_policy.pad_mesh_shards`), as the rest of `shape_policy`'s bucketing
(eager PyTorch compiles nothing per shape); `fused_map_blocks` /
`fused_reduce_blocks`, the mesh routes of a lazy plan (ROADMAP Queue 1 item
12.3).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import api as _api
from ..aggregate import _SEGMENT_OF, _chunk_combiners, _factorized, _keyed_output
from ..frame import Column, TensorFrame, as_tensor
from ..graph import builder as dsl
from ..graph.ir import base_name
from ..ops.lowering import build_callable
from ..ops.standard import segment_reduce
from ..runtime import faults as _flt
from ..runtime.executor import Executor, default_executor
from ..runtime.faults import maybe_check_numerics
from ..runtime.scheduler import device_label
from ..utils import telemetry as _tele
from ..utils.profiling import count as _count
from .mesh import Mesh

__all__ = ["map_blocks", "map_rows", "reduce_blocks", "reduce_rows", "aggregate"]


def _mesh_sig(mesh: Mesh) -> str:
    """The mesh's device identity for cache keys: its shape and every
    device's label. Two meshes of one size over other devices never share
    an executor entry."""
    shape = "x".join(str(int(n)) for n in mesh.devices.shape)
    return f"{shape}@{','.join(device_label(d) for d in mesh.devices.flat)}"


def _mesh_call(name: str, program, rows: int, shards: int, fn: Callable, device):
    """One mesh dispatch, ``fn()``: a ``verb`` span (and ``name.calls`` /
    ``.seconds`` / ``.rows`` counters) around a ``dispatch`` span labeled
    with the program and the shard count, through a fault scope (transient
    errors retry with backoff; no OOM split)."""

    def thunk():
        t0 = time.perf_counter()
        try:
            with _tele.span(name, kind="verb", rows=rows), _tele.dispatch_span(
                name, program=program, rows=rows, shards=shards, torch_device=device
            ):
                return fn()
        finally:
            _tele.counter_inc(f"{name}.calls")
            _tele.counter_inc(f"{name}.seconds", time.perf_counter() - t0)
            _tele.counter_inc(f"{name}.rows", float(rows))

    return _flt.scope(name).dispatch(thunk, what=name)


def _shards(nrows: int, ndev: int) -> Tuple[int, List[Tuple[int, int]], Tuple[int, int]]:
    """``(s, shard row ranges, tail row range)``: ``ndev`` shards of
    ``nrows // ndev`` rows, then the remainder."""
    s = nrows // ndev
    return s, [(d * s, (d + 1) * s) for d in range(ndev)], (s * ndev, nrows)


def _concat_on(parts: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    return _api._concat([p.to(dev) for p in parts])


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------


def map_blocks(
    fetches,
    frame: TensorFrame,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    trim: bool = False,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    bindings=None,
) -> TensorFrame:
    """`map_blocks` with one block a device, the remainder as one more
    block. A trimmed map keeps each shard's output rows as one block.
    Bound placeholders are copied to every device."""
    bindings = _api._normalize_bindings(bindings)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        return _fn_mesh(fetches, frame, mesh, trim, bindings, per_row=False)
    ex = executor or default_executor()
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    summary, mapping = _api._prepare(graph, fetch_list, frame, feed_dict, True, bindings)
    _api._require_dense(frame, list(mapping.values()), "map_blocks")
    feed_names = sorted(summary.inputs)
    devs = mesh.device_list()
    dev0 = devs[0]
    kind = f"shmap-{_mesh_sig(mesh)}"
    fns = [
        ex.cached(kind, graph, fetch_list, feed_names, d,
                  lambda dd: build_callable(graph, fetch_list, feed_names, dd))
        for d in devs
    ]
    bound = [_api._bound_tensors(bindings, d) for d in devs]
    bases = [base_name(f) for f in fetch_list]
    fp = graph.fingerprint()
    s, ranges, (tlo, thi) = _shards(frame.nrows, len(devs))

    def feeds(lo, hi, d):
        return _api._feeds(frame, mapping, feed_names, lo, hi, devs[d], bound[d])

    acc: Dict[str, List[torch.Tensor]] = {b: [] for b in bases}
    block_sizes: List[int] = []

    def collect(outs, rows, what):
        maybe_check_numerics(fetch_list, outs, what)
        named = dict(zip(bases, outs))
        block_sizes.append(_api._block_rows(named, rows, trim))
        for b, o in named.items():
            acc[b].append(o)

    if s > 0:
        shard_outs = _mesh_call(
            "mesh.map_blocks", fp, s * len(devs), len(devs),
            lambda: [fns[d](*feeds(lo, hi, d)) for d, (lo, hi) in enumerate(ranges)], dev0,
        )
        for d, outs in enumerate(shard_outs):
            collect(outs, s, f"map_blocks (mesh shard {d})")
    if thi > tlo:
        tfn = ex.callable_for(graph, fetch_list, feed_names, dev0)
        outs = _mesh_call(
            "mesh.map_blocks.tail", fp, thi - tlo, 1, lambda: tfn(*feeds(tlo, thi, 0)), dev0
        )
        collect(outs, thi - tlo, "map_blocks (mesh tail)")
    out_cols = [
        Column(b, _concat_on(acc[b], dev0) if acc[b] else _api._empty_output(summary, b, True, dev0))
        for b in bases
    ]
    offsets = list(np.cumsum([0] + block_sizes)) if trim else frame.offsets
    return _api._output_frame(frame, out_cols, append_input=not trim, offsets=offsets)


# ---------------------------------------------------------------------------
# map_rows
# ---------------------------------------------------------------------------


def _ragged_per_shard(runs, columns: Sequence[Column], nrows: int, devs, out_names=None):
    """The shape-bucket plan per shard: the rows split into ``len(devs)``
    contiguous shards, each bucketed and run (``runs[d](feeds, rows)``) on
    its device; the outputs go back in row order on the first device.
    Counted as the local verb's (``map_rows.plan.ragged``,
    ``map_rows.ragged.buckets``)."""
    from .. import fn_frontend as _fnf

    bounds = np.linspace(0, nrows, len(devs) + 1).astype(int)
    chunks: Dict[str, List] = {}
    buckets_run = 0
    for d, dev in enumerate(devs):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        if lo == hi:
            continue
        shard_cols = [c.slice(lo, hi) for c in columns]
        buckets = _fnf._bucket_rows(shard_cols, hi - lo)
        buckets_run += len(buckets)
        for name, pairs in _fnf._run_buckets(runs[d], shard_cols, buckets, dev, out_names).items():
            chunks.setdefault(name, []).extend((idx + lo, o.to(devs[0])) for idx, o in pairs)
    _count("map_rows.plan.ragged")
    _count("map_rows.ragged.buckets", buckets_run)
    return _fnf._assemble_ragged(chunks, nrows)


def map_rows(
    fetches,
    frame: TensorFrame,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    bindings=None,
) -> TensorFrame:
    """`map_rows` with the rows sharded across the mesh: each shard runs
    the local verb's plan (`api._row_plan_kind`: vmap, lifted or per-row)
    built for its device, the remainder on the first device through the
    local verb's own program. Ragged columns run the bucket plan per shard.
    Bound placeholders are copied to every device."""
    bindings = _api._normalize_bindings(bindings)
    if callable(fetches) and not isinstance(fetches, dsl.Tensor):
        return _fn_mesh(fetches, frame, mesh, False, bindings, per_row=True)
    ex = executor or default_executor()
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    summary, mapping = _api._prepare(graph, fetch_list, frame, feed_dict, False, bindings)
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
    devs = mesh.device_list()
    dev0 = devs[0]
    plan = _api._row_plan_kind(graph, fetch_list, feed_names, summary, bindings)
    _count(f"map_rows.plan.{plan}")
    prefix = f"shmap-rows-{_mesh_sig(mesh)}-"
    runs = [
        _api._row_runner(plan, ex, graph, fetch_list, feed_names, summary, bindings, d, prefix)
        for d in devs
    ]
    out_names = [base_name(f) for f in fetch_list]
    if not dense:
        per_out = _ragged_per_shard(
            runs, [frame.column(mapping[n]) for n in feed_names], frame.nrows, devs, out_names
        )
        out_cols = [
            per_out[n] if n in per_out else Column(n, _api._empty_output(summary, n, False, dev0))
            for n in out_names
        ]
        return _api._output_frame(frame, out_cols, append_input=True)
    bound = [_api._bound_tensors(bindings, d) for d in devs]
    fp = graph.fingerprint()
    s, ranges, (tlo, thi) = _shards(frame.nrows, len(devs))

    def feeds(lo, hi, d):
        return _api._feeds(frame, mapping, feed_names, lo, hi, devs[d], bound[d])

    acc: Dict[str, List[torch.Tensor]] = {n: [] for n in out_names}
    parts = []
    if s > 0:
        shard_outs = _mesh_call(
            "mesh.map_rows", fp, s * len(devs), len(devs),
            lambda: [runs[d](feeds(lo, hi, d), hi - lo) for d, (lo, hi) in enumerate(ranges)],
            dev0,
        )
        parts += [(outs, f"map_rows (mesh shard {d})") for d, outs in enumerate(shard_outs)]
    if thi > tlo:
        # the tail runs the local verb's program on the first device
        tail = _api._row_runner(plan, ex, graph, fetch_list, feed_names, summary, bindings, dev0)
        outs = _mesh_call(
            "mesh.map_rows.tail", fp, thi - tlo, 1, lambda: tail(feeds(tlo, thi, 0), thi - tlo),
            dev0,
        )
        parts.append((outs, "map_rows (mesh tail)"))
    for outs, what in parts:
        maybe_check_numerics(out_names, outs, what)
        for n, o in zip(out_names, outs):
            acc[n].append(o)
    out_cols = [
        Column(n, _concat_on(ps, dev0) if ps else _api._empty_output(summary, n, False, dev0))
        for n, ps in acc.items()
    ]
    return _api._output_frame(frame, out_cols, append_input=True)


# ---------------------------------------------------------------------------
# the function front end
# ---------------------------------------------------------------------------


def _fn_mesh(fn, frame: TensorFrame, mesh: Mesh, trim: bool, bindings: Dict, per_row: bool):
    """The function front end of the mesh map verbs: the local verbs'
    checks (`fn_frontend`), the empty-dict check included, with the dense
    rows sharded across the mesh (each shard's call on its device, the
    remainder on the first) and ragged rows bucketed per shard."""
    from .. import fn_frontend as _fnf

    verb = "map_rows" if per_row else "map_blocks"
    params = _fnf._fn_feed_columns(fn, frame, bindings)
    col_params = [p for p in params if p not in bindings]

    def wrapped(*cells):
        return _fnf._fn_outputs_to_dict(fn(*cells), verb)

    dense = all(frame.column(p).is_dense for p in col_params)
    devs = mesh.device_list()
    dev0 = devs[0]
    if per_row:
        if bindings and not col_params:
            raise ValueError(
                f"{verb}: every parameter is bound, so nothing varies per "
                "row; use map_blocks (or call the function directly)"
            )
        if bindings and not dense:
            raise ValueError(
                f"{verb}: bindings are not supported with ragged feed "
                "columns; densify the columns or bake the values as constants"
            )
        call = torch.func.vmap(wrapped, in_dims=tuple(None if p in bindings else 0 for p in params))
        if not dense and frame.nrows:
            runs = [lambda feeds, rows: call(*feeds)] * len(devs)
            per_out = _ragged_per_shard(runs, [frame.column(p) for p in params], frame.nrows, devs)
            return _api._output_frame(frame, list(per_out.values()), append_input=True)
    else:
        _api._require_dense(frame, col_params, verb)
        call = wrapped
    bound = [_api._bound_tensors(bindings, d) for d in devs]
    ident = _fnf._identity(params)
    s, ranges, (tlo, thi) = _shards(frame.nrows, len(devs))

    def feeds(lo, hi, d):
        return _api._feeds(frame, ident, params, lo, hi, devs[d], bound[d])

    acc: Dict[str, List[torch.Tensor]] = {}
    block_sizes: List[int] = []

    def collect(outs: Dict[str, torch.Tensor], rows: int):
        block_sizes.append(rows if per_row else _api._block_rows(outs, rows, trim))
        for name, o in outs.items():
            acc.setdefault(name, []).append(o)

    if s > 0:
        shard_outs = _mesh_call(
            f"mesh.{verb}.fn", None, s * len(devs), len(devs),
            lambda: [call(*feeds(lo, hi, d)) for d, (lo, hi) in enumerate(ranges)], dev0,
        )
        for outs in shard_outs:
            collect(outs, s)
    if thi > tlo:
        collect(
            _mesh_call(f"mesh.{verb}.fn.tail", None, thi - tlo, 1,
                       lambda: call(*feeds(tlo, thi, 0)), dev0),
            thi - tlo,
        )
    if not acc:  # zero rows: names and dtypes from one call on the meta device
        empties = _fnf._empty_fn_outputs(call, frame, params, bound[0], dev0, rows=int(per_row))
        acc = {n: [v] for n, v in empties.items()}
    out_cols = [Column(n, _concat_on(ps, dev0)) for n, ps in acc.items()]
    offsets = list(np.cumsum([0] + block_sizes)) if trim else frame.offsets
    return _api._output_frame(frame, out_cols, append_input=not trim, offsets=offsets)


# ---------------------------------------------------------------------------
# reduce_blocks / reduce_rows
# ---------------------------------------------------------------------------


def reduce_blocks(
    fetches,
    frame: TensorFrame,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
):
    """Each shard reduces its rows on its device; the partials are
    gathered to the first device and reduced once more by the same graph.
    The remainder's partial joins a last combine."""
    ex = executor or default_executor()
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    summary, mapping = _api._prepare(
        graph, fetch_list, frame, feed_dict, True, validate=_api._validate_reduce_blocks
    )
    _api._require_dense(frame, list(mapping.values()), "reduce_blocks")
    feed_names = sorted(summary.inputs)
    # the partial of fetch feed_src[j] re-feeds feed_names[j]
    fetch_of_feed = {base_name(f) + "_input": i for i, f in enumerate(fetch_list)}
    feed_src = [fetch_of_feed[n] for n in feed_names]
    devs = mesh.device_list()
    dev0 = devs[0]
    kind = f"shred-{_mesh_sig(mesh)}"
    fns = [
        ex.cached(kind, graph, fetch_list, feed_names, d,
                  lambda dd: build_callable(graph, fetch_list, feed_names, dd))
        for d in devs
    ]
    fp = graph.fingerprint()
    s, ranges, (tlo, thi) = _shards(frame.nrows, len(devs))

    def feeds(lo, hi, d):
        return _api._feeds(frame, mapping, feed_names, lo, hi, devs[d])

    def gather_and_combine(fn, parts):
        stacked = [torch.stack([p[i].to(dev0) for p in parts]) for i in feed_src]
        return tuple(fn(*stacked))

    partials: List[Tuple] = []
    if s > 0:
        partials.append(_mesh_call(
            "mesh.reduce_blocks", fp, s * len(devs), len(devs),
            lambda: gather_and_combine(
                fns[0], [fns[d](*feeds(lo, hi, d)) for d, (lo, hi) in enumerate(ranges)]
            ),
            dev0,
        ))
    tfn = ex.callable_for(graph, fetch_list, feed_names, dev0)
    if thi > tlo:
        partials.append(tuple(_mesh_call(
            "mesh.reduce_blocks.tail", fp, thi - tlo, 1, lambda: tfn(*feeds(tlo, thi, 0)), dev0
        )))
    if not partials:
        raise ValueError("reduce_blocks on an empty frame")
    final = partials[0] if len(partials) == 1 else gather_and_combine(tfn, partials)
    maybe_check_numerics(fetch_list, final, "reduce_blocks (mesh)")
    return _api._results([base_name(f) for f in fetch_list], final)


def reduce_rows(
    fetches,
    frame: TensorFrame,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
):
    """Each shard folds its rows in order on its device (the monoid or the
    general plan of the local verb); the shard partials are gathered to the
    first device and folded in shard order, then the remainder's partial."""
    ex = executor or default_executor()
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    summary, mapping = _api._prepare(
        graph, fetch_list, frame, feed_dict, False, validate=_api._validate_reduce_rows
    )
    _api._require_dense(frame, list(mapping.values()), "reduce_rows")
    bases = [base_name(f) for f in fetch_list]
    cols = _api._fold_columns(mapping, bases)
    monoid = _api._monoid_reductions(graph, bases, summary)
    _count("reduce_rows.plan.monoid" if monoid else "reduce_rows.plan.general")
    devs = mesh.device_list()
    dev0 = devs[0]
    pair_feeds = _api._pair_feeds(bases)
    kind = f"shfold-{_mesh_sig(mesh)}"
    pairs = [
        None if monoid else ex.cached(
            kind, graph, fetch_list, pair_feeds, d,
            lambda dd: build_callable(graph, fetch_list, pair_feeds, dd),
        )
        for d in devs
    ]
    fp = graph.fingerprint()
    s, ranges, (tlo, thi) = _shards(frame.nrows, len(devs))

    def rows(lo, hi, dev):
        return [as_tensor(frame.column(c).values[lo:hi], dev) for c in cols]

    def fold_shards():
        parts = [
            _api._fold(rows(lo, hi, devs[d]), monoid, pairs[d]) for d, (lo, hi) in enumerate(ranges)
        ]
        stacked = [torch.stack([p[i].to(dev0) for p in parts]) for i in range(len(bases))]
        return _api._fold(stacked, monoid, pairs[0])

    partials: List[Tuple] = []
    if s > 0:
        partials.append(_mesh_call("mesh.reduce_rows", fp, s * len(devs), len(devs), fold_shards, dev0))
    pair0 = None if monoid else ex.callable_for(graph, fetch_list, pair_feeds, dev0)
    if thi > tlo:
        partials.append(_mesh_call(
            "mesh.reduce_rows.tail", fp, thi - tlo, 1,
            lambda: _api._fold(rows(tlo, thi, dev0), monoid, pair0), dev0,
        ))
    if not partials:
        raise ValueError("reduce_rows on an empty frame")
    final = partials[0]
    if len(partials) > 1:
        final = _api._fold(
            [torch.stack([p[i].to(dev0) for p in partials]) for i in range(len(bases))],
            monoid, pair0,
        )
    maybe_check_numerics(bases, final, "reduce_rows (mesh)")
    return _api._results(bases, final)


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------


_COMBINE = {"sum": torch.add, "mean": torch.add, "min": torch.minimum,
            "max": torch.maximum, "prod": torch.mul}


def aggregate(
    fetches,
    grouped,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
) -> TensorFrame:
    """Keyed aggregation over the mesh. A graph `aggregate._chunk_combiners`
    classifies (Sum / Min / Max / Prod / float Mean over axis 0 of a
    row-local transform of its placeholder) runs the local segment plan
    (`aggregate._aggregate_segment`) once a shard on its device, and once
    more over the remainder on the first device: the row-wise transform,
    then one segment reduce a fetch over the global group ids. The tables
    combine on the first device in shard order by each fetch's monoid (an
    empty group's entry is the monoid's identity); a mean is the summed
    tables over the group counts. No sort, and exact for every graph the
    chunk plan would take. Any other graph takes the exact plan on the
    mesh's first device (counted ``aggregate.plan.exact``). The mesh has
    this one plan for classified graphs, whatever
    ``config.aggregate_segment_fast`` says: cross-shard sums are summed in
    another order than the exact plan's anyway."""
    ex = executor or default_executor()
    frame = grouped.frame
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    devs = mesh.device_list()
    dev0 = devs[0]
    summary, mapping = _api._prepare(
        graph, fetch_list, frame, feed_dict, True, validate=_api._validate_reduce_blocks
    )
    combiners = _chunk_combiners(graph, fetch_list, summary)
    if combiners is None:
        return _api.aggregate(
            graph, grouped, feed_dict, fetch_names=fetch_list, executor=executor, device=dev0
        )
    _api._require_dense(frame, list(mapping.values()), "aggregate")
    key_out, gid, num_groups = _factorized(grouped, dev0)
    feed_names = sorted(summary.inputs)
    bases = [base_name(f) for f in fetch_list]
    if num_groups == 0:  # empty frame: zero-row outputs from the analysis
        empty = {b: _api._empty_output(summary, b, False, dev0) for b in bases}
        return _keyed_output(key_out, empty, bases)
    # the data operand of each root reduce = the row-wise transform output
    roots = [graph[b].data_inputs()[0][0] for b in bases]
    kind = f"shseg-{_mesh_sig(mesh)}"
    transforms = [
        ex.cached(kind, graph, roots, feed_names, d,
                  lambda dd: build_callable(graph, roots, feed_names, dd))
        for d in devs
    ]
    cols = [mapping[n] for n in feed_names]
    ops = [_SEGMENT_OF.get(combiners[b], "sum") for b in bases]
    _, ranges, tail = _shards(frame.nrows, len(devs))
    parts = [(lo, hi, d) for d, (lo, hi) in enumerate(ranges) if hi > lo]
    if tail[1] > tail[0]:
        parts.append((tail[0], tail[1], 0))

    def tables(lo, hi, d):
        g = gid[lo:hi].to(devs[d])
        # a column fed to several placeholders crosses to the device once
        moved = {c: as_tensor(frame.column(c).values[lo:hi], devs[d]) for c in set(cols)}
        outs = transforms[d](*[moved[c] for c in cols])
        return [segment_reduce(o, g, num_groups, op) for o, op in zip(outs, ops)]

    def combined():
        per_part = [tables(*p) for p in parts]  # every part issued before any combine
        acc = [t.to(dev0) for t in per_part[0]]
        for tabs in per_part[1:]:
            acc = [_COMBINE[combiners[b]](a, t.to(dev0)) for b, a, t in zip(bases, acc, tabs)]
        if "mean" in combiners.values():
            counts = torch.bincount(gid, minlength=num_groups)
            acc = [
                a / counts.to(a.dtype).reshape((-1,) + (1,) * (a.dim() - 1))
                if combiners[b] == "mean" else a
                for b, a in zip(bases, acc)
            ]
        return acc

    acc = _mesh_call(
        "mesh.aggregate.segment", graph.fingerprint(), frame.nrows, len(devs), combined, dev0
    )
    maybe_check_numerics(bases, acc, "aggregate (mesh segment plan)")
    return _keyed_output(key_out, dict(zip(bases, acc)), bases)
