"""Mesh verbs: the five operations over a device mesh (``mesh=`` on the verbs).

The PyTorch counterpart of `tensorframes_tpu/parallel/verbs.py`, with its
topology. A mesh is one placement of the verbs' one block loop
(`api._Place`): the rows split into ``ndev`` equal shards, shard i on mesh
device i, and the rows the device count does not divide (``nrows % ndev``)
run as one extra item on the first device (block boundaries are arbitrary
in the reference too). Each item runs the verb's program built for its
device; outputs and partials converge on the mesh's first device, where a
reduce combines its partials once (JAX's ``all_gather`` and final apply)
and a fold folds them in shard order. Eager PyTorch issues every shard's
work before any result is read, so the cards run at once.

What is the mesh's own (`_mesh_call`, `_mesh_sig`): every shard dispatches
in one ``mesh.<verb>`` call (the tail in ``mesh.<verb>.tail``), a ``verb``
span with ``.calls`` / ``.seconds`` / ``.rows`` counters around a
``dispatch`` span labeled with the program and the shard count, with
classified transient retries; a resource error surfaces as it is (halving
the rows would change the shard layout, and the mesh owns the placement).
The executor's cache keys name the mesh's devices (``shmap-`` / ``shred-`` /
``shfold-`` / ``shmap-rows-`` + `_mesh_sig`). Ragged ``map_rows`` runs the
shape-bucket plan per shard (`_ragged_per_shard`).

``aggregate`` keeps its one mesh plan: a graph `aggregate._chunk_combiners`
classifies takes a segment table a fetch per shard, combined across shards
in shard order by the fetch's monoid (JAX's ``psum`` for a sum); any other
graph takes the exact plan on the first device. The JAX package runs a
classified graph that is not a bare lead-axis sum through its chunk plan
with each chunk call split across the mesh; here the segment tables give
the same results with no sort (the chunk route measured 7-13x slower than
the local segment plan on an H100).

Left out: the mesh shape bucketing of the JAX package (`_bucketed_or_split`,
`shape_policy.pad_mesh_shards`), as the rest of `shape_policy`'s bucketing
(eager PyTorch compiles nothing per shape).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import api as _api
from ..aggregate import (
    _chunk_combiners,
    _factorized,
    _keyed_output,
    _per_count,
    _segment_tables,
)
from ..frame import Column, TensorFrame, as_tensor
from ..graph.ir import base_name
from ..ops.lowering import build_callable
from ..runtime import faults as _flt
from ..runtime.executor import Executor, default_executor
from ..runtime.faults import maybe_check_numerics
from ..runtime.scheduler import device_label
from ..utils import telemetry as _tele
from ..utils.profiling import count as _count
from ..utils.profiling import record as _record
from .mesh import Mesh

__all__ = ["map_blocks", "map_rows", "reduce_blocks", "reduce_rows", "aggregate"]


def _mesh_sig(mesh: Mesh) -> str:
    """The mesh's device identity for cache keys: its shape and every
    device's label (prefixed by its rank on a mesh over several
    processes). Two meshes of one size over other devices never share an
    executor entry."""
    shape = "x".join(str(int(n)) for n in mesh.devices.shape)
    labels = [device_label(d) for d in mesh.devices.flat]
    if mesh.process_count > 1:
        labels = [f"r{r}/{lab}" for r, lab in zip(mesh.ranks.flat, labels)]
    return f"{shape}@{','.join(labels)}"


def _mesh_call(name: str, program, rows: int, shards: int, fn: Callable, device, **attrs):
    """One mesh dispatch, ``fn()``: a `utils.profiling.record` span (a
    ``verb`` span, ``name.calls`` / ``.seconds`` / ``.rows`` counters and
    the ``verb_seconds`` histogram) around a ``dispatch`` span labeled with
    the program, the shard count and ``attrs``, through a fault scope
    (transient errors retry with backoff; no OOM split). ``fn`` runs this
    process's shards only: a retry never re-enters a collective, which
    would hang the processes that moved on."""

    def thunk():
        with _record(name, rows), _tele.dispatch_span(
            name, program=program, rows=rows, shards=shards, torch_device=device, **attrs
        ):
            return fn()

    return _flt.scope(name).dispatch(thunk, what=name)


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


# ---------------------------------------------------------------------------
# the verbs: the local verbs' loop over the mesh's placement
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
    """`map_blocks` with one shard a device, the remainder as one more
    item; a trimmed map keeps each item's output rows as one block;
    bindings are copied to every device."""
    return _api.map_blocks(
        fetches, frame, feed_dict, trim, fetch_names, executor, bindings, mesh=mesh
    )


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
    the local verb's plan built for its device."""
    return _api.map_rows(fetches, frame, feed_dict, fetch_names, executor, bindings, mesh=mesh)


def reduce_blocks(
    fetches,
    frame: TensorFrame,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
):
    """Each shard reduces its rows on its device; the partials are
    gathered to the first device and reduced once more by the graph."""
    return _api.reduce_blocks(fetches, frame, feed_dict, fetch_names, executor, mesh=mesh)


def reduce_rows(
    fetches,
    frame: TensorFrame,
    mesh: Mesh,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
):
    """Each shard folds its rows in order on its device; the partials fold
    on the first device in shard order, the remainder's last."""
    return _api.reduce_rows(fetches, frame, feed_dict, fetch_names, executor, mesh=mesh)


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
    then the tables over the global group ids (`aggregate._segment_tables`:
    one keyed-sums launch for the sum and mean fetches, with the group
    counts, where the kernel takes them, else a segment sum each, and a
    segment reduce for each other fetch; one launch on the shard's columns,
    and no transform, where `aggregate._column_loads` reads them off the
    fed columns). The tables
    combine on the first device in shard order by each fetch's monoid (an
    empty group's entry is the monoid's identity); a mean is the summed
    tables over the group counts (the kernel's, summed over the parts, else
    one `bincount` of all the ids). No sort, and exact for every graph the
    chunk plan would take. Any other graph takes the exact plan on the
    mesh's first device (counted ``aggregate.plan.exact``). The mesh has
    this one plan for classified graphs, whatever
    ``config.aggregate_segment_fast`` says: cross-shard sums are summed in
    another order than the exact plan's anyway."""
    if mesh.process_count > 1:
        raise ValueError(
            f"aggregate over a mesh of {mesh.process_count} processes: aggregate each "
            "process's rows with parallel.multihost.aggregate_global"
        )
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
    _, ranges, tail = _api._shards(frame.nrows, len(devs))
    parts = [(lo, hi, d) for d, (lo, hi) in enumerate(ranges) if hi > lo]
    if tail[1] > tail[0]:
        parts.append((tail[0], tail[1], 0))

    def tables(lo, hi, d):
        g = gid[lo:hi].to(devs[d])
        # a column fed to several placeholders crosses to the device once
        moved = {c: as_tensor(frame.column(c).values[lo:hi], devs[d]) for c in set(cols)}
        return _segment_tables(graph, bases, combiners, mapping, moved,
                               lambda: transforms[d](*[moved[c] for c in cols]), g, num_groups,
                               False)

    def combined():
        per_part = [tables(*p) for p in parts]  # every part issued before any combine
        acc = [t.to(dev0) for t in per_part[0][0]]
        for tabs, _ in per_part[1:]:
            acc = [_COMBINE[combiners[b]](a, t.to(dev0)) for b, a, t in zip(bases, acc, tabs)]
        if "mean" not in combiners.values():
            return acc
        # the kernel's counts a part where it ran, else one bincount of all ids
        part_counts = [c for _, c in per_part]
        if all(c is not None for c in part_counts):
            counts = sum(c.to(dev0) for c in part_counts)
        else:
            counts = torch.bincount(gid, minlength=num_groups)
        return [_per_count(a, counts) if combiners[b] == "mean" else a for b, a in zip(bases, acc)]

    acc = _mesh_call(
        "mesh.aggregate.segment", graph.fingerprint(), frame.nrows, len(devs), combined, dev0
    )
    maybe_check_numerics(bases, acc, "aggregate (mesh segment plan)")
    return _keyed_output(key_out, dict(zip(bases, acc)), bases)
