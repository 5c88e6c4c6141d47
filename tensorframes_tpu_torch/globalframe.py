"""GlobalFrame: a frame whose columns already sit on their cards, one shard a
card.

The PyTorch counterpart of `tensorframes_tpu/globalframe.py`. The block
scheduler and ``mesh=`` both start from a frame on one device (or the
host), so every verb first copies its shards out to the cards; a
`GlobalFrame` keeps them there between verbs:

- Each dense column is one shard tensor per device of a 1-D ``data`` mesh
  (`parallel.data_mesh`) over the healthy devices
  (`scheduler.global_device_set`, shrinking loudly when a circuit is
  open). The rows pad to a multiple of the shard count by replicating the
  last row (JAX's rule with ``shape_bucketing`` off, `_padded_rows_for`;
  the port has no bucketing); ``nrows`` is the truth, and `to_frame` /
  `collect` drop the pad rows.
- ``map_blocks`` / ``map_rows`` of row-local graphs run one call a shard,
  on the shard's card, in one dispatch (span ``<verb>.global``,
  ``sharding=data:N``), and their outputs STAY sharded: a chained map
  never leaves its cards.
- Classified reduces (`aggregate._chunk_combiners` monoids over row-local
  transforms) run once a shard over the shard's valid rows, and the
  partials fold on the anchor (the first device) as an OOM split's halves
  do (`api._reduce_split`: each fetch's monoid, a mean weighed by rows): min,
  max and integer sums equal the block path's, float sums and means carry
  the usual reassociation tolerance.
- Everything else falls back to the eager verb over `to_frame()`, counted
  in `state()` under JAX's reasons: ``not-row-local``,
  ``unclassified-reduce``, ``fn-frontend``, ``bindings``,
  ``bytes-passthrough``, ``executor``. ``trim`` raises. ``reduce_rows``
  and keyed ``aggregate`` take the local path by contract.
- A GlobalFrame owns its placement: ``mesh=``, ``devices=`` and a
  ``device=`` other than its anchor raise on its verbs.

Every dispatch here is the verbs' one block loop (`api._loop` over an
`api._Place`, `_shard_loop`) with the items already placed: shard i lives
on mesh device i, and the loop's mesh dispatch issues every shard in one
span with the mesh's retries.

Routing: under ``config.block_scheduler = "global"`` eligible verbs on
plain frames of at least ``config.global_frame_min_rows`` rows shard the
columns they read and run here (`maybe_map_blocks`, `maybe_map_rows`,
`maybe_reduce_blocks`); smaller frames and ineligible graphs take
per-block scheduling. `force_fused_global` / `fused_reduce_global` are the
lazy plans' routes, `filter_global` the relational filter's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import api as _api  # late-bound: api imports this module in verb bodies
from . import config as _config
from .frame import Column, TensorFrame, as_tensor
from .graph.ir import base_name as _base
from .schema import ColumnInfo, FrameInfo, ScalarType
from .shape_policy import rowwise_fetches

__all__ = ["GlobalFrame", "resolve_global_mesh", "state", "reset_state"]


# ---------------------------------------------------------------------------
# accounting (the diagnostics section)
# ---------------------------------------------------------------------------

_state_lock = threading.Lock()
_stats: Dict = {
    "frames": 0,          # GlobalFrames built (to_global / auto-route)
    "dispatches": 0,      # global dispatches (one a verb, all shards)
    "collectives": 0,     # cross-shard combines (one a reduce fetch)
    "pad_rows": 0,        # rows padded onto shards
    "fallbacks": {},      # reason -> count
    "last_shards": None,  # shard count of the newest frame
    "stream_folds": 0,    # double-buffered accumulator folds of streams
}


def _note_frame(shards: int, pad_rows: int) -> None:
    from .utils import telemetry as _tele

    with _state_lock:
        _stats["frames"] += 1
        _stats["pad_rows"] += int(pad_rows)
        _stats["last_shards"] = int(shards)
    if pad_rows:
        _tele.counter_inc("global_pad_rows", float(pad_rows))


def _note_dispatch(verb: str, collectives: int = 0) -> None:
    from .utils import telemetry as _tele

    with _state_lock:
        _stats["dispatches"] += 1
        _stats["collectives"] += int(collectives)
    _tele.counter_inc("global_dispatches", 1.0, verb=verb)
    if collectives:
        _tele.counter_inc("global_collectives", float(collectives))


def _note_stream_fold() -> None:
    """One fold of a global stream's double-buffered accumulator."""
    from .utils import telemetry as _tele

    with _state_lock:
        _stats["stream_folds"] += 1
    _tele.counter_inc("global_stream_folds", 1.0)


def _note_fallback(reason: str) -> None:
    from .utils import telemetry as _tele

    with _state_lock:
        _stats["fallbacks"][reason] = _stats["fallbacks"].get(reason, 0) + 1
    _tele.counter_inc("global_fallbacks", 1.0, reason=reason)


_route_tls = threading.local()


@contextlib.contextmanager
def _suppress_route():
    """A fallback re-enters the verb layer over `to_frame()`; under
    ``block_scheduler="global"`` the auto-route must not probe (and count
    a second fallback for) the very dispatch that is the fallback."""
    prev = getattr(_route_tls, "suppressed", False)
    _route_tls.suppressed = True
    try:
        yield
    finally:
        _route_tls.suppressed = prev


def state() -> Dict:
    """Shard count, dispatch and combine counts, pad rows, fallback
    reasons (`tft.diagnostics()`'s ``globalframe`` section)."""
    with _state_lock:
        return {
            "frames": _stats["frames"],
            "dispatches": _stats["dispatches"],
            "collectives": _stats["collectives"],
            "pad_rows": _stats["pad_rows"],
            "fallbacks": dict(_stats["fallbacks"]),
            "shards": _stats["last_shards"],
            "stream_folds": _stats["stream_folds"],
        }


def reset_state() -> None:
    with _state_lock:
        _stats.update(
            frames=0, dispatches=0, collectives=0, pad_rows=0,
            fallbacks={}, last_shards=None, stream_folds=0,
        )
        _stats.pop("_mesh_cache", None)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def resolve_global_mesh():
    """The data mesh a new `GlobalFrame` shards over: every healthy local
    device (`scheduler.global_device_set`), memoized on their labels."""
    from .parallel.mesh import data_mesh
    from .runtime import scheduler as _rs

    devs = _rs.global_device_set()
    key = tuple(_rs.device_label(d) for d in devs)
    with _state_lock:
        cached = _stats.get("_mesh_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
    mesh = data_mesh(devices=devs)
    with _state_lock:
        _stats["_mesh_cache"] = (key, mesh)
    return mesh


def _padded_rows_for(nrows: int, ndata: int) -> int:
    """Rows after padding ``nrows`` to a multiple of ``ndata`` shards."""
    return -(-nrows // ndata) * ndata


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------


class GlobalFrame:
    """A frame whose dense columns are one shard tensor per mesh device.

    Logically ONE block (``num_blocks == 1``); ``padded_rows = data_size x
    shard_rows`` is an execution detail, ``nrows`` the truth. Build it with
    `TensorFrame.to_global()` or `GlobalFrame.from_frame`; the verbs take
    it like a `TensorFrame` (fluent methods below)."""

    def __init__(self, shards: Dict[str, List[torch.Tensor]], infos: Dict[str, ColumnInfo],
                 mesh, nrows: int):
        if not shards:
            raise ValueError("a GlobalFrame needs at least one column")
        self.mesh = mesh
        self.devices = mesh.device_list()
        self.data_size = len(self.devices)
        self._shards = dict(shards)
        self._infos = dict(infos)
        self.nrows = int(nrows)
        rows = {int(s[0].shape[0]) for s in self._shards.values()}
        if len(rows) != 1 or any(len(s) != self.data_size for s in self._shards.values()):
            raise ValueError("every column needs one shard a device, all of one row count")
        self.shard_rows = rows.pop()
        self.padded_rows = self.shard_rows * self.data_size
        if self.padded_rows < self.nrows:
            raise ValueError(f"{self.padded_rows} shard rows cannot hold {self.nrows} rows")
        self._local: Optional[TensorFrame] = None

    @property
    def anchor(self) -> torch.device:
        """Where results converge: the mesh's first device."""
        return self.devices[0]

    # -- construction ---------------------------------------------------
    @classmethod
    def from_frame(cls, frame: TensorFrame, mesh=None,
                   columns: Optional[Sequence[str]] = None) -> "GlobalFrame":
        """Shard ``frame``'s dense columns over the mesh (default
        `resolve_global_mesh`): shard i, rows ``[i*s, (i+1)*s)``, copied to
        mesh device i; the last row fills the pad rows. Ragged, bytes and
        empty frames are refused. ``columns`` restricts the conversion."""
        if isinstance(frame, GlobalFrame):
            return frame
        if frame.nrows == 0:
            raise ValueError("to_global on an empty frame")
        if mesh is None:
            mesh = resolve_global_mesh()
        if "data" not in mesh.shape:
            raise ValueError("to_global needs a mesh with a 'data' axis")
        mesh.require_one_process("a GlobalFrame")
        names = list(columns) if columns is not None else frame.columns
        for n in names:
            c = frame.column(n)
            if not c.is_dense or c.dtype is ScalarType.string:
                raise ValueError(
                    f"to_global: column {n!r} is "
                    f"{'ragged' if not c.is_dense else 'a bytes column'}; "
                    "global frames hold dense device-shardable columns "
                    "only — select() the dense columns or use the "
                    "per-block path"
                )
        from .utils import telemetry as _tele

        devs = mesh.device_list()
        n = frame.nrows
        padded = _padded_rows_for(n, len(devs))
        per = padded // len(devs)
        shards: Dict[str, List[torch.Tensor]] = {}
        infos: Dict[str, ColumnInfo] = {}
        h2d = 0
        with _tele.span("to_global", kind="transfer", sharding=f"data:{len(devs)}"):
            for name in names:
                c = frame.column(name)
                vals = c.values
                out = []
                for i, dev in enumerate(devs):
                    lo, hi = min(i * per, n), min((i + 1) * per, n)
                    part = vals[lo:hi] if hi > lo else vals[n - 1:n][:0]
                    t = as_tensor(part, dev)
                    if hi - lo < per:  # pad rows replicate the last row
                        last = as_tensor(vals[n - 1:n], dev)
                        t = torch.cat([t, last.expand((per - (hi - lo),) + tuple(last.shape[1:]))])
                    out.append(t)
                if not isinstance(vals, torch.Tensor):
                    h2d += np.asarray(vals).nbytes
                shards[name] = out
                infos[name] = c.info
        if h2d and _tele.enabled():
            _tele.histogram_observe("h2d_bytes", float(h2d))
        _note_frame(len(devs), padded - n)
        return cls(shards, infos, mesh, n)

    # -- frame-shaped surface -------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._shards)

    @property
    def info(self) -> FrameInfo:
        return FrameInfo([self._infos[n] for n in self._shards])

    def shards(self, name: str) -> List[torch.Tensor]:
        """Column ``name``'s shard tensors, shard i on mesh device i (pad
        rows included)."""
        if name not in self._shards:
            raise KeyError(f"no column {name!r}; available: {self.columns}")
        return self._shards[name]

    def column(self, name: str) -> Column:
        """The column's valid rows on the anchor (`to_frame`)."""
        self.shards(name)
        return self.to_frame().column(name)

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    @property
    def num_blocks(self) -> int:
        return 1

    @property
    def offsets(self) -> List[int]:
        return [0, self.nrows]

    def block_sizes(self) -> List[int]:
        return [self.nrows]

    @property
    def pad_rows(self) -> int:
        return self.padded_rows - self.nrows

    def valid_rows(self, i: int) -> int:
        """Rows of shard ``i`` that are not padding."""
        return max(0, min(self.shard_rows, self.nrows - i * self.shard_rows))

    def __repr__(self) -> str:
        return (
            f"GlobalFrame[{self.nrows} rows x {len(self._shards)} cols, "
            f"data:{self.data_size} sharded, {self.shard_rows} rows/shard"
            f"{f', +{self.pad_rows} pad' if self.pad_rows else ''}]"
        )

    # -- boundaries -----------------------------------------------------
    def to_frame(self) -> TensorFrame:
        """The sharded -> local boundary: one single-block `TensorFrame`
        with every column's valid rows concatenated on the anchor. The
        fallback target of every dispatch the shards cannot take.
        Memoized (the frame is immutable)."""
        if self._local is None:
            cols = []
            for name, shards in self._shards.items():
                c = Column(name, self.gather(shards))
                c.cell_shape = self._infos[name].cell_shape
                cols.append(c)
            self._local = TensorFrame(cols, [0, self.nrows])
        return self._local

    def gather(self, shards: Sequence[torch.Tensor], takes=None) -> torch.Tensor:
        """One column's valid rows concatenated on the anchor, from its
        shards (or a map's output shards); with ``takes``, shard i's row
        indices ``takes[i]`` into its valid rows."""
        parts = []
        for i, t in enumerate(shards):
            v = self.valid_rows(i)
            if v:
                t = t[:v] if takes is None else t[:v][takes[i]]
                parts.append(as_tensor(t, self.anchor))
        return _api._concat(parts)

    def collect(self):
        return self.to_frame().collect()

    def to_pandas(self):
        return self.to_frame().to_pandas()

    def host_values(self, name: str) -> np.ndarray:
        return self.to_frame().host_values(name)

    def select(self, names: Sequence[str]) -> "GlobalFrame":
        return GlobalFrame(
            {n: self.shards(n) for n in names}, {n: self._infos[n] for n in names},
            self.mesh, self.nrows,
        )

    def lazy(self):
        """A `LazyFrame` over this base: a deferred row-local chain forces
        once a shard, a classified fused reduce once a shard with one
        combine."""
        from .lazy import LazyFrame

        return LazyFrame(self, device=self.anchor)

    def print_schema(self) -> None:
        print(self.info.explain())


# ---------------------------------------------------------------------------
# the one-dispatch core
# ---------------------------------------------------------------------------


def _reject_overrides(verb: str, mesh, devices, device=None, frame=None) -> None:
    """A GlobalFrame owns its placement: per-call overrides raise rather
    than being ignored. ``device=`` passes only when it names the frame's
    anchor (a plan over the frame carries it)."""
    from .runtime.scheduler import device_label

    if mesh is not None:
        raise ValueError(
            f"{verb}: mesh= is not accepted on a GlobalFrame — the "
            "frame is already sharded over its own mesh; collect() "
            "first to re-place"
        )
    if devices is not None:
        raise ValueError(
            f"{verb}: devices= is not accepted on a GlobalFrame — the "
            "global path owns placement (the frame's data mesh); "
            "collect() first, or drop the devices= pin"
        )
    if device is not None and (
        frame is None or device_label(device) != device_label(frame.anchor)
    ):
        raise ValueError(
            f"{verb}: device= is not accepted on a GlobalFrame — its "
            "shards already sit on their cards; to_frame() first, or drop "
            "the device= pin"
        )


def _shard_loop(gf: GlobalFrame, verb: str, span_name: str, fp, cols: Sequence[str], make,
                check=None, valid_only: bool = False, collectives: int = 0) -> List:
    """Run ``make(dev)``'s program once a shard through the verbs' one block
    loop (`api._loop` over an `api._Place` whose items are the shards, shard
    i on mesh device i, with no tail): every shard issued in one
    ``span_name`` dispatch (`parallel.verbs._mesh_call`: transient retries,
    the verb's deadline at every attempt) labeled ``sharding=data:N`` with
    the padded lead as its ``bucket``. Item i addresses the padded rows
    ``[i*s, (i+1)*s)`` of the columns ``cols``; ``valid_only`` cuts it to
    the shard's valid rows and skips an all-pad shard. ``check(outs,
    what)`` vets each shard's outputs. A resource error records its
    forensic snapshot and re-raises: the mesh owns the shard layout, so
    there is no row range to split. Returns each shard's outputs, None for
    a skipped one."""
    from .runtime import faults as _flt

    s = gf.shard_rows
    rows = gf.valid_rows if valid_only else (lambda i: s)
    items = [(i, i * s, i * s + rows(i)) for i in range(gf.data_size) if rows(i)]
    place = _api._Place(items, gf.anchor, mesh=gf.mesh, devs=gf.devices)
    shards = [gf.shards(c) for c in cols]

    def feeds_for(lo, hi, dev):
        i, a = divmod(lo, s)
        if hi - lo == s:  # the whole shard
            return [t[i] for t in shards]
        return [t[i][a:a + hi - lo] for t in shards]

    fns = [make(d) for d in gf.devices]
    try:
        outs = _api._loop(
            place, verb, span_name, fp, lambda feeds, n, i: fns[i](*feeds), feeds_for,
            check or (lambda outs, what: None), what=verb, mesh_name=span_name,
            mesh_label="global",
            mesh_attrs=dict(rows=gf.nrows, bucket=gf.padded_rows,
                            sharding=f"data:{gf.data_size}"),
        )
    except Exception as e:
        if _flt.classify(e) == _flt.RESOURCE:
            _flt.record_oom(verb, fp, gf.nrows, 0, "reraise:global-frame", e)
        raise
    _note_dispatch(verb, collectives=collectives)
    by_shard = dict(zip((i for i, _, _ in items), outs))
    return [by_shard.get(i) for i in range(gf.data_size)]


def _lead_check(gf: GlobalFrame, names: Sequence[str], verb: str, hint: str):
    """A map's per-shard check: every output keeps the shard's padded lead
    dim, then the numerics guard. A row-local graph maps the pad rows, the
    last row's copies, to the last row's outputs, so checking the whole
    shard gives the valid rows' verdict."""
    from .runtime.faults import maybe_check_numerics

    def check(outs, what):
        for n, x in zip(names, outs):
            if x.dim() == 0 or x.shape[0] != gf.shard_rows:
                raise ValueError(
                    f"{verb}: output {_base(n)!r} does not preserve the sharded "
                    f"lead dim; {hint}"
                )
        maybe_check_numerics(names, outs, what)

    return check


def _analyze(graph, fetch_list, gf, feed_dict, block_level: bool):
    from .graph.analysis import analyze_graph

    overrides = _api._ph_overrides(graph, gf, feed_dict, block_level, {})
    summary = analyze_graph(graph, fetch_list, placeholder_shapes=overrides)
    mapping = _api._match_columns(summary, gf, feed_dict, block_level, {})
    return summary, mapping


def _spmd_capable(ex) -> bool:
    """The global path needs the block scheduler's opt-in."""
    return getattr(ex, "supports_scheduling", False)


def _map_dispatch(graph, fetch_list, gf: GlobalFrame, mapping, ex, vmap: bool) -> List[List]:
    """One map dispatch over the shards: per output, its shard tensors.
    ``vmap`` runs the per-row graph vmapped (map_rows)."""
    from .ops.lowering import build_callable

    verb = "map_rows" if vmap else "map_blocks"
    feed_names = sorted(mapping)
    if vmap:
        kind, build = "global-vmap-rows", lambda d: torch.func.vmap(
            build_callable(graph, fetch_list, feed_names, d)
        )
    else:
        kind, build = "global-map", lambda d: build_callable(graph, fetch_list, feed_names, d)
    outs = _shard_loop(
        gf, verb, f"{verb}.global", graph.fingerprint(), [mapping[n] for n in feed_names],
        lambda d: ex.cached(kind, graph, fetch_list, feed_names, d, build),
        check=_lead_check(
            gf, fetch_list, verb,
            "row-count-changing graphs cannot run on the global path (the "
            "per-block path with trim=True handles row-count-changing maps)",
        ),
    )
    return [[o[j] for o in outs] for j in range(len(fetch_list))]


def _shard_merge(graph, fetch_list, summary):
    """How two shards' partials combine, or None when the reduce does not
    classify: as an OOM split's halves do (`api._reduce_split`), since the
    shards are row ranges of the frame's one block — each fetch's monoid,
    a mean weighted by rows (JAX's in-program collectives). Not
    `api._combine_placed`, which re-feeds partials through the graph: the
    block contract's combine, which differs from a collective for means
    and transformed sums."""
    return _api._reduce_split(graph, fetch_list, summary).merge()


def _reduce_dispatch(graph, fetch_list, gf: GlobalFrame, mapping, merge, ex,
                     span_name="reduce_blocks.global", verb="reduce_blocks"):
    """One reduce dispatch over the shards' valid rows (``mapping``:
    placeholder -> column), then the partials fold on the anchor in shard
    order by ``merge`` (`_shard_merge`). Returns the outputs as a tuple."""
    from .runtime.faults import maybe_check_numerics

    feed_names = sorted(mapping)
    parts = _shard_loop(
        gf, verb, span_name, graph.fingerprint(), [mapping[n] for n in feed_names],
        lambda d: ex.callable_for(graph, fetch_list, feed_names, d),
        valid_only=True, collectives=len(fetch_list),
    )
    acc, n_acc = None, 0
    for i, p in enumerate(parts):
        if p is None:
            continue
        p, v = tuple(as_tensor(x, gf.anchor) for x in p), gf.valid_rows(i)
        acc, n_acc = (p, v) if acc is None else (merge(acc, p, n_acc, v), n_acc + v)
    maybe_check_numerics(fetch_list, acc, f"{verb} (global)")
    return acc


def _output_global(gf: GlobalFrame, fetch_list, out_shards, summary) -> GlobalFrame:
    """A map's output GlobalFrame: outputs sorted by name, then the input
    columns they do not shadow (the eager `_output_frame`'s order)."""
    shards = {_base(f): s for f, s in zip(fetch_list, out_shards)}
    infos = {}
    for f, s in zip(fetch_list, out_shards):
        b = _base(f)
        infos[b] = ColumnInfo(b, ScalarType.from_torch_dtype(s[0].dtype),
                              _api.Shape(tuple(s[0].shape[1:])))
    names = sorted(shards)
    names += [n for n in gf.columns if n not in shards]
    return GlobalFrame(
        {n: shards[n] if n in shards else gf.shards(n) for n in names},
        {n: infos[n] if n in infos else gf._infos[n] for n in names},
        gf.mesh, gf.nrows,
    )


def _fallback_map(verb, fetches, gf, feed_dict, trim, fetch_names, executor, bindings,
                  reason: str) -> GlobalFrame:
    """The eager verb over `to_frame()`, re-sharded onto the SAME mesh so
    a chain keeps its type. Counted under ``reason``."""
    _note_fallback(reason)
    with _suppress_route():
        if verb == "map_rows":
            out = _api.map_rows(fetches, gf.to_frame(), feed_dict, fetch_names, executor,
                                bindings=bindings, device=gf.anchor)
        else:
            out = _api.map_blocks(fetches, gf.to_frame(), feed_dict, trim, fetch_names, executor,
                                  bindings=bindings, device=gf.anchor)
    return GlobalFrame.from_frame(out, mesh=gf.mesh)


def _ineligible(fetches, fetch_names, bindings, ex):
    """``(graph, fetch_list, reason)``: the fallback reason of a map, or
    None when the graph may run on the shards (a row-local check
    follows)."""
    if callable(fetches) and not isinstance(fetches, _api.dsl.Tensor):
        return None, None, "fn-frontend"
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    if bindings:
        return graph, fetch_list, "bindings"
    if any(ph.dtype_attr is ScalarType.string for ph in graph.placeholders()):
        return graph, fetch_list, "bytes-passthrough"
    if not _spmd_capable(ex):
        return graph, fetch_list, "executor"
    return graph, fetch_list, None


# ---------------------------------------------------------------------------
# verbs on an explicit GlobalFrame
# ---------------------------------------------------------------------------


def map_blocks_global(fetches, gf: GlobalFrame, feed_dict=None, trim=False, fetch_names=None,
                      executor=None, mesh=None, bindings=None, devices=None,
                      device=None) -> GlobalFrame:
    from .runtime.executor import default_executor

    _reject_overrides("map_blocks", mesh, devices, device, gf)
    if trim:
        raise ValueError(
            "map_blocks(trim=True) is not supported on a GlobalFrame: "
            "trimmed maps change the row count under the sharded lead "
            "dim; collect() first"
        )
    ex = executor or default_executor()
    graph, fetch_list, reason = _ineligible(fetches, fetch_names, bindings, ex)
    if reason is not None:
        src = fetches if graph is None else graph
        return _fallback_map("map_blocks", src, gf, feed_dict, trim,
                             fetch_names if graph is None else fetch_list, executor,
                             bindings, reason)
    summary, mapping = _analyze(graph, fetch_list, gf, feed_dict, True)
    if not rowwise_fetches(graph, fetch_list, {p: ph.shape.rank for p, ph in summary.inputs.items()}):
        # a non-row-local map over shards would see the pad rows and the
        # shard boundaries: it runs on the exact local boundary instead
        return _fallback_map("map_blocks", graph, gf, feed_dict, trim, fetch_list, executor,
                             None, "not-row-local")
    outs = _map_dispatch(graph, fetch_list, gf, mapping, ex, vmap=False)
    return _output_global(gf, fetch_list, outs, summary)


def map_rows_global(fetches, gf: GlobalFrame, feed_dict=None, fetch_names=None, executor=None,
                    mesh=None, bindings=None, devices=None, device=None) -> GlobalFrame:
    from .runtime.executor import default_executor

    _reject_overrides("map_rows", mesh, devices, device, gf)
    ex = executor or default_executor()
    graph, fetch_list, reason = _ineligible(fetches, fetch_names, bindings, ex)
    if reason is not None:
        src = fetches if graph is None else graph
        return _fallback_map("map_rows", src, gf, feed_dict, False,
                             fetch_names if graph is None else fetch_list, executor,
                             bindings, reason)
    summary, mapping = _analyze(graph, fetch_list, gf, feed_dict, False)
    # the vmapped per-row program is row-local by construction
    outs = _map_dispatch(graph, fetch_list, gf, mapping, ex, vmap=True)
    return _output_global(gf, fetch_list, outs, summary)


def stream_reduce_eligible(graph, fetch_list, gf, feed_dict, executor=None) -> bool:
    """True when `reduce_blocks` on this GlobalFrame runs on its shards.
    A stream asks once, on its first sharded chunk: the graph is fixed for
    the stream's lifetime."""
    from .runtime.executor import default_executor

    if not _spmd_capable(executor or default_executor()):
        return False
    try:
        summary, _ = _analyze(graph, fetch_list, gf, feed_dict, True)
        return _shard_merge(graph, fetch_list, summary) is not None
    except Exception:
        return False


def reduce_blocks_global(fetches, gf: GlobalFrame, feed_dict=None, fetch_names=None,
                         executor=None, mesh=None, devices=None, device=None):
    from .runtime.executor import default_executor

    _reject_overrides("reduce_blocks", mesh, devices, device, gf)
    ex = executor or default_executor()
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    summary, mapping = _analyze(graph, fetch_list, gf, feed_dict, True)
    _api._validate_reduce_blocks(summary, fetch_list)
    merge = _shard_merge(graph, fetch_list, summary) if _spmd_capable(ex) else None
    if merge is None:
        # no monoid to combine shard partials by: the exact eager verb on
        # the local boundary (still one block)
        _note_fallback("unclassified-reduce" if _spmd_capable(ex) else "executor")
        with _suppress_route():
            return _api.reduce_blocks(
                graph, gf.to_frame(), feed_dict, fetch_list, executor, device=gf.anchor
            )
    out = _reduce_dispatch(graph, fetch_list, gf, mapping, merge, ex)
    return _api._results([_base(f) for f in fetch_list], out)


# ---------------------------------------------------------------------------
# block_scheduler="global": routing plain frames
# ---------------------------------------------------------------------------

# the verb was NOT routed: the eager path continues (a routed reduce may
# return any value)
SKIP = object()


def _route_eligible(frame, ex, devices) -> bool:
    from .runtime import scheduler as _rs

    if getattr(_route_tls, "suppressed", False):
        return False
    return (
        devices is None
        and _rs.global_mode()
        and isinstance(frame, TensorFrame)
        and frame.nrows >= max(1, _config.get().global_frame_min_rows)
        and _spmd_capable(ex)
    )


def _routable(summary, mapping, frame):
    """The columns a routed verb shards: dense, numeric, at least one."""
    used = sorted(set(mapping.values()))
    if not used:
        return None, None
    for c in used:
        col = frame.column(c)
        if not col.is_dense or col.dtype is ScalarType.string:
            return None, None
    return summary, mapping


def _try_match(graph, fetch_list, frame, feed_dict, block_level):
    """Analysis and matching for the route, errors swallowed: a mismatch
    surfaces from the eager path with its own message."""
    try:
        summary, mapping = _api._prepare(graph, fetch_list, frame, feed_dict, block_level)
    except Exception:
        return None, None
    return _routable(summary, mapping, frame)


def _local_out(frame, fetch_list, out_shards, gf):
    """A routed map's plain output: the shards' valid rows on the anchor,
    with the input's offsets and columns."""
    out_cols = [Column(_base(f), gf.gather(shards)) for f, shards in zip(fetch_list, out_shards)]
    return _api._output_frame(frame, out_cols, append_input=True)


def maybe_map_blocks(graph, fetch_list, frame, feed_dict, executor, devices):
    """Route an eager `map_blocks` (graph, no trim / bindings / mesh /
    device) through the shards under ``block_scheduler="global"``: a
    `TensorFrame` with the input's offsets, or `SKIP`."""
    from .runtime.executor import default_executor

    ex = executor or default_executor()
    if not _route_eligible(frame, ex, devices):
        return SKIP
    summary, mapping = _try_match(graph, fetch_list, frame, feed_dict, True)
    if summary is None:
        return SKIP
    if not rowwise_fetches(graph, fetch_list, {p: ph.shape.rank for p, ph in summary.inputs.items()}):
        _note_fallback("not-row-local")
        return SKIP
    gf = GlobalFrame.from_frame(frame, columns=sorted(set(mapping.values())))
    return _local_out(frame, fetch_list, _map_dispatch(graph, fetch_list, gf, mapping, ex, False), gf)


def maybe_map_rows(graph, fetch_list, frame, feed_dict, executor, devices, pre=None):
    """`maybe_map_blocks`' per-row sibling: one vmapped call a shard.
    ``pre`` is the (summary, mapping) the eager verb already computed."""
    from .runtime.executor import default_executor

    ex = executor or default_executor()
    if not _route_eligible(frame, ex, devices):
        return SKIP
    if pre is not None:
        summary, mapping = _routable(pre[0], pre[1], frame)
    else:
        summary, mapping = _try_match(graph, fetch_list, frame, feed_dict, False)
    if summary is None:
        return SKIP
    gf = GlobalFrame.from_frame(frame, columns=sorted(set(mapping.values())))
    return _local_out(frame, fetch_list, _map_dispatch(graph, fetch_list, gf, mapping, ex, True), gf)


def maybe_reduce_blocks(graph, fetch_list, frame, feed_dict, executor, devices):
    """Route an eager `reduce_blocks` of a classified graph through the
    shards: the result, or `SKIP`."""
    from .runtime.executor import default_executor

    ex = executor or default_executor()
    if not _route_eligible(frame, ex, devices):
        return SKIP
    summary, mapping = _try_match(graph, fetch_list, frame, feed_dict, True)
    if summary is None:
        return SKIP
    try:
        _api._validate_reduce_blocks(summary, fetch_list)
    except Exception:
        return SKIP  # the eager path owns the canonical error
    merge = _shard_merge(graph, fetch_list, summary)
    if merge is None:
        _note_fallback("unclassified-reduce")
        return SKIP
    gf = GlobalFrame.from_frame(frame, columns=sorted(set(mapping.values())))
    out = _reduce_dispatch(graph, fetch_list, gf, mapping, merge, ex)
    return _api._results([_base(f) for f in fetch_list], out)


# ---------------------------------------------------------------------------
# lazy plans and the relational filter over a GlobalFrame base
# ---------------------------------------------------------------------------


def force_fused_global(lf, gf: GlobalFrame, ex, fetch_edges: List[str], out_names: List[str],
                       feed_names: List[str]) -> Optional[TensorFrame]:
    """Force a fused lazy map chain over a GlobalFrame base once a shard:
    the concrete `TensorFrame` (valid rows on the anchor + passthrough),
    or None (counted) when the chain is not row-local or the executor
    cannot take shards; the caller then runs the local boundary."""
    from .ops.lowering import build_callable
    from .utils import telemetry as _tele

    graph, feed_map = lf._graph, lf._feed_map
    if not _spmd_capable(ex):
        _note_fallback("executor")
        return None
    if not rowwise_fetches(graph, fetch_edges,
                           {ph: gf.info[col].block_shape.rank for ph, col in feed_map.items()}):
        _note_fallback("lazy-not-row-local")
        return None
    with _tele.span("lazy.force.blocks", kind="stage", program=graph.fingerprint()):
        outs = _shard_loop(
            gf, "lazy.force", "lazy.force.global", graph.fingerprint(),
            [feed_map[n] for n in feed_names],
            lambda d: ex.cached("global-map", graph, fetch_edges, feed_names, d,
                                lambda dd: build_callable(graph, fetch_edges, feed_names, dd)),
            check=_lead_check(
                gf, out_names, "lazy plan",
                "trimmed/reducing stages cannot be part of a lazy map plan",
            ),
        )
    with _tele.span("lazy.force.collect", kind="stage"):
        out_cols = [Column(n, gf.gather([o[j] for o in outs])) for j, n in enumerate(out_names)]
        shadow = set(out_names)
        base = gf.to_frame()
        cols_out = out_cols + [base.column(c) for c in gf.columns if c not in shadow]
    return TensorFrame(cols_out, [0, gf.nrows])


def fused_reduce_global(fused, fused_fetches: List[str], feed_map: Dict[str, str],
                        feed_names: List[str], gf: GlobalFrame, summary, ex) -> Optional[Tuple]:
    """A fused lazy map->reduce chain over a GlobalFrame base once a shard
    and one combine, or None (counted) when the fused chain does not
    classify."""
    merge = _shard_merge(fused, fused_fetches, summary) if _spmd_capable(ex) else None
    if merge is None:
        _note_fallback("unclassified-reduce" if _spmd_capable(ex) else "executor")
        return None
    return _reduce_dispatch(
        fused, fused_fetches, gf, feed_map, merge, ex,
        span_name="reduce_blocks.fused.global", verb="reduce_blocks.fused",
    )


def filter_global(pred, gf: GlobalFrame, executor=None):
    """The relational filter on the shards: the predicate's mask once a
    shard over its valid rows (one dispatch), the survivors gathered on
    the anchor, then re-sharded onto the same mesh. Returns the filtered
    `GlobalFrame` (a `TensorFrame` when nothing survives), or None when
    the predicate cannot run on the shards (a missing or non-scalar
    column, an executor without the opt-in); the caller then falls back,
    counted."""
    from .runtime.executor import default_executor

    ex = executor or default_executor()
    if not _spmd_capable(ex):
        return None
    cols = sorted(pred.columns())
    for c in cols:
        if c not in gf.columns or gf.info[c].cell_shape.rank != 0:
            return None

    def take(*vals):
        lookup = dict(zip(cols, vals))
        return torch.nonzero(pred.mask(lookup.__getitem__)).reshape(-1)

    takes = _shard_loop(
        gf, "filter", "plan.filter.mask", f"plan-filter:{pred.fingerprint()}", cols,
        lambda d: take, valid_only=True,
    )
    cols_out = []
    for name in gf.columns:
        c = Column(name, gf.gather(gf.shards(name), takes))
        c.cell_shape = gf._infos[name].cell_shape
        cols_out.append(c)
    local = TensorFrame(cols_out)
    if local.nrows == 0:
        return local  # nothing to shard; later stages stay local
    return GlobalFrame.from_frame(local, mesh=gf.mesh)


# ---------------------------------------------------------------------------
# fluent methods (as TensorFrame's: gf.map_blocks(...) etc.)
# ---------------------------------------------------------------------------


def _install_fluent_methods() -> None:
    GlobalFrame.map_blocks = lambda self, fetches, **kw: _api.map_blocks(fetches, self, **kw)
    GlobalFrame.map_rows = lambda self, fetches, **kw: _api.map_rows(fetches, self, **kw)
    GlobalFrame.reduce_blocks = lambda self, fetches, **kw: _api.reduce_blocks(fetches, self, **kw)
    GlobalFrame.reduce_rows = lambda self, fetches, **kw: _api.reduce_rows(fetches, self, **kw)
    GlobalFrame.group_by = lambda self, *keys: _api.GroupedFrame(self, keys)
    # relational verbs defer as plan-DAG nodes over this frame: filter runs
    # on the shards, sort and join cross to the local path, counted
    GlobalFrame.filter = lambda self, pred, selectivity=None: self.lazy().filter(
        pred, selectivity=selectivity
    )
    GlobalFrame.sort_by = lambda self, *keys, descending=False: self.lazy().sort_by(
        *keys, descending=descending
    )
    GlobalFrame.join = lambda self, other, on, how="inner": self.lazy().join(other, on, how=how)


_install_fluent_methods()
