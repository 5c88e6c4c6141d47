"""Lazy execution plans: defer chained verbs, fuse, run ONE callable per block.

The PyTorch counterpart of `tensorframes_tpu/lazy.py`. The eager verbs run
one lowered callable per verb per block, with the intermediate columns
concatenated into whole device columns between stages. For the common
pipeline shape — ``map_blocks -> map_blocks -> reduce_blocks`` — that is
O(verbs) block calls and O(verbs) whole-column intermediates. A `LazyFrame`
instead accumulates the chain as one pending fused `Graph`
(`graph.fuse.splice`): each deferred ``map_blocks`` splices its graph onto
the plan by rewiring placeholders to the producer outputs whose base name
matches their column (the same placeholder<->column matching the eager
verbs use), with dtype and shape-precision checks at splice time. A
*terminal action* — ``collect()`` / ``host_values()`` / ``to_pandas()``,
any reduce/aggregate, or an explicit ``.force()`` — lowers the whole fused
graph through `Executor.callable_for` as ONE callable per block: the
executor cache keys on the fused graph's fingerprint, the per-stage Python
dispatch goes away, and no whole-column intermediate is concatenated. The
callable still launches the chain's ATen ops one by one.

Entry points:

- ``df.lazy(device=...)`` — wrap a `TensorFrame` into a `LazyFrame`;
- ``with tft.lazy(): ...`` — a mode under which graph-based ``map_blocks``
  calls on plain frames return LazyFrames. Function front-end fetches,
  ``trim=True``, ``bindings`` and bytes placeholders stay eager under the
  mode (they cannot be spliced); on an explicit `LazyFrame`,
  ``trim``/``bindings`` raise instead so the deferral contract is never
  silently broken.

Laziness contract: a `LazyFrame` is row-aligned with its base frame (same
``nrows``/``offsets``), its schema (`.info`) is the fused plan's virtual
schema (graph outputs sorted by name, then base passthrough), and nothing
executes until a terminal action. Terminal actions run on the frame's
device (``device=`` of the deferring call or of ``lazy()``; ``None`` is the
CUDA card, and without one it raises). ``reduce_blocks`` fuses the
reduce's per-block stage into the pending graph (the combine over stacked
partials runs the plain reduce graph, exactly like the eager verb);
``reduce_rows`` / ``aggregate`` / ``map_rows`` force the plan first, then
run eagerly on the device-resident result.

`force` pipelines the per-block feed prep (``config.plan_pipeline``): a
``plan-prep`` stage of `ingest.pipeline` slices block k+1 and copies it to
the card through `streaming._TransferStage` (pinned staging slots, its own
CUDA stream, an event the consumer's stream waits on) while the consumer
thread runs block k. A device-resident base only slices.

Relational verbs (`filter`, `select`, `sort_by`, `join`, `group_by(...)
.agg(...)`) seal the chain into a `graph.plan` DAG (`RelationalFrame`),
which `graph.optimizer` rewrites before `graph.plan.execute` runs it.

Block dispatches go through `api._dispatch_rows` as the eager verbs' do:
a dispatch span, classified retries, OOM block splits (a row-local fused
chain concatenates the halves; the fused reduce combines classified
monoid halves) and the numerics guard. `explain_analyze` executes a plan
and joins its spans with the cost ledger.

With the materialization cache on (``config.materialize_cache_bytes``
> 0, `runtime.materialize`), `force` and `RelationalFrame.force` consult it
under the data fingerprint of a host-resident base (`graph.plan.
data_fingerprint` for a relational DAG) and the plan's fingerprint with
its device: a hit records the ``materialize.load`` span and dispatches no
block program; a whole computed result is offered back (a failed force
commits nothing).

Placement: a plan takes ``device=``, ``devices=`` or ``mesh=`` (of the
deferring call, of ``lazy()`` or of the terminal) as the eager verbs do
(`api._Place`): the fused callable runs once a block on one device, once a
block where the block scheduler places it, or once a shard of the mesh,
and the outputs converge on the anchor. Over a `GlobalFrame` base a
row-local fused chain runs once a shard and a classified fused reduce once
a shard with one combine (`globalframe.force_fused_global`,
`fused_reduce_global`); anything else crosses to `GlobalFrame.to_frame()`.
Shape bucketing is not in the port on purpose: eager PyTorch compiles
nothing per shape.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import closing, contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .device import DeviceLike, resolve_device
from .frame import Column, TensorFrame, as_tensor
from .graph.fuse import splice
from .graph.ir import Graph, base_name as _base
from .runtime import deadline as _dl
from .runtime.deadline import deadline_entry as _deadline_entry
from .schema import ColumnInfo, FrameInfo, ScalarType

# api loads first and imports this module inside its verbs; helper
# lookups resolve at call time through the module object
from . import api as _api

__all__ = [
    "lazy", "lazy_active", "LazyFrame", "LazyStage", "LazyPlan",
    "RelationalFrame", "LazyGroupedFrame", "explain_analyze",
]


_LAZY_MODE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "tfs_lazy_mode", default=False
)


@contextmanager
def lazy():
    """Enable lazy mode for the enclosed block: graph-based ``map_blocks``
    calls on plain frames return `LazyFrame`s instead of dispatching.
    Thread-/task-safe via contextvars."""
    tok = _LAZY_MODE.set(True)
    try:
        yield
    finally:
        _LAZY_MODE.reset(tok)


def lazy_active() -> bool:
    return _LAZY_MODE.get()


@dataclass(frozen=True)
class LazyStage:
    """Provenance record for one deferred verb (rendered by explain)."""

    verb: str
    outputs: Tuple[str, ...]
    nodes: int  # node count the stage contributed to the fused graph

    def __repr__(self) -> str:
        outs = ", ".join(self.outputs)
        return f"{self.verb} -> [{outs}] (+{self.nodes} nodes)"


@dataclass
class LazyPlan:
    """Structured fused plan, the `explain_detailed` analogue for a
    `LazyFrame`: per-stage provenance plus the fused graph and its
    column/feed wiring."""

    stages: List[LazyStage]
    graph: Graph
    sources: Dict[str, str] = field(default_factory=dict)  # col -> fused edge
    feeds: Dict[str, str] = field(default_factory=dict)  # placeholder -> base col
    info: Optional[FrameInfo] = None
    # relational plans carry the OPTIMIZED `graph.plan.PlanNode` DAG
    # root instead of a linear fused chain
    relational: Optional[object] = None

    def fingerprint(self) -> str:
        """Canonical identity of the plan. Relational plans fingerprint
        their optimized DAG (commutative predicate operands sort, leaves
        contribute ordinals), so semantically equal plans — pre/post
        rewrite, reordered `&`/`|` inputs — share one key; linear fused
        chains digest the spliced graph + bindings + output set."""
        if self.relational is not None:
            from .graph import plan as _plan

            return _plan.plan_fingerprint(self.relational)
        from .graph.fuse import chain_fingerprint

        return chain_fingerprint(self.graph, self.feeds, sorted(self.sources))

    def __repr__(self) -> str:
        if self.relational is not None:
            return f"LazyPlan(relational, fingerprint {self.fingerprint()})"
        return (
            f"LazyPlan({len(self.stages)} stages, {len(self.graph)} nodes, "
            f"outputs {sorted(self.sources)}, feeds {self.feeds})"
        )


class LazyFrame:
    """A frame whose columns are a pending fused graph over a base frame.

    Construct via ``TensorFrame.lazy()`` or under ``with tft.lazy():``.
    All deferred state is immutable — every fused stage returns a new
    `LazyFrame`, so plans can branch like frames do.
    """

    def __init__(
        self,
        base: TensorFrame,
        graph: Optional[Graph] = None,
        sources: Optional[Dict[str, str]] = None,
        feed_map: Optional[Dict[str, str]] = None,
        stages: Optional[List[LazyStage]] = None,
        executor=None,
        device: DeviceLike = None,
        mesh=None,
        devices=None,
    ):
        self._base = base
        self._graph = graph if graph is not None else Graph()
        self._sources: Dict[str, str] = dict(sources or {})
        self._feed_map: Dict[str, str] = dict(feed_map or {})
        self._stages: List[LazyStage] = list(stages or [])
        self._executor = executor
        self._device = device
        self._mesh = mesh
        self._devices = devices  # the block scheduler's devices for terminals
        # (placement key, forced frame) of the last default-context force
        self._forced: Optional[Tuple[tuple, TensorFrame]] = None

    def _with_base(self, base: TensorFrame, device: DeviceLike = None) -> "LazyFrame":
        return LazyFrame(
            base, self._graph, self._sources, self._feed_map, self._stages,
            self._executor, device if device is not None else self._device,
            self._mesh, self._devices,
        )

    def _placement(self, device, mesh, devices):
        """The terminal's placement: the call's ``device`` / ``mesh`` /
        ``devices`` when it gives any, else the plan's; two together
        raise, as on the eager verbs."""
        if device is None and mesh is None and devices is None:
            device, mesh, devices = self._device, self._mesh, self._devices
        _api._check_mesh_args("lazy.force", mesh, device, devices)
        return device, mesh, devices

    # -- frame-shaped surface (row-aligned with the base) ---------------
    @property
    def nrows(self) -> int:
        return self._base.nrows

    @property
    def num_blocks(self) -> int:
        return self._base.num_blocks

    @property
    def offsets(self):
        return self._base.offsets

    @property
    def columns(self) -> List[str]:
        return self.info.names

    def _summary(self):
        """Block-level analysis of the pending graph (memoized by
        fingerprint in `graph.analysis`), recorded as a ``stage`` span."""
        if not self._sources:
            return None
        from .graph.analysis import analyze_graph
        from .utils import telemetry as _tele

        overrides = {
            ph: self._base.info[col].block_shape
            for ph, col in self._feed_map.items()
        }
        fetches = [self._sources[c] for c in sorted(self._sources)]
        with _tele.span(
            "lazy.analyze", kind="stage",
            program=self._graph.fingerprint() if len(self._graph) else None,
        ):
            return analyze_graph(
                self._graph, fetches, placeholder_shapes=overrides
            )

    @property
    def info(self) -> FrameInfo:
        """Virtual schema: fused-graph outputs (sorted by name) first,
        then base passthrough columns — the same ordering as the eager
        `_output_frame`."""
        summary = self._summary()
        if summary is None:
            return self._base.info
        cols = []
        for c in sorted(self._sources):
            ns = summary.outputs[_base(self._sources[c])]
            cols.append(ColumnInfo(c, ns.dtype, ns.shape.tail))
        shadow = set(self._sources)
        cols += [ci for ci in self._base.info if ci.name not in shadow]
        return FrameInfo(cols)

    def __repr__(self) -> str:
        return (
            f"LazyFrame[{self.nrows} rows x {len(self.info)} cols, "
            f"{len(self._stages)} pending stage(s), "
            f"{len(self._graph)} fused nodes]"
        )

    # -- splicing -------------------------------------------------------
    def _resolve_placeholders(
        self, graph: Graph, feed_dict: Optional[Dict[str, str]], what: str
    ) -> Tuple[Dict[str, str], Dict[str, str]]:
        """Map each consumer placeholder to either a pending fused
        output (a splice binding) or a base column (a feed), validating
        dtype equality and shape precision AT SPLICE TIME — a mismatch
        surfaces here, on the deferring call, not at force time.

        Returns ``(bindings: placeholder -> fused edge,
        new_feeds: placeholder -> base column)``."""
        feed_dict = feed_dict or {}
        summary = None
        by_col: Dict[str, str] = {}
        for p, c in self._feed_map.items():
            by_col.setdefault(c, p)
        bindings: Dict[str, str] = {}
        new_feeds: Dict[str, str] = {}
        for ph in graph.placeholders():
            col = feed_dict.get(ph.name, _api._default_column(ph.name, self))
            if col in self._sources:
                if summary is None:
                    summary = self._summary()
                ns = summary.outputs[_base(self._sources[col])]
                if ph.dtype_attr is not None and ph.dtype_attr is not ns.dtype:
                    raise ValueError(
                        f"{what}: placeholder {ph.name!r} has dtype "
                        f"{ph.dtype_attr.name} but fused column {col!r} has "
                        f"dtype {ns.dtype.name} (TF graphs do not promote "
                        "dtypes)"
                    )
                attr = ph.shape_attr
                if attr is not None and not ns.shape.check_more_precise_than(
                    attr
                ):
                    raise ValueError(
                        f"{what}: fused column {col!r} with shape {ns.shape} "
                        f"is not compatible with shape {attr} requested by "
                        f"placeholder {ph.name!r}"
                    )
                bindings[ph.name] = self._sources[col]
            elif col in self._base.info:
                info = self._base.info[col]
                if ph.dtype_attr is not None and ph.dtype_attr is not info.dtype:
                    raise ValueError(
                        f"{what}: placeholder {ph.name!r} has dtype "
                        f"{ph.dtype_attr.name} but column {col!r} has dtype "
                        f"{info.dtype.name} (TF graphs do not promote dtypes)"
                    )
                attr = ph.shape_attr
                if attr is not None and not info.block_shape.check_more_precise_than(attr):
                    raise ValueError(
                        f"{what}: column {col!r} with shape "
                        f"{info.block_shape} is not compatible with shape "
                        f"{attr} requested by placeholder {ph.name!r}"
                    )
                prev = by_col.get(col)
                if (
                    prev is not None
                    and self._graph[prev].dtype_attr is ph.dtype_attr
                ):
                    # a pending stage already feeds this column: share
                    # the existing placeholder instead of adding another
                    bindings[ph.name] = prev
                else:
                    new_feeds[ph.name] = col
            else:
                raise ValueError(
                    f"{what}: placeholder {ph.name!r} wants column {col!r} "
                    f"which is not in the lazy frame (columns: "
                    f"{self.columns}); use feed_dict to rename"
                )
        return bindings, new_feeds

    def _fuse_stage(
        self,
        verb: str,
        graph: Graph,
        fetch_list: List[str],
        feed_dict: Optional[Dict[str, str]],
        executor=None,
        device: DeviceLike = None,
        mesh=None,
        devices=None,
    ) -> "LazyFrame":
        from .utils import telemetry as _tele

        with _tele.span("lazy.fuse", kind="stage", verb=verb):
            bindings, new_feeds = self._resolve_placeholders(
                graph, feed_dict, verb
            )
            fused, new_fetches, rename = splice(
                self._graph, graph, bindings, fetch_list
            )
        feed_map = dict(self._feed_map)
        for ph, col in new_feeds.items():
            feed_map[rename[ph]] = col
        sources = dict(self._sources)
        out_bases = []
        for old, new in zip(fetch_list, new_fetches):
            sources[_base(old)] = new  # graph output wins on collision
            out_bases.append(_base(old))
        stage = LazyStage(verb, tuple(out_bases), len(graph))
        return LazyFrame(
            self._base,
            fused,
            sources,
            feed_map,
            self._stages + [stage],
            executor if executor is not None else self._executor,
            device if device is not None else self._device,
            mesh if mesh is not None else self._mesh,
            devices if devices is not None else self._devices,
        )

    # -- deferred verbs -------------------------------------------------
    def map_blocks(
        self,
        fetches,
        feed_dict: Optional[Dict[str, str]] = None,
        trim: bool = False,
        fetch_names=None,
        executor=None,
        bindings=None,
        device: DeviceLike = None,
        mesh=None,
        devices=None,
    ) -> "LazyFrame":
        """Defer a row-preserving block map onto the fused plan
        (``device=``, ``devices=`` or ``mesh=`` place its terminal)."""
        _api._check_mesh_args("map_blocks", mesh, device, devices)
        if trim:
            raise ValueError(
                "map_blocks(trim=True) is not supported on a LazyFrame: "
                "trimmed maps change row alignment with the base frame; "
                "call .force() first"
            )
        if bindings:
            raise ValueError(
                "map_blocks: bindings are not supported on a LazyFrame; "
                "bake the values as graph constants or call .force() first"
            )
        if callable(fetches) and not isinstance(fetches, _api.dsl.Tensor):
            raise ValueError(
                "LazyFrame.map_blocks needs a graph (DSL tensors, Graph, "
                "or GraphDef bytes); function front-end graphs cannot be "
                "spliced — call .force() first"
            )
        graph, fetch_list = _api._as_graph(fetches, fetch_names)
        if any(
            ph.dtype_attr is ScalarType.string for ph in graph.placeholders()
        ):
            raise ValueError(
                "lazy map_blocks does not support bytes placeholders "
                "(host-side pass-through cannot fuse); call .force() first"
            )
        return self._fuse_stage(
            "map_blocks", graph, fetch_list, feed_dict, executor, device, mesh, devices
        )

    def map_rows(self, fetches, **kw):
        """Terminal in effect: forces the pending plan, then runs eagerly."""
        return _api.map_rows(fetches, self, **kw)

    @_deadline_entry("reduce_blocks", frame_at=0)
    @torch.no_grad()
    def reduce_blocks(
        self,
        fetches,
        feed_dict: Optional[Dict[str, str]] = None,
        fetch_names=None,
        executor=None,
        device: DeviceLike = None,
        mesh=None,
        devices=None,
    ):
        """Terminal action: fuse the reduce's per-block stage into the
        pending graph and run the whole chain as ONE callable per item of
        the placement (block, scheduled block, mesh shard, or global-frame
        shard); the combine over the partials runs the plain reduce graph,
        exactly like the eager verb."""
        executor = executor if executor is not None else self._executor
        device, mesh, devices = self._placement(device, mesh, devices)
        if callable(fetches) and not isinstance(fetches, _api.dsl.Tensor):
            return _api.reduce_blocks(
                fetches, self.force(device=device, mesh=mesh, devices=devices), feed_dict,
                fetch_names, executor, device=device, mesh=mesh, devices=devices,
            )
        if not self._sources:
            return _api.reduce_blocks(
                fetches, self._base, feed_dict, fetch_names, executor,
                device=device, mesh=mesh, devices=devices,
            )
        from . import globalframe as _gfm
        from .graph.analysis import analyze_graph
        from .ops.lowering import build_callable
        from .runtime.executor import default_executor
        from .utils import telemetry as _tele

        ex = executor or default_executor()
        rgraph, rfetch = _api._as_graph(fetches, fetch_names)
        # validate the reduce contract against the VIRTUAL schema (the
        # same x <-> x_input checks the eager verb runs on a real frame)
        feed_dict = feed_dict or {}
        vinfo = self.info
        overrides = {}
        for ph in rgraph.placeholders():
            col = feed_dict.get(ph.name, _api._default_column(ph.name, self))
            if col in vinfo:
                shp = vinfo[col].block_shape
                attr = ph.shape_attr
                if attr is None or shp.check_more_precise_than(attr):
                    overrides[ph.name] = shp
        with _tele.span("lazy.analyze", kind="stage"):
            rsummary = analyze_graph(rgraph, rfetch, placeholder_shapes=overrides)
            _api._validate_reduce_blocks(rsummary, rfetch)

        with _tele.span("lazy.fuse", kind="stage", verb="reduce_blocks"):
            bindings, new_feeds = self._resolve_placeholders(
                rgraph, feed_dict, "reduce_blocks"
            )
            fused, fused_fetches, rename = splice(
                self._graph, rgraph, bindings, rfetch
            )
        feed_map = dict(self._feed_map)
        for ph, col in new_feeds.items():
            feed_map[rename[ph]] = col
        feed_names = sorted(feed_map)
        rfeed_names = sorted(rsummary.inputs)
        # partials arrive in FETCH order; the combine's positional args
        # are the SORTED reduce feed names (the eager verb's re-keying)
        fetch_of_feed = {_base(f) + "_input": i for i, f in enumerate(rfetch)}
        feed_src = [fetch_of_feed[n] for n in rfeed_names]

        frame = self._base
        _api._require_dense(
            frame, [feed_map[n] for n in feed_names], "reduce_blocks"
        )
        from .runtime import faults as _flt
        from .runtime.faults import maybe_check_numerics

        def fused_summary():
            fshapes = {
                ph: frame.info[col].block_shape for ph, col in feed_map.items()
            }
            return analyze_graph(fused, fused_fetches, placeholder_shapes=fshapes)

        if isinstance(frame, _gfm.GlobalFrame):
            # sharded base: the fused chain and a classified reduce once a
            # shard, one combine; else the local boundary
            _gfm._reject_overrides("reduce_blocks", mesh, devices, device, frame)
            out = _gfm.fused_reduce_global(
                fused, fused_fetches, feed_map, feed_names, frame, fused_summary(), ex,
            )
            if out is not None:
                return _api._results([_base(f) for f in rfetch], out)
            frame = frame.to_frame()
        place = _api._place(frame, device, devices, mesh, ex)
        prog = _api._programs(place, lambda d: ex.callable_for(fused, fused_fetches, feed_names, d))
        fscope = _flt.scope("reduce_blocks.fused")
        fp = fused.fingerprint()

        # the OOM split recipe: the fused graph (map chain + reduce) must
        # classify as a monoid reduce over a row-local transform
        def _fused_split():
            return _api._reduce_split(fused, fused_fetches, fused_summary()).merge()

        with _tele.span("reduce_blocks.fused.blocks", kind="stage", program=fp):
            partials = _api._loop(
                place, "reduce_blocks.fused", "reduce_blocks.fused.block", fp,
                lambda feeds, rows, i: prog(i)(*feeds),
                _api._feed_source(frame, feed_map, feed_names),
                lambda outs, what: maybe_check_numerics(rfetch, outs, what),
                fscope=fscope, split=_api._Split(_fused_split),
                refuse="unclassifiable-reduce", what="reduce_blocks (fused)",
            )
        if not partials:
            raise ValueError("reduce_blocks on an empty frame")
        _dl.check("reduce_blocks")
        if len(partials) == 1:
            final = tuple(_api.as_tensor(x, place.anchor) for x in partials[0])
        else:
            def combine_for(d):
                return ex.cached(
                    "reduce-combine", rgraph, rfetch, rfeed_names, d,
                    lambda dd: build_callable(rgraph, rfetch, rfeed_names, dd),
                )

            owners = [place.sched.slot(i) for i, _, _ in place.items] if place.sched else None
            with _tele.span("reduce_blocks.fused.combine", kind="stage"):
                final = _api._combine_placed(
                    "reduce-combine", rgraph.fingerprint(), fscope, combine_for, feed_src,
                    partials, owners, place,
                    place.sched is not None and _api._assoc_reduce(rgraph, rfetch, rsummary),
                )
        return _api._results([_base(f) for f in rfetch], final)

    def reduce_rows(self, fetches, **kw):
        """Terminal: forces the plan (one fused callable per block), then
        runs the eager fold on the device-resident result."""
        return _api.reduce_rows(fetches, self, **kw)

    def group_by(self, *keys: str) -> "_api.GroupedFrame":
        """Terminal: `aggregate` forces the plan on its device, since
        aggregation needs concrete key columns."""
        return _api.GroupedFrame(self, keys)

    # -- terminal actions ----------------------------------------------
    @_deadline_entry("lazy.force", frame_at=0)
    @torch.no_grad()
    def force(self, executor=None, device: DeviceLike = None, mesh=None, devices=None) -> TensorFrame:
        """Lower the whole fused plan as ONE callable per item of the
        placement (``device``, ``devices=``, ``mesh=``; default the plan's)
        and return the concrete `TensorFrame` (outputs on the anchor + base
        passthrough). The result of a call without ``executor=`` is
        memoized per placement."""
        if not self._sources:
            return self._base
        from . import config as _config
        from . import globalframe as _gfm
        from .ops.lowering import build_callable
        from .runtime.executor import default_executor
        from .utils import telemetry as _tele

        device, mesh, devices = self._placement(device, mesh, devices)
        ex = executor or self._executor or default_executor()
        frame = self._base
        out_names = sorted(self._sources)
        fetch_edges = [self._sources[c] for c in out_names]
        feed_names = sorted(self._feed_map)
        _api._require_dense(
            frame, [self._feed_map[n] for n in feed_names], "lazy.force"
        )
        if isinstance(frame, _gfm.GlobalFrame):
            # sharded base: a row-local chain once a shard; else the local
            # boundary (one block)
            _gfm._reject_overrides("lazy.force", mesh, devices, device, frame)
            out = _gfm.force_fused_global(self, frame, ex, fetch_edges, out_names, feed_names)
            if out is not None:
                return out
            frame = frame.to_frame()
        place = _api._place(frame, device, devices, mesh, ex)
        key = (place.anchor, place.mesh, tuple(place.devs) if place.spread else None)
        if executor is None and self._forced is not None and self._forced[0] == key:
            return self._forced[1]
        dev = place.anchor
        # materialization cache (off by default): a repeated (data, plan,
        # device) triple under the same numerics config returns the
        # committed result and dispatches nothing. Only for the default
        # executor (an explicit one is a one-off, like the memo), one
        # device, and a host-resident base (fingerprinting a card's column
        # would copy it to the host behind the caller's back).
        from .runtime import materialize as _mat

        cache_key = None
        if (
            executor is None and self._executor is None and not place.spread
            and _mat.enabled()
        ):
            data_fp = _mat.frame_fingerprint(frame)
            if data_fp is not None:
                from .runtime.scheduler import device_label

                plan_fp = _mat.plan_fingerprint(
                    self._graph.fingerprint(), self._feed_map, out_names,
                    device=device_label(dev),
                )
                hit = _mat.lookup(data_fp, plan_fp)
                if hit is not None:
                    out = _cached_result(hit, frame, out_names, dev)
                    self._forced = (key, out)
                    return out
                cache_key = (data_fp, plan_fp)
        t_compute0 = time.perf_counter()
        from .runtime import faults as _flt
        from .runtime.faults import maybe_check_numerics

        mesh_make = None
        if place.mesh is not None:
            from .parallel.verbs import _mesh_sig

            kind = f"shmap-{_mesh_sig(place.mesh)}"
            mesh_make = lambda d: ex.cached(  # noqa: E731
                kind, self._graph, fetch_edges, feed_names, d,
                lambda dd: build_callable(self._graph, fetch_edges, feed_names, dd),
            )
        prog = _api._programs(
            place, lambda d: ex.callable_for(self._graph, fetch_edges, feed_names, d), mesh_make,
        )
        # a row-local fused chain's block may split on OOM (halves
        # concatenate)
        split = _api._rowwise_split(
            self._graph, fetch_edges,
            {ph: frame.info[col].block_shape.rank for ph, col in self._feed_map.items()},
        )
        fp = self._graph.fingerprint()
        feeds_for = _api._feed_source(frame, self._feed_map, feed_names)

        def check(outs, what):
            maybe_check_numerics(out_names, outs, what)

        def rows_check(outs, rows):
            for n, o in zip(out_names, outs):
                if o.dim() == 0 or o.shape[0] != rows:
                    raise ValueError(
                        f"lazy plan output {n!r} does not preserve the "
                        "block row count; trimmed/reducing stages cannot "
                        "be part of a lazy map plan"
                    )

        def run(feeds, rows, i):
            outs = prog(i)(*feeds)
            rows_check(outs, rows)
            return outs

        cfg = _config.get()
        with _tele.span("lazy.force.blocks", kind="stage", program=fp):
            if cfg.plan_pipeline and len(place.items) >= 2 and not place.spread:
                parts = self._pipelined_blocks(
                    frame, place, feed_names, cfg.plan_pipeline_depth,
                    run, feeds_for, split, fp, check,
                )
            else:
                parts = _api._loop(
                    place, "lazy.force", "lazy.force.block", fp, run, feeds_for, check,
                    fscope=_flt.scope("lazy.force"), split=split, forensics=False,
                    what="lazy fused",
                )
        with _tele.span("lazy.force.collect", kind="stage"):
            out_cols = []
            for j, n in enumerate(out_names):
                if parts:
                    data = place.gather([p[j] for p in parts])
                else:  # all blocks empty: zero-row column from analysis
                    ci = self.info[n]
                    data = torch.zeros(
                        (0,) + tuple(0 if d is None else d for d in ci.cell_shape.dims),
                        dtype=ci.dtype.torch_dtype, device=dev,
                    )
                out_cols.append(Column(n, data))
            shadow = set(out_names)
            cols = out_cols + [
                frame.column(c) for c in frame.columns if c not in shadow
            ]
            out = TensorFrame(cols, frame.offsets)
        if cache_key is not None:
            # a failed force raised above: only a whole result is offered
            _mat.store(
                cache_key[0], cache_key[1], out, ledger_fp=self._graph.fingerprint(),
                compute_s=time.perf_counter() - t_compute0,
            )
        if executor is None:
            self._forced = (key, out)
        return out

    def _pipelined_blocks(self, frame, place, feed_names, depth, run, feeds_for, split, fp, check):
        """The one-device block loop with feed prep on a ``plan-prep``
        pipeline stage: each block's feed columns are sliced there and
        copied to the device through the stream's transfer stage (pinned
        slots on its own CUDA stream; a column already there is only
        sliced), while this thread runs the previous block. A consumer
        error closes the pipeline at once, leaving no stage thread
        behind. Returns each block's outputs."""
        from .ingest.pipeline import PipeStage, pipelined
        from .runtime import faults as _flt
        from .streaming import _TransferStage
        from .utils import telemetry as _tele

        dev = place.anchor
        cols = sorted(set(self._feed_map.values()))
        transfer = _TransferStage(dev, fallback_counter="lazy.force.transfer_fallback")
        fscope = _flt.scope("lazy.force")

        def prep(item):
            bi, lo, hi = item
            block = TensorFrame([frame.column(c).slice(lo, hi) for c in cols])
            return bi, lo, hi, transfer(block)

        parts = []
        block_iter = pipelined(
            iter(place.items), [PipeStage("plan-prep", prep)], depth=depth, inline=False,
        )
        try:
            with closing(block_iter), _tele.dispatch_run(dev):
                for bi, lo, hi, staged in block_iter:
                    block = transfer.receive(staged)
                    feeds = [
                        as_tensor(block.column(self._feed_map[n]).values, dev)
                        for n in feed_names
                    ]
                    _dl.check("lazy.force")

                    def prepared(lo_, hi_, d, lo=lo, hi=hi, feeds=feeds):
                        # the block's own range: the prepared feeds; a
                        # split re-slices its halves
                        return feeds if (lo_, hi_) == (lo, hi) else feeds_for(lo_, hi_, d)

                    outs = _api._dispatch_rows(
                        "lazy.force", "lazy.force.block", fp, run, prepared, fscope,
                        bi, lo, hi, place, split=split, forensics=False,
                    )
                    del feeds, prepared
                    check(outs, f"lazy fused block {bi}")
                    parts.append(outs)
        finally:
            transfer.close()
        return parts

    def host_values(self, name: str):
        return self.force().host_values(name)

    def collect(self):
        return self.force().collect()

    def collect_async(self):
        """Force the plan on a background daemon thread and return a
        `concurrent.futures.Future` of ``collect()``'s result, so the
        caller overlaps host work with device work.

        The ambient deadline/admission context is COPIED at call time
        (contextvars do not flow into threads by themselves): inside a
        ``deadline_scope`` the async force inherits the scope's budget —
        an expired or cancelled scope resolves the future with the typed
        `DeadlineExceeded` / `Cancelled`."""
        import threading
        from concurrent.futures import Future

        ctx = contextvars.copy_context()
        fut: Future = Future()

        def _run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(ctx.run(lambda: self.force().collect()))
            except BaseException as e:  # typed deadline errors included
                fut.set_exception(e)

        threading.Thread(
            target=_run, name="tfs-collect-async", daemon=True
        ).start()
        return fut

    def to_pandas(self):
        return self.force().to_pandas()

    def to_host(self) -> TensorFrame:
        return self.force().to_host()

    def column(self, name: str) -> Column:
        return self.force().column(name)

    def __getitem__(self, name: str) -> Column:
        return self.force().column(name)

    # -- non-terminal frame ops -----------------------------------------
    def to_device(self, device: DeviceLike = None) -> "LazyFrame":
        """The same plan over the base moved to ``device``; terminal
        actions then run there."""
        return self._with_base(self._base.to_device(device), device)

    def repartition(self, num_blocks: int) -> "LazyFrame":
        return self._with_base(self._base.repartition(num_blocks))

    def analyze(self) -> "LazyFrame":
        return self._with_base(self._base.analyze())

    def print_schema(self) -> None:
        print(self.info.explain())

    # -- plan rendering --------------------------------------------------
    def plan(self) -> LazyPlan:
        return LazyPlan(
            list(self._stages), self._graph, dict(self._sources),
            dict(self._feed_map), self.info,
        )

    def explain_plan(self) -> str:
        """The fused plan with per-stage provenance (rendered by
        `explain` for LazyFrames)."""
        lines = [
            f"LazyFrame plan: {len(self._stages)} fused stage(s), "
            f"{len(self._graph)} nodes, {len(self._feed_map)} feed(s), "
            f"{self._base.nrows} rows x {self._base.num_blocks} blocks"
        ]
        for i, st in enumerate(self._stages, 1):
            lines.append(f"  stage {i}: {st!r}")
        for ph in sorted(self._feed_map):
            lines.append(f"  feed: {ph} <- column {self._feed_map[ph]!r}")
        for c in sorted(self._sources):
            lines.append(f"  pending: {c} = {self._sources[c]}")
        lines.append(self.info.explain())
        return "\n".join(lines)

    # -- relational verbs (seal the fused chain into a plan DAG) --------
    def _to_plan_node(self):
        """The pending fused chain as a `graph.plan` DAG fragment: the
        base frame as a ``source`` leaf, plus (when stages are pending)
        ONE opaque ``map`` node carrying the whole spliced chain —
        execution replays it through this class, so fusion is identical
        to a plain `force()`."""
        from .graph import plan as _plan

        node = _plan.PlanNode("source", (), {"frame": self._base})
        if self._sources:
            node = _plan.PlanNode("map", (node,), {
                "kind": "fused",
                "graph": self._graph,
                "sources": dict(self._sources),
                "feed_map": dict(self._feed_map),
                "stages": list(self._stages),
            })
        return node

    def _relational(self) -> "RelationalFrame":
        return RelationalFrame(
            self._to_plan_node(), executor=self._executor, device=self._device
        )

    def filter(self, pred, selectivity: Optional[float] = None):
        """Relational filter: defers as a plan-DAG node (`graph.plan`);
        the optimizer may reorder it below maps or push it into the
        ingest scan. ``selectivity`` is an optional 0..1 hint for the
        cost model (default `config.plan_selectivity_default`)."""
        return self._relational().filter(pred, selectivity=selectivity)

    def select(self, names):
        """Relational projection (column pruning seed)."""
        return self._relational().select(names)

    def sort_by(self, *keys: str, descending: bool = False):
        return self._relational().sort_by(*keys, descending=descending)

    def join(self, other, on, how: str = "inner"):
        return self._relational().join(other, on, how=how)


# ---------------------------------------------------------------------------
# RelationalFrame: a deferred relational plan DAG
# ---------------------------------------------------------------------------


def _cached_result(hit: TensorFrame, base: TensorFrame, out_names, dev) -> TensorFrame:
    """A materialization-cache hit as `LazyFrame.force` returns a computed
    result: the plan's outputs on ``dev``, then the base's own passthrough
    columns (the hit's copies are equal: the data fingerprint matched)."""
    shadow = set(out_names)
    cols = [Column(n, as_tensor(hit.column(n).values, dev)) for n in out_names]
    cols += [base.column(c) for c in base.columns if c not in shadow]
    return TensorFrame(cols, base.offsets)


def _as_plan_node(obj):
    """Coerce a frame-like object to a plan-DAG node (join inputs)."""
    from .graph import plan as _plan

    if isinstance(obj, RelationalFrame):
        return obj._node
    if isinstance(obj, LazyFrame):
        return obj._to_plan_node()
    return _plan.PlanNode("source", (), {"frame": obj})


class RelationalFrame:
    """A frame defined by a pending relational plan DAG.

    Built by the relational verbs on `TensorFrame` / `LazyFrame` or by
    `tft.scan(...)`; verbs compose lazily into `graph.plan.PlanNode`s,
    `force()` optimizes the DAG through the cost-based rewriter
    (`graph.optimizer`, `config.plan_optimizer`), then lowers it
    node-by-node onto the port's executors on its device
    (`graph.plan.execute`). All state is immutable — every verb returns a
    new `RelationalFrame`, so plans branch like frames do."""

    def __init__(self, node, executor=None, device: DeviceLike = None):
        self._node = node
        self._executor = executor
        self._device = device
        self._forced: Optional[Tuple[torch.device, TensorFrame]] = None
        self._opt: Optional[Tuple] = None  # (optimized node, decisions)

    def _chain(self, node) -> "RelationalFrame":
        return RelationalFrame(node, executor=self._executor, device=self._device)

    # -- verbs ----------------------------------------------------------
    def filter(self, pred, selectivity: Optional[float] = None):
        from .graph import plan as _plan

        if not isinstance(pred, _plan.Pred):
            raise TypeError(
                "filter wants a predicate built from tft.col(...) "
                f"comparisons, got {type(pred).__name__}"
            )
        payload: Dict[str, object] = {"pred": pred}
        if selectivity is not None:
            s = float(selectivity)
            if not 0.0 <= s <= 1.0:
                raise ValueError(
                    f"filter selectivity hint must be in [0, 1], got {s}"
                )
            payload["selectivity"] = s
        return self._chain(_plan.PlanNode("filter", (self._node,), payload))

    def select(self, names):
        from .graph import plan as _plan

        names = [names] if isinstance(names, str) else list(names)
        return self._chain(
            _plan.PlanNode("select", (self._node,), {"columns": tuple(names)})
        )

    def sort_by(self, *keys: str, descending: bool = False):
        from .graph import plan as _plan

        if not keys:
            raise ValueError("sort_by needs at least one key column")
        return self._chain(_plan.PlanNode("sort", (self._node,), {
            "keys": tuple(keys), "descending": bool(descending),
        }))

    def join(self, other, on, how: str = "inner"):
        from .graph import plan as _plan

        if how != "inner":
            raise ValueError(
                f"join how={how!r}: only the hash equi-join ('inner') "
                "is implemented"
            )
        on = (on,) if isinstance(on, str) else tuple(on)
        return self._chain(_plan.PlanNode(
            "join", (self._node, _as_plan_node(other)),
            {"on": on, "how": how},
        ))

    def group_by(self, *keys: str) -> "LazyGroupedFrame":
        if not keys:
            raise ValueError("group_by needs at least one key column")
        return LazyGroupedFrame(self, keys)

    def map_blocks(self, fetches, feed_dict=None, fetch_names=None):
        """Deferred row-local map stage. Adjacent map stages fuse into
        ONE callable per block at execution (via the ordinary `LazyFrame`
        splice), including across relational boundaries the optimizer
        clears."""
        from .graph import plan as _plan

        if callable(fetches) and not isinstance(fetches, _api.dsl.Tensor):
            # the tracer front-end needs a concrete frame to name/shape
            # its placeholders — a plan node has none until execution
            raise TypeError(
                "relational map_blocks wants graph fetches (dsl "
                "expressions / Graph / GraphDef); the traced-function "
                "front-end needs a concrete frame — force() first or "
                "build the map with tft.dsl placeholders"
            )
        graph, fetch_list = _api._as_graph(fetches, fetch_names)
        feeds: set = set()
        for ph in graph.placeholders():
            name = ph.name
            if feed_dict and name in feed_dict:
                feeds.add(feed_dict[name])
                continue
            # without an executed frame the default-matching convention
            # (exact name, else strip _input/_k suffixes) cannot be
            # resolved yet — demand both candidates so column pruning
            # never drops the one that matches at execution
            feeds.add(name)
            for suf in _api._REDUCE_SUFFIXES:
                if name.endswith(suf):
                    feeds.add(name[: -len(suf)])
        stage = {
            "graph": graph,
            "fetch_list": list(fetch_list),
            "feed_dict": dict(feed_dict or {}),
            "feeds": frozenset(feeds),
        }
        return self._chain(_plan.PlanNode(
            "map", (self._node,), {"kind": "exprs", "stages": [stage]},
        ))

    # -- terminals -------------------------------------------------------
    def optimize(self) -> Tuple:
        """(optimized DAG root, decision records) — memoized; identity
        rewrite when `config.plan_optimizer` is off."""
        if self._opt is None:
            from . import config as _config

            if _config.get().plan_optimizer:
                from .graph import optimizer as _optm

                self._opt = _optm.optimize(self._node, self._executor)
            else:
                self._opt = (self._node, [])
        return self._opt

    def force(self, executor=None, device: DeviceLike = None):
        """Optimize, then execute the DAG on ``device`` (default: the
        frame's device). The result of a call without ``executor=`` is
        memoized per device."""
        dev = resolve_device(device if device is not None else self._device)
        if executor is None and self._forced is not None and self._forced[0] == dev:
            return self._forced[1]
        from .graph import plan as _plan
        from .runtime import materialize as _mat

        _plan._note_force()
        node, _ = self.optimize()
        ex = executor or self._executor
        cache_key = None
        if ex is None and _mat.enabled():
            data_fp = _plan.data_fingerprint(node)
            if data_fp is not None:
                from .runtime.scheduler import device_label

                plan_fp = _mat.relational_fingerprint(
                    _plan.plan_fingerprint(node), device=device_label(dev)
                )
                hit = _mat.lookup(data_fp, plan_fp)
                if hit is not None:
                    # host columns, as the JAX package's hit: a plan's
                    # filter, sort and join results are host columns too
                    _plan.note_cache_hit()
                    self._forced = (dev, hit)
                    return hit
                cache_key = (data_fp, plan_fp)
        t0 = time.perf_counter()
        out = _plan.execute(node, executor=ex, device=dev)
        if cache_key is not None:
            _mat.store(cache_key[0], cache_key[1], out, compute_s=time.perf_counter() - t0)
        if executor is None:
            self._forced = (dev, out)
        return out

    def collect(self):
        return self.force().collect()

    def plan(self) -> LazyPlan:
        """The OPTIMIZED plan as a `LazyPlan` (fingerprintable)."""
        node, _ = self.optimize()
        return LazyPlan([], Graph(), relational=node)

    def explain_plan(self) -> str:
        """Pre- and post-optimization DAG with per-node costed
        estimates and every rewrite decision — WITHOUT executing."""
        from .graph import plan as _plan
        from .graph.optimizer import Estimator

        node, decisions = self.optimize()
        pre_est = Estimator(self._executor)
        post_est = Estimator(self._executor)

        def annot(est):
            def fn(n):
                rows, cols = est.shape(n)
                return (
                    f"~{rows:,.0f} rows x {cols:.0f} cols, "
                    f"est {est.node_cost(n) * 1e3:.3f} ms"
                )
            return fn

        lines = ["RelationalFrame plan (pre-optimization):"]
        lines.append(_plan.render(self._node, annot(pre_est)))
        lines.append(
            f"  modeled total: {pre_est.plan_cost(self._node) * 1e3:.3f} ms"
        )
        lines.append("optimized plan:")
        lines.append(_plan.render(node, annot(post_est)))
        lines.append(
            f"  modeled total: {post_est.plan_cost(node) * 1e3:.3f} ms"
        )
        lines.append("rewrite decisions:")
        if not decisions:
            lines.append("  (none)")
        for d in decisions:
            verdict = "accepted" if d["accepted"] else "REJECTED (regression)"
            lines.append(
                f"  {d['rule']}: {verdict} — {d['detail']} "
                f"[{d['cost_before_s'] * 1e3:.3f} ms -> "
                f"{d['cost_after_s'] * 1e3:.3f} ms]"
            )
        lines.append(f"plan fingerprint: {_plan.plan_fingerprint(node)}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        from .graph import plan as _plan

        return f"RelationalFrame<\n{_plan.render(self._node)}\n>"


class LazyGroupedFrame:
    """`RelationalFrame.group_by(...)` handle: `.agg(out=("op", col))`
    appends a lazy groupby-agg node (ops: sum / mean / min / max) — the
    lazy sibling of the eager `GroupedFrame`."""

    def __init__(self, rel: RelationalFrame, keys: Tuple[str, ...]):
        for k in keys:
            if not isinstance(k, str):
                raise TypeError(
                    f"group_by keys must be column names, got {type(k).__name__}"
                )
        self._rel = rel
        self._keys = tuple(keys)

    def agg(self, **specs) -> RelationalFrame:
        from .graph import plan as _plan

        if not specs:
            raise ValueError(
                "agg needs at least one out=(op, column) spec, e.g. "
                "total=('sum', 'x')"
            )
        parsed: Dict[str, Tuple[str, str]] = {}
        for out, spec in specs.items():
            if (
                not isinstance(spec, (tuple, list)) or len(spec) != 2
                or not all(isinstance(s, str) for s in spec)
            ):
                raise TypeError(
                    f"agg spec {out}={spec!r}: want a ('op', 'column') pair"
                )
            op, colname = spec
            if op not in _plan.AGG_OPS:
                raise ValueError(
                    f"agg op {op!r} is not one of {list(_plan.AGG_OPS)}"
                )
            parsed[out] = (op, colname)
        node = _plan.PlanNode("groupby", (self._rel._node,), {
            "keys": self._keys, "specs": parsed,
        })
        return self._rel._chain(node)


# ---------------------------------------------------------------------------
# explain_analyze: execute a plan and join its spans with the cost ledger
# ---------------------------------------------------------------------------


def _fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.0f}us"


def _analyze_window(new_spans, wall_s: float, dropped: int) -> Dict:
    """Join one execution window's spans with the cost ledger into the
    explain_analyze payload (shared by the text and JSON renderings)."""
    from .runtime import costmodel as _cm
    from .utils import telemetry as _tele

    ids = {s.span_id for s in new_spans}
    agg = _tele.span_aggregates(new_spans)
    # verb spans cover the whole window by construction: attribution counts
    # everything below them
    non_verb = [s for s in new_spans if s.kind != "verb"]
    attributed = _tele._union_seconds([(s.t0, s.t1) for s in non_verb])
    stages: Dict[Tuple[str, str], Dict] = {}
    per_prog: Dict[str, Dict] = {}
    for s in new_spans:
        st = stages.setdefault(
            (s.name, s.kind),
            {
                "name": s.name, "kind": s.kind, "count": 0,
                "seconds": 0.0, "rows": 0, "pad_rows": 0,
                "devices": set(), "programs": set(),
            },
        )
        st["count"] += 1
        st["seconds"] += s.seconds
        prog = s.attrs.get("program")
        if prog:
            st["programs"].add(str(prog))
        if s.kind == "dispatch":
            rows = int(s.attrs.get("rows") or 0)
            st["rows"] += rows
            dev = s.attrs.get("device")
            if dev:
                st["devices"].add(str(dev))
            if prog:
                p = per_prog.setdefault(
                    str(prog),
                    {"rows": 0, "pad_rows": 0, "rungs": set(), "devices": set()},
                )
                p["rows"] += rows
                if rows:
                    p["rungs"].add(rows)
                if dev:
                    p["devices"].add(str(dev))
    stage_rows = [
        {**st, "devices": sorted(st["devices"]), "programs": sorted(st["programs"])}
        for st in stages.values()
    ]
    stage_rows.sort(key=lambda r: -r["seconds"])

    roof = {r["program"]: r for r in _cm.roofline(agg["by_program"])}
    res = _cm.residuals(new_spans)
    res_progs = res.get("programs", {})
    programs = []
    for fp in sorted(agg["by_program"]):
        p = agg["by_program"][fp]
        if not p["dispatches"] and not p["compiles"]:
            continue  # a plan-analysis span's program attr, not an execution
        r = roof.get(fp, {})
        extra = per_prog.get(fp, {})
        rr = res_progs.get(fp, {})
        programs.append(
            {
                "program": fp,
                "dispatches": int(p["dispatches"]),
                "execute_s": p["execute_s"],
                "compiles": int(p["compiles"]),
                "compile_s": p["compile_s"],
                "host_syncs": int(p["host_syncs"]),
                "host_sync_s": p["host_sync_s"],
                "rows": extra.get("rows", 0),
                "pad_rows": extra.get("pad_rows", 0),
                "bucket_rungs": sorted(extra.get("rungs", ())),
                "devices": sorted(extra.get("devices", ())),
                "modeled_flops_per_exec": r.get("flops_per_exec"),
                "modeled_bytes_per_exec": r.get("bytes_per_exec"),
                "modeled_footprint_bytes": r.get("footprint_bytes"),
                "achieved_flops_s": r.get("achieved_flops_s"),
                "achieved_hbm_bytes_s": r.get("achieved_hbm_bytes_s"),
                "flops_frac_of_peak": r.get("flops_frac_of_peak"),
                "hbm_frac_of_peak": r.get("hbm_frac_of_peak"),
                "residual_ratio": rr.get("residual_ratio"),
            }
        )
    roots = [s for s in new_spans if s.parent_id is None or s.parent_id not in ids]
    return {
        "wall_s": wall_s,
        "attributed_s": attributed,
        "coverage": min(1.0, attributed / max(wall_s, 1e-12)),
        "spans": len(new_spans),
        "spans_dropped_during": dropped,
        "roots": len(roots),
        "stages": stage_rows,
        "programs": programs,
        "accuracy_fit": res.get("fit"),
    }


def _render_explain_analyze(data: Dict) -> str:
    from .utils.telemetry import _fmt_bytes, _fmt_rate

    lines = [
        f"explain_analyze: {_fmt_seconds(data['wall_s'])} wall, "
        f"{data['coverage'] * 100:.1f}% attributed to "
        f"{len(data['stages'])} stage group(s) "
        f"({data['spans']} span(s), {data['roots']} root(s))"
    ]
    if data["spans_dropped_during"]:
        lines.append(
            f"  WARNING: {data['spans_dropped_during']} span(s) fell off the "
            "ring during execution — attribution is partial"
        )
    plan = data.get("plan")
    if plan:
        lines.append(
            f"plan: {len(plan['stages'])} fused stage(s), "
            f"{plan['nodes']} node(s), feeds {plan['feeds']}"
        )
        for i, st in enumerate(plan["stages"], 1):
            outs = ", ".join(st["outputs"])
            lines.append(
                f"  stage {i}: {st['verb']} -> [{outs}] (+{st['nodes']} node(s))"
            )
    lines.append("observed stages (by span group, slowest first):")
    for st in data["stages"]:
        extra = ""
        if st["rows"]:
            extra += f" rows={st['rows']}"
        if st["pad_rows"]:
            extra += f" pad_rows={st['pad_rows']}"
        if st["devices"]:
            extra += f" devices={','.join(st['devices'])}"
        lines.append(
            f"  {st['name']:<28} {st['kind']:<9} x{st['count']:<4} "
            f"{_fmt_seconds(st['seconds'])}{extra}"
        )
    if data["programs"]:
        lines.append("programs (modeled vs achieved, this execution):")
        for p in data["programs"]:
            lines.append(
                f"  {p['program']:<16} dispatches={p['dispatches']} "
                f"execute={_fmt_seconds(p['execute_s'])} "
                f"compiles={p['compiles']} "
                f"({_fmt_seconds(p['compile_s'])}) rows={p['rows']} "
                f"pad={p['pad_rows']} rungs={p['bucket_rungs']}"
            )
            frac = ""
            if p["flops_frac_of_peak"] is not None:
                frac = f" ({p['flops_frac_of_peak'] * 100:.1f}% of peak)"
            rr = p["residual_ratio"]
            lines.append(
                "    modeled "
                f"{_fmt_rate(p['modeled_flops_per_exec'], 'FLOP')}/exec, "
                f"{_fmt_bytes(p['modeled_bytes_per_exec'])}/exec | "
                "achieved "
                f"{_fmt_rate(p['achieved_flops_s'], 'FLOP/s')}, "
                f"{_fmt_rate(p['achieved_hbm_bytes_s'], 'B/s')}{frac}"
                + (f" | residual={rr:.2f}x" if rr is not None else "")
            )
    return "\n".join(lines)


def _sync_result(result) -> None:
    """Wait for the card's queue behind ``result`` (a frame, a tensor or a
    dict of tensors): the dispatch spans time the enqueue."""
    ts = []
    if isinstance(result, TensorFrame):
        ts = [
            result.column(c).values for c in result.columns
            if isinstance(result.column(c).values, torch.Tensor)
        ]
    elif isinstance(result, torch.Tensor):
        ts = [result]
    elif isinstance(result, dict):
        ts = [v for v in result.values() if isinstance(v, torch.Tensor)]
    for dev in {t.device for t in ts if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def explain_analyze(plan, format: str = "text"):
    """EXPLAIN ANALYZE for a lazy plan: EXECUTE it and render each stage
    with what actually happened — observed wall time per span group, rows
    per dispatch, build counts — beside the cost ledger's modeled flops
    and bytes and the achieved rates of every program the execution
    touched (`runtime.costmodel`), plus the residual ratio per program.

    ``plan`` is a `LazyFrame` (its pending chain is forced fresh, so there
    is always a real execution to measure), a `RelationalFrame`, or any
    zero-argument callable running verbs (the way to analyze a chain
    ending in a reduce: ``tft.explain_analyze(lambda:
    lf.reduce_blocks(...))``); a callable returning a LazyFrame is forced.
    A bare `LazyPlan` is rejected: it cannot execute. ``format="json"``
    returns the payload dict. Needs ``config.telemetry``. The card's queue
    is drained inside the window (a ``host_sync`` stage) and the dispatch
    events resolved, so execute times are device times."""
    from .utils import telemetry as _tele

    if format not in ("text", "json"):
        raise ValueError(
            f"explain_analyze format={format!r} is not one of 'text' | 'json'"
        )
    if not _tele.enabled():
        raise RuntimeError(
            "explain_analyze needs telemetry: the span ring is the "
            "measurement (config.update(telemetry=True) / TFS_TELEMETRY=1)"
        )
    if isinstance(plan, LazyPlan):
        raise TypeError(
            "explain_analyze cannot execute a bare LazyPlan (it is detached "
            "from its frame); pass the LazyFrame itself or a callable "
            "running the terminal action"
        )
    plan_obj: Optional[LazyPlan] = None
    if isinstance(plan, LazyFrame):
        plan_obj = plan.plan()
        fresh = LazyFrame(
            plan._base, plan._graph, plan._sources, plan._feed_map,
            plan._stages, plan._executor, plan._device,
        )
        action = fresh.force
    elif isinstance(plan, RelationalFrame):
        fresh_rel = RelationalFrame(
            plan._node, executor=plan._executor, device=plan._device
        )
        action = fresh_rel.force
    elif callable(plan):
        action = plan
    else:
        raise TypeError(
            "explain_analyze wants a LazyFrame or a callable, got "
            f"{type(plan).__name__}"
        )
    import time as _time

    sid0 = _tele.allocate_span_id()  # monotonic floor for window spans
    dropped0 = _tele.spans_dropped()
    t0 = _time.perf_counter()
    result = action()
    if isinstance(result, LazyFrame):
        plan_obj = result.plan()
        result = result.force()
    elif isinstance(result, RelationalFrame):
        result = result.force()
    with _tele.span("explain_analyze.sync", kind="host_sync"):
        _sync_result(result)
    wall_s = _time.perf_counter() - t0
    new = [s for s in _tele.spans() if s.span_id > sid0]
    _tele.resolve_device_times(new)
    data = _analyze_window(new, wall_s, _tele.spans_dropped() - dropped0)
    if plan_obj is not None:
        data["plan"] = {
            "stages": [
                {"verb": st.verb, "outputs": list(st.outputs), "nodes": st.nodes}
                for st in plan_obj.stages
            ],
            "nodes": len(plan_obj.graph),
            "feeds": dict(plan_obj.feeds),
            "outputs": sorted(plan_obj.sources),
        }
    else:
        data["plan"] = None
    if format == "json":
        return data
    return _render_explain_analyze(data)
