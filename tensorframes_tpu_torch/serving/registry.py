"""Named endpoint registry: the serving runtime's control plane.

The PyTorch counterpart of `tensorframes_tpu/serving/registry.py`. A
serving process registers each program ONCE, validates it against a
declared column schema, and warms every bucket-ladder rung up to the
configured max batch, so steady-state traffic lowers nothing new
(`Executor.compile_count` stays flat).

An `Endpoint` is (name, graph, fetches, schema, device):

- ``register(name, fetches, schema, device=...)`` accepts what
  `map_blocks` does (builder-DSL tensors, a `Graph`, GraphDef bytes or a
  file path with ``fetch_names=``) plus a `LazyFrame` / `LazyPlan`, whose
  pending fused graph and feed wiring are lifted verbatim. ``device``
  follows the port's rule: ``None`` is the CUDA card, and a machine
  without one raises unless the caller passes ``device="cpu"``.
- The declared schema (column -> dtype or (dtype, cell_shape), the cell
  shape a list or tuple) is the contract: placeholders must resolve to
  schema columns with exact dtypes and compatible shapes AT REGISTRATION
  (the verbs' own `_match_columns`), and every request is validated
  against it before it enters a batching lane, so a malformed request
  fails alone.
- **Batchability is proven**: an endpoint coalesces requests only when
  `shape_policy.rowwise_fetches` proves every fetch row-local; then
  concat -> dispatch -> slice is bit-identical to per-request execution.
  Anything else still serves, one dispatch per request.

Registration is process-wide and thread-safe; `reset()` (tests) tears
down the registry and the batching lanes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..frame import Column, TensorFrame
from ..graph.ir import Graph, base_name as _base
from ..schema import ColumnInfo, FrameInfo, ScalarType, Shape

__all__ = [
    "Endpoint",
    "register",
    "unregister",
    "get",
    "endpoints",
    "reset",
]

_lock = threading.Lock()
_endpoints: Dict[str, "Endpoint"] = {}


# ---------------------------------------------------------------------------
# schema normalization
# ---------------------------------------------------------------------------


def normalize_schema(schema) -> FrameInfo:
    """The declared request schema as a `FrameInfo`: a `FrameInfo` as-is,
    or a dict of column -> dtype-like (numpy dtype, dtype string,
    `ScalarType`) or (dtype-like, cell_shape as a list or tuple)."""
    if isinstance(schema, FrameInfo):
        return schema
    if not isinstance(schema, dict) or not schema:
        raise TypeError(
            "serving schema must be a non-empty dict of column -> dtype "
            "or (dtype, cell_shape), or a FrameInfo; got "
            f"{type(schema).__name__}"
        )
    cols: List[ColumnInfo] = []
    for name, spec in schema.items():
        if isinstance(spec, ColumnInfo):
            cols.append(spec.with_name(name))
            continue
        if isinstance(spec, (tuple, list)) and len(spec) == 2:
            dtype_like, cell = spec
        else:
            dtype_like, cell = spec, ()
        if isinstance(dtype_like, ScalarType):
            st = dtype_like
        else:
            st = ScalarType.from_np_dtype(np.dtype(dtype_like))
        cols.append(ColumnInfo(name, st, Shape(tuple(cell))))
    return FrameInfo(cols)


def _schema_frame(info: FrameInfo, rows: int) -> TensorFrame:
    """A synthetic single-block host frame matching the declared schema:
    what registration validates and warms against. Unknown cell dims
    materialize as 1."""
    cols = []
    for ci in info:
        cell = tuple(1 if d is None else int(d) for d in ci.cell_shape.dims)
        if ci.dtype is ScalarType.string:
            data = np.array([b""] * rows, dtype=object)
        else:
            data = np.zeros((rows,) + cell, dtype=ci.dtype.np_dtype)
        cols.append(Column(ci.name, data, ci.dtype))
    return TensorFrame(cols)


# ---------------------------------------------------------------------------
# the endpoint
# ---------------------------------------------------------------------------


class Endpoint:
    """One registered serving program, immutable after construction
    (replacing re-registers). ``run_frame`` is THE execution path: warm-up,
    inline requests and coalesced batch dispatches all go through it, so
    they share the executor's cached callables."""

    def __init__(
        self,
        name: str,
        graph: Graph,
        fetch_edges: Sequence[str],
        output_names: Sequence[str],
        feed_dict: Dict[str, str],
        schema: FrameInfo,
        outputs: FrameInfo,
        required_columns: Tuple[str, ...],
        batchable: bool,
        max_batch_rows: int,
        device,
        executor=None,
    ):
        self.name = name
        self.graph = graph
        self.fetch_edges = tuple(fetch_edges)
        self.output_names = tuple(output_names)
        self.feed_dict = dict(feed_dict)
        self.schema = schema
        self.outputs = outputs
        self.required_columns = tuple(required_columns)
        self.batchable = bool(batchable)
        self.max_batch_rows = int(max_batch_rows)
        self.device = device
        self.executor = executor
        self.fingerprint = graph.fingerprint()
        self.warmed_rungs: Tuple[int, ...] = ()
        self.created_at = time.time()
        # per-endpoint batch window (milliseconds) the autotuner writes
        # (`runtime.autotune`); None = follow config.serve_batch_window_ms
        self.batch_window_ms: Optional[float] = None

    # -- request validation --------------------------------------------
    def validate_request(self, frame: TensorFrame) -> None:
        """Check one request frame against the declared schema before it
        enters a batching lane. Raises ValueError."""
        if frame.nrows < 1:
            raise ValueError(f"endpoint {self.name!r}: request frame has no rows")
        for col in self.required_columns:
            ci = self.schema[col]
            if col not in frame.info:
                raise ValueError(
                    f"endpoint {self.name!r}: request is missing column "
                    f"{col!r} (schema: {[c.name for c in self.schema]}; "
                    f"got: {frame.columns})"
                )
            got = frame.info[col]
            if got.dtype is not ci.dtype:
                raise ValueError(
                    f"endpoint {self.name!r}: column {col!r} has dtype "
                    f"{got.dtype.name} but the schema declares "
                    f"{ci.dtype.name} (TF graphs do not promote dtypes)"
                )
            if not got.cell_shape.check_more_precise_than(ci.cell_shape):
                raise ValueError(
                    f"endpoint {self.name!r}: column {col!r} with cell "
                    f"shape {got.cell_shape} is not compatible with the "
                    f"declared {ci.cell_shape}"
                )
            if not frame.column(col).is_dense:
                raise ValueError(
                    f"endpoint {self.name!r}: column {col!r} is ragged; "
                    "serving requests need uniform cells"
                )

    # -- execution ------------------------------------------------------
    def run_frame(
        self,
        frame: TensorFrame,
        timeout_s: Optional[float] = None,
        _use_cache: bool = True,
    ) -> TensorFrame:
        """Run the program on ``frame`` on the endpoint's device and return
        ONLY the fetch outputs, renamed to the registered output names.

        With the materialization cache on (``config.materialize_cache_bytes``
        > 0) a repeated (host request bytes, program, config) triple is
        served from the cache without dispatching. Warm-up passes
        ``_use_cache=False``: its synthetic frames must reach the device."""
        from .. import api as _api
        from ..runtime import materialize as _mat
        from ..runtime.scheduler import device_label

        cache_key = None
        if _use_cache and self.executor is None and _mat.enabled():
            data_fp = _mat.frame_fingerprint(frame)
            if data_fp is not None:
                plan_fp = _mat.plan_fingerprint(
                    self.fingerprint, self.feed_dict, self.output_names,
                    device=device_label(self.device),
                )
                hit = _mat.lookup(data_fp, plan_fp)
                if hit is not None:
                    return hit
                cache_key = (data_fp, plan_fp)
        t0 = time.perf_counter()
        res = _api.map_blocks(
            self.graph,
            frame,
            feed_dict=self.feed_dict or None,
            fetch_names=list(self.fetch_edges),
            executor=self.executor,
            device=self.device,
            timeout_s=timeout_s,
        )
        cols = [
            Column(out, res.column(_base(edge)).values)
            for out, edge in zip(self.output_names, self.fetch_edges)
        ]
        out_frame = TensorFrame(cols, offsets=[0, frame.nrows])
        if cache_key is not None:
            _mat.store(
                cache_key[0], cache_key[1], out_frame,
                ledger_fp=self.fingerprint,
                compute_s=time.perf_counter() - t0,
            )
        return out_frame

    # -- warm-up --------------------------------------------------------
    def warm(self) -> Tuple[int, ...]:
        """Run every bucket-ladder rung up to ``max_batch_rows`` once
        (batchable endpoints only: the batcher pads every dispatch to a
        rung, so these are all the shapes steady-state traffic makes). On
        the card this lowers the graph and settles the cuBLAS handles and
        the allocator's blocks for each rung. Non-batchable endpoints
        dispatch at raw request sizes, so there is nothing to warm."""
        from .. import shape_policy as _sp
        from ..utils import telemetry as _tele

        if not self.batchable:
            return ()
        rungs = tuple(_sp.bucket_ladder(self.max_batch_rows))
        t0 = time.perf_counter()
        with _tele.span(
            "serving.warm", kind="stage", endpoint=self.name, rungs=len(rungs)
        ):
            for rung in rungs:
                self.run_frame(_schema_frame(self.schema, rung), _use_cache=False)
        self.warmed_rungs = rungs
        _tele.counter_inc("serve_warm_rungs", float(len(rungs)), endpoint=self.name)
        from ..utils.log import get_logger

        get_logger("serving").info(
            "endpoint %r warmed %d rung(s) up to %d rows in %.2fs",
            self.name, len(rungs), rungs[-1] if rungs else 0,
            time.perf_counter() - t0,
        )
        return rungs

    # -- introspection --------------------------------------------------
    def describe(self) -> dict:
        """JSON-friendly descriptor (the server's GET /serve listing)."""
        return {
            "name": self.name,
            "program": self.fingerprint,
            "batchable": self.batchable,
            "max_batch_rows": self.max_batch_rows,
            "batch_window_ms": self.batch_window_ms,
            "warmed_rungs": list(self.warmed_rungs),
            "columns": {
                ci.name: {
                    "dtype": ci.dtype.name,
                    "cell_shape": list(ci.cell_shape.dims),
                }
                for ci in self.schema
                if ci.name in self.required_columns
            },
            "outputs": {
                ci.name: {
                    "dtype": ci.dtype.name,
                    "cell_shape": list(ci.cell_shape.dims),
                }
                for ci in self.outputs
            },
        }

    def __repr__(self) -> str:
        return (
            f"Endpoint({self.name!r}, program {self.fingerprint[:12]}, "
            f"{'batchable' if self.batchable else 'unbatched'}, "
            f"max_batch_rows={self.max_batch_rows}, device={self.device}, "
            f"{len(self.warmed_rungs)} warmed rung(s))"
        )


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


def _normalize_program(fetches, fetch_names, feed_dict):
    """(graph, fetch_edges, output_names, feed_dict) of ``fetches``. Lazy
    plans carry their own feed wiring; everything else goes through the
    verbs' `_as_graph`."""
    from .. import api as _api
    from ..lazy import LazyFrame, LazyPlan

    plan = None
    if isinstance(fetches, LazyFrame):
        plan = fetches.plan()
    elif isinstance(fetches, LazyPlan):
        plan = fetches
    if plan is not None:
        if feed_dict:
            raise ValueError(
                "register: feed_dict cannot be combined with a lazy "
                "plan — the plan carries its own placeholder->column "
                f"wiring ({plan.feeds})"
            )
        if not plan.sources:
            raise ValueError(
                "register: the lazy plan has no pending stages (nothing "
                "to serve); register the graph directly instead"
            )
        output_names = sorted(plan.sources)
        return (
            plan.graph,
            [plan.sources[c] for c in output_names],
            output_names,
            dict(plan.feeds),
        )
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    return graph, fetch_list, [_base(f) for f in fetch_list], dict(feed_dict or {})


def register(
    name: str,
    fetches,
    schema,
    *,
    fetch_names: Optional[Sequence[str]] = None,
    feed_dict: Optional[Dict[str, str]] = None,
    max_batch_rows: Optional[int] = None,
    warm: Optional[bool] = None,
    executor=None,
    replace: bool = False,
    device: DeviceLike = None,
) -> Endpoint:
    """Register a named serving endpoint on ``device``: validate
    ``fetches`` against the declared ``schema``, classify batchability,
    warm the bucket ladder, and make it servable through the micro-batcher
    and the HTTP front-end. See the module docstring."""
    from .. import api as _api
    from .. import config as _config
    from .. import shape_policy as _sp
    from ..graph.analysis import analyze_graph

    if not name or "/" in name or name != name.strip():
        raise ValueError(f"endpoint name {name!r} must be a non-empty path-safe token")
    dev = resolve_device(device)
    with _lock:
        dup = _endpoints.get(name)
    if dup is not None and not replace:
        # the cheap check BEFORE the probe and warm-up (the re-check under
        # the lock below still guards the insert)
        raise ValueError(
            f"endpoint {name!r} is already registered (program "
            f"{dup.fingerprint[:12]}); pass replace=True to swap it"
        )
    info = normalize_schema(schema)
    graph, fetch_edges, output_names, feeds = _normalize_program(
        fetches, fetch_names, feed_dict
    )
    if not fetch_edges:
        raise ValueError(f"endpoint {name!r}: no fetches to serve")
    if len(set(output_names)) != len(output_names):
        raise ValueError(f"endpoint {name!r}: duplicate output names {output_names}")

    # the verbs' own validation, against a synthetic schema frame
    probe = _schema_frame(info, 2)
    try:
        overrides = _api._ph_overrides(graph, probe, feeds, True, {})
        summary = analyze_graph(graph, list(fetch_edges), placeholder_shapes=overrides)
        mapping = _api._match_columns(summary, probe, feeds, True, {})
    except Exception as e:
        raise ValueError(
            f"endpoint {name!r}: program does not fit the declared schema: {e}"
        ) from e

    out_cols = []
    for out, edge in zip(output_names, fetch_edges):
        ns = summary.outputs[_base(edge)]
        if ns.shape.rank == 0:
            raise ValueError(
                f"endpoint {name!r}: fetch {out!r} is a scalar — serving "
                "programs must be row-preserving maps (one output row "
                "per request row); reduce-shaped programs cannot be "
                "served"
            )
        out_cols.append(ColumnInfo(out, ns.dtype, ns.shape.tail))
    outputs = FrameInfo(out_cols)

    batchable = _sp.rowwise_fetches(
        graph,
        list(fetch_edges),
        {p: ph.shape.rank for p, ph in summary.inputs.items()},
    )
    cfg = _config.get()
    mbr = int(max_batch_rows if max_batch_rows is not None else cfg.serve_max_batch_rows)
    if mbr < 1:
        raise ValueError(f"max_batch_rows must be >= 1, got {mbr}")
    ep = Endpoint(
        name=name,
        graph=graph,
        fetch_edges=fetch_edges,
        output_names=output_names,
        feed_dict=feeds,
        schema=info,
        outputs=outputs,
        required_columns=tuple(sorted(set(mapping.values()))),
        batchable=batchable,
        max_batch_rows=mbr,
        device=dev,
        executor=executor,
    )
    # probe run: only a dispatch proves the program keeps the row count
    # (a reduce-shaped program passes the static checks)
    try:
        probe_out = ep.run_frame(_schema_frame(info, 2))
    except Exception as e:
        raise ValueError(
            f"endpoint {name!r}: probe execution failed — serving "
            f"programs must be row-preserving maps over the schema "
            f"columns: {e}"
        ) from e
    if probe_out.nrows != 2:
        raise ValueError(
            f"endpoint {name!r}: program changed the row count "
            f"(2 -> {probe_out.nrows}); serving programs must be "
            "row-preserving"
        )
    if warm if warm is not None else cfg.serve_warm_compile:
        ep.warm()

    from .batcher import batcher as _the_batcher

    with _lock:
        old = _endpoints.get(name)
        if old is not None and not replace:
            raise ValueError(
                f"endpoint {name!r} is already registered (program "
                f"{old.fingerprint[:12]}); pass replace=True to swap it"
            )
        _endpoints[name] = ep
    if old is not None:
        _the_batcher().drop(name)
    from ..utils import telemetry as _tele

    _tele.counter_inc("serve_endpoints_registered", 1.0)
    return ep


def get(name: str) -> Endpoint:
    """A registered endpoint; KeyError (HTTP 404) if absent."""
    with _lock:
        try:
            return _endpoints[name]
        except KeyError:
            raise KeyError(
                f"no serving endpoint {name!r} (registered: {sorted(_endpoints)})"
            ) from None


def endpoints() -> List[dict]:
    """Descriptors of every registered endpoint (the listing route)."""
    with _lock:
        eps = list(_endpoints.values())
    return [ep.describe() for ep in eps]


def unregister(name: str) -> bool:
    """Remove an endpoint and stop its batching lanes (in-flight requests
    finish; new ones get a 404). True when something was removed."""
    with _lock:
        ep = _endpoints.pop(name, None)
    if ep is None:
        return False
    from .batcher import batcher as _the_batcher

    _the_batcher().drop(name)
    return True


def reset() -> None:
    """Test hook: forget every endpoint and stop every batching lane."""
    with _lock:
        _endpoints.clear()
    from .batcher import batcher as _the_batcher

    _the_batcher().shutdown()
