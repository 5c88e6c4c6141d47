"""Structured span tracing + a metrics registry.

The PyTorch counterpart of the registry and span half of
`tensorframes_tpu/utils/telemetry.py`:

- **Spans** — hierarchical timed regions recorded into a bounded
  thread-safe ring (8,192 spans) with parent ids and monotonic timestamps.
  Nesting rides a contextvar; threads where it does not flow (ingest
  pipeline stages) record already-timed regions with an explicit parent
  (`allocate_span_id` / `add_event`).
- **Metrics** — labeled counters, gauges (set or registered callables)
  and fixed-bucket histograms, with the JAX module's per-name bucket
  ladders (``config.histogram_buckets`` overrides them).
- **Request attribution** — `request_scope` stamps ``request=<id>`` on
  every verb span started inside (the serving front-end and its batcher
  set it).
- **Exporters** — `span_aggregates`, `export_chrome_trace` (trace-event
  JSON for Perfetto) and `export_prometheus` (text exposition), and the
  HTTP endpoint that serves them: `serve`, `maybe_serve` (started at
  import when ``config.telemetry_port`` is set) and `shutdown`.

``config.telemetry`` (env ``TFS_TELEMETRY``, default on) gates span
recording and histogram observation; counters are always live.

``diagnostics`` of the JAX module reads its cost model, which the port
does not have yet.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Span",
    "enabled",
    "span",
    "add_event",
    "current_span_id",
    "allocate_span_id",
    "counter_inc",
    "gauge_set",
    "gauge_register",
    "histogram_observe",
    "spans",
    "spans_dropped",
    "span_aggregates",
    "metrics_snapshot",
    "flat_counters",
    "labeled_counters",
    "export_chrome_trace",
    "export_prometheus",
    "serve",
    "maybe_serve",
    "shutdown",
    "request_scope",
    "current_request",
    "reset",
    "reset_counters",
]


def enabled() -> bool:
    """Telemetry master switch (``config.telemetry`` / ``TFS_TELEMETRY``)."""
    from .. import config as _config

    return _config.get().telemetry


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@dataclass
class Span:
    """One finished timed region. ``t0``/``t1`` are `time.perf_counter`
    seconds; ``parent_id`` links to the enclosing span (None for a root);
    ``kind`` is the coarse phase: ``verb`` | ``stage`` | ``host_sync`` |
    ``checkpoint`` | ``fault`` | ``span``."""

    span_id: int
    parent_id: Optional[int]
    name: str
    kind: str
    t0: float
    t1: float
    thread: int
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


_RING_ENTRIES = 8192


class _SpanRing:
    """Bounded thread-safe span store: the oldest spans fall off, and
    ``dropped`` counts them."""

    def __init__(self, maxlen: int):
        self._lock = threading.Lock()
        self._ring: "deque[Span]" = deque(maxlen=max(1, int(maxlen)))
        self.dropped = 0

    def append(self, s: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(s)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._ring)


_ids = itertools.count(1)  # next() is GIL-atomic in CPython
_ring = _SpanRing(_RING_ENTRIES)

_CURRENT: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "tfs_torch_current_span", default=None
)
# serving request attribution: the HTTP front-end and the micro-batcher's
# dispatcher set this around the verbs a request triggers, and every verb
# span under it carries ``request=`` (a coalesced batch: the joined ids)
_REQUEST: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "tfs_torch_current_request", default=None
)


class _NullCtx:
    """The disabled-telemetry context: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _SpanCtx:
    """Class-based span context; on exit the finished `Span` goes into the
    ring, with ``attrs['error']`` naming an exception that passed
    through."""

    __slots__ = ("name", "kind", "attrs", "sid", "parent", "tok", "t0", "t1")

    def __init__(self, name, kind, attrs):
        self.name = name
        self.kind = kind
        self.attrs = attrs

    def __enter__(self):
        self.sid = next(_ids)
        self.parent = _CURRENT.get()
        self.tok = _CURRENT.set(self.sid)
        if self.kind == "verb":
            rid = _REQUEST.get()
            if rid is not None:
                self.attrs["request"] = rid
        self.t0 = time.perf_counter()
        return self.sid

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __exit__(self, et, ev, tb):
        t1 = self.t1 = time.perf_counter()
        _CURRENT.reset(self.tok)
        attrs = self.attrs
        if et is not None:
            attrs = dict(attrs)
            attrs["error"] = et.__name__
        _ring.append(
            Span(
                self.sid, self.parent, self.name, self.kind, self.t0, t1,
                threading.get_ident(), attrs,
            )
        )
        return False


def span(name: str, kind: str = "span", **attrs):
    """Record a timed region into the ring (no-op context when telemetry
    is disabled). Entering yields the span id."""
    if not enabled():
        return _NULL
    return _SpanCtx(name, kind, attrs)


def current_request() -> Optional[str]:
    """Request id of the enclosing `request_scope`, if any."""
    return _REQUEST.get()


class _RequestScope:
    """Sets the ambient request id (see ``_REQUEST``)."""

    __slots__ = ("rid", "tok")

    def __init__(self, rid: str):
        self.rid = rid

    def __enter__(self):
        self.tok = _REQUEST.set(self.rid)
        return self.rid

    def __exit__(self, et, ev, tb):
        _REQUEST.reset(self.tok)
        return False


def request_scope(request_id: str):
    """Label every verb span started inside with ``request=<id>``."""
    return _RequestScope(str(request_id))


def current_span_id() -> Optional[int]:
    """Id of the enclosing span, if any — what cross-thread emitters
    (ingest pipeline stages) capture on the consumer thread and pass as
    ``add_event(parent_id=...)``."""
    return _CURRENT.get()


def allocate_span_id() -> int:
    """Reserve a span id BEFORE its region is recorded: the ingest
    pipeline hands it to worker threads as their explicit parent, then
    records the region itself via `add_event(span_id=...)`."""
    return next(_ids)


def add_event(
    name: str,
    kind: str,
    t0: float,
    t1: float,
    parent_id: Optional[int] = None,
    span_id: Optional[int] = None,
    **attrs,
) -> None:
    """Record an ALREADY-TIMED region, parented to the current span or to
    an explicit ``parent_id`` (the cross-thread case)."""
    if not enabled():
        return
    _ring.append(
        Span(
            span_id if span_id is not None else next(_ids),
            parent_id if parent_id is not None else _CURRENT.get(),
            name, kind, t0, t1,
            threading.get_ident(), attrs,
        )
    )


def spans() -> List[Span]:
    """Snapshot of the span ring (oldest first)."""
    return _ring.snapshot()


def spans_dropped() -> int:
    """Spans evicted from the ring by overflow since the last reset."""
    return _ring.dropped


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


# fixed bucket ladders per histogram family (the JAX package's; part of
# the exposition contract)
_DEFAULT_BUCKETS: Dict[str, Tuple[float, ...]] = {
    "seconds": (
        1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
        1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0,
    ),
    "rows": (
        1.0, 8.0, 64.0, 512.0, 4096.0, 32768.0, 262144.0, 2097152.0,
        16777216.0, 134217728.0, 1073741824.0,
    ),
    "bytes": (
        256.0, 4096.0, 65536.0, 1048576.0, 16777216.0, 268435456.0,
        4294967296.0,
    ),
    # 0..1 ratios (bucket fill fractions), resolution near full
    "fraction": (
        0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0,
    ),
}

# histogram name -> bucket family (default "seconds")
_HISTOGRAM_FAMILIES: Dict[str, str] = {
    "verb_seconds": "seconds",
    "compile_seconds": "seconds",
    "block_rows": "rows",
    "h2d_bytes": "bytes",
    "d2h_bytes": "bytes",
    "bucket_fill": "fraction",
    "serve_batch_rows": "rows",
    "serve_batch_fill": "rows",
    "checkpoint_write_seconds": "seconds",
    "incident_capture_seconds": "seconds",
}


def _buckets_for(name: str) -> Tuple[float, ...]:
    """Bucket boundaries for a new histogram series: the
    ``config.histogram_buckets`` override (the exact name wins over its
    family), if ascending, else the family default. A malformed override
    falls back silently: an observation never raises."""
    fam = _HISTOGRAM_FAMILIES.get(name, "seconds")
    try:
        from .. import config as _config

        over = _config.get().histogram_buckets
        if over:
            raw = over.get(name, over.get(fam))
            if raw:
                b = tuple(float(x) for x in raw)
                if b and all(x < y for x, y in zip(b, b[1:])):
                    return b
    except Exception:
        pass  # malformed override: the family default
    return _DEFAULT_BUCKETS[fam]


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1


class MetricsRegistry:
    """Thread-safe labeled counters, gauges and fixed-bucket histograms.
    Gauges are *registered* callables (evaluated at snapshot) or *set*
    values (pushed by the producer)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelItems], float] = {}
        self._gauges: Dict[Tuple[str, LabelItems], float] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}
        self._histograms: Dict[Tuple[str, LabelItems], _Histogram] = {}

    def counter_inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def flat_counters(self) -> Dict[str, float]:
        """Unlabeled counters by bare name, labeled ones rendered
        ``name{k=v,...}``."""
        with self._lock:
            items = list(self._counters.items())
        out: Dict[str, float] = {}
        for (name, labels), v in items:
            if not labels:
                out[name] = v
            else:
                lab = ",".join(f"{k}={val}" for k, val in labels)
                out[f"{name}{{{lab}}}"] = v
        return out

    def gauge_set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def gauge_register(self, name: str, fn: Callable[[], float]) -> None:
        """Registered gauges survive `reset()` (they read live state)."""
        with self._lock:
            self._gauge_fns[name] = fn

    def gauge_values(self) -> Dict[Tuple[str, LabelItems], float]:
        with self._lock:
            out = dict(self._gauges)
            fns = list(self._gauge_fns.items())
        for name, fn in fns:
            try:
                out[(name, ())] = float(fn())
            except Exception:
                pass  # a dead gauge must never break a snapshot
        return out

    def histogram_observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = _Histogram(_buckets_for(name))
                self._histograms[key] = h
            h.observe(float(value))

    def histogram_snapshot(self):
        with self._lock:
            return {
                key: (h.buckets, tuple(h.counts), h.sum, h.count)
                for key, h in self._histograms.items()
            }

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_registry = MetricsRegistry()


def counter_inc(name: str, value: float = 1.0, **labels) -> None:
    _registry.counter_inc(name, value, **labels)


def gauge_set(name: str, value: float, **labels) -> None:
    _registry.gauge_set(name, value, **labels)


def gauge_register(name: str, fn: Callable[[], float]) -> None:
    _registry.gauge_register(name, fn)


def histogram_observe(name: str, value: float, **labels) -> None:
    _registry.histogram_observe(name, value, **labels)


def flat_counters() -> Dict[str, float]:
    return _registry.flat_counters()


def labeled_counters() -> Dict[Tuple[str, LabelItems], float]:
    """Structured counter snapshot keyed ``(name, ((label, value), ...))``."""
    with _registry._lock:
        return dict(_registry._counters)


def metrics_snapshot():
    """(counters, gauges, histograms) snapshot for tests and reports."""
    return (
        _registry.flat_counters(),
        _registry.gauge_values(),
        _registry.histogram_snapshot(),
    )


def reset_counters() -> None:
    """Counters only."""
    _registry.reset_counters()


def reset() -> None:
    """Full reset: spans, counters, gauges, histograms (registered gauge
    callables survive)."""
    global _ring
    _ring = _SpanRing(_RING_ENTRIES)
    _registry.reset()


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def _union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [t0, t1] intervals (concurrent verbs
    on several threads count once)."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur0, cur1 = intervals[0]
    for a, b in intervals[1:]:
        if a > cur1:
            total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    return total + (cur1 - cur0)


def span_aggregates(span_list: Optional[List[Span]] = None) -> Dict:
    """Aggregates over the span ring: wall-clock coverage by root spans,
    totals by verb and by kind, and the per-program compile / execute /
    host-sync table (spans that carry a ``program`` attribute)."""
    ss = spans() if span_list is None else span_list
    if not ss:
        return {
            "window": 0.0, "covered": 0.0, "coverage": 0.0, "roots": 0,
            "spans": 0, "dropped": spans_dropped(),
            "by_verb": {}, "by_kind": {}, "by_program": {},
            "by_device": {},
        }
    window = max(max(s.t1 for s in ss) - min(s.t0 for s in ss), 1e-12)
    roots = [s for s in ss if s.parent_id is None]
    covered = _union_seconds([(s.t0, s.t1) for s in roots])
    by_verb: Dict[str, Dict[str, float]] = {}
    by_kind: Dict[str, Dict[str, float]] = {}
    by_program: Dict[str, Dict[str, float]] = {}
    dev_intervals: Dict[str, List[Tuple[float, float]]] = {}
    for s in ss:
        k = by_kind.setdefault(s.kind, {"seconds": 0.0, "count": 0})
        k["seconds"] += s.seconds
        k["count"] += 1
        if s.kind == "verb":
            v = by_verb.setdefault(
                s.name, {"seconds": 0.0, "calls": 0, "rows": 0.0}
            )
            v["seconds"] += s.seconds
            v["calls"] += 1
            v["rows"] += float(s.attrs.get("rows") or 0)
        prog = s.attrs.get("program")
        if prog:
            p = by_program.setdefault(
                str(prog),
                {
                    "compile_s": 0.0, "compiles": 0,
                    "execute_s": 0.0, "dispatches": 0,
                    "host_sync_s": 0.0, "host_syncs": 0,
                },
            )
            if s.kind == "compile":
                p["compile_s"] += s.seconds
                p["compiles"] += 1
            elif s.kind == "dispatch":
                p["execute_s"] += s.seconds
                p["dispatches"] += 1
            elif s.kind == "host_sync":
                p["host_sync_s"] += s.seconds
                p["host_syncs"] += 1
        if s.kind == "dispatch" and s.attrs.get("device"):
            dev_intervals.setdefault(str(s.attrs["device"]), []).append(
                (s.t0, s.t1)
            )
    return {
        "window": window,
        "covered": covered,
        "coverage": min(1.0, covered / window),
        "roots": len(roots),
        "spans": len(ss),
        "dropped": spans_dropped(),
        "by_verb": by_verb,
        "by_kind": by_kind,
        "by_program": by_program,
        "by_device": {
            d: {"busy_s": _union_seconds(iv), "dispatches": len(iv)}
            for d, iv in dev_intervals.items()
        },
    }


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def _json_safe(v):
    """Span attrs may carry numpy scalars; coerce them to JSON types."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass  # non-scalar .item(): fall through to str()
    return str(v)


def export_chrome_trace(path: Optional[str] = None) -> Dict:
    """The span ring as Chrome trace-event JSON (complete "X" events;
    load it in https://ui.perfetto.dev). Each event's ``args`` carry the
    span and parent ids. Written atomically to ``path`` when given."""
    events = []
    for s in spans():
        args = {k: _json_safe(v) for k, v in s.attrs.items() if v is not None}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append(
            {
                "name": s.name,
                "cat": s.kind,
                "ph": "X",
                "ts": s.t0 * 1e6,  # microseconds, monotonic clock
                "dur": (s.t1 - s.t0) * 1e6,
                "pid": os.getpid(),
                "tid": s.thread,
                "args": args,
            }
        )
    obj = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "tensorframes_tpu_torch.telemetry",
            "spans_dropped": spans_dropped(),
        },
    }
    if path is not None:
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(obj, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return obj


def _prom_name(name: str) -> str:
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"tfs_{safe}"


def _prom_escape(v: str) -> str:
    """Label-value escaping of the exposition format (backslash, double
    quote, newline)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(labels: LabelItems, extra: str = "") -> str:
    parts = [f'{k}="{_prom_escape(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# HELP text of the families the port records; others get a generic line
_PROM_HELP: Dict[str, str] = {
    "fault_retries": "Classified dispatch retries by fault class",
    "device_evictions": "Failover circuit-breaker device evictions",
    "deadline_exceeded": "Verb deadline expiries by verb",
    "verbs_shed": "Verbs rejected by admission control",
    "checkpoint_commits": "Durable-stream checkpoint commits",
    "checkpoint_resumes": "Streams resumed from a durable checkpoint",
    "checkpoint_chunks_skipped": (
        "Committed chunks skipped (never re-decoded) by resumed streams"
    ),
    "checkpoint_write_seconds": "Durable-stream checkpoint commit latency",
    "materialize_hits": "Materialization-cache hits served without compute",
    "materialize_misses": "Materialization-cache lookups that missed",
    "materialize_evictions": "Materialization-cache entries evicted (LRU)",
    "materialize_bytes": "Bytes held by the materialization cache",
    "admission_wait_seconds": "Time spent queued for a verb slot",
    "admission_queue_depth": "Verbs queued for admission right now",
    "admission_in_flight": "Admitted top-level verbs in flight",
    "stream_queue_depth": "Decoded chunks ready ahead of the consumer",
    "ingest_queue_depth": "Ingest stage input-queue occupancy",
    "ingest_chunks": "Items through each ingest stage",
    "ingest_stage_busy_seconds": "Ingest stage busy time",
    "ingest_stage_wait_seconds": "Ingest stage starved time",
    "verb_seconds": "Verb call latency",
    "serve_requests": "Serving requests accepted per endpoint",
    "serve_batches": "Coalesced serving dispatches per endpoint",
    "serve_shed": "Serving requests shed at a full lane per endpoint",
    "serve_batch_rows": "Rows per coalesced serving dispatch",
    "serve_batch_fill": "Requests coalesced into one serving dispatch",
    "serve_queue_seconds": "Request wait in the batching lane",
    "serve_pending": "Serving requests queued across all lanes",
    "serve_warm_rungs": "Bucket rungs warmed per endpoint",
    "serve_endpoints_registered": "Serving endpoints registered",
    "bucket_fill": "Valid-row fraction of each bucketed dispatch by verb",
    "h2d_bytes": "Host-to-device transfer bytes",
    "d2h_bytes": "Device-to-host transfer bytes",
    "incidents_captured": "Incident bundles written by trigger class",
    "incidents_suppressed": (
        "Incident captures suppressed by reason (rate_limit/store/error)"
    ),
    "incident_bytes": "Bytes held by on-disk incident bundles",
    "incident_capture_seconds": "Incident bundle capture latency",
    "plan_rewrites": "Cost-accepted plan-optimizer rewrites by rule",
    "plan_fallbacks": "Relational plan nodes run another way, by reason",
    "row_vectorize_lowered": (
        "Control-flow nodes lowered to masked dense programs, by kind"
    ),
    "row_vectorize_fallbacks": (
        "Graphs kept off the vectorized control-flow path, by reason"
    ),
    "plan_pushdown_rows_skipped": (
        "Rows never decoded thanks to predicate pushdown into the scan"
    ),
    "ingest_rows_decoded": "Rows decoded at the arrow ingest boundary",
}


def _prom_help_text(raw_name: str) -> str:
    text = _PROM_HELP.get(raw_name, f"tensorframes_tpu_torch metric {raw_name}")
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def export_prometheus() -> str:
    """Counters, gauges and histograms in the Prometheus text exposition
    format (histograms with cumulative ``le`` buckets, ``_sum`` and
    ``_count``), with ``# HELP`` / ``# TYPE`` headers."""
    lines: List[str] = []
    with _registry._lock:
        counters = list(_registry._counters.items())
        hists = [
            (key, (h.buckets, tuple(h.counts), h.sum, h.count))
            for key, h in _registry._histograms.items()
        ]
    gauges = _registry.gauge_values()
    seen_types: set = set()

    def _type(name: str, t: str, raw: str) -> None:
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# HELP {name} {_prom_help_text(raw)}")
            lines.append(f"# TYPE {name} {t}")

    for (name, labels), v in sorted(counters):
        pn = _prom_name(name)
        _type(pn, "counter", name)
        lines.append(f"{pn}{_prom_labels(labels)} {v:g}")
    for (name, labels), v in sorted(gauges.items()):
        pn = _prom_name(name)
        _type(pn, "gauge", name)
        lines.append(f"{pn}{_prom_labels(labels)} {v:g}")
    for (name, labels), (buckets, counts, hsum, hcount) in sorted(hists):
        pn = _prom_name(name)
        _type(pn, "histogram", name)
        cum = 0
        for b, c in zip(buckets, counts[:-1]):
            cum += c
            le = 'le="%g"' % b
            lines.append(f"{pn}_bucket{_prom_labels(labels, le)} {cum}")
        cum += counts[-1]
        inf = 'le="+Inf"'
        lines.append(f"{pn}_bucket{_prom_labels(labels, inf)} {cum}")
        lines.append(f"{pn}_sum{_prom_labels(labels)} {hsum:g}")
        lines.append(f"{pn}_count{_prom_labels(labels)} {hcount}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------


def serve(port: Optional[int] = None, host: Optional[str] = None):
    """Start the telemetry HTTP endpoint (`utils.telemetry_http`):
    ``/metrics``, ``/healthz`` and ``/trace`` on a daemon thread. ``port``
    defaults to ``config.telemetry_port``; ``port=0`` binds an ephemeral
    port. Returns the `TelemetryServer` handle."""
    from . import telemetry_http as _http

    return _http.serve(port=port, host=host)


def maybe_serve():
    """Start the endpoint at import IFF ``config.telemetry_port`` is set.
    Never raises: a busy port logs a warning."""
    from .. import config as _config

    if not _config.get().telemetry_port:
        return None
    try:
        return serve()
    except Exception as e:
        from .log import get_logger

        get_logger("telemetry").warning(
            "telemetry endpoint auto-start failed (TFS_TELEMETRY_PORT/"
            "config.telemetry_port): %s: %s", type(e).__name__, e,
        )
        return None


def shutdown() -> bool:
    """Stop the process-wide HTTP endpoint (unbind the port, join the
    serve thread). False when nothing was serving. Mounted routes stay
    registered for the next `serve()`."""
    from . import telemetry_http as _http

    return _http.shutdown()
