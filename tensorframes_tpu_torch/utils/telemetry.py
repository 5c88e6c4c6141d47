"""Structured span tracing + a metrics registry.

The PyTorch counterpart of the registry and span half of
`tensorframes_tpu/utils/telemetry.py`:

- **Spans** — hierarchical timed regions recorded into a bounded
  thread-safe ring (8,192 spans) with parent ids and monotonic timestamps.
  Nesting rides a contextvar; threads where it does not flow (ingest
  pipeline stages) record already-timed regions with an explicit parent
  (`allocate_span_id` / `add_event`).
- **Metrics** — labeled counters, gauges (set or registered callables)
  and fixed-bucket histograms.

``config.telemetry`` (env ``TFS_TELEMETRY``, default on) gates span
recording and histogram observation; counters are always live.

The exporters and diagnostics of the JAX module (Chrome trace, Prometheus
text, ``diagnostics``, the HTTP endpoint) are not in the port yet.
"""

from __future__ import annotations

import contextvars
import itertools
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
    "metrics_snapshot",
    "flat_counters",
    "labeled_counters",
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


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


# fixed bucket ladders per histogram family (the JAX package's)
_DEFAULT_BUCKETS: Dict[str, Tuple[float, ...]] = {
    "seconds": (
        1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
        1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0,
    ),
    "bytes": (
        256.0, 4096.0, 65536.0, 1048576.0, 16777216.0, 268435456.0,
        4294967296.0,
    ),
}

# histogram name -> bucket family (default "seconds")
_HISTOGRAM_FAMILIES: Dict[str, str] = {
    "h2d_bytes": "bytes",
    "d2h_bytes": "bytes",
}


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
                fam = _HISTOGRAM_FAMILIES.get(name, "seconds")
                h = _Histogram(_DEFAULT_BUCKETS[fam])
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
