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
- **Dispatch spans** — `dispatch_span` labels one block dispatch with its
  program fingerprint (what the cost ledger's roofline groups by). A CUDA
  launch returns before the kernel runs, so on a CUDA device the span also
  records a pair of ``torch.cuda.Event(enable_timing=True)`` on the current
  stream: the start when the executor launches the program (`launching`),
  the end at the span's exit. Inside a verb's block loop
  (`dispatch_run`) one pair times the whole loop, split over its
  dispatches by rows; the loop's dispatch spans set no contextvar each,
  and they and their ``block_rows`` observations go into the ring and the
  histogram when the verb ends. `exec_seconds` reads the
  ``elapsed_time``, resolved lazily (on ``query()``, or after the one
  synchronise of `diagnostics`); the dispatch path itself never
  synchronises, and resolved events are reused. On the CPU the host span
  is the execute time. A plain span opts into the same lazily resolved
  pair with ``torch_device=`` (a stage timed on the card: the aggregate's
  ``aggregate.keys``).
- **Profiler ranges** — while a `torch.profiler` records, every span,
  verb span and dispatch span is also a `torch.profiler.record_function`
  range of its name, so the program's spans appear on the profiler's
  timeline (its host clock) around the operations they enclose. With no
  profiler recording, a span pays one check of
  ``torch._C._autograd._profiler_enabled()``.
- **Exporters** — `span_aggregates`, `export_chrome_trace` (trace-event
  JSON for Perfetto), `export_prometheus` (text exposition), `diagnostics`
  (the "where did the time go" report: spans joined with the cost ledger's
  roofline, OOM forensics, memory, the autotuner and executor stats), and
  the HTTP endpoint that serves them: `serve`, `maybe_serve` (started at
  import when ``config.telemetry_port`` is set) and `shutdown`.

``config.telemetry`` (env ``TFS_TELEMETRY``, default on) gates span
recording and histogram observation; counters are always live.
"""

from __future__ import annotations

import bisect
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .. import config as _config

try:
    from torch._C._autograd import _profiler_enabled as _profiling
except ImportError:  # a torch without the accessor: no ranges

    def _profiling() -> bool:
        return False

__all__ = [
    "Span",
    "enabled",
    "span",
    "dispatch_span",
    "current_program",
    "current_verb",
    "exec_seconds",
    "launching",
    "dispatch_run",
    "current_run",
    "on_run_end",
    "add_event",
    "record_compile",
    "current_span_id",
    "allocate_span_id",
    "counter_inc",
    "gauge_set",
    "gauge_register",
    "gauge_register_multi",
    "histogram_observe",
    "spans",
    "spans_dropped",
    "span_aggregates",
    "metrics_snapshot",
    "flat_counters",
    "labeled_counters",
    "export_chrome_trace",
    "export_prometheus",
    "diagnostics",
    "diagnostics_data",
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
    return _config._config.telemetry


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span:
    """One finished timed region. ``t0``/``t1`` are `time.perf_counter`
    seconds; ``parent_id`` links to the enclosing span (None for a root);
    ``kind`` is the coarse phase: ``verb`` | ``stage`` | ``dispatch`` |
    ``compile`` | ``host_sync`` | ``checkpoint`` | ``fault`` | ``tuning`` |
    ``span``. ``events`` holds a CUDA dispatch's pending `_Timing` until
    `exec_seconds` resolves it into ``attrs["device_s"]``. A slotted
    class, not a dataclass: one is built at every dispatch."""

    __slots__ = (
        "span_id", "parent_id", "name", "kind", "t0", "t1", "thread", "attrs",
        "events",
    )

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 kind: str, t0: float, t1: float, thread: int,
                 attrs: Optional[Dict[str, object]] = None,
                 events: Optional[tuple] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.thread = thread
        self.attrs = {} if attrs is None else attrs
        self.events = events

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:
        return (
            f"Span({self.span_id}, {self.parent_id}, {self.name!r}, "
            f"{self.kind!r}, {self.seconds:.6f}s, {self.attrs!r})"
        )


def _ring_size() -> int:
    """``config.telemetry_ring_entries``, read when the ring is built."""
    return int(_config.get().telemetry_ring_entries)


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

    def extend(self, ss: List[Span]) -> None:
        with self._lock:
            over = len(self._ring) + len(ss) - self._ring.maxlen
            if over > 0:
                self.dropped += over
            self._ring.extend(ss)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._ring)


_ids = itertools.count(1)  # next() is GIL-atomic in CPython
_ring = _SpanRing(_ring_size())

# CUDA timing events of resolved timings, reused by later dispatches:
# recording an event that exists skips its creation (list pop/extend are
# atomic under the GIL)
_event_pool: List[object] = []
_EVENT_POOL_MAX = 4096


# the card the pooled events were recorded on: an event recorded on one
# card cannot be recorded on another's stream, so only one card's pairs
# are pooled at a time (the others are made fresh)
_pool_device: List[Optional[int]] = [None]


def _new_event():
    try:
        return _event_pool.pop()
    except IndexError:
        import torch

        return torch.cuda.Event(enable_timing=True)


def _event_for(idx: Optional[int]):
    """An event to record on card ``idx``'s stream: from the pool when the
    pool holds that card's events."""
    if _pool_device[0] is None or _pool_device[0] == idx or not _event_pool:
        return _new_event()
    import torch

    return torch.cuda.Event(enable_timing=True)


class _Timing:
    """The CUDA event pair that times one dispatch, or one run of a verb's
    dispatches (`dispatch_run`), and the spans that share it. Resolved,
    the pair's elapsed time is split over its spans by their rows (evenly
    when they carry none) into ``attrs["device_s"]``."""

    __slots__ = ("ev0", "ev1", "spans", "idx")

    def __init__(self, ev0, idx: Optional[int] = None):
        self.ev0 = ev0
        self.ev1 = None
        self.spans: List["Span"] = []
        self.idx = idx  # the card whose stream the pair is recorded on

    def close(self, stream) -> None:
        ev1 = _event_for(self.idx)
        ev1.record(stream)
        self.ev1 = ev1

    def resolve(self, wait: bool) -> bool:
        """Fill the spans' device seconds once the end event has completed
        (``wait`` synchronises on it); False while it is pending."""
        if self.ev1 is None:
            return False  # the run is still dispatching
        if wait:
            self.ev1.synchronize()
        elif not self.ev1.query():
            return False
        total = self.ev0.elapsed_time(self.ev1) / 1e3
        weights = [float(sp.attrs.get("rows") or 0) for sp in self.spans]
        wsum = sum(weights)
        for sp, w in zip(self.spans, weights):
            sp.attrs["device_s"] = total * (w / wsum if wsum else 1.0 / len(self.spans))
            sp.events = None
        self.spans = []
        if not _event_pool:
            _pool_device[0] = self.idx
        if len(_event_pool) < _EVENT_POOL_MAX and _pool_device[0] == self.idx:
            _event_pool.extend((self.ev0, self.ev1))
        return True


_CURRENT: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "tfs_torch_current_span", default=None
)
# the enclosing `dispatch_run`: dispatches inside share its timing
_RUN: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "tfs_torch_current_run", default=None
)
# the enclosing dispatch span (its program: `current_program`)
_DISPATCH: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "tfs_torch_current_dispatch", default=None
)
# the open ``verb`` span (`_SpanCtx`): its name is what the cost ledger
# attributes per-verb footprint high-water marks to, and it flushes the
# dispatch runs that ended inside it
_VERB: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "tfs_torch_current_verb", default=None
)
# serving request attribution: the HTTP front-end and the micro-batcher's
# dispatcher set this around the verbs a request triggers, and every verb
# span under it carries ``request=`` (a coalesced batch: the joined ids)
_REQUEST: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "tfs_torch_current_request", default=None
)


_perf_counter = time.perf_counter
_get_ident = threading.get_ident


def _current_parent() -> Optional[int]:
    """Id of the innermost open span: the `_CURRENT` span, or the open
    dispatch of the enclosing `dispatch_run` when that opened later (a
    run's dispatches set no contextvar; span ids only grow, so the later
    opened of the two is the inner one)."""
    cur = _CURRENT.get()
    run = _RUN.get()
    if run is not None:
        d = run.open
        if d is not None and (cur is None or d.span_id > cur):
            return d.span_id
    return cur


def _open_dispatch():
    """The innermost open dispatch span: a `_DispatchCtx` (the
    `_DISPATCH` contextvar) or the enclosing run's open dispatch."""
    ctx = _DISPATCH.get()
    run = _RUN.get()
    if run is not None:
        d = run.open
        if d is not None and (ctx is None or d.span_id > ctx.span_id):
            return d
    return ctx


class _NullCtx:
    """The disabled-telemetry context: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def _open_range(name: str):
    """A `torch.profiler.record_function` range named ``name``, entered,
    while a profiler records; else None (the only cost: the check)."""
    if not _profiling():
        return None
    import torch

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def _close_range(sp) -> None:
    """Exit the profiler range ``sp`` opened, if any."""
    if sp.rf is not None:
        sp.rf.__exit__(None, None, None)
        sp.rf = None


def _close_timing(sp, et) -> None:
    """End the event pair that times ``sp`` alone (a span, or a dispatch
    outside a run), and hand the span the pair to resolve; a span an
    exception left keeps its host time."""
    timing = sp.timing
    if timing is not None:
        sp.timing = None
        if et is None:
            timing.spans.append(sp)
            sp.events = timing
            timing.close(sp.stream)
        sp.stream = None


class _SpanCtx(Span):
    """Class-based span context; on exit it is itself the finished `Span`
    that goes into the ring (no second object is built), with
    ``attrs['error']`` naming an exception that passed through. A ``verb``
    span sets the verb contextvar, stamps the ambient request id, and at
    its exit flushes the `dispatch_run`s that ended inside it (``runs``):
    by then the verb has launched its last kernel, so the flush keeps off
    the path to the card. On a CUDA ``device`` the span is also timed on
    the card, by an event pair on its current stream from entry to exit
    (`exec_seconds`)."""

    __slots__ = ("tok", "vtok", "runs", "rf", "device", "stream", "timing")

    def __init__(self, name, kind, attrs, device=None):
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.events = None
        self.vtok = self.runs = None
        self.device = device

    def __enter__(self):
        self.rf = _open_range(self.name)
        sid = self.span_id = next(_ids)
        self.parent_id = _current_parent()
        self.tok = _CURRENT.set(sid)
        if self.kind == "verb":
            self.vtok = _VERB.set(self)
            rid = _REQUEST.get()
            if rid is not None:
                self.attrs["request"] = rid
        self.timing = None
        if self.device is not None:
            self.stream, self.timing = _start_timing(self.device)
        self.t0 = _perf_counter()
        return sid

    def __exit__(self, et, ev, tb):
        self.t1 = _perf_counter()
        if self.vtok is not None:
            _VERB.reset(self.vtok)
            self.vtok = None
        _CURRENT.reset(self.tok)
        self.tok = None
        self.thread = _get_ident()
        if et is not None:
            self.attrs = dict(self.attrs)
            self.attrs["error"] = et.__name__
        _close_timing(self, et)
        if self.runs is not None:
            runs, self.runs = self.runs, None
            for run in runs:
                run.flush(self.name)
        _ring.append(self)
        _close_range(self)
        return False


def span(name: str, kind: str = "span", torch_device=None, **attrs):
    """Record a timed region into the ring (no-op context when telemetry
    is disabled). Entering yields the span id. On a CUDA ``torch_device``
    the region is also timed by events on its current stream, resolved
    lazily as a dispatch span's are (`exec_seconds`)."""
    if not enabled():
        return _NULL
    cuda = torch_device if getattr(torch_device, "type", None) == "cuda" else None
    return _SpanCtx(name, kind, attrs, cuda)


# raw CUDA stream handle -> its `torch.cuda.Stream`: the current stream of a
# CUDA device, looked up at every dispatch, costs microseconds through
# `torch.cuda.current_stream`; the raw handle costs a fraction of one
_stream_objs: Dict[Tuple[int, int], object] = {}


def _current_stream(device):
    """The current `torch.cuda.Stream` of CUDA ``device``."""
    import torch

    try:
        idx = device.index if device.index is not None else torch._C._cuda_getDevice()
        raw = torch._C._cuda_getCurrentRawStream(idx)
    except AttributeError:  # a torch without the raw accessors
        return torch.cuda.current_stream(device)
    s = _stream_objs.get((idx, raw))
    if s is None:
        s = torch.cuda.current_stream(idx)
        _stream_objs[(idx, raw)] = s
    return s


class _DispatchCtx(Span):
    """`_SpanCtx` for a block dispatch outside a `dispatch_run`; on exit
    it is itself the ``dispatch`` span in the ring. It is the current
    dispatch (`current_program` reads its program). On a CUDA device its
    timing starts when the executor launches the program's first kernel
    (`launching`), so host work before the launch (feed slicing, the cost
    ledger's first-shape capture) stays out of the device time, and ends
    at the span's exit."""

    __slots__ = ("program", "device", "stream", "tok", "dtok", "timing", "rf")

    def __init__(self, name, attrs, program, device):
        self.name = name
        self.kind = "dispatch"
        self.attrs = attrs
        self.events = None
        self.program = program
        self.device = device
        self.timing = self.stream = None

    def __enter__(self):
        self.rf = _open_range(self.name)
        sid = self.span_id = next(_ids)
        self.parent_id = _current_parent()
        self.tok = _CURRENT.set(sid)
        self.dtok = _DISPATCH.set(self)
        self.t0 = _perf_counter()
        return sid

    def __exit__(self, et, ev, tb):
        self.t1 = _perf_counter()
        _DISPATCH.reset(self.dtok)
        _CURRENT.reset(self.tok)
        self.tok = self.dtok = None
        self.thread = _get_ident()
        if et is not None:
            self.attrs = dict(self.attrs)
            self.attrs["error"] = et.__name__
        _close_timing(self, et)
        _ring.append(self)
        _close_range(self)
        return False


class _RunDispatch(Span):
    """A dispatch span inside a `dispatch_run`, trimmed for the per-block
    path: it sets no contextvar (the run holds it as its open dispatch,
    which `_current_parent`, `current_program` and `launching` consult),
    and on exit it joins the run's finished spans, which go into the ring
    together when the run is flushed. On a CUDA run it shares the run's
    event pair from its first launch on."""

    __slots__ = ("program", "device", "run", "prev", "timing", "rf")

    def __init__(self, name, attrs, program, device, run):
        self.name = name
        self.kind = "dispatch"
        self.attrs = attrs
        self.events = None
        self.program = program
        self.device = device
        self.run = run
        self.timing = None

    def __enter__(self):
        self.rf = _open_range(self.name)
        sid = self.span_id = next(_ids)
        run = self.run
        prev = self.prev = run.open
        cur = _CURRENT.get()
        self.parent_id = (
            prev.span_id if prev is not None and (cur is None or prev.span_id > cur) else cur
        )
        run.open = self
        self.t0 = _perf_counter()
        return sid

    def __exit__(self, et, ev, tb):
        self.t1 = _perf_counter()
        run = self.run
        run.open = self.prev
        self.prev = self.run = None
        self.thread = _get_ident()
        if et is not None:
            self.attrs = dict(self.attrs)
            self.attrs["error"] = et.__name__
        timing = self.timing
        if timing is not None:
            self.timing = None
            if et is None:
                timing.spans.append(self)
                self.events = timing
        run.spans.append(self)
        _close_range(self)
        return False


def launching() -> None:
    """The executor is about to launch a cached program's kernels: start
    the enclosing CUDA dispatch span's timing (its run's, inside a CUDA
    `dispatch_run`), once."""
    ctx = _open_dispatch()
    if ctx is None or ctx.device is None or ctx.timing is not None:
        return
    if ctx.__class__ is _RunDispatch:
        run = ctx.run
        dev = ctx.device
        if dev is run.device or dev == run.device:
            if run.timing is None:
                run.stream, run.timing = _start_timing(run.device)
            ctx.timing = run.timing
            return
        # a block the scheduler placed on another card: that card's own
        # pair, on its current stream
        pair = run.others.get(dev)
        if pair is None:
            pair = run.others[dev] = _start_timing(dev)
        ctx.timing = pair[1]
        return
    ctx.stream, ctx.timing = _start_timing(ctx.device)


def _start_timing(device):
    """``(stream, timing)``: a timing whose start event is recorded now on
    ``device``'s current stream."""
    stream = _current_stream(device)
    idx = getattr(stream, "device_index", None)
    ev = _event_for(idx)
    ev.record(stream)
    return stream, _Timing(ev, idx)


# run flush hooks: ``fn(run, verb)`` when a `dispatch_run` is flushed (the
# cost ledger folds the run's deferred execution counts, ``run.ledger``)
_run_end_hooks: List[Callable[["_DispatchRun", Optional[str]], None]] = []


def on_run_end(fn: Callable[["_DispatchRun", Optional[str]], None]) -> None:
    """Call ``fn(run, verb)`` when a `dispatch_run` that deferred
    cost-ledger counts (``run.ledger`` is not empty) is flushed; ``verb``
    names the verb span it ran in, if any."""
    if fn not in _run_end_hooks:
        _run_end_hooks.append(fn)


def current_run():
    """The enclosing `dispatch_run`, if any (None with telemetry off)."""
    return _RUN.get()


class _DispatchRun:
    """A verb's loop of dispatches. Its dispatch spans (`_RunDispatch`)
    set no contextvar each; they, their ``block_rows`` observations and
    the cost ledger's execution counts (``ledger``) go into the ring, the
    histogram and the ledger together (`flush`, one lock each for the
    loop and not one a block) when the enclosing verb span ends, or at
    the loop's end outside a verb. On a CUDA device one event pair times
    the loop, from the first dispatch's launch to the loop's end, and its
    time is split over the dispatches by rows: per dispatch the loop
    records no event (two records a block were most of the dispatch
    path's cost on the card). A loop whose blocks the scheduler placed on
    several cards keeps one pair per card, each on that card's stream and
    split over that card's dispatches."""

    __slots__ = (
        "device", "stream", "timing", "others", "tok", "rows", "spans", "open", "ledger",
    )

    def __init__(self, device):
        self.device = device  # the CUDA device, or None
        self.stream = None
        self.timing = None
        self.others: Dict = {}  # another card -> (stream, timing)
        self.open = None  # the dispatch in progress
        self.rows: List[int] = []
        self.spans: List[Span] = []
        self.ledger: List[tuple] = []

    def __enter__(self):
        self.tok = _RUN.set(self)
        return self

    def __exit__(self, et, ev, tb):
        _RUN.reset(self.tok)
        if self.timing is not None:
            self.timing.close(self.stream)
        for stream, timing in self.others.values():
            timing.close(stream)
        verb = _VERB.get()
        if verb is None:
            self.flush(None)
        elif verb.runs is None:
            verb.runs = [self]
        else:
            verb.runs.append(self)
        return False

    def flush(self, verb: Optional[str]) -> None:
        """Hand the run's spans, row observations and ledger counts on."""
        if self.ledger:
            for fn in _run_end_hooks:
                try:
                    fn(self, verb)
                except Exception:
                    pass  # accounting never breaks the verb it counts
            self.ledger = []
        if self.spans:
            _ring.extend(self.spans)
            self.spans = []
        if self.rows:
            _registry.histogram_observe_many("block_rows", self.rows)
            self.rows = []


def dispatch_run(torch_device):
    """The context of one verb's block loop (see `_DispatchRun`): on a
    CUDA ``torch_device`` it also times the loop with one event pair. A
    no-op context with telemetry off."""
    if not _config._config.telemetry:
        return _NULL
    return _DispatchRun(
        torch_device if getattr(torch_device, "type", None) == "cuda" else None
    )


def dispatch_span(
    name: str,
    program: Optional[str] = None,
    block: Optional[int] = None,
    rows: Optional[int] = None,
    torch_device=None,
    **attrs,
):
    """A per-block dispatch leaf: a ``dispatch`` span labeled with the
    program fingerprint, plus a `block_rows` histogram observation (both
    recorded when the run is flushed, inside a `dispatch_run`). Makes the span the
    current dispatch (`current_program`). When ``torch_device`` is a CUDA
    device, the region is also timed by events on its current stream
    (see `exec_seconds`)."""
    if not _config._config.telemetry:
        return _NULL
    attrs["program"] = program
    attrs["block"] = block
    attrs["rows"] = rows
    cuda = torch_device if getattr(torch_device, "type", None) == "cuda" else None
    run = _RUN.get()
    if run is not None and (run.device is None) == (cuda is None):
        if rows is not None:
            run.rows.append(rows)
        return _RunDispatch(name, attrs, program, cuda, run)
    if rows is not None:
        _registry.histogram_observe("block_rows", float(rows))
    return _DispatchCtx(name, attrs, program, cuda)


def current_program() -> Optional[str]:
    """Program fingerprint of the enclosing dispatch span, if any."""
    ctx = _open_dispatch()
    return ctx.program if ctx is not None else None


def current_verb() -> Optional[str]:
    """Name of the enclosing ``verb`` span, if any (the cost ledger's
    per-verb attribution key)."""
    v = _VERB.get()
    return v.name if v is not None else None


def exec_seconds(s: Span, wait: bool = False) -> float:
    """Execute seconds of one span: for a CUDA dispatch, its device time
    from its timing's events (``attrs["device_s"]`` once resolved); else,
    and while the events are still pending without ``wait``, the host
    span. ``wait`` synchronises on the end event."""
    timing = s.events
    if timing is not None:
        try:
            timing.resolve(wait)
        except Exception:
            s.events = None  # a lost context: fall back to the host span
    d = s.attrs.get("device_s")
    return float(d) if d is not None else s.seconds


def resolve_device_times(span_list: Optional[List[Span]] = None) -> None:
    """Resolve every pending dispatch event pair (one synchronise when
    any is pending): what `diagnostics` and `explain_analyze` call before
    dividing modeled work by execute seconds."""
    ss = spans() if span_list is None else span_list
    pending = [s for s in ss if s.events is not None]
    if not pending:
        return
    try:
        import torch

        torch.cuda.synchronize()
    except Exception:
        pass  # exec_seconds falls back per span
    for s in pending:
        exec_seconds(s, wait=True)


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
    return _current_parent()


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
            parent_id if parent_id is not None else _current_parent(),
            name, kind, t0, t1,
            threading.get_ident(), attrs,
        )
    )


def record_compile(
    program: str,
    cache_kind: str,
    seconds: float,
    phase: str,
    t0: Optional[float] = None,
    t1: Optional[float] = None,
) -> None:
    """Build-time attribution: one call per timed build event. ``phase``
    is ``trace`` for an executor cache miss (graph lowering). Gated on the
    master switch."""
    if not enabled():
        return
    prog = str(program)
    histogram_observe("compile_seconds", seconds, program=prog, phase=phase)
    counter_inc(f"telemetry.compiles.{phase}")
    if t0 is not None and t1 is not None:
        add_event(
            f"compile[{phase}]:{cache_kind}", "compile", t0, t1,
            program=prog, cache_kind=cache_kind, phase=phase,
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
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
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
        self._gauge_multi_fns: Dict[str, Tuple[str, Callable]] = {}
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

    def gauge_register_multi(
        self, name: str, label: str, fn: Callable[[], Dict[str, float]]
    ) -> None:
        """A registered gauge FAMILY: ``fn()`` returns {label value: gauge
        value}, exported as ``name{label="..."}`` rows; survives
        `reset()`."""
        with self._lock:
            self._gauge_multi_fns[name] = (label, fn)

    def gauge_values(self) -> Dict[Tuple[str, LabelItems], float]:
        with self._lock:
            out = dict(self._gauges)
            fns = list(self._gauge_fns.items())
            multi = list(self._gauge_multi_fns.items())
        for name, fn in fns:
            try:
                out[(name, ())] = float(fn())
            except Exception:
                pass  # a dead gauge must never break a snapshot
        for name, (label, fn) in multi:
            try:
                for lv, v in fn().items():
                    out[(name, ((label, str(lv)),))] = float(v)
            except Exception:
                pass  # a dead gauge family must never break a snapshot
        return out

    def histogram_observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels) if labels else ())
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = _Histogram(_buckets_for(name))
                self._histograms[key] = h
            h.observe(float(value))

    def histogram_observe_many(self, name: str, values, **labels) -> None:
        """`histogram_observe` of each of ``values``, under one lock."""
        key = (name, _label_key(labels) if labels else ())
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = _Histogram(_buckets_for(name))
                self._histograms[key] = h
            for v in values:
                h.observe(float(v))

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


def gauge_register_multi(
    name: str, label: str, fn: Callable[[], Dict[str, float]]
) -> None:
    _registry.gauge_register_multi(name, label, fn)


def histogram_observe(name: str, value: float, **labels) -> None:
    _registry.histogram_observe(name, value, **labels)


def _gauge_executor_cache_entries() -> float:
    """Live entries of the process-default executor's LRU; reads the
    module global only, never constructs an executor."""
    from ..runtime import executor as _exmod

    ex = _exmod._default
    return float(len(ex._cache)) if ex is not None else 0.0


gauge_register("executor_cache_entries", _gauge_executor_cache_entries)


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
    callables survive). The ring is rebuilt at the current
    ``config.telemetry_ring_entries``, so a scoped override takes effect
    here."""
    global _ring
    _ring = _SpanRing(_ring_size())
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
                p["execute_s"] += exec_seconds(s)
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
    "block_splits": "OOM-triggered block split-retries by verb",
    "oom_forensics": "Forensic snapshots captured for resource faults",
    "autotune_adjustments": "Knob adjustments applied by the autotuner",
    "compile_seconds": "Lowering time by program and phase",
    "block_rows": "Rows per block dispatch",
    "live_buffer_bytes": "Live CUDA caching-allocator bytes per device",
    "device_bytes_in_use": "torch.cuda.memory_allocated per device",
    "device_peak_bytes": "torch.cuda.max_memory_allocated per device",
    "costmodel_residual": (
        "Span-achieved vs cost-model-predicted time ratio per program"
    ),
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
    "executor_cache_entries": "Live compiled-program cache entries",
    "admission_wait_seconds": "Time spent queued for a verb slot",
    "admission_queue_depth": "Verbs queued for admission right now",
    "admission_in_flight": "Admitted top-level verbs in flight",
    "stream_queue_depth": "Decoded chunks ready ahead of the consumer",
    "scheduler_queue_depth": "Planned dispatches not yet issued per device",
    "global_dispatches": "Global-frame dispatches by verb",
    "global_collectives": "Cross-shard combines of global-frame reduces",
    "global_fallbacks": "Global-frame dispatches that left the path, by reason",
    "global_pad_rows": "Rows padded onto global-frame shards",
    "global_stream_folds": "Double-buffered accumulator folds of global streams",
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
# diagnostics
# ---------------------------------------------------------------------------


def _fmt_bytes(n) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TiB"  # pragma: no cover - the loop always returns


def _fmt_rate(v, unit: str) -> str:
    if v is None:
        return "?"
    for prefix, scale in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {prefix}{unit}"
    return f"{v:.2f} {unit}"


def _verb_roofline(span_list: List[Span], costs: Dict) -> Dict[str, Dict]:
    """Per-verb modeled flops/bytes: each dispatch span's program cost
    (average per exec) attributed to the span's root ``verb`` ancestor."""
    by_id = {s.span_id: s for s in span_list}
    out: Dict[str, Dict] = {}
    for s in span_list:
        if s.kind != "dispatch":
            continue
        prog = s.attrs.get("program")
        c = costs.get(str(prog)) if prog else None
        if not c or not c["execs"]:
            continue
        node, hops = s, 0
        verb = None
        while node is not None and hops < 64:
            if node.kind == "verb":
                verb = node.name
                break
            node = by_id.get(node.parent_id)
            hops += 1
        if verb is None:
            continue
        v = out.setdefault(verb, {"flops": 0.0, "bytes": 0.0})
        if c["total_flops"] is not None:
            v["flops"] += c["total_flops"] / c["execs"]
        if c["total_bytes_accessed"] is not None:
            v["bytes"] += c["total_bytes_accessed"] / c["execs"]
    return out


def diagnostics_data(executor=None) -> Dict:
    """The machine-readable diagnostics payload (what
    ``tft.diagnostics(format="json")`` and ``/diagnostics`` serve): span
    aggregates, the cost-ledger roofline join, per-verb footprint peaks,
    per-device memory, the fault ledger with OOM forensic snapshots,
    executor stats and the per-program shape counts. Pending CUDA dispatch
    events are resolved first (one synchronise). Sections that read modules
    the port does not have keep the JAX package's keys and say so; sections
    that fail to collect carry an ``error`` string instead of raising."""
    from .inspection import executor_stats

    ss = spans()
    resolve_device_times(ss)
    agg = span_aggregates(ss)
    data: Dict = {
        "telemetry_enabled": enabled(),
        "window": {
            k: agg[k]
            for k in ("window", "covered", "coverage", "roots", "spans",
                      "dropped")
        },
        "verbs": agg["by_verb"],
        "phases": agg["by_kind"],
        "devices": agg["by_device"],
        "programs": agg["by_program"],
    }
    try:
        from ..runtime import costmodel as _cm

        costs = _cm.program_costs()
        data["cost"] = {
            "enabled": _cm.enabled(),
            "peaks": _cm.device_peaks(),
            "programs": _cm.roofline(agg["by_program"]),
            "verb_peaks": _cm.verb_peaks(),
            "verb_roofline": _verb_roofline(ss, costs),
        }
    except Exception as e:
        data["cost"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..runtime import costmodel as _cm

        data["accuracy"] = _cm.residuals(ss)
    except Exception as e:
        data["accuracy"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        counters = flat_counters()
        fill: Dict[str, Dict] = {}
        for (name, labels), (
            _b, _c, hsum, hcount,
        ) in _registry.histogram_snapshot().items():
            if name != "bucket_fill" or not hcount:
                continue
            verb = dict(labels).get("verb", "unattributed")
            f = fill.setdefault(verb, {"sum": 0.0, "count": 0})
            f["sum"] += hsum
            f["count"] += hcount
        data["bucketing"] = {
            "padded_dispatches": int(
                counters.get("shape_bucketing.padded_dispatch", 0)
            ),
            "pad_rows": int(counters.get("shape_bucketing.pad_rows", 0)),
            "fill": {
                v: {"mean": f["sum"] / f["count"], "dispatches": f["count"]}
                for v, f in sorted(fill.items())
            },
        }
    except Exception as e:
        data["bucketing"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..runtime import costmodel as _cm

        data["memory"] = _cm.memory_overview()
    except Exception as e:
        data["memory"] = [{"error": f"{type(e).__name__}: {e}"}]
    try:
        from ..runtime import faults as _faults

        from ..runtime.scheduler import device_health

        data["health"] = device_health().table()
        data["faults"] = _faults.ledger_snapshot()
        data["forensics"] = _faults.forensics_snapshot()
    except Exception as e:
        data["faults_error"] = f"{type(e).__name__}: {e}"
    try:
        from ..runtime import autotune as _autotune

        data["autotune"] = _autotune.state()
    except Exception as e:
        data["autotune"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..runtime import checkpoint as _checkpoint

        data["checkpoint"] = _checkpoint.state()
    except Exception as e:
        data["checkpoint"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from .. import globalframe as _globalframe

        data["globalframe"] = _globalframe.state()
    except Exception as e:
        data["globalframe"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..graph import vectorize as _vectorize

        data["row_vectorize"] = _vectorize.state()
    except Exception as e:
        data["row_vectorize"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..runtime import materialize as _materialize

        data["materialize"] = _materialize.state()
    except Exception as e:
        data["materialize"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..graph import plan as _planmod

        data["plan_optimizer"] = _planmod.state()
    except Exception as e:
        data["plan_optimizer"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ..runtime import blackbox as _blackbox

        data["blackbox"] = _blackbox.state()
    except Exception as e:
        data["blackbox"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        es = dict(executor_stats(executor))
        if isinstance(es.get("faults"), dict):
            # data["forensics"] above is the one copy
            es["faults"] = {
                k: v for k, v in es["faults"].items() if k != "forensics"
            }
        data["executor"] = es
        from .. import config as _config
        from ..runtime.executor import default_executor

        ex = executor if executor is not None else default_executor()
        shapes = ex.program_shape_compiles()
        threshold = _config.get().recompile_warn_shapes
        data["recompile"] = {
            "threshold": threshold,
            "worst": max(shapes.values()) if shapes else 0,
            "storming": {
                f"{k[0]}/{str(k[1])[:12]}": n
                for k, n in shapes.items()
                if threshold and n > threshold
            },
        }
    except Exception as e:
        data["executor_error"] = f"{type(e).__name__}: {e}"
    data["gauges"] = {
        name + _prom_labels(labels): v
        for (name, labels), v in sorted(_registry.gauge_values().items())
    }
    return data


def _render_diagnostics(data: Dict) -> str:
    lines = ["tensorframes-tpu-torch diagnostics", "=" * 34]
    if not data["telemetry_enabled"]:
        lines.append(
            "telemetry is DISABLED (config.telemetry=False / "
            "TFS_TELEMETRY=0): spans below reflect only what was "
            "recorded while it was on"
        )
    w = data["window"]
    lines.append(
        f"window: {w['window']:.4f}s wall, "
        f"{w['coverage'] * 100:.1f}% attributed to {w['roots']} root "
        f"span(s) ({w['spans']} spans buffered, {w['dropped']} dropped)"
    )
    cost = data.get("cost", {})
    verb_roof = cost.get("verb_roofline", {})
    if data["verbs"]:
        lines.append("")
        lines.append("verbs:")
        for name, v in sorted(
            data["verbs"].items(), key=lambda kv: -kv[1]["seconds"]
        ):
            rows = f"  rows={int(v['rows'])}" if v["rows"] else ""
            extra = ""
            vr = verb_roof.get(name)
            if vr and v["seconds"] > 0 and (vr["flops"] or vr["bytes"]):
                extra = (
                    f"  ~{_fmt_rate(vr['flops'] / v['seconds'], 'FLOP/s')}"
                    f" ~{_fmt_rate(vr['bytes'] / v['seconds'], 'B/s')}"
                )
            lines.append(
                f"  {name:<28} calls={v['calls']:<4} "
                f"total={v['seconds']:.4f}s{rows}{extra}"
            )
    if data["phases"]:
        lines.append("")
        lines.append("time by phase (span totals on the host clock):")
        for kind, k in sorted(
            data["phases"].items(), key=lambda kv: -kv[1]["seconds"]
        ):
            lines.append(
                f"  {kind:<10} {k['seconds']:.4f}s ({k['count']} span(s))"
            )
    if data["programs"]:
        lines.append("")
        lines.append(
            "programs (by graph fingerprint; execute = CUDA event time on "
            "the card, host span time on the CPU):"
        )
        for prog, p in sorted(
            data["programs"].items(),
            key=lambda kv: -(kv[1]["compile_s"] + kv[1]["execute_s"]),
        ):
            lines.append(
                f"  {prog:<16} compile={p['compile_s']:.4f}s "
                f"({p['compiles']}x)  execute={p['execute_s']:.4f}s "
                f"({p['dispatches']} dispatch(es))  "
                f"host_sync={p['host_sync_s']:.4f}s"
            )
    if cost.get("programs"):
        peaks = cost.get("peaks", {})
        kind = peaks.get("device_kind")
        known = peaks.get("matmul_flops_s") or peaks.get("hbm_bytes_s")
        lines.append("")
        lines.append(
            "cost ledger (counted on the meta device at the first dispatch "
            "of each shape; achieved = modeled total / execute time"
            + (
                f"; peaks for {kind})"
                if known
                else f"; no datasheet peak for {kind!r} — peak unknown)"
            )
        )
        for r in cost["programs"]:
            if not r["execs"] and not r["dispatches"]:
                continue
            ffrac = r["flops_frac_of_peak"]
            hfrac = r["hbm_frac_of_peak"]
            frac = ""
            if ffrac is not None or hfrac is not None:
                frac = (
                    f"  peak: flops={ffrac * 100:.1f}%"
                    if ffrac is not None
                    else "  peak: flops=?"
                )
                frac += (
                    f" hbm={hfrac * 100:.1f}%" if hfrac is not None else " hbm=?"
                )
            lines.append(
                f"  {r['program']:<16} execs={r['execs']:<5} "
                f"flops/exec={_fmt_rate(r['flops_per_exec'], 'FLOP')} "
                f"hbm/exec={_fmt_bytes(r['bytes_per_exec'])} "
                f"footprint={_fmt_bytes(r['footprint_bytes'])}"
                + ("" if r["temp_known"] else "(+temp?)")
                + f" achieved={_fmt_rate(r['achieved_flops_s'], 'FLOP/s')}"
                f"/{_fmt_rate(r['achieved_hbm_bytes_s'], 'B/s')}"
                + frac
            )
        if cost.get("verb_peaks"):
            lines.append(
                "verb footprint high-water (largest modeled single dispatch):"
            )
            for verb, pk in sorted(cost["verb_peaks"].items()):
                lines.append(
                    f"  {verb:<28} {_fmt_bytes(pk['bytes'])} "
                    f"(program {str(pk['program'])[:12]}, rows={pk['rows']})"
                )
    acc = data.get("accuracy", {})
    if acc.get("programs"):
        warn = acc.get("warn_ratio")
        fit = acc.get("fit", {})
        lines.append("")
        lines.append(
            "cost-model accuracy (achieved vs predicted per dispatch; "
            "predictions from the process-fitted effective throughput "
            f"{_fmt_rate(fit.get('bytes_per_s'), 'B/s')} / "
            f"{_fmt_rate(fit.get('flops_per_s'), 'FLOP/s')}; "
            f"flag threshold x{warn:g}):"
        )
        for fp, p in sorted(
            acc["programs"].items(),
            key=lambda kv: -(kv[1]["residual_ratio"] or 0.0),
        ):
            ratio = p["residual_ratio"]
            if ratio is None:
                continue
            flag = "  ** MODEL MISPRICES THIS PROGRAM" if p["flagged"] else ""
            lines.append(
                f"  {fp:<16} residual={ratio:.2f}x "
                f"({p['dispatches']} dispatch(es), "
                f"achieved {p['achieved_s']:.4f}s vs predicted "
                f"{p['predicted_s']:.4f}s){flag}"
            )
    if "faults_error" in data:
        lines.append(f"fault state unavailable: {data['faults_error']}")
    else:
        health = data.get("health", [])
        ledger = data.get("faults", {})
        lines.append("")
        if health:
            lines.append(
                "device health (failover circuit breaker; closed "
                "circuits are not listed):"
            )
            for row in health:
                lines.append(
                    f"  {row['device']:<10} {row['state']:<9} "
                    f"failures={row['failures']} "
                    f"cooldown={row['cooldown_s']}s "
                    f"retry_in={row['retry_in_s']}s"
                )
        else:
            lines.append("device health: all devices healthy")
        if any(ledger.values()):
            lines.append(
                "faults: "
                + " ".join(f"{k}={v}" for k, v in sorted(ledger.items()))
            )
        else:
            lines.append("faults: none")
        for snap in data.get("forensics", []):
            modeled = snap.get("modeled") or {}
            lines.append(
                f"  oom[{snap.get('verb')}] program "
                f"{str(snap.get('program'))[:12]} rows={snap.get('rows')} "
                f"depth={snap.get('depth')} -> {snap.get('decision')}; "
                "modeled footprint "
                f"{_fmt_bytes(modeled.get('footprint_bytes'))}"
            )
    mem = [m for m in data.get("memory", []) if "error" not in m]
    if mem:
        lines.append("")
        lines.append(
            "device memory (torch.cuda.memory_stats: live allocator bytes; "
            "in_use/peak = memory_allocated / max_memory_allocated):"
        )
        for m in mem:
            lines.append(
                f"  {m['device']:<10} live={_fmt_bytes(m['live_buffer_bytes'])}"
                f" ({m['live_buffers']} buffer(s)) "
                f"in_use={_fmt_bytes(m['bytes_in_use'])} "
                f"peak={_fmt_bytes(m['peak_bytes_in_use'])}"
            )
    gf = data.get("globalframe", {})
    if gf and "error" not in gf and (
        gf.get("frames") or gf.get("dispatches") or gf.get("fallbacks")
    ):
        lines.append("")
        lines.append(
            f"global frames: {gf.get('frames', 0)} frame(s) over "
            f"{gf.get('shards') or '?'} shard(s), "
            f"{gf.get('dispatches', 0)} dispatch(es), "
            f"{gf.get('collectives', 0)} cross-shard combine(s), "
            f"{gf.get('pad_rows', 0)} pad row(s) on shards"
        )
        for reason, n in sorted(gf.get("fallbacks", {}).items()):
            lines.append(f"  fallback {reason}: {n} dispatch(es)")
        if gf.get("stream_folds"):
            lines.append(
                f"  streaming double-buffer: {gf['stream_folds']} eager fold(s)"
            )
    at = data.get("autotune", {})
    if at and "error" not in at:
        tuned = at.get("tuned", {})
        ep_windows = at.get("endpoint_windows", {})
        if at.get("enabled") or tuned or ep_windows:
            lines.append("")
            lines.append(
                "autotune: "
                + ("loop ON" if at.get("enabled") else "loop off")
                + (
                    f" (running, {at.get('cycles', 0)} cycle(s), every "
                    f"{at.get('interval_s', 0):g}s)"
                    if at.get("running")
                    else ""
                )
            )
            for knob, v in sorted(tuned.items()):
                lines.append(f"  tuned {knob} = {v}")
            for ep, wv in sorted(ep_windows.items()):
                lines.append(f"  tuned serve_batch_window_ms[{ep}] = {wv:g}")
            if at.get("pinned"):
                lines.append(
                    "  pinned (never tuned): " + ", ".join(at["pinned"])
                )
            for dec in at.get("decisions", [])[-4:]:
                lines.append(
                    f"  decision: {dec.get('knob')} ({dec.get('scope')}) "
                    f"{dec.get('current')} -> {dec.get('proposed')} "
                    f"[{dec.get('outcome')}]"
                )
    ck = data.get("checkpoint", {})
    if ck and "error" not in ck and (
        ck.get("commits") or ck.get("resumes") or ck.get("ignored")
    ):
        lines.append("")
        lines.append(
            f"durable streams: {ck.get('commits', 0)} commit(s), "
            f"{ck.get('resumes', 0)} resume(s), "
            f"{ck.get('chunks_skipped', 0)} committed chunk(s) skipped"
        )
    mat = data.get("materialize", {})
    if mat and "error" not in mat and (
        mat.get("hits") or mat.get("misses") or mat.get("stores")
    ):
        lines.append("")
        lines.append(
            f"materialization cache: {mat.get('hits', 0)} hit(s), "
            f"{mat.get('misses', 0)} miss(es), "
            f"{mat.get('stores', 0)} store(s), "
            f"{mat.get('evictions', 0)} eviction(s)"
        )
    po = data.get("plan_optimizer", {})
    if po and "error" not in po and (
        po.get("forces") or po.get("optimize_runs")
    ):
        lines.append("")
        lines.append(
            f"plan optimizer: {po.get('forces', 0)} plan force(s), "
            f"{po.get('optimize_runs', 0)} optimize run(s), "
            f"{po.get('pushdown_rows_skipped', 0)} row(s) never decoded "
            "via predicate pushdown"
        )
    bb = data.get("blackbox", {})
    if bb and "error" not in bb and (bb.get("captured") or bb.get("bundles")):
        lines.append("")
        lines.append(
            f"flight recorder: {bb.get('captured', 0)} incident(s) "
            f"captured; {bb.get('bundles', 0)} bundle(s) in {bb.get('dir')}"
        )
    if "executor_error" in data:
        lines.append(f"executor stats unavailable: {data['executor_error']}")
    else:
        es = data.get("executor", {})
        lines.append("")
        lines.append(
            "executor: " + " ".join(f"{k}={v}" for k, v in sorted(es.items()))
        )
        rc = data.get("recompile")
        if rc is not None:
            if rc["storming"]:
                lines.append(
                    f"shape storm: {len(rc['storming'])} program(s) over "
                    f"recompile_warn_shapes={rc['threshold']}:"
                )
                for key, n in sorted(rc["storming"].items(), key=lambda kv: -kv[1]):
                    lines.append(f"  {key}: {n} dispatched shapes")
            else:
                lines.append(
                    f"shape storm: none (max {rc['worst']} shape(s)/program, "
                    f"threshold {rc['threshold']})"
                )
    if data["gauges"]:
        lines.append("")
        lines.append("gauges:")
        for name, v in data["gauges"].items():
            lines.append(f"  {name} = {v:g}")
    return "\n".join(lines)


def diagnostics(executor=None, format: str = "text"):
    """The one-call "where did my time go" report (``tft.diagnostics()``):
    span coverage, per-verb totals, time by phase, the per-program
    execute attribution, the cost-ledger roofline (modeled flops / bytes /
    footprint and achieved-vs-peak fractions per program), memory, OOM
    forensics, the autotuner and executor stats. ``format="json"`` returns
    the `diagnostics_data` dict."""
    if format not in ("text", "json"):
        raise ValueError(
            f"diagnostics format={format!r} is not one of 'text' | 'json'"
        )
    data = diagnostics_data(executor)
    if format == "json":
        return data
    return _render_diagnostics(data)


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------


def serve(port: Optional[int] = None, host: Optional[str] = None):
    """Start the telemetry HTTP endpoint (`utils.telemetry_http`):
    ``/metrics``, ``/healthz``, ``/diagnostics``, ``/trace`` and
    ``/profile`` on a daemon thread. ``port``
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
