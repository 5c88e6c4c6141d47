"""Stage-graph pipeline runtime: N concurrent stages, bounded queues.

A copy of `tensorframes_tpu/ingest/pipeline.py`: an arbitrary linear
stage graph

    source -> stage_1 -> stage_2 -> ... -> consumer

where every stage runs concurrently with every other on its own
thread(s), connected by BOUNDED queues, so the pipeline's peak host
memory stays a documented constant no matter how long the stream. A
stage with ``workers > 1`` decodes items OUT OF ORDER on a small thread
pool and re-sequences them through a bounded reorder buffer, so
delivery is always IN ORDER — downstream stages (the H2D transfer
stage, the consumer's chunk ordinals) never observe reordering.

Memory bound (threaded mode, ``config.ingest_pipeline`` on): with
final-queue depth ``d`` (``config.stream_prefetch_depth``), the number
of simultaneously live chunks is at most

    d                  (the delivery queue)
  + 1                  (the consumer's item in hand)
  + 1 + 1              per single-worker stage (in hand + its in-queue)
  + workers + d        per pooled stage (in-flight + reorder window)
  + 1 + c0             (the producer's item in hand + the source queue,
                        c0 = d with no stages, else 1 — or the
                        declared task capacity when the first stage
                        consumes cheap task descriptors)

For the canonical chain (decode pool of W, one transfer stage) that is
``W + 2d + 4`` chunks; `tests/test_torch_ingest.py` asserts it.

Failure semantics (`runtime.faults`, applied to ingest):
every stage invocation is routed through `runtime.faults` — a
``transient``-classified failure (device loss, connection reset,
injected `UNAVAILABLE:`) is retried in place with the deterministic
backoff schedule, up to ``config.block_retry_attempts`` per chunk
within one ``config.verb_retry_budget`` per stage; ``deterministic``
failures (corrupt files, schema mismatches) surface after EXACTLY one
attempt. Either way the exception reaches the consumer stamped with
``tfs_chunk_index`` / ``tfs_pipeline_stage`` (and whatever context the
stage declares — the decode stage adds ``tfs_shard_path``), and every
pipeline thread exits promptly: an error, like consumer abandonment,
cancels the whole graph and drains the bounded queues so buffered
chunks release.

Telemetry (always-live counters; gauges/spans gated on
``config.telemetry``):

- ``ingest_stage_busy_seconds{stage=}`` / ``ingest_stage_wait_seconds
  {stage=}`` — per-stage busy vs starved time (the consumer reports as
  ``stage="compute"``: its wait is exactly the time the devices sat
  starved for input).
- ``ingest_chunks{stage=}`` — items through each stage.
- ``ingest_queue_depth{stage=}`` gauge — occupancy of each stage's
  input queue at consume time (0 = that stage is starved).
- the legacy ``stream_queue_depth`` gauge on the delivery queue.

``config.ingest_pipeline`` off runs the SAME stage functions inline on
the consumer thread (stage-serial) — the no-overlap baseline; error
stamping and retry classification behave identically.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "PipeStage",
    "pipelined",
    "set_stage_fault_injector",
    "current_cancel_event",
]


# Per-thread handle to the owning graph's cancel event, set for every
# pipeline thread at spawn: stage code (and the hang-fault injector)
# running on WORKER threads — where the deadline contextvar does not
# flow — can wait on it and wake the moment the graph tears down
# (consumer abandon, stage error, or deadline expiry).
_CANCEL_LOCAL = threading.local()


def current_cancel_event() -> Optional[threading.Event]:
    """The cancel event of the pipeline graph owning THIS thread (None
    off pipeline threads). A long-running stage may poll/wait on it to
    exit early on teardown; `testing.faults`'s ``fault="hang"``
    injection sleeps against it so injected wedges never outlive the
    pipeline."""
    return getattr(_CANCEL_LOCAL, "event", None)


class PipeStage:
    """One pipeline stage: a per-item transform.

    ``fn(item) -> item`` runs on ``workers`` threads (out-of-order when
    ``workers > 1``; delivery re-sequences). ``context(item)`` returns
    attribute names -> values stamped onto an exception escaping this
    stage (the decode stage stamps ``tfs_shard_path``).
    ``cheap_input=True`` declares the stage's INPUT items to be small
    task descriptors rather than decoded chunks, letting the runtime
    deepen the stage's input queue without growing chunk memory."""

    __slots__ = ("name", "fn", "workers", "context", "cheap_input")

    def __init__(
        self,
        name: str,
        fn: Callable,
        workers: int = 1,
        context: Optional[Callable[[object], Dict[str, object]]] = None,
        cheap_input: bool = False,
    ):
        if workers < 1:
            raise ValueError(f"stage {name!r}: workers must be >= 1")
        self.name = name
        self.fn = fn
        self.workers = int(workers)
        self.context = context
        self.cheap_input = cheap_input


# -- fault-injection seam (testing.faults.inject_stage) ----------------------

_stage_fault_injector: Optional[Callable] = None


def set_stage_fault_injector(hook: Optional[Callable]) -> None:
    """Install/clear the stage-level chaos hook: ``hook(stage_name,
    item)`` is called before every stage-fn ATTEMPT (retries draw new
    verdicts, mirroring the executor seam's ordinal semantics) and may
    raise a classified fault."""
    global _stage_fault_injector
    _stage_fault_injector = hook


def _stamp(
    e: BaseException,
    idx: int,
    stage_name: str,
    extra: Optional[Dict[str, object]] = None,
) -> BaseException:
    """Chunk-index / stage / shard context for pipeline failures: the
    consumer sees WHICH chunk (and which pipeline stage, and — for
    decode — which shard file) died without the exception type
    changing. First stamp wins (an error forwarded through later
    stages keeps its origin)."""
    if getattr(e, "tfs_chunk_index", None) is None:
        try:
            e.tfs_chunk_index = idx
            e.tfs_pipeline_stage = stage_name
            for k, v in (extra or {}).items():
                if getattr(e, k, None) is None:
                    setattr(e, k, v)
        except Exception:
            pass  # extension exceptions without a __dict__
    return e


def _close_source(it) -> None:
    """Deterministically release the source's resources (open file
    handles in the `io` readers) instead of waiting for GC — the
    generator may live on a pipeline thread, where refcount collection
    is not prompt."""
    close = getattr(it, "close", None)
    if callable(close):
        try:
            close()
        except Exception:
            pass  # releasing a half-consumed reader must never mask errors


def _run_stage_fn(
    stage: PipeStage, scope, ordinal: int, item, parent: Optional[int] = None
):
    """One stage invocation under classified fault handling: transient
    errors retry in place (deterministic backoff, per-chunk attempt cap
    + per-stage budget from ``scope``); everything else surfaces after
    one attempt. Escaping exceptions are stamped with chunk / stage /
    stage-declared context.

    Span attribution: pipeline stages run on WORKER threads, where the
    telemetry contextvars do not flow — a naive span here would record
    an orphan root disconnected from the verb consuming the stream.
    Each successful invocation instead records an already-timed
    ``stage`` span with an EXPLICIT parent (the consumer-side span id
    captured by `pipelined` at first pull) plus a ``stage`` label, so
    decode/transfer spans nest under the verb with no orphan parent
    ids."""
    from ..utils import telemetry as _tele

    def attempt():
        hook = _stage_fault_injector
        if hook is not None:
            hook(stage.name, item)
        return stage.fn(item)

    try:
        t0 = time.perf_counter()
        out = scope.dispatch(
            attempt, what=f"ingest.{stage.name}[chunk {ordinal}]"
        )
        _tele.add_event(
            f"ingest.{stage.name}", "stage", t0, time.perf_counter(),
            parent_id=parent, stage=stage.name, chunk=ordinal,
        )
        return out
    except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
        extra = None
        if stage.context is not None:
            try:
                extra = stage.context(item)
            except Exception:
                extra = None
        raise _stamp(e, ordinal, stage.name, extra)


def _note_stage(stage_name: str, busy_s: float, wait_s: float) -> None:
    from ..utils import telemetry as _tele

    _tele.counter_inc("ingest_chunks", 1.0, stage=stage_name)
    _tele.counter_inc("ingest_stage_busy_seconds", busy_s, stage=stage_name)
    _tele.counter_inc("ingest_stage_wait_seconds", wait_s, stage=stage_name)


def _fault_scope(stage_name: str):
    from ..runtime import faults as _faults

    return _faults.scope(f"ingest.{stage_name}")


# ---------------------------------------------------------------------------
# stage-serial fallback (config.ingest_pipeline = off)
# ---------------------------------------------------------------------------


class _PipelineRoot:
    """The pipeline's virtual root span: an id reserved up front (so
    stage spans on WORKER threads can name their parent before the
    parent region closes) and recorded as an already-timed ``stage``
    span when the pipeline ends — under the span that was current at
    first pull when there was one. Guarantees the exported trace never
    carries an orphan parent id, whatever thread a stage ran on."""

    __slots__ = ("sid", "parent", "t0")

    def __init__(self):
        from ..utils import telemetry as _tele

        if _tele.enabled():
            self.parent = _tele.current_span_id()
            self.sid = _tele.allocate_span_id()
            self.t0 = time.perf_counter()
        else:
            self.parent = self.sid = self.t0 = None

    def close(self, chunks: int) -> None:
        if self.sid is None:
            return
        from ..utils import telemetry as _tele

        _tele.add_event(
            "ingest.pipeline", "stage", self.t0, time.perf_counter(),
            parent_id=self.parent, span_id=self.sid, chunks=chunks,
        )


def _serial_pipeline(source, stages: Sequence[PipeStage], ordinal_base: int = 0):
    """Every stage inline on the consumer thread — no overlap, but the
    same stage functions, fault classification and error stamping as
    the threaded graph (the honest pipeline-off baseline)."""
    from ..runtime import deadline as _dl

    it = iter(source)
    scopes = [_fault_scope(s.name) for s in stages]
    root = _PipelineRoot()
    ordinal = ordinal_base
    try:
        while True:
            _dl.check("ingest.pipeline")
            try:
                item = next(it)
            except StopIteration:
                return
            except BaseException as e:  # noqa: BLE001 — stamped context
                raise _stamp(e, ordinal, "producer")
            for stage, scope in zip(stages, scopes):
                t0 = time.perf_counter()
                item = _run_stage_fn(stage, scope, ordinal, item, root.sid)
                _note_stage(stage.name, time.perf_counter() - t0, 0.0)
            ordinal += 1
            yield item
    finally:
        _close_source(it)
        root.close(ordinal - ordinal_base)


# ---------------------------------------------------------------------------
# the threaded stage graph
# ---------------------------------------------------------------------------

# queue message protocol: ("item", ordinal, payload) |
# ("end", count, None) | ("error", position, exc). `position` is the
# stream ordinal at which the stream ends/fails, so an out-of-order
# pool can re-sequence terminal messages exactly like items.
_ITEM, _END, _ERROR = "item", "end", "error"


class _Graph:
    """Shared cancellation + bounded-put plumbing for one pipeline run.

    ``scope`` (a `runtime.deadline.CancelScope`, captured from the
    CONSUMER's context at first pull) folds the verb's deadline /
    cancellation into the graph's own teardown signal: every queue
    poll checks `aborted()`, so a deadline expiry tears the stage
    graph down with exactly the consumer-abandon guarantees — threads
    exit, the source closes, bounded queues drain."""

    def __init__(self, scope=None):
        self.cancelled = threading.Event()
        self.scope = scope
        self.queues: List[queue.Queue] = []
        self.threads: List[threading.Thread] = []

    def aborted(self) -> bool:
        """Teardown signal: explicit shutdown, consumer-scope cancel,
        or consumer-deadline expiry."""
        if self.cancelled.is_set():
            return True
        if self.scope is not None and self.scope.should_abort():
            # latch: waking every poller once beats each of them
            # re-reading the clock forever
            self.cancelled.set()
            return True
        return False

    def make_queue(self, maxsize: int) -> "queue.Queue":
        q = queue.Queue(maxsize=max(1, int(maxsize)))
        self.queues.append(q)
        return q

    def put(self, q: "queue.Queue", msg) -> bool:
        """Bounded put that gives up when the consumer abandoned the
        pipeline (or its deadline expired) — a blocked put would
        otherwise pin buffered chunks (and the thread) forever."""
        while not self.aborted():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def get(self, q: "queue.Queue"):
        """Bounded get; returns None when cancelled."""
        while not self.aborted():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def spawn(self, target, name: str) -> None:
        def run():
            _CANCEL_LOCAL.event = self.cancelled
            try:
                target()
            finally:
                _CANCEL_LOCAL.event = None

        t = threading.Thread(target=run, daemon=True, name=name)
        self.threads.append(t)
        t.start()

    def shutdown(self) -> None:
        self.cancelled.set()
        for q in self.queues:
            while True:  # release buffered chunks promptly
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def _start_producer(
    g: _Graph, source, q_out: "queue.Queue", ordinal_base: int = 0
) -> None:
    def producer():
        it = None
        idx = ordinal_base
        try:
            try:
                # iter() INSIDE the try: a source whose __iter__ raises
                # (non-iterable, failing open) must surface to the
                # consumer as an error message, not kill this thread
                # and leave the consumer blocked on the queue forever
                it = iter(source)
                for item in it:
                    if not g.put(q_out, (_ITEM, idx, item)):
                        return
                    idx += 1
            except BaseException as e:  # noqa: BLE001 — consumer side
                g.put(q_out, (_ERROR, idx, _stamp(e, idx, "producer")))
                return
            g.put(q_out, (_END, idx, None))
        finally:
            _close_source(source if it is None else it)

    g.spawn(producer, "tfs-ingest-producer")


def _start_serial_stage(
    g: _Graph,
    stage: PipeStage,
    q_in: "queue.Queue",
    q_out: "queue.Queue",
    parent: Optional[int] = None,
) -> None:
    """A single-worker stage: in-order by construction (one thread, one
    bounded in/out queue) — the old transfer-stage shape."""
    scope = _fault_scope(stage.name)

    def worker():
        from ..utils import telemetry as _tele

        while True:
            t0 = time.perf_counter()
            msg = g.get(q_in)
            if msg is None:
                return
            wait_s = time.perf_counter() - t0
            kind, pos, payload = msg
            if kind != _ITEM:
                g.put(q_out, msg)
                return
            if _tele.enabled():
                _tele.gauge_set(
                    "ingest_queue_depth", q_in.qsize(), stage=stage.name
                )
            t1 = time.perf_counter()
            try:
                payload = _run_stage_fn(stage, scope, pos, payload, parent)
            except BaseException as e:  # noqa: BLE001 — consumer side
                g.put(q_out, (_ERROR, pos, e))
                return
            _note_stage(stage.name, time.perf_counter() - t1, wait_s)
            if not g.put(q_out, (_ITEM, pos, payload)):
                return

    g.spawn(worker, f"tfs-ingest-{stage.name}")


class _PoolState:
    """Reorder state of one pooled stage: out-of-order workers feed
    ``buffer``; the emitter drains it in ordinal order. ``window``
    bounds how far workers may run ahead of delivery (the reorder
    buffer's chunk-memory cap)."""

    def __init__(self, window: int, base: int = 0):
        self.cond = threading.Condition()
        self.buffer: Dict[int, tuple] = {}
        self.next_emit = base
        self.end_at: Optional[int] = None
        self.done = False
        self.window = max(1, int(window))


def _start_pooled_stage(
    g: _Graph,
    stage: PipeStage,
    q_in: "queue.Queue",
    q_out: "queue.Queue",
    depth: int,
    parent: Optional[int] = None,
    ordinal_base: int = 0,
) -> None:
    """A ``workers > 1`` stage: out-of-order execution, in-order
    delivery through a bounded reorder buffer."""
    st = _PoolState(window=stage.workers + depth, base=ordinal_base)
    scope = _fault_scope(stage.name)

    def worker():
        from ..utils import telemetry as _tele

        while not st.done:
            t0 = time.perf_counter()
            msg = g.get(q_in)
            if msg is None:
                return
            wait_s = time.perf_counter() - t0
            kind, pos, payload = msg
            if kind == _END:
                with st.cond:
                    st.end_at = pos
                    st.cond.notify_all()
                return
            if kind == _ERROR:
                with st.cond:
                    st.buffer[pos] = (_ERROR, payload)
                    st.end_at = pos  # nothing follows an upstream error
                    st.cond.notify_all()
                return
            if _tele.enabled():
                _tele.gauge_set(
                    "ingest_queue_depth", q_in.qsize(), stage=stage.name
                )
            # reorder window: never run more than `window` ordinals
            # ahead of delivery — this is the decode pool's chunk
            # memory bound
            with st.cond:
                while (
                    pos - st.next_emit >= st.window
                    and not st.done
                    and not g.aborted()
                ):
                    st.cond.wait(timeout=0.1)
                if st.done or g.aborted():
                    return
            t1 = time.perf_counter()
            try:
                out = (
                    _ITEM,
                    _run_stage_fn(stage, scope, pos, payload, parent),
                )
            except BaseException as e:  # noqa: BLE001 — consumer side
                out = (_ERROR, e)
            else:
                _note_stage(stage.name, time.perf_counter() - t1, wait_s)
            with st.cond:
                st.buffer[pos] = out
                st.cond.notify_all()

    def emitter():
        while True:
            with st.cond:
                while (
                    st.next_emit not in st.buffer
                    and st.end_at != st.next_emit
                    and not g.aborted()
                ):
                    st.cond.wait(timeout=0.1)
                if g.aborted():
                    st.done = True
                    st.cond.notify_all()
                    return
                if st.next_emit in st.buffer:
                    kind, payload = st.buffer.pop(st.next_emit)
                    pos = st.next_emit
                    if kind == _ITEM:
                        st.next_emit += 1
                    else:
                        st.done = True
                    st.cond.notify_all()
                else:  # end_at == next_emit: clean end of stream
                    kind, pos, payload = _END, st.next_emit, None
                    st.done = True
                    st.cond.notify_all()
            # puts happen OUTSIDE the lock: a full downstream queue
            # must not deadlock workers waiting to buffer results
            if kind == _ITEM:
                if not g.put(q_out, (_ITEM, pos, payload)):
                    with st.cond:
                        st.done = True
                        st.cond.notify_all()
                    return
            elif kind == _END:
                g.put(q_out, (_END, pos, None))
                return
            else:
                g.put(q_out, (_ERROR, pos, payload))
                return

    for w in range(stage.workers):
        g.spawn(worker, f"tfs-ingest-{stage.name}-{w}")
    g.spawn(emitter, f"tfs-ingest-{stage.name}-emit")


def pipelined(
    source,
    stages: Sequence[PipeStage] = (),
    depth: Optional[int] = None,
    ordinal_base: int = 0,
    inline: Optional[bool] = None,
):
    """Run ``source`` through ``stages`` as a concurrently-executing
    stage graph and yield the results in order.

    ``depth`` is the delivery-queue bound (default
    ``config.stream_prefetch_depth``); the full chunk-memory bound is
    documented in the module docstring. With ``config.ingest_pipeline``
    off, runs the same stages inline on the consumer thread
    (stage-serial). ``inline`` overrides that gate for a caller whose
    on/off switch is another knob (`lazy.LazyFrame.force` gates on
    ``config.plan_pipeline``): ``True`` forces the inline path, ``False``
    the threaded graph, ``None`` follows ``config.ingest_pipeline``.
    ``ordinal_base`` offsets every chunk ordinal (span
    labels, ``tfs_chunk_index`` stamps): a RESUMED durable stream
    re-enters the pipeline at its committed watermark, and a failure at
    post-resume chunk 3 must name the GLOBAL ordinal, not the third
    chunk since restart. The generator owns the graph:
    closing/abandoning it cancels every stage thread and drains the
    bounded queues; an error in any stage surfaces here with
    ``tfs_chunk_index`` / ``tfs_pipeline_stage`` (+ stage context)
    stamped, after which the graph shuts down the same way."""
    from .. import config as _config
    from ..runtime import deadline as _dl
    from ..utils import telemetry as _tele

    cfg = _config.get()
    if depth is None:
        depth = cfg.stream_prefetch_depth
    depth = max(1, int(depth))
    ordinal_base = max(0, int(ordinal_base))
    stages = list(stages)
    if inline is None:
        inline = not cfg.ingest_pipeline
    if inline:
        yield from _serial_pipeline(source, stages, ordinal_base)
        return

    # the consumer's deadline/cancel scope (this generator body first
    # runs at first pull, on the consuming verb's thread): its expiry
    # becomes the graph's teardown signal — the DEADLINE path gives the
    # same guarantees as consumer abandonment (threads exit, source
    # closes, queues drain), and the consumer loop below raises the
    # typed DeadlineExceeded instead of blocking on the queue forever
    g = _Graph(scope=_dl.current_scope())
    # cross-thread span attribution: stage spans recorded on worker
    # threads parent to the pipeline's virtual root span (contextvars
    # do not flow into pipeline threads; the root's id is reserved NOW
    # and its region recorded at shutdown, so no child ever references
    # a missing parent). The root itself parents to whatever span is
    # current at first pull — the consuming verb, when there is one.
    root = _PipelineRoot()
    parent = root.sid
    # one buffering budget for the whole graph: intermediate handoffs
    # hold a single item (cheap task descriptors may buffer a few more)
    # and the DELIVERY queue gets the full depth — adding stages must
    # not silently multiply a stream's peak chunk memory.
    if stages:
        first = stages[0]
        c0 = first.workers * 2 if first.cheap_input else 1
        q = g.make_queue(c0)
    else:
        q = g.make_queue(depth)
    _start_producer(g, source, q, ordinal_base)
    for i, stage in enumerate(stages):
        last = i == len(stages) - 1
        q_out = g.make_queue(depth if last else 1)
        if stage.workers == 1:
            _start_serial_stage(g, stage, q, q_out, parent)
        else:
            _start_pooled_stage(
                g, stage, q, q_out, depth, parent, ordinal_base
            )
        q = q_out

    delivered = 0
    try:
        while True:
            t0 = time.perf_counter()
            if _tele.enabled():
                # queue depth at each consume: how far ahead the
                # pipeline is running (0 = the consumer is starved,
                # depth = the pipeline is saturated)
                _tele.gauge_set("stream_queue_depth", q.qsize())
                _tele.gauge_set(
                    "ingest_queue_depth", q.qsize(), stage="compute"
                )
            # poll, not block: a wedged stage (slow shard, injected
            # hang) must not hold the consumer past its deadline — the
            # check raises DeadlineExceeded/Cancelled and the finally
            # below tears the graph down like an abandon
            while True:
                _dl.check("ingest.pipeline")
                if g.aborted():
                    # the scope CAPTURED at first pull died (expired,
                    # or cancel() on a retained handle from another
                    # thread) and the stage threads may already have
                    # torn down without delivering _END — the ambient
                    # check above cannot see a captured scope, so
                    # raise its typed error here instead of polling
                    # an abandoned queue forever
                    if g.scope is not None:
                        g.scope.check("ingest.pipeline")
                    raise _dl.Cancelled(
                        "ingest pipeline torn down mid-consume"
                    )
                try:
                    msg = q.get(timeout=0.1)
                    break
                except queue.Empty:
                    continue
            kind, pos, payload = msg
            wait_s = time.perf_counter() - t0
            if kind == _ERROR:
                idx = getattr(payload, "tfs_chunk_index", None)
                if idx is not None:
                    from ..utils.log import get_logger

                    get_logger("ingest").warning(
                        "ingest pipeline failed at chunk %d (%s stage%s): "
                        "%s: %s",
                        idx,
                        getattr(payload, "tfs_pipeline_stage", "?"),
                        (
                            f", shard {payload.tfs_shard_path}"
                            if getattr(payload, "tfs_shard_path", None)
                            is not None
                            else ""
                        ),
                        type(payload).__name__,
                        payload,
                    )
                raise payload
            if kind == _END:
                return
            _note_stage("compute", 0.0, wait_s)
            delivered += 1
            yield payload
    finally:
        g.shutdown()
        root.close(delivered)
