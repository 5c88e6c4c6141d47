"""Deadline propagation, cooperative cancellation, admission control.

The PyTorch counterpart of `tensorframes_tpu/runtime/deadline.py`, the
whole module but the flight-recorder hook:

- **`Deadline`** — an ABSOLUTE time budget (monotonic seconds).
  Relative ``timeout_s`` arguments convert on entry, so nested verbs
  share one budget end to end instead of each restarting the clock.

- **`CancelScope`** — the cooperative cancellation token, propagated
  through a contextvar: every dispatch boundary (`FaultScope.dispatch`,
  the per-block loops of the verbs, the ingest consumer loop, backoff
  sleeps) calls `check()` / `sleep()` against the ambient scope. Expiry
  raises a typed `DeadlineExceeded`; an explicit `cancel()` raises
  `Cancelled`. Both carry ``tfs_fault_class="deterministic"`` so the
  fault classifier NEVER burns a retry on them. Nested scopes share the
  parent's cancel event (cancellation flows down) and may only TIGHTEN
  the deadline.

- **`AdmissionController`** — gates concurrent TOP-LEVEL verb entry
  against ``config.max_concurrent_verbs`` with a bounded wait queue
  (``config.admission_queue_limit``) and load shedding: a caller
  arriving at a full queue (or waiting out
  ``config.admission_wait_timeout_s``) is rejected with a typed
  `OverloadError` carrying the queue depth and a retry-after hint
  derived from the ``verb_seconds`` latency histogram. NESTED verbs (a
  stream's per-chunk reduce, a combine) never re-enter admission — one
  admitted verb is one slot, whatever it dispatches internally — which
  also makes small limits deadlock-free by construction.

Telemetry (always-live): ``deadline_exceeded{verb=}`` / ``verbs_shed``
/ ``admission_wait_seconds`` counters and the registered
``admission_queue_depth`` / ``admission_in_flight`` gauges; the fault
ledger gains ``deadlines`` / ``shed`` counts.

Partial-work semantics: a verb that trips its deadline mid-flight stops
issuing new block dispatches at the next boundary check. Work already
queued on the card is not interrupted — a CUDA kernel is not preemptible
— but nothing new is started, and admission slots, pipeline threads and
file handles release exactly as they do on consumer abandonment.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Optional

import contextvars

__all__ = [
    "Deadline",
    "CancelScope",
    "DeadlineExceeded",
    "Cancelled",
    "OverloadError",
    "AdmissionController",
    "controller",
    "current_scope",
    "remaining",
    "check",
    "sleep_interruptible",
    "deadline_scope",
    "verb_scope",
    "deadline_entry",
    "reset",
]


# ---------------------------------------------------------------------------
# typed exceptions
# ---------------------------------------------------------------------------


class DeadlineExceeded(TimeoutError):
    """A verb ran past its time budget. Classified ``deterministic``
    (``tfs_fault_class``): re-running the same dispatch under the same
    expired budget fails identically, so the fault layer surfaces it
    after exactly one attempt — a deadline is never burned as a retry.
    A CHECKPOINTED streaming reduce stamps
    ``tfs_checkpoint_path`` / ``tfs_checkpoint_watermark`` — the
    durable progress the expired budget bought (`runtime.checkpoint`):
    re-issuing the same call resumes from that watermark instead of
    chunk zero."""

    tfs_fault_class = "deterministic"

    def __init__(self, message: str, verb: Optional[str] = None,
                 budget_s: Optional[float] = None,
                 elapsed_s: Optional[float] = None):
        super().__init__(message)
        self.verb = verb
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s
        self.tfs_checkpoint_path = None
        self.tfs_checkpoint_watermark = None


class Cancelled(RuntimeError):
    """The scope's cancel token fired (explicit `CancelScope.cancel`).
    Deterministic for the classifier, like `DeadlineExceeded` — and
    like it, a checkpointed stream stamps ``tfs_checkpoint_path`` /
    ``tfs_checkpoint_watermark`` with the progress committed on the
    way out."""

    tfs_fault_class = "deterministic"

    def __init__(self, message: str, reason: Optional[str] = None):
        super().__init__(message)
        self.reason = reason
        self.tfs_checkpoint_path = None
        self.tfs_checkpoint_watermark = None


class OverloadError(RuntimeError):
    """Admission control shed this verb: the concurrency limit was
    reached and the bounded wait queue was full (or the wait timed
    out). Carries ``queue_depth`` (waiters at shed time), ``limit``,
    and ``retry_after_s`` — a hint derived from the live per-verb
    latency histogram: roughly how long until a slot should free.
    Deterministic for the classifier (retrying INSIDE the runtime
    would just re-join the overload; backing off is the caller's
    move — that is what the hint is for)."""

    tfs_fault_class = "deterministic"

    def __init__(self, message: str, queue_depth: int, limit: int,
                 retry_after_s: float):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.limit = int(limit)
        self.retry_after_s = float(retry_after_s)


# ---------------------------------------------------------------------------
# deadline + cancel scope
# ---------------------------------------------------------------------------


class Deadline:
    """An absolute monotonic-clock expiry. Immutable; combine by
    `min` (the tighter budget wins — `tightened`)."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    def remaining(self) -> float:
        """Seconds left (negative once expired)."""
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def tightened(self, other: Optional["Deadline"]) -> "Deadline":
        if other is None or self.at <= other.at:
            return self
        return other

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(in {self.remaining():.3f}s)"


class CancelScope:
    """One verb call's cancellation state: an optional `Deadline` plus
    a cancel event. Nested scopes SHARE the event object (cancelling a
    verb cancels everything it started), so any `sleep()` in the tree
    wakes immediately on `cancel()`."""

    __slots__ = (
        "deadline", "verb", "started", "_event", "_reason",
        "_deadline_noted",
    )

    def __init__(
        self,
        deadline: Optional[Deadline] = None,
        verb: Optional[str] = None,
        event: Optional[threading.Event] = None,
    ):
        self.deadline = deadline
        self.verb = verb
        self.started = time.monotonic()
        self._event = event if event is not None else threading.Event()
        self._reason: Optional[str] = None
        self._deadline_noted = False

    # -- cancellation ---------------------------------------------------
    def cancel(self, reason: str = "cancelled") -> None:
        """Fire the cancel token: every `check()`/`sleep()` against this
        scope (or a scope nested under it) raises `Cancelled` from now
        on. Idempotent; thread-safe."""
        self._reason = reason
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def cancel_event(self) -> threading.Event:
        """The shared cancel event (what worker threads without
        contextvar flow — ingest stages, watchdogs — may wait on)."""
        return self._event

    # -- deadline -------------------------------------------------------
    def remaining(self) -> Optional[float]:
        """Seconds left on the deadline, or None when unbounded."""
        return None if self.deadline is None else self.deadline.remaining()

    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def should_abort(self) -> bool:
        """Non-raising poll for worker loops: cancelled or expired."""
        return self._event.is_set() or self.expired()

    # -- the cooperative boundary --------------------------------------
    def _note_deadline_once(self) -> None:
        if self._deadline_noted:
            return
        self._deadline_noted = True
        try:
            from ..utils import telemetry as _tele

            _tele.counter_inc(
                "deadline_exceeded", 1.0, verb=self.verb or "?"
            )
            from . import faults as _faults

            _faults.note_deadline()
        except Exception:  # accounting must never mask the timeout
            pass

    def check(self, what: str = "") -> None:
        """Raise `Cancelled` / `DeadlineExceeded` when the scope is
        dead; no-op (one event check + one clock read) otherwise. THE
        cooperative cancellation point — called at every dispatch
        boundary."""
        if self._event.is_set():
            raise Cancelled(
                f"{what or 'verb'} cancelled"
                + (f": {self._reason}" if self._reason else ""),
                reason=self._reason,
            )
        d = self.deadline
        if d is not None:
            rem = d.remaining()
            if rem <= 0.0:
                self._note_deadline_once()
                elapsed = time.monotonic() - self.started
                budget = d.at - self.started
                raise DeadlineExceeded(
                    f"{what or 'verb'} exceeded its deadline "
                    f"(budget {budget:.3f}s, elapsed {elapsed:.3f}s"
                    + (f", verb {self.verb}" if self.verb else "")
                    + ")",
                    verb=self.verb, budget_s=budget, elapsed_s=elapsed,
                )

    def sleep(self, seconds: float, what: str = "") -> None:
        """Interruptible sleep: waits ``seconds`` on the cancel event,
        clipped to the remaining deadline — a timed-out scope never
        sleeps past its budget. Wakes (and raises, via `check`) the
        moment the scope is cancelled or the deadline arrives; returns
        normally only after the full ``seconds`` elapsed with the
        scope still alive."""
        end = time.monotonic() + max(0.0, float(seconds))
        while True:
            self.check(what)
            left = end - time.monotonic()
            if left <= 0.0:
                return
            rem = self.remaining()
            if rem is not None:
                # +1ms so the post-wait check() observes the expiry
                # instead of spinning on a 0-length wait
                left = min(left, max(rem, 0.0) + 1e-3)
            self._event.wait(left)


_SCOPE: "contextvars.ContextVar[Optional[CancelScope]]" = (
    contextvars.ContextVar("tfs_torch_cancel_scope", default=None)
)

# admission nesting is tracked SEPARATELY from deadline nesting: a
# user-level `deadline_scope` must propagate its budget into the verbs
# it wraps WITHOUT exempting them from admission (each wrapped verb is
# still a top-level unit of load), while a verb nested inside another
# verb (stream chunk reduce, combine) must never take a
# second slot — that is what makes small limits deadlock-free.
_ADMITTED: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "tfs_torch_admitted_verb", default=False
)


def current_scope() -> Optional[CancelScope]:
    """The ambient `CancelScope`, if a verb (or `deadline_scope`) is
    active on this thread/context."""
    return _SCOPE.get()


def remaining() -> Optional[float]:
    """Seconds left on the ambient deadline, or None (no scope, or an
    unbounded one)."""
    s = _SCOPE.get()
    return None if s is None else s.remaining()


def check(what: str = "") -> None:
    """Module-level cooperative checkpoint: no-op without an ambient
    scope (the common, un-deadlined case costs one contextvar read)."""
    s = _SCOPE.get()
    if s is not None:
        s.check(what)


def sleep_interruptible(seconds: float, what: str = "") -> None:
    """Sleep that honors the ambient scope: event-based wait clipped to
    the remaining deadline (raising `DeadlineExceeded` / `Cancelled` at
    expiry) — plain `time.sleep` when no scope is active."""
    s = _SCOPE.get()
    if s is None:
        time.sleep(seconds)
    else:
        s.sleep(seconds, what)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _mean_verb_seconds() -> Optional[float]:
    """Mean verb latency from the live ``verb_seconds`` histogram (all
    verbs pooled) — the retry-after oracle. None when nothing has run
    (fresh process) or telemetry is off and the histogram is empty."""
    try:
        from ..utils import telemetry as _tele

        hists = _tele.metrics_snapshot()[2]
        tot_s = 0.0
        tot_n = 0
        for (name, _labels), (_b, _c, hsum, hcount) in hists.items():
            if name == "verb_seconds":
                tot_s += hsum
                tot_n += hcount
        if tot_n:
            return tot_s / tot_n
    except Exception:
        pass  # no latency history: retry_after uses the default hint
    return None


class AdmissionController:
    """Bounded concurrent-verb gate. `admit()` is the single entry
    point; it returns a release callable. With
    ``config.max_concurrent_verbs`` <= 0 the gate is open (in-flight
    is still tracked — the gauges stay meaningful for capacity
    planning before a limit is turned on)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.in_flight = 0
        self.waiting = 0
        self.admitted = 0
        self.shed = 0
        self.peak_in_flight = 0

    # -- introspection --------------------------------------------------
    def snapshot(self) -> dict:
        """Live overload state. ``overloaded`` means a new arrival RIGHT
        NOW would shed."""
        from .. import config as _config

        cfg = _config.get()
        limit = int(getattr(cfg, "max_concurrent_verbs", 0) or 0)
        qlimit = int(getattr(cfg, "admission_queue_limit", 0) or 0)
        with self._lock:
            return {
                "limit": limit,
                "queue_limit": qlimit,
                "in_flight": self.in_flight,
                "queue_depth": self.waiting,
                "peak_in_flight": self.peak_in_flight,
                "admitted": self.admitted,
                "shed": self.shed,
                "overloaded": bool(
                    limit > 0
                    and self.in_flight >= limit
                    and self.waiting >= qlimit
                ),
            }

    def queue_depth(self) -> int:
        # lock-free read (GIL-atomic int): this feeds the registered
        # admission_queue_depth gauge, which metrics exports evaluate —
        # including exports triggered from INSIDE the controller (the
        # shed path reads the verb-latency histogram while holding the
        # gate lock), so taking self._lock here would deadlock
        return self.waiting

    def in_flight_now(self) -> int:
        return self.in_flight  # lock-free, see queue_depth

    def reset(self) -> None:
        """Test hook: forget the accounting (NOT the live in-flight
        count — a reset mid-verb must not free someone's slot)."""
        with self._lock:
            self.admitted = 0
            self.shed = 0
            self.peak_in_flight = self.in_flight

    # -- the gate -------------------------------------------------------
    def _shed(self, verb: str, depth: int, limit: int):
        self.shed += 1
        mean = _mean_verb_seconds()
        retry_after = max(0.001, (mean or 0.05) * (depth + 1))
        try:
            from ..utils import telemetry as _tele

            _tele.counter_inc("verbs_shed", 1.0)
            from . import faults as _faults

            _faults.note_shed()
        except Exception:
            pass  # shed accounting must never mask the typed error
        return OverloadError(
            f"{verb}: admission control shed this call — "
            f"{self.in_flight} verb(s) in flight (limit {limit}), "
            f"{depth} waiting (queue limit reached); retry in "
            f"~{retry_after:.3f}s",
            queue_depth=depth, limit=limit, retry_after_s=retry_after,
        )

    def admit(self, verb: str, scope: Optional[CancelScope] = None):
        """Take one concurrency slot (blocking in the bounded queue when
        the limit is reached). Returns the zero-arg release callable.
        Raises `OverloadError` on shed, `DeadlineExceeded` /
        `Cancelled` when the caller's scope dies while queued — the
        queue slot is released either way."""
        from .. import config as _config

        cfg = _config.get()
        limit = int(getattr(cfg, "max_concurrent_verbs", 0) or 0)
        qlimit = int(getattr(cfg, "admission_queue_limit", 0) or 0)
        wait_cap = float(
            getattr(cfg, "admission_wait_timeout_s", 0.0) or 0.0
        )
        waited = 0.0
        with self._cond:
            if limit > 0 and self.in_flight >= limit:
                if self.waiting >= qlimit:
                    raise self._shed(verb, self.waiting, limit)
                self.waiting += 1
                t0 = time.monotonic()
                try:
                    deadline_cap = (
                        None if wait_cap <= 0 else t0 + wait_cap
                    )
                    while self.in_flight >= limit:
                        now = time.monotonic()
                        if deadline_cap is not None and now >= deadline_cap:
                            raise self._shed(
                                verb, self.waiting - 1, limit
                            )
                        # wake at least every 50ms to poll the scope:
                        # a queued caller whose deadline expires must
                        # leave the queue promptly, not on notify
                        timeout = 0.05
                        if deadline_cap is not None:
                            timeout = min(timeout, deadline_cap - now)
                        if scope is not None:
                            scope.check(f"{verb} (queued for admission)")
                            rem = scope.remaining()
                            if rem is not None:
                                timeout = min(timeout, max(rem, 0.0) + 1e-3)
                        self._cond.wait(timeout)
                finally:
                    self.waiting -= 1
                    waited = time.monotonic() - t0
            self.in_flight += 1
            self.admitted += 1
            if self.in_flight > self.peak_in_flight:
                self.peak_in_flight = self.in_flight
        if waited > 0.0:
            try:
                from ..utils import telemetry as _tele

                _tele.counter_inc("admission_wait_seconds", waited)
            except Exception:
                pass  # wait accounting must never fail an admitted verb

        released = [False]

        def release() -> None:
            with self._cond:
                if released[0]:  # idempotent: double release never
                    return        # corrupts the in-flight count
                released[0] = True
                self.in_flight -= 1
                self._cond.notify()

        return release


_controller = AdmissionController()


def controller() -> AdmissionController:
    """The process-wide admission controller."""
    return _controller


def reset() -> None:
    """Test hook: clear the admission accounting."""
    _controller.reset()


# the live queue-depth / in-flight gauges ride the registered-gauge
# mechanism (evaluated at export, survive telemetry.reset())
def _register_gauges() -> None:
    try:
        from ..utils import telemetry as _tele

        _tele.gauge_register(
            "admission_queue_depth", lambda: float(_controller.queue_depth())
        )
        _tele.gauge_register(
            "admission_in_flight",
            lambda: float(_controller.in_flight_now()),
        )
    except Exception:  # pragma: no cover - telemetry always importable
        pass


_register_gauges()


# ---------------------------------------------------------------------------
# scope entry: the verb decorator + the user-facing context manager
# ---------------------------------------------------------------------------


def _effective_deadline(
    outer: Optional[CancelScope],
    timeout_s: Optional[float],
    apply_default: bool,
) -> Optional[Deadline]:
    """Combine an explicit ``timeout_s`` with the inherited deadline
    (tighter wins). ``apply_default``: fall back to
    ``config.default_verb_timeout_s`` (0 = unbounded) when no explicit
    timeout is given — true for top-level UNITS OF LOAD (admission
    nesting, not deadline nesting: a verb wrapped in a bare
    `deadline_scope()` still gets the config's safety budget, which
    then tightens against the envelope's own deadline)."""
    if timeout_s is None and apply_default:
        from .. import config as _config

        dflt = float(
            getattr(_config.get(), "default_verb_timeout_s", 0.0) or 0.0
        )
        timeout_s = dflt if dflt > 0 else None
    mine = None if timeout_s is None else Deadline.after(float(timeout_s))
    inherited = outer.deadline if outer is not None else None
    if mine is None:
        return inherited
    return mine.tightened(inherited)


@contextlib.contextmanager
def verb_scope(verb: str, timeout_s: Optional[float] = None):
    """One verb call's deadline/cancellation/admission envelope.

    Top-level entry (no ambient scope): resolves the deadline
    (explicit ``timeout_s`` or ``config.default_verb_timeout_s``) and
    takes an admission slot — possibly waiting in the bounded queue or
    shedding with `OverloadError`. Nested entry (an ambient scope
    exists — a stream's per-chunk reduce, a combine, a recursive
    verb): inherits the outer deadline (an explicit ``timeout_s`` may
    only tighten it), shares the outer cancel event, and NEVER
    re-enters admission."""
    outer = _SCOPE.get()
    nested = outer is not None
    # the config default applies per UNIT OF LOAD (same boundary as
    # admission): a verb nested inside another verb inherits, but a
    # verb under a bare user deadline_scope still gets the safety net
    dl = _effective_deadline(
        outer, timeout_s, apply_default=not _ADMITTED.get()
    )
    scope = CancelScope(
        deadline=dl,
        verb=verb,
        event=outer._event if nested else None,
    )
    release = None
    atok = None
    if not _ADMITTED.get():
        release = _controller.admit(verb, scope)
        atok = _ADMITTED.set(True)
    tok = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(tok)
        if atok is not None:
            _ADMITTED.reset(atok)
        if release is not None:
            release()


@contextlib.contextmanager
def deadline_scope(
    timeout_s: Optional[float] = None, verb: str = "deadline_scope"
):
    """User-facing budget for a whole chain of verbs::

        with tft.deadline_scope(timeout_s=2.0) as scope:
            mapped = tft.map_blocks(z, df)
            total = tft.reduce_blocks(s, mapped)   # same 2s budget

    Every verb inside inherits the scope's deadline (their own
    ``timeout_s`` may only tighten it) and the whole chain can be
    cancelled via ``scope.cancel()`` from another thread. Takes no
    admission slot itself, and does NOT exempt the verbs inside from
    admission — each wrapped top-level verb still enters the gate
    (deadline nesting and admission nesting are tracked separately)."""
    outer = _SCOPE.get()
    dl = _effective_deadline(outer, timeout_s, apply_default=False)
    scope = CancelScope(
        deadline=dl,
        verb=verb,
        event=outer._event if outer is not None else None,
    )
    tok = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(tok)


def deadline_entry(verb: str):
    """Decorator threading ``timeout_s=`` into a verb: pops the kwarg,
    enters `verb_scope` around the call. Applied to `api.map_blocks`,
    `api.map_rows`, `api.reduce_blocks` and
    `streaming.reduce_blocks_stream`. Each call's wall time feeds the
    ``verb_seconds{verb=}`` histogram (when telemetry is on), which the
    admission controller's retry-after hint reads."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, timeout_s: Optional[float] = None, **kwargs):
            from ..utils import telemetry as _tele

            t0 = time.perf_counter()
            try:
                with verb_scope(verb, timeout_s=timeout_s):
                    return fn(*args, **kwargs)
            finally:
                if _tele.enabled():
                    _tele.histogram_observe(
                        "verb_seconds", time.perf_counter() - t0, verb=verb
                    )

        wrapper.__tfs_deadline_verb__ = verb
        return wrapper

    return deco
