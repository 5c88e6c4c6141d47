"""Fault-tolerant dispatch: error taxonomy, classified retries, a ledger.

The PyTorch counterpart of `tensorframes_tpu/runtime/faults.py` (the parts
the ingest pipeline uses):

- **Taxonomy** (`classify`): every dispatch exception is one of

  - ``transient`` — a status-shaped ``UNAVAILABLE:`` / ``INTERNAL:`` /
    ``DATA_LOSS:`` / ``ABORTED:`` / ``DEADLINE_EXCEEDED:`` runtime error, or
    a dropped connection. Re-running the pure stage function is expected to
    succeed; it is retried with exponential backoff.
  - ``resource`` — out of memory: `MemoryError`,
    `torch.cuda.OutOfMemoryError`, "CUDA out of memory",
    ``CUBLAS_STATUS_ALLOC_FAILED``. The identical dispatch would fail
    identically, so it is not retried here.
  - ``deterministic`` — everything else (shape/dtype mismatches, corrupt
    files, user-graph bugs), and above all a STICKY CUDA error (an illegal
    memory access, a misaligned address, a device-side assert): the CUDA
    context is lost after one, so a retry can only fail again. The original
    exception surfaces after exactly one attempt.

- **Classified retry** (`FaultScope` / `run_with_retries`): a per-scope
  retry budget (``config.verb_retry_budget``) on top of the per-call
  attempt cap (``config.block_retry_attempts``), exponential backoff with
  DETERMINISTIC seeded jitter, and a deadline check before every attempt.

- **Fault ledger** (`ledger_snapshot`): process-wide counts by class, plus
  retries, fail-fasts, deadline expiries and admission sheds.

An explicit ``tfs_fault_class`` attribute (the injection harness in
`testing.faults` stamps it) wins over every pattern.

Not in the port: the device-grant watchdog (it falls back to the CPU
backend, which the port never does), and the verb-dispatch half — OOM
block splits, their forensics and the numerics guard.
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, Optional

from ..utils.log import get_logger

__all__ = [
    "TRANSIENT",
    "RESOURCE",
    "DETERMINISTIC",
    "classify",
    "backoff_delay",
    "FaultScope",
    "scope",
    "run_with_retries",
    "ledger_snapshot",
    "reset_ledger",
]

_log = get_logger("faults")

TRANSIENT = "transient"
RESOURCE = "resource"
DETERMINISTIC = "deterministic"
_CLASSES = (TRANSIENT, RESOURCE, DETERMINISTIC)


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

# status-code tokens of the retryable families, matched as STATUS-SHAPED
# prefixes ("UNAVAILABLE: ...") so prose that merely contains the word is
# never retried
_STATUS_TOKENS = (
    "UNAVAILABLE",
    "INTERNAL",
    "DATA_LOSS",
    "ABORTED",
    "DEADLINE_EXCEEDED",
)

# looser phrases, trusted only on connection errors (runtime-owned text)
_TRANSIENT_PHRASES = (
    "DEVICE LOST",
    "DEVICE IS LOST",
    "PREEMPT",
    "SOCKET CLOSED",
    "CONNECTION RESET",
    "HEARTBEAT",
)

_RESOURCE_PATTERNS = (
    "CUDA OUT OF MEMORY",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "RESOURCE_EXHAUSTED",
    "RESOURCE EXHAUSTED",
    "OUT OF MEMORY",
    "OOM ",
    "OOM:",
    "ALLOCATION FAILURE",
    "FAILED TO ALLOCATE",
)

# CUDA errors that poison the context: every later call on it fails too
_STICKY_CUDA_PATTERNS = (
    "ILLEGAL MEMORY ACCESS",
    "MISALIGNED ADDRESS",
    "DEVICE-SIDE ASSERT",
    "ILLEGAL INSTRUCTION",
    "UNSPECIFIED LAUNCH FAILURE",
)


def _runtimeish(exc: BaseException) -> bool:
    return isinstance(exc, (RuntimeError, OSError))


def _is_cuda_oom(exc: BaseException) -> bool:
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def classify(exc: BaseException) -> str:
    """Classify one dispatch exception as ``transient`` | ``resource`` |
    ``deterministic``. Honors an explicit ``tfs_fault_class`` attribute
    first, then `MemoryError` and `torch.cuda.OutOfMemoryError`, then, on
    runtime-ish exception types, sticky CUDA errors (deterministic, never
    retried), out-of-memory text and status-code prefixes (plus
    runtime-owned phrases on connection errors). Everything unrecognized is
    deterministic."""
    tagged = getattr(exc, "tfs_fault_class", None)
    if tagged in _CLASSES:
        return tagged
    if isinstance(exc, MemoryError) or _is_cuda_oom(exc):
        return RESOURCE
    if _runtimeish(exc):
        msg = str(exc).upper()
        if any(p in msg for p in _STICKY_CUDA_PATTERNS):
            return DETERMINISTIC
        if any(p in msg for p in _RESOURCE_PATTERNS):
            return RESOURCE
        if any(f"{t}:" in msg for t in _STATUS_TOKENS):
            return TRANSIENT
        if isinstance(exc, ConnectionError) and any(
            p in msg for p in _TRANSIENT_PHRASES
        ):
            return TRANSIENT
    return DETERMINISTIC


# ---------------------------------------------------------------------------
# fault ledger (process-wide)
# ---------------------------------------------------------------------------

_LEDGER_KEYS = (
    "transient", "resource", "deterministic",  # classified failures seen
    "retries", "failfast",
    "deadlines", "shed",  # runtime.deadline: budget expiries + admission sheds
)
_ledger_lock = threading.Lock()
_ledger: Dict[str, int] = {k: 0 for k in _LEDGER_KEYS}


def _note(key: str, n: int = 1) -> None:
    with _ledger_lock:
        _ledger[key] = _ledger.get(key, 0) + n


def note_deadline() -> None:
    """Ledger hook for `runtime.deadline`: one verb ran out its time
    budget."""
    _note("deadlines")


def note_shed() -> None:
    """Ledger hook for `runtime.deadline`: admission control shed one
    verb."""
    _note("shed")


def ledger_snapshot() -> Dict[str, int]:
    """The fault ledger: classified failure counts plus what was done
    about them."""
    with _ledger_lock:
        return dict(_ledger)


def reset_ledger() -> None:
    with _ledger_lock:
        for k in list(_ledger):
            _ledger[k] = 0


def _tag_fault(e: BaseException, cls: str) -> None:
    """Stamp the final classification onto an exception escaping a
    `FaultScope`, so later layers need not re-classify it."""
    if getattr(e, "tfs_fault_class", None) is None:
        try:
            e.tfs_fault_class = cls
        except Exception:
            pass  # __slots__ errors refuse stamps; e still raises


# ---------------------------------------------------------------------------
# backoff
# ---------------------------------------------------------------------------


def backoff_delay(
    attempt: int,
    what: str = "",
    base: Optional[float] = None,
    cap: Optional[float] = None,
    jitter: Optional[float] = None,
    seed: Optional[int] = None,
) -> float:
    """Delay before transient retry ``attempt`` (1-based): exponential
    ``base * 2^(attempt-1)`` capped at ``cap``, times a DETERMINISTIC
    jitter factor in ``[1, 1+jitter]`` seeded from ``(seed, what,
    attempt)`` — reruns of the same failing dispatch sleep the same
    schedule."""
    from .. import config as _config

    cfg = _config.get()
    base = cfg.retry_backoff_base_s if base is None else base
    cap = cfg.retry_backoff_max_s if cap is None else cap
    jitter = cfg.retry_jitter if jitter is None else jitter
    seed = cfg.retry_seed if seed is None else seed
    delay = min(float(cap), float(base) * (2.0 ** max(0, attempt - 1)))
    if jitter:
        # crc32 keyed by (seed, what, attempt): stable across processes
        h = zlib.crc32(f"{seed}|{what}|{attempt}".encode())
        delay *= 1.0 + float(jitter) * ((h & 0xFFFF) / 65535.0)
    return delay


# ---------------------------------------------------------------------------
# classified retry
# ---------------------------------------------------------------------------


class FaultScope:
    """One call's fault-handling state: the per-call attempt cap and the
    scope-wide retry budget. Route every dispatch through `dispatch`."""

    def __init__(
        self,
        verb: str,
        attempts: Optional[int] = None,
        budget: Optional[int] = None,
    ):
        from .. import config as _config

        cfg = _config.get()
        self.verb = verb
        self.attempts = (
            cfg.block_retry_attempts if attempts is None else int(attempts)
        )
        self.budget = (
            cfg.verb_retry_budget if budget is None else int(budget)
        )

    def dispatch(
        self,
        thunk: Callable[[], object],
        what: str = "block",
        sleep: Optional[Callable[[float], None]] = None,
    ):
        """Run a zero-arg ``thunk`` with classified fault handling:

        - ``deterministic`` and ``resource`` → re-raise after exactly one
          attempt;
        - ``transient`` → sleep the deterministic backoff and re-invoke,
          until the per-call attempts or the scope's budget run out, then
          re-raise the last error.

        Every attempt starts with a cooperative deadline/cancel check
        (`runtime.deadline.check`). The default backoff ``sleep`` is the
        deadline-aware interruptible wait; an explicit ``sleep=`` callable
        (tests) bypasses the clipping but not the per-attempt checks."""
        from ..utils import telemetry as _tele
        from . import deadline as _dl

        attempt = 0
        while True:
            try:
                _dl.check(what)
                return thunk()
            except (_dl.DeadlineExceeded, _dl.Cancelled):
                # counted once at the raising scope, not double-booked as
                # a classified dispatch failure here
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                cls = classify(e)
                _note(cls)
                if cls != TRANSIENT:
                    if cls == DETERMINISTIC:
                        _note("failfast")
                    _tag_fault(e, cls)
                    raise
                if attempt >= self.attempts or self.budget <= 0:
                    _log.warning(
                        "%s: transient failure, retries exhausted "
                        "(attempt %d/%d, budget %d left): %s",
                        what, attempt + 1, self.attempts + 1,
                        self.budget, e,
                    )
                    _tag_fault(e, cls)
                    raise
                attempt += 1
                self.budget -= 1
                _note("retries")
                _tele.counter_inc(
                    "fault_retries", 1.0, **{"class": TRANSIENT}
                )
                delay = backoff_delay(attempt, what)
                _log.warning(
                    "%s: transient failure (attempt %d/%d) — retrying "
                    "in %.3fs: %s",
                    what, attempt, self.attempts + 1, delay, e,
                )
                with _tele.span(
                    "fault.retry", kind="fault", what=what,
                    attempt=attempt, **{"class": TRANSIENT},
                ):
                    if sleep is not None:
                        sleep(delay)
                    else:
                        _dl.sleep_interruptible(delay, f"{what} (backoff)")


def scope(
    verb: str,
    attempts: Optional[int] = None,
    budget: Optional[int] = None,
) -> FaultScope:
    """One `FaultScope` per call (reads the config at entry)."""
    return FaultScope(verb, attempts=attempts, budget=budget)


def run_with_retries(
    fn: Callable,
    *args,
    attempts: int = 0,
    what: str = "block",
    verb: Optional[str] = None,
    sleep: Optional[Callable[[float], None]] = None,
):
    """Call ``fn(*args)``; TRANSIENT errors get up to ``attempts`` extra
    attempts with backoff, ``resource``/``deterministic`` errors surface
    after exactly one attempt."""
    s = FaultScope(verb or what, attempts=attempts)
    return s.dispatch(lambda: fn(*args), what=what, sleep=sleep)
