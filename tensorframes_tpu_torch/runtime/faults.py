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

- **OOM block splits** (`split_allowed`, `combine_split_partials`,
  `record_oom`): a verb whose block dispatch fails with a ``resource``
  error halves the block's row range (up to ``config.oom_split_depth``
  times) and re-dispatches; row-local maps concatenate the halves,
  classified monoid reduces combine them. Each resource fault leaves a
  forensic snapshot (`forensics_snapshot`): the program, its modeled
  footprint from the cost ledger, the card's memory at fault time and the
  split decision. The snapshot holds strings and numbers only, never the
  exception: a CUDA out-of-memory error's traceback keeps the failed
  attempt's tensors alive.

- **Fault ledger** (`ledger_snapshot`): process-wide counts by class, plus
  retries, splits, fail-fasts, deadline expiries and admission sheds.

- **Numerics guard** (`maybe_check_numerics`): with
  ``config.check_numerics`` on, a verb raises `FloatingPointError` on a
  NaN or Inf output, naming the block and the fetch.

An explicit ``tfs_fault_class`` attribute (the injection harness in
`testing.faults` stamps it) wins over every pattern.

- **Device failover**: a transient failure of a block the scheduler placed
  (`FaultScope.dispatch` with ``sched=`` / ``index=``) evicts its device
  before the backoff (`scheduler.BlockSchedule.evict`), so the retry runs
  on the block's new device; counted as ``evictions``.

Not in the port: the device-grant watchdog (it falls back to the CPU
backend, which the port never does).
"""

from __future__ import annotations

import threading
import zlib
from collections import deque as _deque
from typing import Callable, Dict, Optional, Sequence

from .. import config as _config
from ..utils import telemetry as _tele
from ..utils.log import get_logger
from . import deadline as _dl

__all__ = [
    "TRANSIENT",
    "RESOURCE",
    "DETERMINISTIC",
    "classify",
    "backoff_delay",
    "FaultScope",
    "scope",
    "run_with_retries",
    "split_allowed",
    "combine_split_partials",
    "note_split",
    "note_transient_retry",
    "record_oom",
    "forensics_snapshot",
    "ledger_snapshot",
    "reset_ledger",
    "maybe_check_numerics",
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
    "retries", "splits", "evictions", "failfast",
    "deadlines", "shed",  # runtime.deadline: budget expiries + admission sheds
)
_ledger_lock = threading.Lock()
_ledger: Dict[str, int] = {k: 0 for k in _LEDGER_KEYS}


def _note(key: str, n: int = 1) -> None:
    with _ledger_lock:
        _ledger[key] = _ledger.get(key, 0) + n


def note_eviction() -> None:
    """Scheduler hook: one device circuit opened (ledger only; the
    labeled ``device_evictions`` counter is the scheduler's)."""
    _note("evictions")


def note_transient_retry() -> None:
    """Ledger + counter for a transient retry performed outside
    `FaultScope.dispatch`."""
    _note(TRANSIENT)
    _note("retries")
    _tele.counter_inc("fault_retries", 1.0, **{"class": TRANSIENT})


def note_split(verb: str) -> None:
    """One OOM block split performed by ``verb`` (ledger + the always-live
    ``block_splits`` counter; the split IS the resource class's retry, so
    it counts under ``fault_retries{class=resource}`` too)."""
    _note("splits")
    _note("retries")
    _tele.counter_inc("block_splits", 1.0, verb=verb)
    _tele.counter_inc("fault_retries", 1.0, **{"class": RESOURCE})


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
        _forensics.clear()


def _tag_fault(e: BaseException, cls: str) -> None:
    """Stamp the final classification onto an exception escaping a
    `FaultScope`, so later layers need not re-classify it."""
    if getattr(e, "tfs_fault_class", None) is None:
        try:
            e.tfs_fault_class = cls
        except Exception:
            pass  # __slots__ errors refuse stamps; e still raises


# ---------------------------------------------------------------------------
# OOM forensics: what was resident when a dispatch ran out of memory
# ---------------------------------------------------------------------------

# bounded: the freshest window of OOMs is the useful one
_FORENSICS_MAX = 16
_forensics: "_deque" = _deque(maxlen=_FORENSICS_MAX)


def record_oom(
    verb: str,
    program,
    rows: int,
    depth: int,
    decision: str,
    error: BaseException,
    bucket: Optional[int] = None,
) -> None:
    """Capture a forensic snapshot for one ``resource``-classified
    dispatch: the failing program, its cost-ledger modeled footprint, the
    memory of every CUDA device at fault time (`costmodel.memory_overview`),
    the block's row count and the split decision (``"split:..."``, or a
    ``"reraise:*"`` reason when splitting is ineligible). Only strings and
    numbers are kept. A decision other than a split means the fault is
    about to escape, so the flight recorder captures a bundle too. Never
    raises."""
    err = f"{type(error).__name__}: {str(error)[:200]}"
    try:
        from . import costmodel as _cm

        snap = {
            "verb": str(verb),
            "program": str(program),
            "rows": int(rows),
            "bucket": int(bucket) if bucket is not None else None,
            "depth": int(depth),
            "decision": str(decision),
            "error": err,
            "modeled": _cm.program_footprint(program),
            "devices": _cm.memory_overview(),
        }
    except Exception:  # a degraded snapshot beats no snapshot
        snap = {
            "verb": str(verb),
            "program": str(program),
            "rows": int(rows),
            "bucket": None,
            "depth": int(depth),
            "decision": str(decision),
            "error": type(error).__name__,
            "modeled": None,
            "devices": [],
        }
    with _ledger_lock:
        _forensics.append(snap)
    try:
        _tele.counter_inc("oom_forensics", 1.0, verb=str(verb))
    except Exception:
        pass  # forensics must not worsen the failure it documents
    if not str(decision).startswith("split"):
        try:
            from . import blackbox as _blackbox

            _tag_fault(error, RESOURCE)
            _blackbox.capture(
                "oom", error, verb=str(verb), program=str(program),
                extra={"oom": snap},
            )
        except Exception:
            pass  # the recorder must not worsen the failure either


def forensics_snapshot() -> list:
    """The bounded OOM forensic log, oldest first."""
    with _ledger_lock:
        return [dict(s) for s in _forensics]


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
        sched=None,
        index: Optional[int] = None,
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
        (tests) bypasses the clipping but not the per-attempt checks.

        Under the block scheduler (``sched=``, ``index=`` the item), a
        transient failure evicts the item's device before the backoff
        (`BlockSchedule.evict`: the thunk reads the item's device again,
        so the retry runs where it was re-placed), and a deadline or
        cancellation escaping is stamped with ``tfs_blocks_issued`` /
        ``tfs_blocks_unissued`` (`BlockSchedule.progress`)."""
        attempt = 0
        while True:
            try:
                _dl.check(what)
                return thunk()
            except (_dl.DeadlineExceeded, _dl.Cancelled) as e:
                # counted once at the raising scope, not double-booked as
                # a classified dispatch failure here
                raise _stamp_progress(e, sched)
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
                evicted = None
                if sched is not None and index is not None:
                    evicted = sched.evict(index)
                delay = backoff_delay(attempt, what)
                _log.warning(
                    "%s: transient failure (attempt %d/%d)%s — retrying "
                    "in %.3fs: %s",
                    what, attempt, self.attempts + 1,
                    f", evicted device {evicted}" if evicted else "",
                    delay, e,
                )
                del e  # no frame of the failed attempt outlives the retry
                with _tele.span(
                    "fault.retry", kind="fault", what=what,
                    attempt=attempt, device=evicted, **{"class": TRANSIENT},
                ):
                    if sleep is not None:
                        sleep(delay)
                    else:
                        _dl.sleep_interruptible(delay, f"{what} (backoff)")


def _stamp_progress(e: BaseException, sched) -> BaseException:
    """Stamp a scheduled verb's partial progress on a deadline or
    cancellation escaping it."""
    if sched is not None and getattr(e, "tfs_blocks_issued", None) is None:
        try:
            p = sched.progress()
            e.tfs_blocks_issued = p["issued"]
            e.tfs_blocks_unissued = p["unissued"]
        except Exception:
            pass  # __slots__ errors refuse stamps; e still raises
    return e


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


# ---------------------------------------------------------------------------
# OOM split support
# ---------------------------------------------------------------------------


def split_allowed(n_rows: int, depth: int) -> bool:
    """A resource-classified block of ``n_rows`` at recursion ``depth`` may
    split once more: at least 2 rows to halve, and a bounded depth
    (``config.oom_split_depth``), so a memory budget too small even for the
    smallest half re-raises the original error."""
    return n_rows > 1 and depth < _config.get().oom_split_depth


def combine_split_partials(
    combiners: Sequence[str],
    left: Sequence,
    right: Sequence,
    n_left: int,
    n_right: int,
):
    """Monoid-combine the per-fetch partials of a split reduce block:
    ``sum`` adds, ``prod`` multiplies, ``min``/``max`` are elementwise
    (`torch.minimum` / `torch.maximum`), and ``mean`` is the row-weighted
    mean in the partial's dtype (exact: the halves partition the block's
    rows). Only graphs `aggregate._chunk_combiners` classified reach a
    split."""
    import torch

    out = []
    for comb, a, b in zip(combiners, left, right):
        if comb == "sum":
            out.append(a + b)
        elif comb == "prod":
            out.append(a * b)
        elif comb == "min":
            out.append(torch.minimum(a, b))
        elif comb == "max":
            out.append(torch.maximum(a, b))
        elif comb == "mean":
            w = float(n_left + n_right)
            out.append((a * (n_left / w) + b * (n_right / w)).to(a.dtype))
        else:  # pragma: no cover - the classifier emits only the tags above
            raise AssertionError(f"unknown combiner {comb!r}")
    return tuple(out)


# ---------------------------------------------------------------------------
# numerics guard
# ---------------------------------------------------------------------------


def maybe_check_numerics(fetch_names, outs, what: str) -> None:
    """Debug-mode numerics guard (``config.check_numerics``): raise
    `FloatingPointError` naming the verb, block and fetch when an output
    holds a NaN or Inf.

    The check runs on the device: each float fetch folds to one
    ``isfinite().all()`` boolean, the booleans stack into one verdict, and
    the clean path pays exactly one host sync (``.item()``, counted as
    ``host_sync``). Only when the verdict fires are the bad values counted,
    fetch by fetch. Off by default."""
    if not _config._config.check_numerics:
        return
    import torch

    from ..utils.profiling import count

    finites = []  # (name, tensor, all-finite scalar) per float fetch
    for name, o in zip(fetch_names, outs):
        if not isinstance(o, torch.Tensor) or not o.is_floating_point():
            continue
        finites.append((name, o, torch.isfinite(o).all()))
    if not finites:
        return
    verdict = (
        finites[0][2]
        if len(finites) == 1
        else torch.stack([f for _, _, f in finites]).all()
    )
    count("host_sync")
    if verdict.item():  # the one sync on the clean path
        return
    for name, o, fin in finites:
        if not fin.item():
            bad = int((~torch.isfinite(o)).sum().item())
            raise FloatingPointError(
                f"{what}: fetch {name!r} contains {bad} non-finite "
                "value(s) (check_numerics is on)"
            )
    raise AssertionError("unreachable: verdict fired but no fetch did")
