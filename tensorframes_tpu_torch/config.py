"""Config layer: a process-global `Config` with scoped overrides::

    tft.config.update(stream_prefetch_depth=2)
    with tft.config.override(ingest_pipeline=False):
        ...

The PyTorch counterpart of `tensorframes_tpu/config.py`. The machinery is
the JAX package's: `get`, `update`, `override`, pin tracking
(`explicit_keys` / `is_explicit`), `default_value`, and env seeding through
the ``_env_*`` helpers. The port carries only the knobs its own code reads
(the streaming reduce, the ingest pipeline, durable checkpoints, the fault
layer, deadlines and admission, telemetry and the numerics flag), each
with the JAX package's name, ``TFS_*`` env var and default.

Pin tracking: every knob set EXPLICITLY — through `update()`, inside an
`override()` scope, or seeded from a well-formed ``TFS_*`` env var at
import — is recorded as pinned (`explicit_keys()` / `is_explicit()`).

Env parsing: a malformed ``TFS_*`` value never breaks the package import;
it is ignored entirely (default value, no pin).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Optional

__all__ = [
    "Config",
    "get",
    "update",
    "override",
    "explicit_keys",
    "is_explicit",
    "default_value",
]


# fields whose env var was present AND parsed cleanly during Config
# construction: the import-time pin seed (a malformed value falls back to
# the default and pins nothing)
_ENV_SEEDED: set = set()


def _env_bool(var: str, default: bool, field: str) -> bool:
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    _ENV_SEEDED.add(field)
    return raw.lower() not in ("0", "false", "off")


def _env_int(var: str, default: int, field: str,
             minimum: Optional[int] = None) -> int:
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except (TypeError, ValueError):
        return default  # malformed env never breaks the import
    _ENV_SEEDED.add(field)
    return v if minimum is None else max(minimum, v)


def _env_float(var: str, default: float, field: str,
               minimum: Optional[float] = None) -> float:
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except (TypeError, ValueError):
        return default  # malformed env never breaks the import
    _ENV_SEEDED.add(field)
    return v if minimum is None else max(minimum, v)


@dataclasses.dataclass
class Config:
    # Pipelined ingest (`ingest.pipeline`): the streaming reduce runs
    # shard discovery -> parallel decode -> H2D transfer -> compute as
    # concurrently-executing stages over bounded queues. Off = the SAME
    # stage functions run inline on the consumer thread (no overlap).
    ingest_pipeline: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_INGEST_PIPELINE", True, "ingest_pipeline"
        )
    )
    # Delivery-queue bound of the ingest pipeline: how many chunks may sit
    # ready ahead of the consumer. Peak live chunks for the canonical
    # discovery -> decode(W) -> transfer chain is W + 2*depth + 4 (see
    # ingest/pipeline.py).
    stream_prefetch_depth: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_STREAM_PREFETCH_DEPTH", 1, "stream_prefetch_depth",
            minimum=1,
        )
    )
    # Durable-stream commit cadence (`runtime.checkpoint`): a streaming
    # reduce given checkpoint= without checkpoint_every= commits after
    # this many FOLDED chunks.
    stream_checkpoint_every: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_STREAM_CHECKPOINT_EVERY", 16, "stream_checkpoint_every",
            minimum=1,
        )
    )
    # Decode thread-pool width for multi-file datasets
    # (`ingest.dataset.IngestStream`): 0 = auto (min(4, host cores)).
    ingest_decode_workers: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_INGEST_DECODE_WORKERS", 0, "ingest_decode_workers"
        )
    )
    # Telemetry master switch (`utils.telemetry`): span recording and
    # histogram observation. Counters stay live either way.
    telemetry: bool = dataclasses.field(
        default_factory=lambda: _env_bool("TFS_TELEMETRY", True, "telemetry")
    )
    # Classified retries (`runtime.faults`): extra attempts per dispatch
    # (or pipeline stage call) for TRANSIENT errors only.
    block_retry_attempts: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_BLOCK_RETRY_ATTEMPTS", 3, "block_retry_attempts",
            minimum=0,
        )
    )
    # Total transient retries one verb call (or one pipeline stage) may
    # spend.
    verb_retry_budget: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_VERB_RETRY_BUDGET", 32, "verb_retry_budget", minimum=0
        )
    )
    # Exponential backoff between transient retries: base * 2^(k-1)
    # capped at max, times a DETERMINISTIC jitter factor in
    # [1, 1+retry_jitter] seeded by (retry_seed, dispatch, attempt).
    retry_backoff_base_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_RETRY_BACKOFF_BASE_S", 0.05, "retry_backoff_base_s",
            minimum=0.0,
        )
    )
    retry_backoff_max_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_RETRY_BACKOFF_MAX_S", 2.0, "retry_backoff_max_s",
            minimum=0.0,
        )
    )
    retry_jitter: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_RETRY_JITTER", 0.25, "retry_jitter", minimum=0.0
        )
    )
    retry_seed: int = dataclasses.field(
        default_factory=lambda: _env_int("TFS_RETRY_SEED", 0, "retry_seed")
    )
    # Deadline (`runtime.deadline`): default time budget for a TOP-LEVEL
    # verb call without timeout_s= (0 = unbounded).
    default_verb_timeout_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_DEFAULT_VERB_TIMEOUT_S", 0.0, "default_verb_timeout_s"
        )
    )
    # Admission control (`runtime.deadline.AdmissionController`): max
    # TOP-LEVEL verbs in flight at once (0 = unlimited).
    max_concurrent_verbs: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_MAX_CONCURRENT_VERBS", 0, "max_concurrent_verbs"
        )
    )
    # Bounded admission wait queue: arrivals at a full queue are shed
    # with a typed OverloadError (0 = shed the moment the limit is hit).
    admission_queue_limit: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_ADMISSION_QUEUE_LIMIT", 32, "admission_queue_limit"
        )
    )
    # Max seconds a queued caller waits for a slot before being shed
    # (0 = bounded only by the caller's deadline).
    admission_wait_timeout_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_ADMISSION_WAIT_TIMEOUT_S", 30.0,
            "admission_wait_timeout_s", minimum=0.0,
        )
    )
    # Debug mode: raise on NaN/Inf in any verb output. Part of the
    # durable-stream config digest (`runtime.checkpoint`).
    check_numerics: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_CHECK_NUMERICS", False, "check_numerics"
        )
    )


_config = Config()

# one lock serializes every pin mutation (update / override restore)
_state_lock = threading.Lock()

# knobs the OPERATOR set: update()/override() calls plus well-formed
# TFS_* env seeds captured while _config was constructed above
_EXPLICIT: set = set(_ENV_SEEDED)


def explicit_keys() -> frozenset:
    """Knobs pinned by the operator (update()/override()/env)."""
    return frozenset(_EXPLICIT)


def is_explicit(key: str) -> bool:
    return key in _EXPLICIT


def default_value(key: str):
    """The knob's baseline: the dataclass default, env-seeded the same way
    the process's initial config was."""
    base = Config()
    if not hasattr(base, key):
        raise AttributeError(f"unknown config key {key!r}")
    return getattr(base, key)


def get() -> Config:
    return _config


def update(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config key {k!r}")
        with _state_lock:
            setattr(_config, k, v)
            _EXPLICIT.add(k)  # an explicit set PINS the knob


@contextlib.contextmanager
def override(**kwargs):
    old = {k: getattr(_config, k) for k in kwargs}
    # pin state is scoped like the values: a knob pinned only inside an
    # override() is un-pinned again on exit
    old_explicit = {k: (k in _EXPLICIT) for k in kwargs}
    update(**kwargs)
    try:
        yield _config
    finally:
        update(**old)
        with _state_lock:
            for k in kwargs:
                if not old_explicit[k]:
                    _EXPLICIT.discard(k)
