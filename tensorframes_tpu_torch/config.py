"""Config layer: a process-global `Config` with scoped overrides::

    tft.config.update(stream_prefetch_depth=2)
    with tft.config.override(ingest_pipeline=False):
        ...

The PyTorch counterpart of `tensorframes_tpu/config.py`. The machinery is
the JAX package's: `get`, `update`, `override`, pin tracking
(`explicit_keys` / `is_explicit`), `default_value`, and env seeding through
the ``_env_*`` helpers. The port carries only the knobs its own code reads
(the streaming reduce, the ingest pipeline, durable checkpoints, the fault
layer, deadlines and admission, telemetry and its HTTP endpoint, the
numerics flag, the lazy plans, per-row vectorization, the aggregate plans,
the executor's LRU bound, the serving runtime's bucket ladder and batching
lanes, the materialization cache and the flight recorder), each with the
JAX package's name, ``TFS_*`` env var and default (the block scheduler,
the global frame and device failover among them). The JAX package's
``default_num_blocks``, ``aggregate_buffer_rows`` and ``default_mesh`` are
read nowhere there, so the port leaves them out: setting one raises, as
for any unknown key.

Pin tracking: every knob set EXPLICITLY — through `update()`, inside an
`override()` scope, or seeded from a well-formed ``TFS_*`` env var at
import — is recorded as pinned (`explicit_keys()` / `is_explicit()`). The
autotuner (`runtime.autotune`) writes knobs only through `set_tuned()`,
which refuses pinned keys; `tuned()` reports what it owns and
`reset_tuning()` restores those knobs to their (env-seeded) defaults. A
later `update()` of a tuned knob converts it to a pin.

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
    "set_tuned",
    "tuned",
    "default_value",
    "reset_tuning",
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


def _env_str(var: str, default: str, field: str,
             mapping: Optional[dict] = None) -> str:
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    _ENV_SEEDED.add(field)
    if mapping is not None:
        low = raw.lower()
        return mapping.get(low, low)
    return raw


def _env_histogram_buckets():
    """Seed ``histogram_buckets`` from TFS_HISTOGRAM_BUCKETS (a JSON dict:
    family or metric name -> ascending boundary list); malformed JSON reads
    as None (the built-in ladders)."""
    import json

    raw = os.environ.get("TFS_HISTOGRAM_BUCKETS", "")
    if not raw:
        return None
    try:
        val = json.loads(raw)
    except Exception:
        return None
    if not isinstance(val, dict):
        return None
    _ENV_SEEDED.add("histogram_buckets")
    return val


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
    # aggregate: above this many DISTINCT group sizes, a graph
    # `aggregate._chunk_combiners` classifies leaves the exact plan (one
    # vmapped call per distinct size) for the power-of-two chunk plan
    # (`aggregate._aggregate_chunked`): O(log max size) calls, whatever the
    # size distribution. Unclassified graphs always take the exact plan.
    aggregate_exact_size_limit: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_AGGREGATE_EXACT_SIZE_LIMIT", 32,
            "aggregate_exact_size_limit", minimum=0,
        )
    )
    # aggregate: the sort-free segment plan for classified graphs (the
    # row-wise transform over all rows in one call, one segment reduce a
    # fetch). Float sums differ from the exact plan's by order only. Off =
    # the exact and chunk plans.
    aggregate_segment_fast: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_AGGREGATE_SEGMENT_FAST", True, "aggregate_segment_fast"
        )
    )
    # Bound of the executor's LRU of lowered callables, read at every
    # insert: a long-lived process whose graphs drift keeps at most this
    # many.
    executor_cache_entries: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_EXECUTOR_CACHE_ENTRIES", 512, "executor_cache_entries",
            minimum=1,
        )
    )
    # Block scheduler (`runtime.scheduler`): "auto" spreads a verb's blocks
    # over every card when there are two or more, "on" schedules even on
    # one, "off" keeps one device, "global" routes eligible verbs on frames
    # of at least global_frame_min_rows rows through `globalframe` and
    # schedules the rest as "auto". mesh= and device= always win; a
    # per-call devices= list wins over the knob. An unknown mode raises at
    # the next verb (`scheduler.resolve`).
    block_scheduler: str = dataclasses.field(
        default_factory=lambda: _env_str(
            "TFS_BLOCK_SCHEDULER", "auto", "block_scheduler",
            mapping={"0": "off", "false": "off", "1": "on", "true": "on"},
        )
    )
    # The smallest frame block_scheduler="global" routes through the
    # global frame; smaller ones take per-block scheduling.
    global_frame_min_rows: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_GLOBAL_FRAME_MIN_ROWS", 2048, "global_frame_min_rows",
            minimum=0,
        )
    )
    # Failover (`scheduler.DeviceHealth`): a transient dispatch failure
    # opens the device's circuit for this long, doubling on repeats (at
    # most 8x); then one half-open probe may close it.
    device_cooldown_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_DEVICE_COOLDOWN_S", 30.0, "device_cooldown_s", minimum=0.0,
        )
    )
    # Telemetry master switch (`utils.telemetry`): span recording and
    # histogram observation. Counters stay live either way.
    telemetry: bool = dataclasses.field(
        default_factory=lambda: _env_bool("TFS_TELEMETRY", True, "telemetry")
    )
    # Span ring bound (`utils.telemetry`): the freshest N spans are kept
    # and the ones that fall off are counted. Applied when the ring is
    # rebuilt (`telemetry.reset()`), so a scoped override takes effect
    # there.
    telemetry_ring_entries: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_TELEMETRY_RING_ENTRIES", 8192, "telemetry_ring_entries",
            minimum=1,
        )
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
    # One-time per-program warning when one cached program has been
    # dispatched with more than this many distinct input shape signatures
    # (`runtime.executor`). 0 disables the check.
    recompile_warn_shapes: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_RECOMPILE_WARN_SHAPES", 16, "recompile_warn_shapes",
            minimum=0,
        )
    )
    # Cost-model accuracy (`runtime.costmodel.residuals`): a program whose
    # achieved-vs-predicted time ratio exceeds this (either direction) is
    # flagged. 0 disables flagging.
    cost_residual_warn_ratio: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_COST_RESIDUAL_WARN_RATIO", 4.0,
            "cost_residual_warn_ratio", minimum=0.0,
        )
    )
    # Always-on cost ledger (`runtime.costmodel`): the first dispatch of
    # each (program, input shapes) counts its flops and bytes on the meta
    # device; every dispatch counts one execution. Independent of
    # `telemetry`.
    cost_ledger: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_COST_LEDGER", True, "cost_ledger"
        )
    )
    # Deep memory capture: the meta replay also tracks the high-water mark
    # of live intermediate bytes (``temp_bytes``). Off = the footprint is
    # argument + output bytes and temp_bytes reads None.
    cost_ledger_memory: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_COST_LEDGER_MEMORY", False, "cost_ledger_memory"
        )
    )
    # OOM block splits (`runtime.faults`): a block dispatch that runs out
    # of memory is halved and re-dispatched, up to this many recursive
    # halvings; row-local maps concatenate the halves, classified monoid
    # reduces combine them. 0 disables splitting.
    oom_split_depth: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_OOM_SPLIT_DEPTH", 3, "oom_split_depth", minimum=0
        )
    )
    # Closed-loop autotuner (`runtime.autotune`): a background thread that
    # tunes the unpinned knobs from the live workload profile. Off (the
    # default) = no thread starts and no knob is mutated; `tft.autotune()`
    # stays available for one-shot tuning.
    autotune: bool = dataclasses.field(
        default_factory=lambda: _env_bool("TFS_AUTOTUNE", False, "autotune")
    )
    # Seconds between background tuning cycles.
    autotune_interval_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_AUTOTUNE_INTERVAL_S", 30.0, "autotune_interval_s"
        )
    )
    # Debug mode: raise on NaN/Inf in any verb output. Part of the
    # durable-stream config digest (`runtime.checkpoint`).
    check_numerics: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_CHECK_NUMERICS", False, "check_numerics"
        )
    )
    # Pipelined plan execution (`lazy.LazyFrame.force`): the feed prep of
    # block k+1 (slice, and the H2D copy through pinned staging on its own
    # CUDA stream) runs on a pipeline stage while the consumer thread
    # dispatches block k. Off = prep and dispatch interleaved on one
    # thread.
    plan_pipeline: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_PLAN_PIPELINE", True, "plan_pipeline"
        )
    )
    # Delivery-queue bound of the plan pipeline: prepared blocks that may
    # sit ready ahead of the dispatching consumer.
    plan_pipeline_depth: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_PLAN_PIPELINE_DEPTH", 2, "plan_pipeline_depth",
            minimum=1,
        )
    )
    # Per-row control flow at block level (`graph.vectorize`): `map_rows`
    # runs a per-row graph with `_Cond`/`_While` once per block (lifted,
    # or under `torch.func.vmap` with a cond selecting per row). Off = every
    # such graph runs once per row, and a batched predicate raises.
    row_vectorize: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_ROW_VECTORIZE", True, "row_vectorize"
        )
    )
    # Relational plan optimizer (`graph.optimizer`): dedup, filter below
    # map, predicate pushdown into the scan, column pruning and map fusion,
    # each kept only when the modeled plan cost strictly drops. Off = the
    # verbs run exactly as written.
    plan_optimizer: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_PLAN_OPTIMIZER", True, "plan_optimizer"
        )
    )
    # Filter selectivity the optimizer assumes when a filter carries no
    # selectivity= hint. Changes plan choice, never results.
    plan_selectivity_default: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_PLAN_SELECTIVITY_DEFAULT", 0.5,
            "plan_selectivity_default", minimum=0.0,
        )
    )
    # Bucket-ladder geometry (`shape_policy`): rung k holds
    # min * growth^k rows. The serving batcher pads every coalesced
    # dispatch to a rung; the port's verbs do not bucket.
    shape_bucket_growth: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_SHAPE_BUCKET_GROWTH", 2.0, "shape_bucket_growth",
            minimum=1.05,
        )
    )
    shape_bucket_min: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_SHAPE_BUCKET_MIN", 8, "shape_bucket_min", minimum=1
        )
    )
    # Materialization cache (`runtime.materialize`): byte budget of the
    # content-keyed result cache; 0 (the default) turns it off — no
    # files written.
    materialize_cache_bytes: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_MATERIALIZE_CACHE_BYTES", 0, "materialize_cache_bytes",
            minimum=0,
        )
    )
    # Its directory: empty = a process-private temp directory made on
    # first store.
    materialize_cache_dir: str = dataclasses.field(
        default_factory=lambda: _env_str(
            "TFS_MATERIALIZE_CACHE_DIR", "", "materialize_cache_dir"
        )
    )
    # Telemetry HTTP endpoint (`utils.telemetry_http`): 0 = off; set, the
    # package import starts the server. No auth: it binds localhost
    # unless telemetry_host says otherwise.
    telemetry_port: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_TELEMETRY_PORT", 0, "telemetry_port"
        )
    )
    telemetry_host: str = dataclasses.field(
        default_factory=lambda: _env_str(
            "TFS_TELEMETRY_HOST", "127.0.0.1", "telemetry_host"
        )
    )
    # Histogram bucket overrides by family ("seconds" | "rows" | "bytes"
    # | "fraction") or exact metric name: ascending float lists. Applies
    # to series created after the change.
    histogram_buckets: Optional[dict] = dataclasses.field(
        default_factory=_env_histogram_buckets
    )
    # Flight recorder (`runtime.blackbox`): armed by default; a typed
    # fault escaping the runtime writes an incident bundle.
    incident_capture: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_INCIDENT_CAPTURE", True, "incident_capture"
        )
    )
    # Bundle directory: empty = a process-private temp directory made on
    # first capture.
    incident_dir: str = dataclasses.field(
        default_factory=lambda: _env_str(
            "TFS_INCIDENT_DIR", "", "incident_dir"
        )
    )
    # Trailing span window a bundle keeps, seconds.
    incident_window_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_INCIDENT_WINDOW_S", 60.0, "incident_window_s",
            minimum=0.0,
        )
    )
    # Bundle-count budget of the store (0 = no count bound).
    incident_max_bundles: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_INCIDENT_MAX_BUNDLES", 32, "incident_max_bundles",
            minimum=0,
        )
    )
    # Byte budget of the store; 0 is a real zero-byte quota (every
    # capture is suppressed), not "unlimited".
    incident_max_bytes: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_INCIDENT_MAX_BYTES", 67108864, "incident_max_bytes",
            minimum=0,
        )
    )
    # A repeat of one incident fingerprint within this window is counted
    # as suppressed instead of written (0 = no dedup).
    incident_rate_limit_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_INCIDENT_RATE_LIMIT_S", 30.0, "incident_rate_limit_s",
            minimum=0.0,
        )
    )
    # Serving micro-batcher (`serving.batcher`): how long a lane holds an
    # open batch, closing early on an exact ladder rung or at
    # serve_max_batch_rows. 0 = no coalescing (every request inline).
    serve_batch_window_ms: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_SERVE_BATCH_WINDOW_MS", 5.0, "serve_batch_window_ms"
        )
    )
    # Ceiling of one coalesced dispatch and the top of the ladder
    # `serving.register(warm=True)` runs.
    serve_max_batch_rows: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_SERVE_MAX_BATCH_ROWS", 4096, "serve_max_batch_rows"
        )
    )
    # Requests queued per batching lane before arrivals shed with a typed
    # OverloadError (HTTP 429). 0 = unlimited.
    serve_queue_limit: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "TFS_SERVE_QUEUE_LIMIT", 256, "serve_queue_limit"
        )
    )
    # Budget of a served request that sends no X-TFS-Timeout-S header: a
    # serving request is never unbounded.
    serve_default_timeout_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "TFS_SERVE_DEFAULT_TIMEOUT_S", 30.0, "serve_default_timeout_s"
        )
    )
    # Run every ladder rung up to serve_max_batch_rows at registration
    # (batchable endpoints only).
    serve_warm_compile: bool = dataclasses.field(
        default_factory=lambda: _env_bool(
            "TFS_SERVE_WARM_COMPILE", True, "serve_warm_compile"
        )
    )


_config = Config()

# one lock serializes every pin/tuned mutation (update / set_tuned /
# reset_tuning / override restore): the autotuner runs on a background
# thread, and "pins win" needs check-then-write to be atomic
_state_lock = threading.Lock()

# knobs the OPERATOR set: update()/override() calls plus well-formed
# TFS_* env seeds captured while _config was constructed above
_EXPLICIT: set = set(_ENV_SEEDED)
# knobs the AUTOTUNER currently owns -> the value it applied
_TUNED: dict = {}

_MISSING = object()


def explicit_keys() -> frozenset:
    """Knobs pinned by the operator (update()/override()/env)."""
    return frozenset(_EXPLICIT)


def is_explicit(key: str) -> bool:
    return key in _EXPLICIT


def tuned() -> dict:
    """``{knob: value}`` currently owned by the autotuner."""
    return dict(_TUNED)


def default_value(key: str):
    """The knob's baseline: the dataclass default, env-seeded the same way
    the process's initial config was."""
    base = Config()
    if not hasattr(base, key):
        raise AttributeError(f"unknown config key {key!r}")
    return getattr(base, key)


def set_tuned(key: str, value) -> bool:
    """The autotuner's only write path: apply ``value`` unless the knob is
    pinned. Returns False (and changes nothing) for a pinned knob; the pin
    check and the write are one step under the state lock."""
    if not hasattr(_config, key):
        raise AttributeError(f"unknown config key {key!r}")
    with _state_lock:
        if key in _EXPLICIT:
            return False
        setattr(_config, key, value)
        _TUNED[key] = value
    return True


def reset_tuning() -> None:
    """Restore every tuned knob to its (env-seeded) default and forget the
    tuned set."""
    if not _TUNED:
        return
    base = Config()
    with _state_lock:
        for k in list(_TUNED):
            setattr(_config, k, getattr(base, k))
        _TUNED.clear()


def get() -> Config:
    return _config


def update(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config key {k!r}")
        with _state_lock:
            setattr(_config, k, v)
            # an explicit set PINS the knob and supersedes a tuned value
            _EXPLICIT.add(k)
            _TUNED.pop(k, None)


@contextlib.contextmanager
def override(**kwargs):
    old = {k: getattr(_config, k) for k in kwargs}
    # pin state is scoped like the values: a knob pinned only inside an
    # override() is un-pinned again on exit, and a tuned value it shadowed
    # is restored to the tuned ledger
    old_explicit = {k: (k in _EXPLICIT) for k in kwargs}
    old_tuned = {k: _TUNED.get(k, _MISSING) for k in kwargs}
    update(**kwargs)
    try:
        yield _config
    finally:
        update(**old)
        with _state_lock:
            for k in kwargs:
                if not old_explicit[k]:
                    _EXPLICIT.discard(k)
                if old_tuned[k] is not _MISSING:
                    _TUNED[k] = old_tuned[k]
