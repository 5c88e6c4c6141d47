"""Incident flight recorder: fault-triggered postmortem bundles.

The PyTorch counterpart of `tensorframes_tpu/runtime/blackbox.py`. At the
moment a typed fault ESCAPES the runtime, `capture` freezes a bounded
**incident bundle** joining the observability surfaces:

- the trailing span-ring window in Chrome-trace format, trimmed to
  ``config.incident_window_s`` and capped in event count;
- counter/histogram deltas since the previous capture (or process start
  or reset), with the covered age stamped as ``metrics.covers_s``;
- the config digest and the operator's pinned knobs;
- the per-device health overview and the admission controller
  snapshot;
- the offending program's fingerprint (the trigger site's, else the
  newest span in the ring carrying a ``program`` attribute).

The ``program`` section carries the cost ledger's entry and residual ratio
for the offending program (`runtime.costmodel`), ``memory`` the per-device
memory overview, and ``autotune_decisions`` the autotuner's decision ring.
The ``scheduler`` section's ``circuits`` list holds the failover circuit
breaker's tripped circuits (`scheduler.DeviceHealth.table`).

Triggers: ``deadline`` (`DeadlineExceeded`), ``cancel`` (`Cancelled`),
``shed`` (`OverloadError`), ``oom`` and ``fault`` (a classified failure),
``checkpoint`` (`CheckpointError` on commit or load), ``eviction`` (a
device's failover circuit opened: no exception escapes, the blocks
re-place), ``serving`` (a
request the serving front-end maps to 429/5xx). An exception is stamped with
``tfs_incident_id`` at its first capture, so a fault crossing several
layers makes ONE bundle.

Storage rides the `CheckpointStore` atomic commit under
``config.incident_dir`` (empty: a process-private temp directory).
Bundles dedup by fingerprint (trigger x program x fault class) within
``config.incident_rate_limit_s`` (a repeat counts
``incidents_suppressed{reason="rate_limit"}``); the store is pruned LRU
under ``config.incident_max_bundles`` / ``config.incident_max_bytes``,
and a write that cannot fit, or any store error, is a counted
``incidents_suppressed{reason="store"}``, never an exception on the
caller's fault path. ``_lock`` guards the accounting only and is never
held across file I/O.

Surface: `incidents()` (list / load one), the ``/incidents`` and
``/incidents/<id>`` routes on the telemetry HTTP server, the
``incidents_captured{trigger=}`` / ``incidents_suppressed{reason=}``
counters, the ``incident_bytes`` gauge and the
``incident_capture_seconds`` histogram.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "capture",
    "capture_escape",
    "incidents",
    "load_file",
    "load_payload",
    "state",
    "reset_state",
    "BUNDLE_SCHEMA_VERSION",
]

#: version of the bundle PAYLOAD schema (the store's own framing schema
#: is versioned separately by `runtime.checkpoint.SCHEMA_VERSION`);
#: bump when a bundle section changes shape incompatibly.
BUNDLE_SCHEMA_VERSION = 1

#: bundle file suffix under the incident directory
SUFFIX = ".tfsinc"

#: the mounted route prefix on the shared telemetry HTTP server
ROUTE_PREFIX = "/incidents"

#: hard cap on Chrome-trace events per bundle — capture latency must
#: stay bounded even with a huge span ring (the freshest window wins)
MAX_TRACE_EVENTS = 2048

#: framing allowance (magic + manifest) when checking a payload
#: against the byte quota — keeps "fits alone" decidable pre-commit
_FRAME_ALLOWANCE = 1024

# accounting only — NEVER held across file I/O: capture
# snapshots under it, releases, then writes; /metrics and /healthz
# scrape concurrently with a mid-write bundle
_lock = threading.Lock()

# reentrancy guard: the recorder's own store I/O (commit/load) can
# raise CheckpointError, whose capture hook must not recurse into a
# second capture
_busy = threading.local()

# fingerprint (trigger x program x fault class) -> dedup entry
_dedup: Dict[str, Dict] = {}

# process-private temp directory when config.incident_dir is empty
_tmp_dir: List[Optional[str]] = [None]

# (monotonic, flat counters, flat histogram sums) at the previous
# capture / reset — the anchor the per-bundle metric deltas diff against
_baseline: List[Optional[tuple]] = [None]

_acct: Dict[str, object] = {
    "captured": 0,
    "suppressed": {},
    "bundles": 0,
    "bytes": 0,
    "last": None,
}


def enabled() -> bool:
    """Recorder armed? (``config.incident_capture`` — default True)."""
    from .. import config as _config

    return bool(getattr(_config.get(), "incident_capture", True))


def _dir(create: bool = True) -> Optional[str]:
    """The live incident directory: ``config.incident_dir`` when set,
    else a process-private temp dir created lazily (``create=True``)
    on first capture — same semantics as ``materialize_cache_dir``."""
    from .. import config as _config

    configured = str(getattr(_config.get(), "incident_dir", "") or "")
    if configured:
        return configured
    with _lock:
        existing = _tmp_dir[0]
    if existing is not None or not create:
        return existing
    import tempfile

    made = tempfile.mkdtemp(prefix="tfs-incidents-")
    with _lock:
        if _tmp_dir[0] is None:
            _tmp_dir[0] = made
            return made
        keep = _tmp_dir[0]
    shutil.rmtree(made, ignore_errors=True)  # lost the race; one dir wins
    return keep


# ---------------------------------------------------------------------------
# the choke point
# ---------------------------------------------------------------------------


def capture(
    trigger: str,
    exc: Optional[BaseException] = None,
    *,
    verb: Optional[str] = None,
    program: Optional[str] = None,
    extra: Optional[Dict] = None,
) -> Optional[str]:
    """Record one incident; returns the incident id (existing one when
    the exception was already captured at another layer) or None when
    nothing was written (disarmed, rate-limited, store full/failed).
    NEVER raises — the recorder must not worsen the fault it documents,
    so every failure inside degrades to a counted suppression."""
    try:
        return _capture(trigger, exc, verb, program, extra)
    except Exception:
        try:
            _suppress("error")
        except Exception:
            pass  # even the suppression counter is best-effort here
        return None


def capture_escape(
    exc: BaseException, verb: Optional[str] = None
) -> Optional[str]:
    """The top-level verb-scope hook: map a TYPED fault escaping the
    runtime to its trigger class and capture it. Untyped exceptions
    (no ``tfs_fault_class`` — plain user/validation errors) are not
    incidents and pass through untouched."""
    try:
        from . import deadline as _dl
        from .checkpoint import CheckpointError

        if isinstance(exc, _dl.DeadlineExceeded):
            trigger = "deadline"
        elif isinstance(exc, _dl.Cancelled):
            trigger = "cancel"
        elif isinstance(exc, _dl.OverloadError):
            trigger = "shed"
        elif isinstance(exc, CheckpointError):
            trigger = "checkpoint"
        else:
            cls = getattr(exc, "tfs_fault_class", None)
            if cls is None:
                return None  # untyped: a user error, not an incident
            trigger = "oom" if cls == "resource" else "fault"
        return capture(trigger, exc, verb=verb)
    except Exception:
        return None  # the recorder must never mask the escaping fault


def _capture(trigger, exc, verb, program, extra) -> Optional[str]:
    if getattr(_busy, "active", False):
        return None  # recorder-internal store I/O must not recurse
    if exc is not None:
        stamped = getattr(exc, "tfs_incident_id", None)
        if stamped is not None:
            return stamped  # one fault, one bundle, across layers
    if not enabled():
        return None
    from .. import config as _config

    _busy.active = True
    try:
        t_start = time.perf_counter()
        cfg = _config.get()
        fclass = _fault_class(exc)
        prog = _offending_program(program, exc)
        fp = hashlib.sha256(
            f"{trigger}|{prog}|{fclass}".encode()
        ).hexdigest()[:16]
        now = time.monotonic()
        rate = float(getattr(cfg, "incident_rate_limit_s", 30.0))
        with _lock:
            ent = _dedup.get(fp)
            if ent is not None and rate > 0 and (now - ent["last"]) < rate:
                ent["suppressed"] += 1
                dup_id = ent["id"]
            else:
                dup_id = None
                _dedup[fp] = ent = {
                    "trigger": trigger,
                    "fault_class": fclass,
                    "program": prog,
                    "last": now,
                    "id": None,
                    "suppressed": (
                        ent["suppressed"] if ent is not None else 0
                    ),
                }
        if dup_id is not None:
            _suppress("rate_limit")
            _stamp(exc, dup_id)
            return dup_id

        iid = f"inc-{int(time.time() * 1000):013d}-{fp[:8]}"
        bundle = _build_bundle(
            iid, trigger, fclass, prog, fp, exc, verb, extra, cfg
        )
        payload = json.dumps(
            bundle, sort_keys=True, default=_json_default
        ).encode()
        max_bytes = int(getattr(cfg, "incident_max_bytes", 0))
        if len(payload) + _FRAME_ALLOWANCE > max_bytes:
            _suppress("store")  # quota cannot fit even this one bundle
            return None

        directory = _dir(create=True)
        path = os.path.join(directory, iid + SUFFIX)
        try:
            os.makedirs(directory, exist_ok=True)
            from .checkpoint import CheckpointStore

            CheckpointStore(path).commit(
                {
                    "incident_id": iid,
                    "bundle_schema": BUNDLE_SCHEMA_VERSION,
                    "trigger": trigger,
                    "fault_class": fclass,
                    "program": prog,
                    "verb": bundle.get("verb"),
                    "fingerprint": fp,
                    "created_unix": bundle["captured_unix"],
                },
                payload,
            )
        except Exception:
            # ENOSPC, read-only dir, a torn local filesystem: the
            # caller's fault path must see its own typed error, never
            # a storage one
            _suppress("store")
            return None

        bundles, total = _prune(directory, path, cfg)
        summary = {
            "id": iid,
            "trigger": trigger,
            "fault_class": fclass,
            "program": prog,
            "verb": bundle.get("verb"),
            "path": path,
        }
        with _lock:
            live = _dedup.get(fp)
            if live is not None:
                live["id"] = iid
                live["last"] = now
            _acct["captured"] = int(_acct["captured"]) + 1
            _acct["bundles"] = bundles
            _acct["bytes"] = total
            _acct["last"] = summary
        _stamp(exc, iid)
        try:
            from ..utils import telemetry as _tele

            _tele.counter_inc("incidents_captured", 1.0, trigger=trigger)
            _tele.histogram_observe(
                "incident_capture_seconds",
                time.perf_counter() - t_start,
            )
        except Exception:
            pass  # capture accounting must never fail the fault path
        return iid
    finally:
        _busy.active = False


def _stamp(exc: Optional[BaseException], iid: Optional[str]) -> None:
    if exc is None or iid is None:
        return
    try:
        exc.tfs_incident_id = iid
    except Exception:
        pass  # __slots__ errors refuse stamps; dedup still rate-limits


def _suppress(reason: str) -> None:
    with _lock:
        sup = _acct["suppressed"]
        sup[reason] = int(sup.get(reason, 0)) + 1
    try:
        from ..utils import telemetry as _tele

        _tele.counter_inc("incidents_suppressed", 1.0, reason=reason)
    except Exception:
        pass  # suppression accounting is itself best-effort


def _fault_class(exc: Optional[BaseException]) -> str:
    if exc is None:
        return "n/a"
    tagged = getattr(exc, "tfs_fault_class", None)
    if tagged is not None:
        return str(tagged)
    try:
        from .faults import classify

        return classify(exc)
    except Exception:
        return "unclassified"  # classification must not sink capture


def _offending_program(
    program: Optional[str], exc: Optional[BaseException]
) -> Optional[str]:
    """The program to pin the blame on: the trigger site's explicit
    one, else the exception's stamp, else the newest span in the ring
    carrying a ``program`` attribute."""
    if program:
        return str(program)
    if exc is not None:
        tagged = getattr(exc, "tfs_program", None)
        if tagged:
            return str(tagged)
    try:
        from ..utils import telemetry as _tele

        for s in reversed(_tele.spans()):
            p = s.attrs.get("program")
            if p:
                return str(p)
    except Exception:
        pass  # blame assignment is best-effort evidence, not control
    return None


# ---------------------------------------------------------------------------
# bundle assembly (every section individually shielded: a broken
# subsystem yields {"error": ...} instead of sinking the whole bundle)
# ---------------------------------------------------------------------------


def _section(fn):
    try:
        return fn()
    except Exception as e:  # degraded evidence beats no evidence
        return {"error": f"{type(e).__name__}: {e}"}


def _build_bundle(
    iid, trigger, fclass, prog, fp, exc, verb, extra, cfg
) -> Dict:
    window = float(getattr(cfg, "incident_window_s", 60.0))
    bundle: Dict = {
        "bundle_schema": BUNDLE_SCHEMA_VERSION,
        "id": iid,
        "trigger": trigger,
        "fingerprint": fp,
        "captured_unix": time.time(),
        "captured_monotonic": time.monotonic(),
        "window_s": window,
        "verb": verb or (getattr(exc, "verb", None) if exc else None),
        "fault": _section(lambda: _fault_section(exc, fclass)),
        "program": _section(lambda: _program_section(prog)),
        "trace": _section(lambda: _trailing_trace(window)),
        "metrics": _section(_metrics_delta),
        "config": _section(_config_section),
        "autotune_decisions": _section(_autotune_section),
        "scheduler": _section(_scheduler_section),
        "memory": _section(_memory_section),
        "extra": dict(extra) if extra else {},
    }
    return bundle


#: exception attributes worth carrying verbatim into the fault section
_FAULT_ATTRS = (
    "verb", "budget_s", "elapsed_s", "retry_after_s", "queue_depth",
    "limit", "reason", "kind", "field", "path",
    "tfs_blocks_issued", "tfs_blocks_unissued",
    "tfs_checkpoint_path", "tfs_checkpoint_watermark",
)


def _fault_section(exc: Optional[BaseException], fclass: str) -> Dict:
    if exc is None:
        return {"type": None, "class": fclass, "message": None}
    out: Dict = {
        "type": type(exc).__name__,
        "class": fclass,
        "message": str(exc)[:2000],
    }
    for attr in _FAULT_ATTRS:
        v = getattr(exc, attr, None)
        if v is not None:
            out[attr.replace("tfs_", "")] = _json_default(v) if not (
                isinstance(v, (str, int, float, bool))
            ) else v
    return out


def _program_section(prog: Optional[str]) -> Dict:
    out: Dict = {"fingerprint": prog, "cost": None, "residual_ratio": None}
    if not prog:
        return out
    from . import costmodel as _cm

    out["cost"] = _cm.program_costs().get(prog)
    try:
        entry = (_cm.residuals().get("programs") or {}).get(prog)
        if entry:
            out["residual_ratio"] = entry.get("residual_ratio")
    except Exception:
        pass  # residuals need spans; their absence is not an error
    return out


def _trailing_trace(window: float) -> Dict:
    from ..utils import telemetry as _tele

    obj = _tele.export_chrome_trace()
    events = obj.get("traceEvents", [])
    cutoff = (time.monotonic() - max(0.0, window)) * 1e6
    kept = [
        e for e in events if e.get("ts", 0) + e.get("dur", 0) >= cutoff
    ]
    dropped_by_window = len(events) - len(kept)
    kept = kept[-MAX_TRACE_EVENTS:]
    obj["traceEvents"] = kept
    other = dict(obj.get("otherData") or {})
    other["window_s"] = window
    other["events_outside_window"] = dropped_by_window
    other["events_over_cap"] = max(
        0, len(events) - dropped_by_window - len(kept)
    )
    obj["otherData"] = other
    return obj


def _flat_histograms() -> Dict[str, Dict[str, float]]:
    from ..utils import telemetry as _tele

    out: Dict[str, Dict[str, float]] = {}
    for (name, labels), (
        _buckets, _counts, hsum, hcount,
    ) in _tele._registry.histogram_snapshot().items():
        if labels:
            lab = ",".join(f"{k}={v}" for k, v in labels)
            key = f"{name}{{{lab}}}"
        else:
            key = name
        out[key] = {"sum": float(hsum), "count": float(hcount)}
    return out


def _metrics_delta() -> Dict:
    """Counter/histogram deltas anchored at the previous capture (or
    process start / `reset_state`), with the actually-covered age
    stamped — the closest a pull-free recorder gets to "the last
    ``incident_window_s``" without a happy-path heartbeat."""
    from ..utils import telemetry as _tele

    now = time.monotonic()
    counters = _tele.flat_counters()
    hists = _flat_histograms()
    with _lock:
        base = _baseline[0]
        _baseline[0] = (now, dict(counters), hists)
    if base is None:
        base_t: Optional[float] = None
        base_c: Dict[str, float] = {}
        base_h: Dict[str, Dict[str, float]] = {}
    else:
        base_t, base_c, base_h = base
    c_delta = {
        k: v - base_c.get(k, 0.0)
        for k, v in counters.items()
        if v != base_c.get(k, 0.0)
    }
    h_delta = {}
    for k, v in hists.items():
        prev = base_h.get(k, {"sum": 0.0, "count": 0.0})
        dc = v["count"] - prev["count"]
        if dc:
            h_delta[k] = {"sum": v["sum"] - prev["sum"], "count": dc}
    return {
        "covers_s": None if base_t is None else now - base_t,
        "counters": c_delta,
        "histograms": h_delta,
    }


def _config_section() -> Dict:
    from .. import config as _config
    from .checkpoint import config_digest

    return {
        "digest": config_digest(),
        "explicit": sorted(_config.explicit_keys()),
        "tuned": _config.tuned(),
    }


def _autotune_section():
    from . import autotune as _autotune

    return _autotune.decisions()


def _scheduler_section() -> Dict:
    from .deadline import controller
    from .scheduler import device_health, health_overview

    return {
        "devices": health_overview(),
        "circuits": device_health().table(),
        "admission": controller().snapshot(),
    }


def _memory_section():
    from . import costmodel as _cm

    return _cm.memory_overview()


def _json_default(o):
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass  # non-scalar .item(): fall through to str()
    if isinstance(o, (set, frozenset, tuple)):
        return list(o)
    return str(o)


# ---------------------------------------------------------------------------
# LRU prune (no lock held: pure directory I/O)
# ---------------------------------------------------------------------------


def _scan(directory: str) -> List[tuple]:
    """(mtime, path, bytes) per bundle file, oldest first."""
    rows = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not name.endswith(SUFFIX):
            continue
        p = os.path.join(directory, name)
        try:
            st = os.stat(p)
        except OSError:
            continue  # pruned by a racing process
        rows.append((st.st_mtime, p, st.st_size))
    rows.sort()
    return rows


def _prune(directory: str, keep_path: str, cfg) -> tuple:
    """Drop least-recently-written bundles until both budgets hold;
    the just-written bundle is never the victim. Returns the surviving
    ``(bundle_count, total_bytes)``."""
    max_bundles = int(getattr(cfg, "incident_max_bundles", 32))
    max_bytes = int(getattr(cfg, "incident_max_bytes", 0))
    rows = _scan(directory)
    total = sum(r[2] for r in rows)
    victims = []
    for mtime, path, size in rows:
        over = (
            (max_bundles > 0 and len(rows) - len(victims) > max_bundles)
            or (max_bytes > 0 and total > max_bytes)
        )
        if not over:
            break
        if os.path.abspath(path) == os.path.abspath(keep_path):
            continue  # newest evidence always survives its own prune
        victims.append(path)
        total -= size
    for path in victims:
        try:
            os.unlink(path)
        except OSError:
            pass  # a racing prune already removed it
    return len(rows) - len(victims), total


# ---------------------------------------------------------------------------
# list / load
# ---------------------------------------------------------------------------


def _peek_manifest(path: str) -> Optional[Dict]:
    """Read ONLY the framed manifest (no payload checksum work) — the
    listing stays cheap however large the bundles are. Full
    verification happens on load."""
    from .checkpoint import MAGIC, _LEN

    try:
        with open(path, "rb") as f:
            head = f.read(len(MAGIC) + _LEN.size)
            if len(head) < len(MAGIC) + _LEN.size:
                return None
            if head[: len(MAGIC)] != MAGIC:
                return None
            (mlen,) = _LEN.unpack(head[len(MAGIC):])
            manifest = json.loads(f.read(mlen).decode())
        return manifest if isinstance(manifest, dict) else None
    except Exception:
        return None  # a torn/corrupt file lists as unreadable, below


def load_payload(path: str) -> bytes:
    """The verified payload bytes of one bundle file, exactly as
    `capture` wrote them. Raises `CheckpointError` for a corrupt/torn
    file."""
    from .checkpoint import CheckpointStore

    _busy.active = True  # a corrupt bundle must not record an incident
    try:
        _manifest, payload = CheckpointStore(path).load()
    finally:
        _busy.active = False
    return payload


def load_file(path: str) -> Dict:
    """Load + fully verify one bundle file (checksummed via the
    CheckpointStore protocol); returns the bundle dict. Raises
    `CheckpointError` for a corrupt/torn file."""
    return json.loads(load_payload(path).decode())


def incidents(incident_id: Optional[str] = None):
    """The list/load API (exported as ``tft.incidents``).

    - ``incidents()`` — summaries of every bundle in the incident
      directory, newest first, each joined with its live in-memory
      suppressed count.
    - ``incidents(incident_id)`` — load + verify that bundle and
      return the full dict (raises ``KeyError`` when no such id,
      `CheckpointError` when the file is corrupt).
    """
    directory = _dir(create=False)
    if incident_id is not None:
        if directory is not None:
            path = os.path.join(directory, incident_id + SUFFIX)
            if os.path.isfile(path):
                return load_file(path)
        raise KeyError(f"no incident bundle {incident_id!r}")
    if directory is None:
        return []
    with _lock:
        suppressed_by_fp = {
            fp: ent["suppressed"] for fp, ent in _dedup.items()
        }
    out = []
    for mtime, path, size in reversed(_scan(directory)):
        manifest = _peek_manifest(path)
        if manifest is None:
            out.append(
                {"path": path, "bytes": size, "unreadable": True}
            )
            continue
        fp = manifest.get("fingerprint")
        out.append(
            {
                "id": manifest.get("incident_id"),
                "trigger": manifest.get("trigger"),
                "fault_class": manifest.get("fault_class"),
                "program": manifest.get("program"),
                "verb": manifest.get("verb"),
                "created_unix": manifest.get("created_unix"),
                "bytes": size,
                "path": path,
                "suppressed_since": suppressed_by_fp.get(fp, 0),
            }
        )
    return out


# ---------------------------------------------------------------------------
# state / reset / routes / gauges
# ---------------------------------------------------------------------------


def state() -> Dict:
    """Flight-recorder accounting for reports and tests:
    capture/suppression totals, live bundle count and bytes, the last
    incident summary, the dedup table and the active budgets."""
    from .. import config as _config

    cfg = _config.get()
    with _lock:
        out: Dict = {
            "armed": None,
            "captured": int(_acct["captured"]),
            "suppressed": dict(_acct["suppressed"]),
            "bundles": int(_acct["bundles"]),
            "bytes": int(_acct["bytes"]),
            "last": dict(_acct["last"]) if _acct["last"] else None,
            "dedup": {
                fp: {
                    "trigger": ent["trigger"],
                    "program": ent["program"],
                    "incident_id": ent["id"],
                    "suppressed": ent["suppressed"],
                }
                for fp, ent in _dedup.items()
            },
            "dir": (
                str(getattr(cfg, "incident_dir", "") or "")
                or _tmp_dir[0]
            ),
        }
    out["armed"] = bool(getattr(cfg, "incident_capture", True))
    out["window_s"] = float(getattr(cfg, "incident_window_s", 60.0))
    out["max_bundles"] = int(getattr(cfg, "incident_max_bundles", 32))
    out["max_bytes"] = int(getattr(cfg, "incident_max_bytes", 0))
    out["rate_limit_s"] = float(
        getattr(cfg, "incident_rate_limit_s", 30.0)
    )
    return out


def reset_state() -> None:
    """Test hook: forget the dedup table, the
    accounting, the metrics baseline, and drop the process-private
    temp directory (a user-configured ``incident_dir`` is an operator
    artifact and is left alone)."""
    with _lock:
        tmp = _tmp_dir[0]
        _tmp_dir[0] = None
        _dedup.clear()
        _baseline[0] = None
        _acct["captured"] = 0
        _acct["suppressed"] = {}
        _acct["bundles"] = 0
        _acct["bytes"] = 0
        _acct["last"] = None
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)


def _route(method: str, path: str, headers, body: bytes):
    """`telemetry_http.mount` handler: GET /incidents (listing +
    recorder state), GET /incidents/<id> (the full verified bundle)."""
    sub = path[len(ROUTE_PREFIX):].strip("/")
    if method != "GET":
        return 405, "application/json", json.dumps(
            {"error": f"method {method} not allowed on {path!r}"}
        ).encode(), None
    if not sub:
        payload = {"incidents": incidents(), "recorder": state()}
        return 200, "application/json", json.dumps(
            payload, default=_json_default
        ).encode(), None
    if "/" in sub:
        return 404, "application/json", json.dumps(
            {"error": f"no route {path!r}"}
        ).encode(), None
    try:
        bundle = incidents(sub)
    except KeyError as e:
        return 404, "application/json", json.dumps(
            {"error": str(e)}
        ).encode(), None
    return 200, "application/json", json.dumps(
        bundle, sort_keys=True, default=_json_default
    ).encode(), None


def _gauge_incident_bytes() -> float:
    with _lock:
        return float(_acct["bytes"])


def _register() -> None:
    try:
        from ..utils import telemetry as _tele

        _tele.gauge_register("incident_bytes", _gauge_incident_bytes)
    except Exception:  # pragma: no cover - telemetry always importable
        pass
    try:
        from ..utils import telemetry_http as _http

        _http.mount(ROUTE_PREFIX, _route, replace=True)
    except Exception:  # pragma: no cover - stdlib-only mount registry
        pass


_register()
