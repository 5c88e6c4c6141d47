"""Content-keyed materialization cache (bounded host/disk result reuse).

The PyTorch counterpart of `tensorframes_tpu/runtime/materialize.py`. At
serving scale many users send few distinct queries; this module turns the
repeats into lookups, keyed on

    (data fingerprint, plan fingerprint, config digest)

where the data fingerprint is a content hash of a HOST-resident input
frame, the plan fingerprint covers the graph's ``Graph.fingerprint()``
plus its feed wiring, output names and (from a serving endpoint) the
label of the device that computes it, and
`runtime.checkpoint.config_digest()` folds in the numerics-relevant knobs.

Entries are result frames serialized with ``io.frame_to_ipc_bytes`` and
committed through `runtime.checkpoint.CheckpointStore` (atomic temp file
+ ``os.replace``, sha256-verified load), so a torn entry is never read.
Admission is priced: a result is kept only when its measured compute time
exceeds twice the measured store time (the JAX package prices it from its
cost ledger first, which the port does not have yet). Eviction is LRU
under ``config.materialize_cache_bytes``, a hard bound.

The cache is OFF by default (``materialize_cache_bytes = 0``). When on,
serving `Endpoint.run_frame`, `LazyFrame.force` and
`RelationalFrame.force` consult it: a hit records a ``materialize.load``
stage span and dispatches nothing. A frame with a
column on the card fingerprints to ``None`` (never cached): hashing it
would force a device-to-host copy behind the caller's back.

Observability: ``materialize_hits`` / ``materialize_misses`` /
``materialize_evictions`` counters, the ``materialize_bytes`` gauge, and
`state()` / `reset_state()` for tests.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "enabled",
    "frame_fingerprint",
    "plan_fingerprint",
    "relational_fingerprint",
    "lookup",
    "store",
    "state",
    "reset_state",
]

_SUFFIX = ".tfsmat"

_lock = threading.RLock()
# key -> {"path", "bytes", "last_used"}; LRU order comes from last_used
_index: Dict[str, Dict] = {}
_scanned_dir: List[Optional[str]] = [None]  # the dir the index reflects
_tmp_dir: List[Optional[str]] = [None]  # process-private default dir
_acct: Dict = {
    "hits": 0,
    "misses": 0,
    "stores": 0,
    "evictions": 0,
    "rejected": 0,  # admission pricing or budget said no
    "corrupt_dropped": 0,
    "drift_refusals": 0,
    "last_hit": None,
    "last_store": None,
}


def enabled() -> bool:
    """The cache participates only when a byte budget is configured."""
    from .. import config as _config

    return _config.get().materialize_cache_bytes > 0


def _budget() -> int:
    from .. import config as _config

    return int(_config.get().materialize_cache_bytes)


def _dir() -> str:
    """``config.materialize_cache_dir`` when set, else a process-private
    temp directory made on first use (entries die with the process)."""
    from .. import config as _config

    d = _config.get().materialize_cache_dir
    if d:
        os.makedirs(d, exist_ok=True)
        return d
    if _tmp_dir[0] is None:
        import tempfile

        _tmp_dir[0] = tempfile.mkdtemp(prefix="tfs-materialize-")
    return _tmp_dir[0]


def _ensure_scanned() -> None:
    """Seed the index from entries already in a directory the first time
    it is used (a persistent directory shares results across processes).
    Called under `_lock`."""
    d = _dir()
    if _scanned_dir[0] == d:
        return
    _scanned_dir[0] = d
    _index.clear()
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        if not name.endswith(_SUFFIX):
            continue
        path = os.path.join(d, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        _index[name[: -len(_SUFFIX)]] = {
            "path": path,
            "bytes": int(st.st_size),
            "last_used": float(st.st_mtime),
        }


def _total_bytes_locked() -> int:
    return sum(e["bytes"] for e in _index.values())


def _gauge_bytes() -> float:
    with _lock:
        return float(_total_bytes_locked())


def _on_device(v) -> bool:
    return isinstance(v, torch.Tensor) and v.device.type != "cpu"


# -- fingerprints ------------------------------------------------------------


def _host_array(cell) -> Optional[np.ndarray]:
    """The host numpy view of one column block, or None when it lies on
    a device (or is of a foreign type)."""
    if isinstance(cell, np.ndarray):
        return cell
    if isinstance(cell, torch.Tensor) and cell.device.type == "cpu":
        from ..frame import _to_numpy

        return _to_numpy(cell)
    return None


def frame_fingerprint(frame) -> Optional[str]:
    """Content hash of a HOST-resident dense frame: dtypes, shapes, block
    offsets and raw column bytes. ``None`` when any column lies on a
    device (hashing it would force a device-to-host copy, which a
    transparent cache must never do), or holds ragged or string cells,
    which the JAX package does not fingerprint either."""
    h = hashlib.sha256()
    try:
        h.update(np.asarray(frame.offsets, dtype=np.int64).tobytes())
        for name in frame.columns:
            col = frame.column(name)
            c = _host_array(col.values) if col.is_dense else None
            if c is None:
                return None  # device tensor, ragged cells or foreign: skip
            c = np.ascontiguousarray(c)
            h.update(name.encode())
            h.update(str(c.dtype).encode())
            h.update(str(c.shape).encode())
            h.update(c.tobytes())
    except Exception:
        return None
    return h.hexdigest()[:16]


def plan_fingerprint(
    graph_fp: str, feed_map=None, outputs=None, device: Optional[str] = None
) -> str:
    """The program half of the key: the graph's fingerprint plus its feed
    wiring and output names (two plans over one graph with different feed
    columns never collide), and the label of the device that computes it
    (a CPU endpoint and a CUDA endpoint over one graph never share an
    entry). Without a device the key is the JAX package's."""
    fields = {
        "graph": graph_fp,
        "feeds": sorted((feed_map or {}).items()),
        "outputs": sorted(outputs or []),
    }
    if device is not None:
        fields["device"] = device
    blob = json.dumps(fields, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def relational_fingerprint(dag_fp: str, device: Optional[str] = None) -> str:
    """The program half of the key for a relational plan: the canonical
    DAG fingerprint (`graph.plan.plan_fingerprint`), namespaced so it never
    collides with a fused chain's key, and the computing device's label
    as in `plan_fingerprint`."""
    blob = f"relational:{dag_fp}" + ("" if device is None else f"@{device}")
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _key(data_fp: str, plan_fp: str, cfg: str) -> str:
    return f"{data_fp}-{plan_fp}-{cfg}"


# -- lookup ------------------------------------------------------------------


def lookup(data_fp: str, plan_fp: str):
    """The cached result frame for ``(data_fp, plan_fp)`` under the
    current config digest, or ``None`` on a miss. A corrupt entry is
    dropped and reads as a miss; an entry whose manifest disagrees with
    the key it was filed under raises `CheckpointError` kind ``drift``."""
    if not enabled() or data_fp is None:
        return None
    from ..utils import telemetry as _tele
    from . import checkpoint as _ckpt

    cfg = _ckpt.config_digest()
    key = _key(data_fp, plan_fp, cfg)
    with _lock:
        _ensure_scanned()
        ent = _index.get(key)
        path = ent["path"] if ent else None
    if path is None or not os.path.exists(path):
        with _lock:
            _index.pop(key, None)
            _acct["misses"] += 1
        _tele.counter_inc("materialize_misses")
        return None
    from ..io import frame_from_ipc_bytes

    t_load0 = time.perf_counter()
    try:
        with _tele.span(
            "materialize.load", kind="stage", program=plan_fp, data=data_fp
        ):
            manifest, payload = _ckpt.CheckpointStore(path).load()
            _check_drift(manifest, data_fp, plan_fp, cfg, path)
            frame = frame_from_ipc_bytes(payload)
    except _ckpt.CheckpointError as e:
        if e.kind == "drift":
            with _lock:
                _acct["drift_refusals"] += 1
            raise
        # corrupt / truncated: drop it and recompute
        with _lock:
            _index.pop(key, None)
            _acct["misses"] += 1
            _acct["corrupt_dropped"] += 1
        _tele.counter_inc("materialize_misses")
        try:
            os.unlink(path)
        except OSError:
            pass
        from ..utils.log import get_logger

        get_logger("materialize").warning(
            "dropped corrupt materialization cache entry %r (%s)", path, e
        )
        return None
    now = time.time()
    with _lock:
        ent = _index.get(key)
        if ent is not None:
            ent["last_used"] = now
        _acct["hits"] += 1
        _acct["last_hit"] = {
            "program": plan_fp, "data": data_fp, "bytes": len(payload),
            "load_seconds": time.perf_counter() - t_load0,
        }
    try:
        os.utime(path, (now, now))  # the LRU clock survives a restart
    except OSError:
        pass
    _tele.counter_inc("materialize_hits")
    return frame


def _check_drift(
    manifest: Dict, data_fp: str, plan_fp: str, cfg: str, path: str
) -> None:
    from . import checkpoint as _ckpt

    for field, want in (
        ("dataset_fingerprint", data_fp),
        ("program_fingerprint", plan_fp),
        ("config_digest", cfg),
    ):
        got = manifest.get(field)
        if got != want:
            raise _ckpt.CheckpointError(
                f"materialization cache entry {path!r} refused: drifted "
                f"field {field!r} (committed {got!r}, current {want!r})",
                field=field, path=path, kind="drift",
            )


# -- store -------------------------------------------------------------------


def _priced_out(recompute_s: Optional[float], store_s: float) -> bool:
    """True when recomputing costs no more than the store plus its
    symmetric load; an unpriced result (None) is never priced out."""
    return recompute_s is not None and recompute_s <= 2.0 * store_s


def store(
    data_fp: str,
    plan_fp: str,
    frame,
    ledger_fp: Optional[str] = None,
    compute_s: Optional[float] = None,
) -> bool:
    """Offer a result frame to the cache; True when admitted.

    Admission pricing: the entry is kept only when the modeled recompute
    cost (`costmodel.modeled_recompute_s(ledger_fp)`, falling back to the
    measured ``compute_s``) exceeds the measured store cost plus the
    symmetric load estimate; an unpriced result is admitted. Serializing a
    frame with columns on the card is a device-to-host copy, counted as
    one (``host_sync``, and the ``d2h_bytes`` histogram)."""
    if not enabled() or data_fp is None:
        return False
    from ..io import frame_to_ipc_bytes
    from ..utils import telemetry as _tele
    from ..utils.profiling import count as _count
    from . import checkpoint as _ckpt

    if any(_on_device(frame.column(c).values) for c in frame.columns):
        with _tele.span("materialize.store", kind="host_sync", program=plan_fp):
            payload = frame_to_ipc_bytes(frame)
        _count("host_sync")
        if _tele.enabled():
            _tele.histogram_observe("d2h_bytes", float(len(payload)))
    else:
        payload = frame_to_ipc_bytes(frame)
    budget = _budget()
    if len(payload) > budget:
        with _lock:
            _acct["rejected"] += 1
        return False
    cfg = _ckpt.config_digest()
    key = _key(data_fp, plan_fp, cfg)
    with _lock:
        _ensure_scanned()
        if key in _index:
            return True  # racing identical store: first writer wins
        path = os.path.join(_dir(), key + _SUFFIX)
    manifest = {
        "dataset_fingerprint": data_fp,
        "program_fingerprint": plan_fp,
        "config_digest": cfg,
        "columns": list(frame.columns),
        "nrows": int(frame.nrows),
    }
    t0 = time.perf_counter()
    try:
        _ckpt.CheckpointStore(path).commit(manifest, payload)
    except _ckpt.CheckpointError:
        return False  # unwritable dir: the cache degrades to a no-op
    store_s = time.perf_counter() - t0
    # price the admission: recompute vs store + (symmetric) load
    recompute_s = None
    if ledger_fp is not None:
        from . import costmodel as _cm

        try:
            recompute_s = _cm.modeled_recompute_s(ledger_fp)
        except Exception:
            recompute_s = None
    if recompute_s is None:
        recompute_s = compute_s
    if _priced_out(recompute_s, store_s):
        try:
            os.unlink(path)
        except OSError:
            pass
        with _lock:
            _acct["rejected"] += 1
        return False
    now = time.time()
    evicted: List[str] = []
    with _lock:
        _index[key] = {"path": path, "bytes": len(payload), "last_used": now}
        # LRU eviction: the byte budget is a hard bound
        while _total_bytes_locked() > budget and len(_index) > 1:
            victim = min(
                (k for k in _index if k != key),
                key=lambda k: _index[k]["last_used"],
            )
            evicted.append(_index.pop(victim)["path"])
            _acct["evictions"] += 1
        _acct["stores"] += 1
        _acct["last_store"] = {
            "program": plan_fp, "data": data_fp, "bytes": len(payload),
            "store_seconds": store_s,
            "recompute_seconds": recompute_s,
        }
    for p in evicted:
        try:
            os.unlink(p)
        except OSError:
            pass
    if evicted:
        _tele.counter_inc("materialize_evictions", float(len(evicted)))
    return True


# -- accounting --------------------------------------------------------------


def state() -> Dict:
    """Hit / miss / store / eviction totals, live entry count and bytes,
    the budget and whether the cache is on."""
    with _lock:
        out = dict(_acct)
        out["last_hit"] = dict(_acct["last_hit"]) if _acct["last_hit"] else None
        out["last_store"] = (
            dict(_acct["last_store"]) if _acct["last_store"] else None
        )
        out["entries"] = len(_index)
        out["bytes"] = _total_bytes_locked()
    out["budget_bytes"] = _budget()
    out["enabled"] = enabled()
    return out


def reset_state() -> None:
    """Test hook: forget the accounting and the index, and delete the
    process-private directory's entries (a configured
    ``materialize_cache_dir`` keeps its files; a later use rescans it)."""
    with _lock:
        _acct.update(
            hits=0, misses=0, stores=0, evictions=0, rejected=0,
            corrupt_dropped=0, drift_refusals=0,
            last_hit=None, last_store=None,
        )
        _index.clear()
        _scanned_dir[0] = None
        d = _tmp_dir[0]
    if d is not None:
        try:
            for name in os.listdir(d):
                if name.endswith(_SUFFIX):
                    try:
                        os.unlink(os.path.join(d, name))
                    except OSError:
                        pass
        except OSError:
            pass


def _register_gauge() -> None:
    from ..utils import telemetry as _tele

    _tele.gauge_register("materialize_bytes", _gauge_bytes)


_register_gauge()
