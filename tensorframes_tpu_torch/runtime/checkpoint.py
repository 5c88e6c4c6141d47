"""Durable streams: checkpoint/resume for out-of-core reductions.

The PyTorch counterpart of `tensorframes_tpu/runtime/checkpoint.py`. A
streaming reduce that dies (a crash, SIGKILL, preemption) loses every
folded partial; this module externalizes the stream's progress so a fresh
interpreter picks up where the dead one committed:

- **`CheckpointStore`** — one checkpoint file, committed ATOMICALLY
  (temp file in the same directory + flush + fsync + ``os.replace``, so
  a crash mid-write leaves either the previous checkpoint or none —
  never a torn one). Layout: an 8-byte magic, a length-prefixed JSON
  manifest, then the length-prefixed payload; the manifest records the
  payload's length AND sha256, so truncation or corruption anywhere in
  the file is detected at load and refused with a typed
  `CheckpointError` — never half-loaded, never silently restarted.

- **Manifest** (versioned, ``schema_version``): dataset fingerprint
  (from `Dataset.tasks()` METADATA — shard paths/sizes, group indices,
  row counts), program fingerprint (`Graph.fingerprint()`), per-fetch
  monoid kind (`aggregate._chunk_combiners` — the eligibility gate),
  a digest of the numerics-relevant config knobs, the resolved fold
  cadence, and the contiguous-chunk WATERMARK: every source chunk with
  ordinal < watermark is folded into the committed partials. The
  watermark is well-defined because the ingest pipeline's reorder
  buffer delivers chunks in order (ingest/pipeline.py).

- **Payload** — the live partial table, one frame row per partial,
  serialized with `io.frame_to_ipc_bytes`. Scalar and rank-1 (vector)
  reduce cells round-trip exactly; higher-rank cells are refused.

- **`StreamCheckpointer`** — the per-call protocol object
  `reduce_blocks_stream(checkpoint=...)` drives: resume validation
  (every manifest field checked, a mismatch refuses LOUDLY naming the
  drifted field unless ``resume="ignore"``), the eligibility gate
  (non-classifiable reduces reject ``checkpoint=`` with a typed
  error), periodic commits every ``checkpoint_every`` folded chunks,
  and commit-on-clean-exit for `DeadlineExceeded` / `Cancelled`.

Exactness: resuming seeds the fold with the restored partials at the
restored watermark, so the partial list evolves exactly as in an
uninterrupted run — bit-identical results for exact monoids (min / max
/ prod / integer sum), within the reassociation tolerance for float
sum/mean.

Telemetry (always-live counters; spans/histograms gated on
``config.telemetry``): ``checkpoint_commits`` / ``checkpoint_resumes``
/ ``checkpoint_chunks_skipped`` counters, the
``checkpoint_write_seconds`` histogram, and ``checkpoint``-kind spans
around commit/resume; `state()` keeps the process-wide totals.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "SCHEMA_VERSION",
    "CheckpointError",
    "CheckpointStore",
    "StreamCheckpointer",
    "config_digest",
    "state",
    "reset_state",
]

MAGIC = b"TFSCKPT1"
SCHEMA_VERSION = 1
_LEN = struct.Struct(">Q")

# Config knobs folded into the manifest digest: the ones that change the
# NUMERICS of a reduce. The JAX package's list also names its matmul
# precision, shape-bucketing and block-scheduler knobs; the port has none
# of them (TF32 is always off, and eager PyTorch buckets nothing). A
# resumed stream under a drifted digest could silently produce a result
# neither run would have produced alone, so drift refuses loudly instead.
_DIGEST_KNOBS = ("check_numerics",)


class CheckpointError(RuntimeError):
    """A checkpoint could not be written, read, or trusted.

    ``kind`` is one of ``"corrupt"`` (truncated / garbled file),
    ``"drift"`` (a manifest field no longer matches the running call —
    ``field`` names which one), ``"ineligible"`` (the reduce is not a
    classifiable monoid, so its partials cannot be durably resumed), or
    ``"invalid"`` (bad arguments / unserializable partials). A drifted
    or corrupt checkpoint is never half-loaded and never silently
    restarted from zero — pass ``resume="ignore"`` to opt into a fresh
    start."""

    # retrying a corrupt/drifted/ineligible checkpoint re-reads the same
    # bytes — surface it once; message text ("INTERNAL:..." in a quoted
    # manifest field) must never pattern-match into the transient class
    tfs_fault_class = "deterministic"

    def __init__(
        self,
        message: str,
        field: Optional[str] = None,
        path: Optional[str] = None,
        kind: str = "invalid",
    ):
        super().__init__(message)
        self.field = field
        self.path = path
        self.kind = kind


def _record_incident(e: "CheckpointError") -> None:
    """Hand a commit/load failure to the flight recorder. A failing
    incident-bundle commit cannot recurse: the recorder holds its
    reentrancy guard across its own store I/O."""
    try:
        from . import blackbox as _blackbox

        _blackbox.capture("checkpoint", e)
    except Exception:
        pass  # the recorder must never mask the checkpoint fault


# ---------------------------------------------------------------------------
# process-wide accounting (reports + test surface)
# ---------------------------------------------------------------------------

_acct_lock = threading.Lock()
_acct: Dict = {
    "commits": 0,
    "resumes": 0,
    "chunks_skipped": 0,
    "ignored": 0,  # resume="ignore" fresh starts over an existing file
    "last_commit": None,
    "last_resume": None,
}


def state() -> Dict:
    """Durable-stream accounting: commit /
    resume / skipped-chunk totals plus the most recent commit and
    resume descriptors."""
    with _acct_lock:
        out = dict(_acct)
        out["last_commit"] = (
            dict(_acct["last_commit"]) if _acct["last_commit"] else None
        )
        out["last_resume"] = (
            dict(_acct["last_resume"]) if _acct["last_resume"] else None
        )
    return out


def reset_state() -> None:
    """Test hook: forget the accounting."""
    with _acct_lock:
        _acct.update(
            commits=0, resumes=0, chunks_skipped=0, ignored=0,
            last_commit=None, last_resume=None,
        )


def _note_commit(path: str, watermark: int, partials: int,
                 nbytes: int, seconds: float) -> None:
    with _acct_lock:
        _acct["commits"] += 1
        _acct["last_commit"] = {
            "path": path,
            "watermark": watermark,
            "partials": partials,
            "bytes": nbytes,
            "write_seconds": seconds,
        }


def _note_resume(
    path: str, watermark: int, partials: int, skipped: int
) -> None:
    with _acct_lock:
        _acct["resumes"] += 1
        _acct["chunks_skipped"] += skipped
        _acct["last_resume"] = {
            "path": path,
            "watermark": watermark,
            "partials": partials,
        }


def _note_ignored() -> None:
    with _acct_lock:
        _acct["ignored"] += 1


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------


def config_digest() -> str:
    """Digest of the numerics-relevant config knobs (see
    `_DIGEST_KNOBS`): part of the manifest, so a resume under knobs
    that would change the reduce's accumulation refuses loudly."""
    from .. import config as _config

    cfg = _config.get()
    blob = json.dumps(
        {k: getattr(cfg, k, None) for k in _DIGEST_KNOBS}, sort_keys=True
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the store: atomic commit + corruption-checked load
# ---------------------------------------------------------------------------


class CheckpointStore:
    """One checkpoint file. `commit` is atomic (temp + fsync +
    ``os.replace``); `load` verifies magic, framing lengths and the
    manifest's payload sha256 before returning anything — a truncated
    or garbled file raises `CheckpointError` (kind ``corrupt``) instead
    of half-loading."""

    def __init__(self, path):
        self.path = os.fspath(path)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def commit(self, manifest: Dict, payload: bytes) -> int:
        """Atomically replace the checkpoint with (manifest, payload);
        returns the file size written. The manifest is augmented with
        ``schema_version``, ``payload_len`` and ``payload_sha256``."""
        manifest = dict(manifest)
        manifest["schema_version"] = SCHEMA_VERSION
        manifest["payload_len"] = len(payload)
        manifest["payload_sha256"] = hashlib.sha256(payload).hexdigest()
        mbytes = json.dumps(manifest, sort_keys=True).encode()
        blob = (
            MAGIC + _LEN.pack(len(mbytes)) + mbytes
            + _LEN.pack(len(payload)) + payload
        )
        # a SIGKILL inside an earlier commit can strand
        # `<path>.tmp.<pid>` siblings; reap the ones whose writer pid
        # is DEAD so repeated preemptions don't litter the directory
        # with payload-sized orphans. A live pid's temp is left alone:
        # a preempted-but-still-running writer racing its replacement
        # must lose last-writer-wins, not crash on a vanished temp.
        import glob as _glob

        for stale in _glob.glob(f"{_glob.escape(self.path)}.tmp.*"):
            try:
                pid = int(stale.rsplit(".", 1)[1])
            except ValueError:
                continue
            if pid != os.getpid():
                try:
                    os.kill(pid, 0)
                    continue  # writer still alive (or pid reused)
                except ProcessLookupError:
                    pass  # dead: the orphan is safe to reap
                except OSError:
                    continue  # EPERM etc.: assume alive
            try:
                os.unlink(stale)
            except OSError:
                pass
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except Exception as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            err = CheckpointError(
                f"checkpoint commit to {self.path!r} failed: "
                f"{type(e).__name__}: {e}",
                path=self.path,
            )
            _record_incident(err)
            raise err from e
        # best-effort directory fsync so the rename itself is durable
        try:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return len(blob)

    def _corrupt(self, why: str) -> CheckpointError:
        return CheckpointError(
            f"checkpoint {self.path!r} is corrupt ({why}); refusing to "
            "load it — delete the file or pass resume=\"ignore\" to "
            "restart from chunk zero",
            path=self.path, kind="corrupt",
        )

    def load(self) -> Tuple[Dict, bytes]:
        """Read and verify the checkpoint; returns (manifest, payload).
        Raises `CheckpointError` kind ``corrupt`` for any framing /
        checksum violation and kind ``drift`` (field
        ``schema_version``) for a manifest written by a different
        schema generation."""
        try:
            return self._load_verified()
        except CheckpointError as e:
            _record_incident(e)
            raise

    def _load_verified(self) -> Tuple[Dict, bytes]:
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointError(
                f"checkpoint {self.path!r} unreadable: {e}",
                path=self.path, kind="corrupt",
            ) from e
        hdr = len(MAGIC) + _LEN.size
        if len(blob) < hdr:
            raise self._corrupt("truncated header")
        if blob[: len(MAGIC)] != MAGIC:
            raise self._corrupt("bad magic")
        (mlen,) = _LEN.unpack(blob[len(MAGIC):hdr])
        if len(blob) < hdr + mlen + _LEN.size:
            raise self._corrupt("truncated manifest")
        try:
            manifest = json.loads(blob[hdr:hdr + mlen].decode())
        except Exception:
            raise self._corrupt("unparseable manifest") from None
        if not isinstance(manifest, dict):
            raise self._corrupt("manifest is not an object")
        version = manifest.get("schema_version")
        if version != SCHEMA_VERSION:
            raise CheckpointError(
                f"checkpoint {self.path!r} was written by schema version "
                f"{version!r}; this build reads version {SCHEMA_VERSION} "
                "(drifted field: schema_version)",
                field="schema_version", path=self.path, kind="drift",
            )
        off = hdr + mlen
        (plen,) = _LEN.unpack(blob[off:off + _LEN.size])
        payload = blob[off + _LEN.size:]
        if len(payload) != plen or plen != manifest.get("payload_len"):
            raise self._corrupt("truncated payload")
        digest = hashlib.sha256(payload).hexdigest()
        if digest != manifest.get("payload_sha256"):
            raise self._corrupt("payload checksum mismatch")
        return manifest, payload


# ---------------------------------------------------------------------------
# partial-table serialization (Arrow IPC via io.frame_to_ipc_bytes)
# ---------------------------------------------------------------------------


def partials_to_payload(
    partials: List[Dict[str, object]], fetch_bases: List[str]
) -> Tuple[bytes, bool]:
    """Serialize the live partial list as ONE frame (row i = partial i,
    one column per fetch base) in Arrow IPC stream bytes. Returns
    ``(payload, synced)`` — ``synced`` is True when any partial lived
    on device (the copy is a real D2H sync, accounted by the caller).
    Tensor partials are COPIED to host; the live list is untouched, so
    the stream keeps overlapping after a commit."""
    import torch

    from ..frame import TensorFrame, _to_numpy
    from ..io import frame_to_ipc_bytes

    synced = False
    cols: Dict[str, np.ndarray] = {}
    for b in fetch_bases:
        vals = []
        for p in partials:
            v = p[b]
            if isinstance(v, torch.Tensor):
                synced = True
                v = _to_numpy(v)
            vals.append(np.asarray(v))
        stacked = np.stack(vals)
        if stacked.ndim > 2:
            raise CheckpointError(
                f"checkpoint: fetch {b!r} produces rank-"
                f"{stacked.ndim - 1} partials; the durable payload "
                "round-trips scalar and rank-1 (vector) reduce cells "
                "only",
                field=b,
            )
        cols[b] = stacked
    try:
        return frame_to_ipc_bytes(TensorFrame.from_dict(cols)), synced
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"checkpoint: partial table not serializable "
            f"({type(e).__name__}: {e})"
        ) from e


def payload_to_partials(
    payload: bytes, manifest: Dict, store: CheckpointStore
) -> List[Dict[str, np.ndarray]]:
    """Rebuild the partial list (host numpy) from a verified payload."""
    from ..io import frame_from_ipc_bytes

    try:
        frame = frame_from_ipc_bytes(payload)
    except Exception as e:
        raise store._corrupt(
            f"payload not an Arrow IPC stream ({type(e).__name__})"
        ) from e
    n = int(manifest.get("partials", -1))
    bases = list(manifest.get("fetch_names") or [])
    if frame.nrows != n or sorted(frame.columns) != sorted(bases):
        raise store._corrupt("payload does not match its manifest")
    cols = {b: frame.column(b).host_values() for b in bases}
    return [
        {b: np.asarray(cols[b][i]) for b in bases} for i in range(n)
    ]


# ---------------------------------------------------------------------------
# the per-call protocol object reduce_blocks_stream drives
# ---------------------------------------------------------------------------

_RESUME_MODES = ("auto", "ignore")


class StreamCheckpointer:
    """Checkpoint/resume protocol for ONE `reduce_blocks_stream` call.

    Lifecycle: construct at verb entry (validates arguments, attempts
    the ENTRY-time eligibility check when the graph's declared shapes
    allow it), `try_resume()` before the pipeline starts (loads +
    validates an existing checkpoint, returns the watermark and
    restored partials), `on_first_chunk()` once shapes are known (the
    final eligibility gate + monoid/fold-cadence drift checks),
    `note_chunk_folded()` after every folded chunk (commits every
    ``every`` folds), `on_interrupt()` for clean deadline/cancel exits,
    `finalize()` on success."""

    def __init__(
        self,
        path,
        graph,
        fetch_bases: List[str],
        every: Optional[int],
        resume: str,
        dataset_fingerprint: Optional[str],
    ):
        if resume not in _RESUME_MODES:
            raise CheckpointError(
                f"resume={resume!r} is not one of "
                + " | ".join(repr(m) for m in _RESUME_MODES)
            )
        from .. import config as _config

        if every is None:
            every = int(
                getattr(_config.get(), "stream_checkpoint_every", 16)
            )
        if int(every) < 1:
            raise CheckpointError(
                f"checkpoint_every must be >= 1, got {every!r}"
            )
        self.store = CheckpointStore(path)
        self.every = int(every)
        self.resume = resume
        self.graph = graph
        self.fetch_bases = list(fetch_bases)
        self.dataset_fingerprint = dataset_fingerprint
        self.program_fingerprint = graph.fingerprint()
        self.config_digest = config_digest()
        self.monoids: Optional[Dict[str, str]] = None
        self.fold_every: Optional[int] = None
        self._resumed_manifest: Optional[Dict] = None
        self._folded_since_commit = 0
        self._rank_checked = False
        self.watermark = 0  # last COMMITTED contiguous-chunk watermark

    # -- eligibility ----------------------------------------------------
    def entry_gate(self) -> None:
        """Best-effort eligibility check at verb ENTRY, before any
        chunk decodes: when the graph's declared placeholder shapes
        suffice for classification, a non-classifiable reduce is
        rejected here. Unknown shapes defer the verdict to
        `on_first_chunk` (which can never wrongly reject)."""
        from ..aggregate import _chunk_combiners
        from ..graph.analysis import analyze_graph

        try:
            summary = analyze_graph(self.graph, self.fetch_bases)
            comb = _chunk_combiners(self.graph, self.fetch_bases, summary)
        except Exception:
            return  # shapes unknown at entry; first chunk decides
        if comb is None:
            raise self._ineligible()

    def _ineligible(self) -> CheckpointError:
        return CheckpointError(
            "checkpoint= requires every fetch to be a classifiable "
            "monoid reduce (sum/min/max/prod, float mean) of a "
            "row-local transform — this graph's partials cannot be "
            "durably resumed (exactness could not be guaranteed)",
            kind="ineligible", path=self.store.path,
        )

    # -- resume ---------------------------------------------------------
    def _drift(self, field: str, committed, current) -> CheckpointError:
        return CheckpointError(
            f"checkpoint {self.store.path!r} does not match this call: "
            f"drifted field {field!r} (committed {committed!r}, current "
            f"{current!r}); refusing to resume — fix the drift or pass "
            "resume=\"ignore\" to restart from chunk zero",
            field=field, path=self.store.path, kind="drift",
        )

    def try_resume(self) -> Tuple[int, List[Dict[str, np.ndarray]]]:
        """Load + validate an existing checkpoint. Returns
        ``(watermark, restored_partials)`` — ``(0, [])`` when there is
        nothing (or ``resume="ignore"`` discards what exists). Raises
        `CheckpointError` on corruption or drift."""
        if not self.store.exists():
            return 0, []
        if self.resume == "ignore":
            _note_ignored()
            from ..utils.log import get_logger

            get_logger("checkpoint").warning(
                "resume=\"ignore\": existing checkpoint %s discarded; "
                "restarting the stream from chunk zero",
                self.store.path,
            )
            return 0, []
        manifest, payload = self.store.load()
        for field, current in (
            ("fetch_names", self.fetch_bases),
            ("program_fingerprint", self.program_fingerprint),
            ("dataset_fingerprint", self.dataset_fingerprint),
            ("config_digest", self.config_digest),
        ):
            committed = manifest.get(field)
            if committed != current:
                raise self._drift(field, committed, current)
        watermark = int(manifest.get("watermark", 0))
        if watermark < 0:
            raise self.store._corrupt("negative watermark")
        partials = payload_to_partials(payload, manifest, self.store)
        self._resumed_manifest = manifest
        self.watermark = watermark
        from ..utils import telemetry as _tele

        # "skipped" means NEVER RE-DECODED — true only for the dataset
        # (task-metadata) path; a plain iterator re-pulls committed
        # chunks from the producer (synthesis is paid, dispatch is not)
        skipped = watermark if self.dataset_fingerprint is not None else 0
        _tele.counter_inc("checkpoint_resumes", 1.0)
        if skipped:
            _tele.counter_inc("checkpoint_chunks_skipped", float(skipped))
        if _tele.enabled():
            with _tele.span(
                "checkpoint.resume", kind="checkpoint",
                watermark=watermark, partials=len(partials),
            ):
                pass
        _note_resume(self.store.path, watermark, len(partials), skipped)
        return watermark, partials

    # -- the per-chunk protocol ----------------------------------------
    def on_first_chunk(
        self, monoids: Optional[Dict[str, str]], fold_every: Optional[int]
    ) -> None:
        """The chunk-level eligibility gate + the deferred drift
        checks: ``monoids`` is the `_chunk_combiners` classification
        under the first chunk's real shapes, ``fold_every`` the
        resolved fold cadence. Both are recorded into every later
        manifest; on a resumed stream both are validated against the
        committed values."""
        if monoids is None:
            raise self._ineligible()
        self.monoids = dict(monoids)
        self.fold_every = fold_every
        m = self._resumed_manifest
        if m is not None:
            if m.get("monoids") != self.monoids:
                raise self._drift("monoids", m.get("monoids"), self.monoids)
            if m.get("fold_every") != fold_every:
                raise self._drift(
                    "fold_every", m.get("fold_every"), fold_every
                )

    def _manifest(self, watermark: int, n_partials: int) -> Dict:
        return {
            "fetch_names": self.fetch_bases,
            "program_fingerprint": self.program_fingerprint,
            "dataset_fingerprint": self.dataset_fingerprint,
            "config_digest": self.config_digest,
            "monoids": self.monoids,
            "fold_every": self.fold_every,
            "watermark": int(watermark),
            "partials": int(n_partials),
            "created_unix": time.time(),
        }

    def _commit(self, watermark: int, partials: List[Dict]) -> None:
        from ..utils import telemetry as _tele
        from ..utils.profiling import count as _count

        t0 = time.perf_counter()
        payload, synced = partials_to_payload(partials, self.fetch_bases)
        with _tele.span(
            "checkpoint.commit", kind="checkpoint",
            watermark=watermark, partials=len(partials),
            bytes=len(payload),
        ):
            nbytes = self.store.commit(
                self._manifest(watermark, len(partials)), payload
            )
        dt = time.perf_counter() - t0
        if synced:
            # the payload copy pulled tensor partials to host: a D2H sync
            # on the card, accounted like the unfoldable-stream spill
            _count("host_sync")
            if _tele.enabled():
                _tele.histogram_observe("d2h_bytes", float(len(payload)))
        _tele.counter_inc("checkpoint_commits", 1.0)
        if _tele.enabled():
            _tele.histogram_observe("checkpoint_write_seconds", dt)
        self.watermark = watermark
        self._folded_since_commit = 0
        _note_commit(
            self.store.path, watermark, len(partials), nbytes, dt
        )

    def note_chunk_folded(
        self, ordinal: int, partials: List[Dict]
    ) -> bool:
        """One more chunk folded into ``partials``; ``ordinal`` is the
        count of source chunks fully consumed (the candidate
        watermark). Commits when ``checkpoint_every`` folds have
        accumulated; returns True when a commit happened."""
        if not self._rank_checked and partials:
            # `np.ndim` reads `.ndim` only — no D2H sync for tensor
            # partials; failing at the FIRST fold beats discovering an
            # unserializable payload checkpoint_every chunks later
            self._rank_checked = True
            for b in self.fetch_bases:
                if np.ndim(partials[-1][b]) > 1:
                    raise CheckpointError(
                        f"checkpoint: fetch {b!r} produces rank-"
                        f"{np.ndim(partials[-1][b])} partials; the "
                        "durable payload round-trips scalar and rank-1 "
                        "(vector) reduce cells only",
                        field=b,
                    )
        self._folded_since_commit += 1
        if self._folded_since_commit < self.every:
            return False
        self._commit(ordinal, partials)
        return True

    def on_interrupt(
        self, exc: BaseException, ordinal: int, partials: List[Dict]
    ) -> None:
        """Clean deadline/cancel exit: commit the progress so far (when
        anything new folded since the last commit) and stamp the
        committed watermark onto the escaping exception."""
        if self._folded_since_commit > 0 and partials:
            try:
                self._commit(ordinal, partials)
            except Exception as e:
                # the commit must never mask the typed exit — but the
                # lost recovery point deserves a trace (cf. finalize)
                from ..utils.log import get_logger

                get_logger("checkpoint").warning(
                    "interrupt-time checkpoint commit to %s failed "
                    "(%s: %s); resume will restart from watermark %d",
                    self.store.path, type(e).__name__, e, self.watermark,
                )
        try:
            exc.tfs_checkpoint_path = self.store.path
            exc.tfs_checkpoint_watermark = self.watermark
        except Exception:
            pass  # __slots__ errors refuse stamps; the typed exit raises

    def finalize(self, ordinal: int, partials: List[Dict]) -> None:
        """Successful completion: commit the final state (watermark =
        every chunk), so an identical re-run resumes to a no-op —
        restored partials combine, zero chunks re-decode. A failed
        FINAL commit is logged, not raised: the result already exists
        in memory, and durability bookkeeping must never destroy the
        very thing it protects (mirrors `on_interrupt`)."""
        if self._folded_since_commit > 0 and partials:
            try:
                self._commit(ordinal, partials)
            except Exception as e:
                from ..utils.log import get_logger

                get_logger("checkpoint").warning(
                    "final checkpoint commit to %s failed (%s: %s); "
                    "the completed result is returned anyway — an "
                    "identical re-run will resume from watermark %d",
                    self.store.path, type(e).__name__, e, self.watermark,
                )
