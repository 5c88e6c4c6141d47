"""Persistent workload profiles: measurements that outlive the process.

The PyTorch counterpart of `tensorframes_tpu/runtime/profiler.py`, with
the same JSON schema (``PROFILE_SCHEMA`` 1), so a profile one package
saved loads in the other. A `WorkloadProfile` is a compact,
JSON-serializable rollup of the process's live observability state
(`snapshot()` reads; it never mutates and never raises — a section that
fails to collect carries an ``error`` string):

- **verbs** — per-verb call/second/row totals (the ``<verb>.calls`` /
  ``.seconds`` / ``.rows`` counters `utils.profiling.record` keeps) plus
  the verb latency histogram;
- **programs** — the cost ledger per fingerprint: kinds, exec counts, the
  set of dispatched lead row counts (``rungs``) and per-shape modeled
  flops/bytes — the profile's structural identity;
- **bucketing** — pad-waste counters and per-verb ``bucket_fill``
  histograms (the serving batcher's);
- **serving** — per-endpoint request/batch/shed counts and the batch rows /
  coalesced-size / queue-latency histograms;
- **ingest** — per-stage busy/starvation rollups;
- **admission** — admitted/shed totals, peak in-flight, queued-wait
  seconds, per-verb deadline expiries;
- **residuals** — the cost-model accuracy join (`costmodel.residuals`)
  with the roofline saturation rollup ``peak_ratio_max``;
- **autotune** — the tuner's state (`runtime.autotune.state()`).

Operations: ``save(path)`` / ``load(path)`` (versioned JSON),
``merge(other)`` (counter sums, exact histogram merges; mismatched bucket
boundaries refuse), ``diff(other)`` (structural drift separated from
timing deltas). The telemetry HTTP server serves a live snapshot at
``/profile``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

__all__ = ["PROFILE_SCHEMA", "WorkloadProfile", "snapshot", "load"]

PROFILE_SCHEMA = 1

# histogram dict shape used throughout:
#   {"buckets": [...], "counts": [... len(buckets)+1 ...],
#    "sum": float, "count": int}


def _hist_from_snapshot(entry) -> Dict:
    buckets, counts, hsum, hcount = entry
    return {
        "buckets": [float(b) for b in buckets],
        "counts": [int(c) for c in counts],
        "sum": float(hsum),
        "count": int(hcount),
    }


def _merge_hist(a: Optional[Dict], b: Optional[Dict], what: str):
    if a is None:
        return None if b is None else dict(b)
    if b is None:
        return dict(a)
    if list(a["buckets"]) != list(b["buckets"]):
        raise ValueError(
            f"cannot merge profiles: histogram {what!r} bucket "
            f"boundaries differ ({a['buckets']} vs {b['buckets']}); "
            "profiles captured under different config.histogram_buckets "
            "are not mergeable"
        )
    return {
        "buckets": list(a["buckets"]),
        "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
        "sum": a["sum"] + b["sum"],
        "count": a["count"] + b["count"],
    }


def _labels(label_items) -> Dict[str, str]:
    return dict(label_items)


class WorkloadProfile:
    """A saved/loadable workload measurement rollup (see module doc).

    Thin wrapper over a plain JSON-able dict (``.data``) so save→load
    round trips are exact by construction: everything `save` writes is
    everything the constructor holds."""

    def __init__(self, data: Dict):
        if not isinstance(data, dict):
            raise TypeError(f"WorkloadProfile wants a dict, got {type(data)}")
        schema = data.get("schema")
        if schema != PROFILE_SCHEMA:
            raise ValueError(
                f"unsupported profile schema {schema!r} (this build "
                f"reads schema {PROFILE_SCHEMA})"
            )
        self.data = data

    # -- accessors ------------------------------------------------------
    @property
    def meta(self) -> Dict:
        return self.data.get("meta", {})

    @property
    def verbs(self) -> Dict:
        return self.data.get("verbs", {})

    @property
    def programs(self) -> Dict:
        return self.data.get("programs", {})

    def to_dict(self) -> Dict:
        return self.data

    def __repr__(self) -> str:
        return (
            f"WorkloadProfile({len(self.verbs)} verb(s), "
            f"{len(self.programs)} program(s), "
            f"created={self.meta.get('created_unix')})"
        )

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> str:
        """Write the profile as versioned JSON. Returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.data, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def from_dict(cls, data: Dict) -> "WorkloadProfile":
        return cls(data)

    # -- merge ----------------------------------------------------------
    def merge(self, other: "WorkloadProfile") -> "WorkloadProfile":
        """Combine two profiles of the SAME workload family into one:
        counters sum, fixed-bucket histograms merge exactly, program
        shape entries merge by (kind, rows) with exec counts summed and
        modeled costs kept from whichever side captured them, rung sets
        union. Histograms with different bucket boundaries raise — a
        blended ladder would silently misreport every quantile."""
        a, b = self.data, other.data
        out: Dict = {"schema": PROFILE_SCHEMA}
        ma, mb = a.get("meta", {}), b.get("meta", {})

        def _same(key):
            va, vb = ma.get(key), mb.get(key)
            return va if va == vb else None

        created = [
            t for t in (ma.get("created_unix"), mb.get("created_unix"))
            if t is not None
        ]
        # provenance survives the merge: shared fields carry over,
        # differing ones read None (never silently pick a side), the
        # full per-side metas ride along in merged_from
        out["meta"] = {
            "created_unix": min(created) if created else None,
            "host": _same("host"),
            "pid": _same("pid"),
            "device_kind": _same("device_kind"),
            "device_count": _same("device_count"),
            "note": "merged",
            "merged_from": [ma, mb],
        }
        # verbs ---------------------------------------------------------
        verbs: Dict = {}
        for name in sorted(set(a.get("verbs", {})) | set(b.get("verbs", {}))):
            va = a.get("verbs", {}).get(name)
            vb = b.get("verbs", {}).get(name)
            if va is None or vb is None:
                verbs[name] = dict(va or vb)
                continue
            verbs[name] = {
                "calls": va["calls"] + vb["calls"],
                "seconds": va["seconds"] + vb["seconds"],
                "rows": va["rows"] + vb["rows"],
                "latency": _merge_hist(
                    va.get("latency"), vb.get("latency"),
                    f"verb_seconds{{verb={name}}}",
                ),
            }
        out["verbs"] = verbs
        # programs ------------------------------------------------------
        progs: Dict = {}
        for fp in sorted(
            set(a.get("programs", {})) | set(b.get("programs", {}))
        ):
            pa = a.get("programs", {}).get(fp)
            pb = b.get("programs", {}).get(fp)
            if pa is None or pb is None:
                progs[fp] = json.loads(json.dumps(pa or pb))
                continue
            by_shape: Dict[Tuple, Dict] = {}
            for src in (pa, pb):
                for sh in src.get("shapes", []):
                    key = (sh.get("kind"), sh.get("rows"))
                    cur = by_shape.get(key)
                    if cur is None:
                        by_shape[key] = dict(sh)
                    else:
                        cur["execs"] = cur.get("execs", 0) + sh.get(
                            "execs", 0
                        )
                        for k in (
                            "flops", "bytes_accessed", "arg_bytes",
                            "out_bytes", "temp_bytes",
                        ):
                            if cur.get(k) is None:
                                cur[k] = sh.get(k)
            progs[fp] = {
                "kinds": sorted(
                    set(pa.get("kinds", [])) | set(pb.get("kinds", []))
                ),
                "execs": pa.get("execs", 0) + pb.get("execs", 0),
                "rungs": sorted(
                    set(pa.get("rungs", [])) | set(pb.get("rungs", []))
                ),
                "shapes": [
                    by_shape[k] for k in sorted(
                        by_shape, key=lambda k: (str(k[0]), k[1] or 0)
                    )
                ],
            }
        out["programs"] = progs
        # bucketing -----------------------------------------------------
        ba, bb = a.get("bucketing", {}), b.get("bucketing", {})
        fill: Dict = {}
        for verb in sorted(
            set(ba.get("fill", {})) | set(bb.get("fill", {}))
        ):
            fill[verb] = _merge_hist(
                ba.get("fill", {}).get(verb),
                bb.get("fill", {}).get(verb),
                f"bucket_fill{{verb={verb}}}",
            )
        out["bucketing"] = {
            "padded_dispatches": ba.get("padded_dispatches", 0)
            + bb.get("padded_dispatches", 0),
            "pad_rows": ba.get("pad_rows", 0) + bb.get("pad_rows", 0),
            "fill": fill,
        }
        # serving -------------------------------------------------------
        sa, sb = a.get("serving", {}), b.get("serving", {})
        eps: Dict = {}
        for name in sorted(
            set(sa.get("endpoints", {})) | set(sb.get("endpoints", {}))
        ):
            ea = sa.get("endpoints", {}).get(name, {})
            eb = sb.get("endpoints", {}).get(name, {})
            eps[name] = {
                k: ea.get(k, 0) + eb.get(k, 0)
                for k in ("requests", "batches", "shed")
            }
        out["serving"] = {
            "endpoints": eps,
            **{
                k: _merge_hist(sa.get(k), sb.get(k), k)
                for k in ("batch_rows", "batch_requests", "queue_seconds")
            },
        }
        # ingest --------------------------------------------------------
        ia, ib = a.get("ingest", {}), b.get("ingest", {})
        out["ingest"] = {
            stage: {
                k: ia.get(stage, {}).get(k, 0.0)
                + ib.get(stage, {}).get(k, 0.0)
                for k in ("chunks", "busy_s", "wait_s")
            }
            for stage in sorted(set(ia) | set(ib))
        }
        # admission -----------------------------------------------------
        aa, ab = a.get("admission", {}), b.get("admission", {})
        out["admission"] = {
            "admitted": aa.get("admitted", 0) + ab.get("admitted", 0),
            "shed": aa.get("shed", 0) + ab.get("shed", 0),
            "peak_in_flight": max(
                aa.get("peak_in_flight", 0), ab.get("peak_in_flight", 0)
            ),
            "wait_seconds": aa.get("wait_seconds", 0.0)
            + ab.get("wait_seconds", 0.0),
            "deadline_exceeded": {
                v: aa.get("deadline_exceeded", {}).get(v, 0)
                + ab.get("deadline_exceeded", {}).get(v, 0)
                for v in sorted(
                    set(aa.get("deadline_exceeded", {}))
                    | set(ab.get("deadline_exceeded", {}))
                )
            },
        }
        # residuals are per-run joins; a merged profile keeps both for
        # the reader instead of inventing a combined fit
        out["residuals"] = {
            "merged_from": [a.get("residuals"), b.get("residuals")]
        }
        return WorkloadProfile(out)

    # -- diff -----------------------------------------------------------
    def diff(self, other: "WorkloadProfile") -> Dict:
        """Compare two profiles of nominally the same workload.

        Returns ``{"structural": [...], "timing": [...],
        "structural_drift": bool}``. *Structural* entries are identity
        changes — programs present in only one run, bucket-rung sets
        that differ for a shared program, verb/endpoint/ingest-stage
        sets that differ — the things that mean "this is not the same
        workload (or the same plan) anymore". *Timing* entries are
        magnitude deltas (seconds, counts) between runs of the same
        structure: the normal run-to-run variation an autotuner
        consumes. Two runs of one workload should diff to zero
        structural drift with timing deltas only."""
        a, b = self.data, other.data
        structural: List[str] = []
        timing: List[Dict] = []

        def _sets(what: str, sa, sb):
            only_a = sorted(set(sa) - set(sb))
            only_b = sorted(set(sb) - set(sa))
            for k in only_a:
                structural.append(f"{what} {k!r} only in A")
            for k in only_b:
                structural.append(f"{what} {k!r} only in B")

        pa, pb = a.get("programs", {}), b.get("programs", {})
        _sets("program", pa, pb)
        for fp in sorted(set(pa) & set(pb)):
            ra = pa[fp].get("rungs", [])
            rb = pb[fp].get("rungs", [])
            if sorted(ra) != sorted(rb):
                structural.append(
                    f"program {fp!r} rungs differ: A={sorted(ra)} "
                    f"B={sorted(rb)}"
                )
            ea, eb = pa[fp].get("execs", 0), pb[fp].get("execs", 0)
            if ea != eb:
                timing.append(
                    {
                        "what": f"program {fp} execs",
                        "a": ea, "b": eb, "delta": eb - ea,
                        "ratio": (eb / ea) if ea else None,
                    }
                )
        va, vb = a.get("verbs", {}), b.get("verbs", {})
        _sets("verb", va, vb)
        for name in sorted(set(va) & set(vb)):
            for field in ("seconds", "calls", "rows"):
                x, y = va[name].get(field, 0), vb[name].get(field, 0)
                if x != y:
                    timing.append(
                        {
                            "what": f"verb {name} {field}",
                            "a": x, "b": y, "delta": y - x,
                            "ratio": (y / x) if x else None,
                        }
                    )
        _sets(
            "serving endpoint",
            a.get("serving", {}).get("endpoints", {}),
            b.get("serving", {}).get("endpoints", {}),
        )
        _sets("ingest stage", a.get("ingest", {}), b.get("ingest", {}))
        aa, ab = a.get("admission", {}), b.get("admission", {})
        for field in ("admitted", "shed"):
            x, y = aa.get(field, 0), ab.get(field, 0)
            if x != y:
                timing.append(
                    {
                        "what": f"admission {field}",
                        "a": x, "b": y, "delta": y - x,
                        "ratio": (y / x) if x else None,
                    }
                )
        return {
            "structural": structural,
            "timing": timing,
            "structural_drift": bool(structural),
        }


# ---------------------------------------------------------------------------
# live capture
# ---------------------------------------------------------------------------


def _capture_verbs(counters, hists) -> Dict:
    verbs: Dict = {}
    for (name, labels), v in counters.items():
        if labels or not name.endswith(".calls"):
            continue
        verb = name[: -len(".calls")]
        if not verb or verb.startswith("telemetry."):
            continue
        verbs[verb] = {
            "calls": int(v),
            "seconds": float(counters.get((f"{verb}.seconds", ()), 0.0)),
            "rows": float(counters.get((f"{verb}.rows", ()), 0.0)),
            "latency": None,
        }
    for (name, labels), entry in hists.items():
        if name != "verb_seconds":
            continue
        verb = _labels(labels).get("verb")
        if verb in verbs:
            verbs[verb]["latency"] = _hist_from_snapshot(entry)
    return verbs


def _capture_programs() -> Dict:
    from . import costmodel as _cm

    out: Dict = {}
    costs = _cm.program_costs()
    shapes = _cm.program_shapes()
    for fp, c in costs.items():
        ents = shapes.get(fp, [])
        out[fp] = {
            "kinds": list(c["kinds"]),
            "execs": int(c["execs"]),
            # the structural identity: which bucket rungs (captured
            # lead row counts) this program dispatched at
            "rungs": sorted(
                {
                    int(e["rows"]) for e in ents if e["rows"] is not None
                }
            ),
            "shapes": sorted(
                (
                    {
                        "kind": e["kind"],
                        "rows": e["rows"],
                        "execs": e["execs"],
                        "flops": e["flops"],
                        "bytes_accessed": e["bytes_accessed"],
                        "arg_bytes": e["arg_bytes"],
                        "out_bytes": e["out_bytes"],
                        "temp_bytes": e["temp_bytes"],
                    }
                    for e in ents
                ),
                key=lambda e: (str(e["kind"]), e["rows"] or 0),
            ),
        }
    return out


def _capture_bucketing(counters, hists) -> Dict:
    fill: Dict = {}
    for (name, labels), entry in hists.items():
        if name != "bucket_fill":
            continue
        verb = _labels(labels).get("verb", "unattributed")
        fill[verb] = _hist_from_snapshot(entry)
    return {
        "padded_dispatches": int(
            counters.get(("shape_bucketing.padded_dispatch", ()), 0)
        ),
        "pad_rows": int(counters.get(("shape_bucketing.pad_rows", ()), 0)),
        "fill": fill,
    }


def _capture_serving(counters, hists) -> Dict:
    eps: Dict = {}
    keymap = {
        "serve_requests": "requests",
        "serve_batches": "batches",
        "serve_shed": "shed",
    }
    for (name, labels), v in counters.items():
        field = keymap.get(name)
        if field is None:
            continue
        ep = _labels(labels).get("endpoint", "?")
        eps.setdefault(
            ep, {"requests": 0, "batches": 0, "shed": 0}
        )[field] = int(v)
    histmap = {
        "serve_batch_rows": "batch_rows",
        # serve_batch_fill counts coalesced REQUESTS per batch (see
        # serving/batcher.py) — named honestly here
        "serve_batch_fill": "batch_requests",
        "serve_queue_seconds": "queue_seconds",
    }
    out: Dict = {"endpoints": eps, "batch_rows": None,
                 "batch_requests": None, "queue_seconds": None}
    for (name, labels), entry in hists.items():
        field = histmap.get(name)
        if field is not None and not labels:
            out[field] = _hist_from_snapshot(entry)
    return out


def _capture_ingest(counters) -> Dict:
    stages: Dict = {}
    keymap = {
        "ingest_chunks": "chunks",
        "ingest_stage_busy_seconds": "busy_s",
        "ingest_stage_wait_seconds": "wait_s",
    }
    for (name, labels), v in counters.items():
        field = keymap.get(name)
        if field is None:
            continue
        stage = _labels(labels).get("stage", "?")
        stages.setdefault(
            stage, {"chunks": 0.0, "busy_s": 0.0, "wait_s": 0.0}
        )[field] = float(v)
    return stages


def _capture_admission(counters) -> Dict:
    from .deadline import controller

    snap = controller().snapshot()
    deadline_by_verb = {}
    for (name, labels), v in counters.items():
        if name == "deadline_exceeded":
            verb = _labels(labels).get("verb", "?")
            deadline_by_verb[verb] = int(v)
    return {
        "admitted": int(snap.get("admitted", 0)),
        "shed": int(snap.get("shed", 0)),
        "peak_in_flight": int(snap.get("peak_in_flight", 0)),
        "wait_seconds": float(
            counters.get(("admission_wait_seconds", ()), 0.0)
        ),
        "deadline_exceeded": deadline_by_verb,
    }


def _capture_meta(note: Optional[str]) -> Dict:
    import os
    import platform
    import time

    meta: Dict = {
        "created_unix": time.time(),
        "host": platform.node(),
        "pid": os.getpid(),
        "schema": PROFILE_SCHEMA,
    }
    if note:
        meta["note"] = str(note)
    try:
        import torch

        if torch.cuda.is_available():
            meta["device_count"] = torch.cuda.device_count()
            meta["device_kind"] = torch.cuda.get_device_name(0)
        else:
            meta["device_count"] = 1
            meta["device_kind"] = "cpu"
    except Exception:
        pass  # no live backend: the profile meta omits device fields
    return meta


def snapshot(note: Optional[str] = None) -> WorkloadProfile:
    """Capture the process's live observability state as a
    `WorkloadProfile`. Read-only and exception-guarded per section —
    a snapshot must never perturb or break the workload it measures;
    a section that fails to collect is recorded as its empty shape."""
    from ..utils import telemetry as _tele

    try:
        counters = _tele.labeled_counters()
    except Exception:
        counters = {}
    try:
        hists = _tele.metrics_snapshot()[2]
    except Exception:
        hists = {}
    data: Dict = {"schema": PROFILE_SCHEMA, "meta": _capture_meta(note)}
    for key, fn in (
        ("verbs", lambda: _capture_verbs(counters, hists)),
        ("programs", _capture_programs),
        ("bucketing", lambda: _capture_bucketing(counters, hists)),
        ("serving", lambda: _capture_serving(counters, hists)),
        ("ingest", lambda: _capture_ingest(counters)),
        ("admission", lambda: _capture_admission(counters)),
    ):
        try:
            data[key] = fn()
        except Exception as e:
            data[key] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from . import costmodel as _cm

        res = _cm.residuals()
        ratios = [
            g["peak_ratio"] for g in res.get("groups", [])
            if g.get("peak_ratio") is not None
        ]
        data["residuals"] = {
            "warn_ratio": res["warn_ratio"],
            "fit": res["fit"],
            "programs": res["programs"],
            # roofline saturation rollup (the admission autotuner's
            # signal): the highest achieved-vs-datasheet-peak ratio any
            # (program x rung) group reached; honest None where no
            # datasheet peak exists (CPU)
            "peak_ratio_max": max(ratios) if ratios else None,
        }
    except Exception as e:
        data["residuals"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from . import autotune as _at

        data["autotune"] = _at.state()
    except Exception as e:
        data["autotune"] = {"error": f"{type(e).__name__}: {e}"}
    return WorkloadProfile(data)


def load(path: str) -> WorkloadProfile:
    """Read a profile written by `WorkloadProfile.save` (schema
    checked — a profile from an incompatible build refuses loudly)."""
    with open(path) as f:
        return WorkloadProfile(json.load(f))
