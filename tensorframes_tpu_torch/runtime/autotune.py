"""Closed-loop autotuner: the telemetry drives the knobs.

The PyTorch counterpart of `tensorframes_tpu/runtime/autotune.py`, with
its policies, watermarks, safety bounds and decision records. The knobs
it tunes — the bucket ladder the serving batcher pads to, the ingest
decode workers and prefetch depth, the serving batch window (per
endpoint) and the admission limit — are hand-set defaults; the
measurements that should set them (bucket-fill and serving histograms,
per-stage busy/starvation counters, roofline residuals) roll up into the
`WorkloadProfile`. This module closes the loop.

Design rules:

- **Policies are pure functions** ``observations -> recommendation``:
  every policy takes a profile snapshot (the `WorkloadProfile` data dict)
  plus the current knob values and returns `Recommendation`s —
  deterministic given its inputs, identical across processes (and across
  the two packages) for the same saved profile.
- **Pins win, always.** Tuned values flow through `config.set_tuned()`,
  which refuses any knob the operator set explicitly (`update()` /
  `override()` / a well-formed ``TFS_*`` env var).
- **Hysteresis + bounded steps.** Every policy has a dead band between its
  low and high watermarks, moves at most one bounded step per cycle, and
  the applied value is clamped to a per-knob safety range. The background
  loop tunes on PER-CYCLE deltas of the cumulative telemetry
  (`profile_delta`).
- **Every decision is observable**: a ``tuning``-kind span plus an
  ``autotune_adjustments{knob=}`` counter per applied change, and a
  bounded decision ring surfaced in ``tft.diagnostics()``, the ``/profile``
  snapshot (`state()`) and the flight recorder's bundles.

Entry points: ``tft.autotune(profile=...)`` — one-shot tuning from a live
snapshot or a saved `WorkloadProfile` (path or object);
``config.autotune`` / ``TFS_AUTOTUNE`` — the in-process background loop
(off by default: no thread starts, no knob is ever mutated).

The four policies:

========================  =============================================
knob(s)                   signal -> move
========================  =============================================
shape_bucket_growth/min   mean ``bucket_fill`` below FILL_LOW with few
                          observed rungs -> shrink growth; many observed
                          rungs with full buckets -> widen growth;
                          smallest observed rung far above the ladder
                          min -> raise the min (shorter warm ladders).
                          In the port the ladder is the serving
                          batcher's, whose fill (``verb=serve:<name>``)
                          the policy leaves to the window policy
ingest_decode_workers /   compute stage starved + decoders busy ->
stream_prefetch_depth     more workers (and depth >= workers); starved
                          but decoders idling -> deepen the delivery
                          queue; decoders idle and compute saturated
                          -> fewer workers
serve_batch_window_ms     per endpoint: shed or queue p99 near the
(per endpoint)            request budget -> shrink the window;
                          coalescing working with p99 headroom ->
                          widen it
max_concurrent_verbs      roofline-saturated card -> cap at the
                          observed peak in flight; shedding without
                          saturation -> raise the limit
========================  =============================================
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "Recommendation",
    "ladder_policy",
    "ingest_policy",
    "serving_policy",
    "admission_policy",
    "recommend",
    "apply",
    "autotune",
    "profile_delta",
    "AutoTuner",
    "maybe_start",
    "stop",
    "reset",
    "state",
    "decisions",
    "SAFETY_BOUNDS",
]


# ---------------------------------------------------------------------------
# tuning constants (watermarks, steps, safety bounds)
# ---------------------------------------------------------------------------

# bucket-ladder policy: act only below FILL_LOW / above FILL_HIGH mean
# fill — the band between is the dead band a borderline workload rests
# in. MIN_FILL_SAMPLES bucketed dispatches of evidence before moving.
FILL_LOW = 0.80
FILL_HIGH = 0.92
MIN_FILL_SAMPLES = 16
# raise shape_bucket_min only when the smallest rung any program
# actually dispatched sits at least this factor above it (a full
# hysteresis band), and by at most x8 per cycle
MIN_RAISE_FACTOR = 4
MIN_RAISE_STEP = 8

# ingest policy watermarks: compute-stage starved fraction and decode
# busy fraction, with a dead band between each pair
STARVED_HIGH = 0.25
STARVED_LOW = 0.05
DECODE_BUSY_HIGH = 0.50
DECODE_BUSY_LOW = 0.15
MIN_INGEST_CHUNKS = 8

# serving policy: shrink under pressure (shed, or queue p99 beyond
# PRESSURE_FRAC of the request budget); widen only with real
# coalescing (>= WIDEN_COALESCE requests/batch) AND p99 headroom
PRESSURE_FRAC = 0.25
HEADROOM_FRAC = 0.05
WIDEN_COALESCE = 1.5
MIN_SERVE_REQUESTS = 16

# admission policy: saturation watermarks on the roofline peak ratio
# (None on peak-less backends -> only the shed-without-saturation rule
# can fire), with MIN_ADMITTED verbs of evidence
SAT_HIGH = 0.50
SAT_LOW = 0.25
MIN_ADMITTED = 32

# hard safety ranges every applied value is clamped into — the tuner
# may only move knobs inside these, whatever a policy proposes
SAFETY_BOUNDS: Dict[str, tuple] = {
    "shape_bucket_growth": (1.05, 4.0),
    "shape_bucket_min": (1, 4096),
    "ingest_decode_workers": (1, 32),
    "stream_prefetch_depth": (1, 8),
    "serve_batch_window_ms": (0.5, 100.0),
    "max_concurrent_verbs": (1, 256),
}


@dataclass(frozen=True)
class Recommendation:
    """One policy's proposed knob move: ``scope`` is ``"config"`` or
    ``"endpoint:<name>"`` (the per-endpoint serving window), ``reason``
    is the human-readable why, ``signals`` the measurements it read."""

    knob: str
    scope: str
    current: object
    proposed: object
    reason: str
    signals: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "knob": self.knob,
            "scope": self.scope,
            "current": self.current,
            "proposed": self.proposed,
            "reason": self.reason,
            "signals": dict(self.signals),
        }


# ---------------------------------------------------------------------------
# profile readers
# ---------------------------------------------------------------------------


def _data(profile) -> Dict:
    """Accept a `WorkloadProfile`, its data dict, or a saved-profile
    path."""
    if isinstance(profile, str):
        from . import profiler as _prof

        return _prof.load(profile).data
    d = getattr(profile, "data", profile)
    if not isinstance(d, dict):
        raise TypeError(
            f"autotune wants a WorkloadProfile / data dict / path, got "
            f"{type(profile)}"
        )
    return d


def _hist_mean(hist: Optional[Dict]):
    """(mean, count) of a profile histogram dict; (None, 0) if empty."""
    if not hist or not hist.get("count"):
        return None, 0
    return hist["sum"] / hist["count"], int(hist["count"])


def _hist_quantile(hist: Optional[Dict], q: float) -> Optional[float]:
    """Upper BOUND of the bucket holding quantile ``q`` — a
    conservative (pessimistic) quantile read off fixed buckets. An
    observation in the +Inf bucket reports the top finite bound (an
    honest floor)."""
    if not hist or not hist.get("count"):
        return None
    n = int(hist["count"])
    target = q * n
    cum = 0
    buckets = hist["buckets"]
    for b, c in zip(buckets, hist["counts"][: len(buckets)]):
        cum += c
        if cum >= target:
            return float(b)
    return float(buckets[-1]) if buckets else None


def _clamp(knob: str, value):
    lo, hi = SAFETY_BOUNDS[knob]
    v = min(max(value, lo), hi)
    if isinstance(lo, int):
        v = int(round(v))
    return v


# ---------------------------------------------------------------------------
# the four policies (pure: profile data + current knobs in,
# recommendations out)
# ---------------------------------------------------------------------------


def ladder_policy(
    profile,
    growth: float,
    min_bucket: int,
    recompile_warn_shapes: int = 16,
) -> List[Recommendation]:
    """Tune the bucket ladder from observed bucket-fill economics and
    the dispatched-rung sets (the recompile-storm table's profile
    form). Growth moves by halving/doubling its EXCESS over 1
    (``1 + (g-1)/2`` / ``1 + (g-1)*2``), so it can never cross 1 and
    every step is bounded; the fill dead band [FILL_LOW, FILL_HIGH]
    is where a tuned workload comes to rest."""
    d = _data(profile)
    fill = d.get("bucketing", {}).get("fill", {}) or {}
    tot_sum = tot_n = 0.0
    for verb, h in fill.items():
        # serving fill (verb="serve:<endpoint>") is a batching-WINDOW
        # question, not ladder geometry: the batcher pads to the rung
        # itself and absorbs the waste, so it must not drive a ladder
        # re-shape that would invalidate every warm-compiled endpoint
        if str(verb).startswith("serve:"):
            continue
        m, n = _hist_mean(h)
        if m is not None:
            tot_sum += h["sum"]
            tot_n += n
    mean_fill = (tot_sum / tot_n) if tot_n else None
    rung_sets = [
        p.get("rungs", []) for p in d.get("programs", {}).values()
    ]
    max_rungs = max((len(r) for r in rung_sets), default=0)
    smallest_rung = min(
        (min(r) for r in rung_sets if r), default=None
    )
    signals = {
        "mean_fill": mean_fill,
        "fill_samples": int(tot_n),
        "max_rungs_per_program": max_rungs,
        "smallest_rung": smallest_rung,
    }
    out: List[Recommendation] = []
    if mean_fill is not None and tot_n >= MIN_FILL_SAMPLES:
        if mean_fill < FILL_LOW and max_rungs <= recompile_warn_shapes:
            proposed = _clamp(
                "shape_bucket_growth", round(1.0 + (growth - 1.0) / 2.0, 4)
            )
            if proposed < growth:
                out.append(Recommendation(
                    "shape_bucket_growth", "config", growth, proposed,
                    f"mean bucket fill {mean_fill:.3f} < {FILL_LOW} over "
                    f"{int(tot_n)} dispatch(es): the ladder pads away "
                    f"{(1 - mean_fill) * 100:.0f}% of dispatched rows — "
                    "shrink the growth toward the observed clustering",
                    signals,
                ))
        elif mean_fill > FILL_HIGH and max_rungs > recompile_warn_shapes:
            proposed = _clamp(
                "shape_bucket_growth", round(1.0 + (growth - 1.0) * 2.0, 4)
            )
            if proposed > growth:
                out.append(Recommendation(
                    "shape_bucket_growth", "config", growth, proposed,
                    f"{max_rungs} dispatched rungs on one program with "
                    f"mean fill {mean_fill:.3f}: compiles, not pad "
                    "waste, are the bottleneck — coarsen the ladder",
                    signals,
                ))
    if (
        smallest_rung is not None
        and tot_n >= MIN_FILL_SAMPLES
        and smallest_rung >= MIN_RAISE_FACTOR * min_bucket
    ):
        proposed = _clamp(
            "shape_bucket_min",
            min(int(smallest_rung), min_bucket * MIN_RAISE_STEP),
        )
        if proposed > min_bucket:
            out.append(Recommendation(
                "shape_bucket_min", "config", min_bucket, proposed,
                f"no program dispatched below rung {smallest_rung} "
                f"(ladder min {min_bucket}): raising the min shortens "
                "every warm-compile ladder without touching a rung "
                "traffic uses",
                signals,
            ))
    return out


def ingest_policy(
    profile,
    decode_workers: int,
    prefetch_depth: int,
    max_workers: Optional[int] = None,
) -> List[Recommendation]:
    """Tune decode workers / prefetch depth from the per-stage
    busy/starvation counters: the compute stage's wait fraction IS
    device starvation (`ingest/pipeline.py`), the decode stage's busy
    fraction says whether decoding is the reason."""
    if max_workers is None:
        max_workers = max(4, 2 * (os.cpu_count() or 1))
    stages = {
        k: v for k, v in (_data(profile).get("ingest", {}) or {}).items()
        if isinstance(v, dict)
    }
    comp = stages.get("compute", {})
    dec = stages.get("decode", {})
    chunks = min(comp.get("chunks", 0.0), dec.get("chunks", 0.0))
    if chunks < MIN_INGEST_CHUNKS:
        return []

    def _frac(st, key):
        busy, wait = st.get("busy_s", 0.0), st.get("wait_s", 0.0)
        tot = busy + wait
        return (st.get(key, 0.0) / tot) if tot > 0 else 0.0

    starved = _frac(comp, "wait_s")
    decode_busy = _frac(dec, "busy_s")
    signals = {
        "compute_starved_frac": round(starved, 4),
        "decode_busy_frac": round(decode_busy, 4),
        "chunks": chunks,
    }
    out: List[Recommendation] = []
    if starved > STARVED_HIGH:
        if decode_busy > DECODE_BUSY_HIGH:
            # compute starves while decoders run flat out: decoding is
            # the bottleneck — widen the pool (and keep the delivery
            # queue at least as deep, so the extra workers have
            # somewhere to put finished chunks)
            w = _clamp(
                "ingest_decode_workers",
                min(decode_workers + 1, max_workers),
            )
            if w > decode_workers:
                out.append(Recommendation(
                    "ingest_decode_workers", "config", decode_workers, w,
                    f"compute starved {starved * 100:.0f}% of its time "
                    f"while decoders were {decode_busy * 100:.0f}% busy "
                    "— the stream is decode-bound, add a worker",
                    signals,
                ))
            dp = _clamp("stream_prefetch_depth", w)
            if dp > prefetch_depth:
                out.append(Recommendation(
                    "stream_prefetch_depth", "config", prefetch_depth,
                    dp,
                    "keep the delivery queue at least as deep as the "
                    "decode pool",
                    signals,
                ))
        else:
            # starved although decoders idle on average: bursty decode
            # — a deeper delivery queue rides the bursts out
            dp = _clamp("stream_prefetch_depth", prefetch_depth + 1)
            if dp > prefetch_depth:
                out.append(Recommendation(
                    "stream_prefetch_depth", "config", prefetch_depth, dp,
                    f"compute starved {starved * 100:.0f}% of its time "
                    f"with decoders only {decode_busy * 100:.0f}% busy "
                    "— bursty decode, deepen the prefetch buffer",
                    signals,
                ))
    elif (
        starved < STARVED_LOW
        and decode_busy < DECODE_BUSY_LOW
        and decode_workers > 1
    ):
        out.append(Recommendation(
            "ingest_decode_workers", "config", decode_workers,
            _clamp("ingest_decode_workers", decode_workers - 1),
            f"decoders {decode_busy * 100:.0f}% busy and compute never "
            "starved: the pool is oversized, shed a worker",
            signals,
        ))
    return out


def serving_policy(
    profile,
    window_ms: float,
    default_timeout_s: float,
    endpoint_windows: Optional[Dict[str, float]] = None,
) -> List[Recommendation]:
    """Per-endpoint batch-window tuning from the latency-vs-fill
    serving histograms: widen while p99 queue headroom exists AND
    coalescing is actually happening; shrink the moment the lane sheds
    or queue p99 eats into the request budget.

    Attribution caveat: the queue-latency / requests-per-batch
    histograms are PROCESS-GLOBAL (the per-endpoint dimensions are the
    request/batch/shed counters), so the p99-pressure shrink is only
    trusted when exactly one endpoint is batching — with several, one
    hot endpoint's p99 must not shrink its healthy neighbors, and only
    each endpoint's OWN shed counter counts as pressure. The global
    p99 still gates widening for everyone: refusing to widen during
    someone else's overload is the safe direction."""
    d = _data(profile)
    srv = d.get("serving", {}) or {}
    eps = srv.get("endpoints", {}) or {}
    coalesce, _ = _hist_mean(srv.get("batch_requests"))
    p99_queue = _hist_quantile(srv.get("queue_seconds"), 0.99)
    batching_eps = [n for n, e in eps.items() if e.get("batches", 0)]
    out: List[Recommendation] = []
    for name in sorted(eps):
        ep = eps[name]
        if ep.get("requests", 0) < MIN_SERVE_REQUESTS:
            continue
        if not ep.get("batches", 0):
            continue  # unbatched endpoint: no window to tune
        cur = float(
            (endpoint_windows or {}).get(name, window_ms)
        )
        signals = {
            "requests": ep.get("requests", 0),
            "batches": ep.get("batches", 0),
            "shed": ep.get("shed", 0),
            "coalesce_mean": coalesce,
            "p99_queue_s": p99_queue,
            "budget_s": default_timeout_s,
        }
        pressure = bool(ep.get("shed", 0)) or (
            len(batching_eps) == 1
            and p99_queue is not None
            and p99_queue > PRESSURE_FRAC * default_timeout_s
        )
        headroom = (
            p99_queue is None
            or p99_queue <= HEADROOM_FRAC * default_timeout_s
        )
        if pressure:
            proposed = _clamp("serve_batch_window_ms", round(cur / 2.0, 3))
            if proposed < cur:
                out.append(Recommendation(
                    "serve_batch_window_ms", f"endpoint:{name}", cur,
                    proposed,
                    f"endpoint {name!r} under deadline pressure "
                    f"(shed={ep.get('shed', 0)}, queue p99="
                    f"{p99_queue}): shrink the coalescing window",
                    signals,
                ))
        elif (
            headroom
            and coalesce is not None
            and coalesce >= WIDEN_COALESCE
        ):
            proposed = _clamp("serve_batch_window_ms", round(cur * 1.5, 3))
            if proposed > cur:
                out.append(Recommendation(
                    "serve_batch_window_ms", f"endpoint:{name}", cur,
                    proposed,
                    f"endpoint {name!r} coalesces {coalesce:.1f} "
                    "request(s)/batch with p99 queue headroom: widen "
                    "the window for fuller batches",
                    signals,
                ))
    return out


def admission_policy(profile, limit: int) -> List[Recommendation]:
    """Tune ``max_concurrent_verbs`` from roofline-measured saturation
    (the residual join's ``peak_ratio_max`` — None on backends without
    datasheet peaks, where only the shed-without-saturation raise can
    fire) plus the admission ledger."""
    d = _data(profile)
    adm = d.get("admission", {}) or {}
    admitted = int(adm.get("admitted", 0))
    if admitted < MIN_ADMITTED:
        return []
    shed = int(adm.get("shed", 0))
    peak = int(adm.get("peak_in_flight", 0))
    res = d.get("residuals", {}) or {}
    sat = res.get("peak_ratio_max")
    signals = {
        "admitted": admitted, "shed": shed, "peak_in_flight": peak,
        "peak_ratio_max": sat,
    }
    if sat is not None and sat >= SAT_HIGH and peak > 0:
        target = max(1, peak)
        if limit <= 0 or limit > target:
            # step bound: halve an existing limit at most; an unlimited
            # gate jumps straight to the observed peak (that IS the
            # bounded move — it admits everything that ever ran at once)
            proposed = target if limit <= 0 else max(target, limit // 2)
            proposed = _clamp("max_concurrent_verbs", proposed)
            if proposed != limit:
                return [Recommendation(
                    "max_concurrent_verbs", "config", limit, proposed,
                    f"roofline saturation {sat:.2f} >= {SAT_HIGH}: "
                    f"admitting more than the observed peak in flight "
                    f"({peak}) only queues work on saturated devices",
                    signals,
                )]
    elif shed > 0 and limit > 0 and (sat is None or sat <= SAT_LOW):
        proposed = _clamp("max_concurrent_verbs", limit * 2)
        if proposed > limit:
            return [Recommendation(
                "max_concurrent_verbs", "config", limit, proposed,
                f"{shed} verb(s) shed with no measured saturation "
                f"(peak ratio {sat}): the limit is tighter than the "
                "hardware — raise it",
                signals,
            )]
    return []


# ---------------------------------------------------------------------------
# recommend: resolve current knobs, run every policy
# ---------------------------------------------------------------------------


def _effective_decode_workers(cfg_val: int) -> int:
    """Mirror `ingest.dataset._auto_decode_workers`: 0 = auto."""
    if cfg_val > 0:
        return cfg_val
    return max(1, min(4, os.cpu_count() or 1))


def recommend(profile=None, knobs: Optional[Dict] = None) -> List[Recommendation]:
    """Run every policy over ``profile`` (default: a live
    `runtime.profiler.snapshot()`) and return the recommendations —
    NOTHING is applied. ``knobs`` overrides the current knob values
    the policies compare against (default: the live config), which is
    how benches/tests evaluate a policy against hypothetical settings.
    Deterministic: the same profile + knobs always recommend the same
    moves."""
    if profile is None:
        from . import profiler as _prof

        profile = _prof.snapshot(note="autotune.recommend")
    from .. import config as _config

    cfg = _config.get()
    k = dict(knobs or {})

    def _knob(name, default):
        return k[name] if name in k else default

    recs: List[Recommendation] = []
    recs += ladder_policy(
        profile,
        growth=float(_knob("shape_bucket_growth", cfg.shape_bucket_growth)),
        min_bucket=int(_knob("shape_bucket_min", cfg.shape_bucket_min)),
        recompile_warn_shapes=int(
            _knob("recompile_warn_shapes", cfg.recompile_warn_shapes) or 16
        ),
    )
    recs += ingest_policy(
        profile,
        decode_workers=int(_knob(
            "ingest_decode_workers",
            _effective_decode_workers(cfg.ingest_decode_workers),
        )),
        prefetch_depth=int(
            _knob("stream_prefetch_depth", cfg.stream_prefetch_depth)
        ),
    )
    recs += serving_policy(
        profile,
        window_ms=float(
            _knob("serve_batch_window_ms", cfg.serve_batch_window_ms)
        ),
        default_timeout_s=float(
            _knob("serve_default_timeout_s", cfg.serve_default_timeout_s)
        ),
        endpoint_windows=k.get("endpoint_windows", _endpoint_windows()),
    )
    recs += admission_policy(
        profile,
        limit=int(_knob("max_concurrent_verbs", cfg.max_concurrent_verbs)),
    )
    return recs


def _endpoint_windows() -> Dict[str, float]:
    """Per-endpoint tuned windows currently in force (registered
    endpoints whose ``batch_window_ms`` the tuner set)."""
    try:
        from ..serving import registry as _reg

        out = {}
        for desc in _reg.endpoints():
            ep = _reg.get(desc["name"])
            if ep.batch_window_ms is not None:
                out[desc["name"]] = float(ep.batch_window_ms)
        return out
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# apply: pins, clamps, spans, counters, the decision ring
# ---------------------------------------------------------------------------

# bounded ring of every decision (applied AND skipped) for
# diagnostics / the profile snapshot
_DECISIONS: "deque" = deque(maxlen=64)


def decisions() -> List[Dict]:
    return list(_DECISIONS)


def apply(recs: List[Recommendation]) -> List[Dict]:
    """Apply recommendations through the tuned-config layer: a knob the
    operator pinned is SKIPPED (``outcome="skipped:pinned"``), applied
    values are clamped into `SAFETY_BOUNDS`, and every decision —
    applied or not — records a ``tuning``-kind span and lands in the
    decision ring; applied ones also count
    ``autotune_adjustments{knob=}``."""
    from .. import config as _config
    from ..utils import telemetry as _tele

    out: List[Dict] = []
    for r in recs:
        d = r.to_dict()
        d["at_unix"] = time.time()
        if r.scope == "config":
            val = _clamp(r.knob, r.proposed)
            # set_tuned is the atomic pin-check-and-write: its verdict
            # (not a separate is_explicit read) decides the outcome, so
            # an update() racing this cycle can never be misreported as
            # applied — or overwritten
            if _config.set_tuned(r.knob, val):
                d["outcome"] = "applied"
                d["applied_value"] = val
            else:
                d["outcome"] = "skipped:pinned"
        elif r.scope.startswith("endpoint:"):
            name = r.scope.split(":", 1)[1]
            if _config.is_explicit("serve_batch_window_ms"):
                # the global window pin covers its per-endpoint splits
                d["outcome"] = "skipped:pinned"
            else:
                try:
                    from ..serving import registry as _reg

                    ep = _reg.get(name)
                except Exception:
                    ep = None
                if ep is None:
                    d["outcome"] = "skipped:unknown-endpoint"
                else:
                    val = _clamp("serve_batch_window_ms", r.proposed)
                    ep.batch_window_ms = float(val)
                    d["outcome"] = "applied"
                    d["applied_value"] = float(val)
        else:
            d["outcome"] = f"skipped:unknown-scope:{r.scope}"
        with _tele.span(
            f"autotune.{r.knob}",
            kind="tuning",
            knob=r.knob,
            scope=r.scope,
            outcome=d["outcome"],
            current=r.current,
            proposed=r.proposed,
            reason=r.reason,
        ):
            pass
        if d["outcome"] == "applied":
            _tele.counter_inc("autotune_adjustments", 1.0, knob=r.knob)
            from ..utils.log import get_logger

            get_logger("autotune").info(
                "tuned %s (%s): %s -> %s — %s",
                r.knob, r.scope, r.current, d["applied_value"], r.reason,
            )
        _DECISIONS.append(d)
        out.append(d)
    if any(
        d["outcome"] == "applied"
        and d["knob"] in ("shape_bucket_growth", "shape_bucket_min")
        for d in out
    ):
        # a ladder re-shape moves every rung: warmed serving endpoints
        # would otherwise meet new rung shapes on the request path.
        # Re-warm here — off the request path — instead.
        _rewarm_endpoints()
    return out


def _rewarm_endpoints() -> None:
    """Warm the CURRENT ladder's rungs for every previously warmed serving
    endpoint (no-op when serving is idle/unused)."""
    try:
        from ..serving import registry as _reg

        for desc in _reg.endpoints():
            ep = _reg.get(desc["name"])
            if ep.warmed_rungs:
                ep.warm()
    except Exception:
        from ..utils.log import get_logger

        get_logger("autotune").warning(
            "endpoint re-warm after ladder change failed", exc_info=True
        )


def autotune(profile=None, apply_recommendations: bool = True,
             knobs: Optional[Dict] = None) -> Dict:
    """One-shot tuning pass, exposed as ``tfs.autotune()``: recommend
    from ``profile`` (a `WorkloadProfile`, a saved-profile path, or
    None for a live snapshot) and — unless
    ``apply_recommendations=False`` — apply through the pin-respecting
    tuned layer. Returns ``{"recommendations": [...], "applied":
    [...]}`` (``applied`` holds the decision records, including
    skips)."""
    recs = recommend(profile, knobs=knobs)
    return {
        "recommendations": [r.to_dict() for r in recs],
        "applied": apply(recs) if apply_recommendations else [],
    }


# ---------------------------------------------------------------------------
# per-cycle deltas for the background loop
# ---------------------------------------------------------------------------


def _hist_delta(cur: Optional[Dict], prev: Optional[Dict]):
    if not cur:
        return cur
    if not prev or list(prev.get("buckets", [])) != list(cur["buckets"]):
        return dict(cur)  # ladder changed (or first cycle): take current
    return {
        "buckets": list(cur["buckets"]),
        "counts": [
            max(0, a - b) for a, b in zip(cur["counts"], prev["counts"])
        ],
        "sum": max(0.0, cur["sum"] - prev["sum"]),
        "count": max(0, cur["count"] - prev["count"]),
    }


def profile_delta(cur, prev) -> Dict:
    """The PER-CYCLE view of two cumulative profile snapshots: counter
    sections subtract, histograms subtract bucket-wise, structural
    sections (programs/rungs, residuals) ride the current snapshot.
    This is what lets the background loop tune on what happened since
    its last look instead of on all of history — apply a fix and the
    next cycle's signal reflects the fix, not the past."""
    c, p = _data(cur), _data(prev) if prev is not None else {}
    if not p:
        return dict(c)
    out = dict(c)
    cb, pb = c.get("bucketing", {}) or {}, p.get("bucketing", {}) or {}
    out["bucketing"] = {
        "padded_dispatches": max(
            0, cb.get("padded_dispatches", 0)
            - pb.get("padded_dispatches", 0)
        ),
        "pad_rows": max(0, cb.get("pad_rows", 0) - pb.get("pad_rows", 0)),
        "fill": {
            verb: _hist_delta(h, pb.get("fill", {}).get(verb))
            for verb, h in (cb.get("fill", {}) or {}).items()
        },
    }
    ci, pi = c.get("ingest", {}) or {}, p.get("ingest", {}) or {}
    out["ingest"] = {
        stage: {
            k: max(0.0, st.get(k, 0.0) - pi.get(stage, {}).get(k, 0.0))
            for k in ("chunks", "busy_s", "wait_s")
        }
        for stage, st in ci.items()
        if isinstance(st, dict)
    }
    cs, ps = c.get("serving", {}) or {}, p.get("serving", {}) or {}
    out["serving"] = {
        "endpoints": {
            name: {
                k: max(
                    0, ep.get(k, 0)
                    - ps.get("endpoints", {}).get(name, {}).get(k, 0)
                )
                for k in ("requests", "batches", "shed")
            }
            for name, ep in (cs.get("endpoints", {}) or {}).items()
        },
        **{
            k: _hist_delta(cs.get(k), ps.get(k))
            for k in ("batch_rows", "batch_requests", "queue_seconds")
        },
    }
    ca, pa = c.get("admission", {}) or {}, p.get("admission", {}) or {}
    out["admission"] = {
        "admitted": max(0, ca.get("admitted", 0) - pa.get("admitted", 0)),
        "shed": max(0, ca.get("shed", 0) - pa.get("shed", 0)),
        # peak is a cumulative high-water mark; the current value is
        # the honest read either way
        "peak_in_flight": ca.get("peak_in_flight", 0),
        "wait_seconds": max(
            0.0, ca.get("wait_seconds", 0.0) - pa.get("wait_seconds", 0.0)
        ),
        "deadline_exceeded": ca.get("deadline_exceeded", {}),
    }
    return out


# ---------------------------------------------------------------------------
# the background loop
# ---------------------------------------------------------------------------


class AutoTuner:
    """The in-process feedback loop: every ``interval_s``, snapshot the
    live profile, diff against the previous cycle, recommend, apply.
    One per process (`maybe_start`); a daemon thread that never blocks
    interpreter exit."""

    def __init__(self, interval_s: Optional[float] = None):
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev = None
        self.cycles = 0

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def cycle(self) -> List[Dict]:
        """One deterministic tuning step (what the loop runs; callable
        directly from tests/benches): snapshot -> delta vs the previous
        cycle -> recommend -> apply."""
        from . import profiler as _prof

        cur = _prof.snapshot(note="autotune.cycle")
        delta = profile_delta(cur, self._prev)
        self._prev = cur
        self.cycles += 1
        from .profiler import WorkloadProfile

        return apply(recommend(WorkloadProfile(delta)))

    def _interval(self) -> float:
        if self.interval_s is not None:
            return float(self.interval_s)
        from .. import config as _config

        return max(
            1.0, float(getattr(_config.get(), "autotune_interval_s", 30.0))
        )

    def _run(self) -> None:
        while not self._stop.wait(self._interval()):
            try:
                self.cycle()
            except Exception:  # the loop must never die of one bad cycle
                from ..utils.log import get_logger

                get_logger("autotune").warning(
                    "autotune cycle failed", exc_info=True
                )

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tfs-autotune"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None


_tuner: Optional[AutoTuner] = None
_tuner_lock = threading.Lock()


def maybe_start() -> Optional[AutoTuner]:
    """Start the background loop IFF ``config.autotune`` is on (the
    import-time hook, like `telemetry.maybe_serve`). With the knob off
    — the default — this is a strict no-op: no thread, no state."""
    from .. import config as _config

    if not getattr(_config.get(), "autotune", False):
        return None
    global _tuner
    with _tuner_lock:
        if _tuner is None:
            _tuner = AutoTuner()
        _tuner.start()
        return _tuner


def stop() -> None:
    """Stop the background loop (test/teardown hook); keeps tuned
    values in force — `config.reset_tuning()` reverts those. The join
    happens OUTSIDE the module lock: a cycle mid-`snapshot()` calls
    `state()`, which takes the same lock — joining under it would
    always time out and leak the thread past the stop."""
    global _tuner
    with _tuner_lock:
        tuner, _tuner = _tuner, None
    if tuner is not None:
        tuner.stop()


def reset() -> None:
    """Stop the loop, forget the decision ring, and clear every tuned
    per-endpoint batch window (the tuned CONFIG values are
    `config.reset_tuning()`'s job — the two compose in the conftest
    autouse fixture and form the operator's full undo)."""
    stop()
    _DECISIONS.clear()
    try:
        from ..serving import registry as _reg

        for desc in _reg.endpoints():
            _reg.get(desc["name"]).batch_window_ms = None
    except Exception:
        pass  # serving never imported: no endpoint windows to clear


def state() -> Dict:
    """The tuner's live state for ``tfs.diagnostics()`` and the
    ``/profile`` snapshot: enabled/running flags, every currently
    tuned knob, the pin set it must respect, per-endpoint tuned
    windows, and the recent decision ring."""
    from .. import config as _config

    cfg = _config.get()
    with _tuner_lock:
        running = _tuner.running if _tuner is not None else False
        cycles = _tuner.cycles if _tuner is not None else 0
    return {
        "enabled": bool(getattr(cfg, "autotune", False)),
        "running": running,
        "cycles": cycles,
        "interval_s": float(getattr(cfg, "autotune_interval_s", 30.0)),
        "tuned": _config.tuned(),
        "pinned": sorted(_config.explicit_keys()),
        "endpoint_windows": _endpoint_windows(),
        "decisions": decisions(),
    }
