"""The traced run's device trace: `torch.profiler` over the window, reduced
to what the per-layer metrics and the breakdown read.

The summary holds the union of the device's activity intervals (kernels,
copies, sets) inside the window (``busy_s``), each kernel name's count and
summed device seconds, the ten device operations that took most time, and
the idle time between device activity summed by what the host was doing
then: the benchmark's own span (``portbench.call`` around each call) and
the innermost host operation running at each gap's middle.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_SPAN_PREFIX = "portbench."
CALL_SPAN = _SPAN_PREFIX + "call"  # the host span around each call of the window
_NAME_CHARS = 160  # kernel names are C++ templates: keep the head of each
_CANDIDATES = 64  # host operations searched for the innermost at a gap


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def summary(self, t0_ns: int, t1_ns: int, window_s: float) -> Dict:
        events = self._prof.profiler.kineto_results.events()
        return summarize(events, t0_ns, t1_ns, window_s)


def _is_device(e) -> bool:
    return e.device_type().name == "CUDA"


def summarize(events, t0_ns: int, t1_ns: int, window_s: float) -> Dict:
    dev: List = []
    host: List = []
    for e in events:
        name = e.name()
        if _is_device(e):
            if not e.is_user_annotation() and not name.startswith(_SPAN_PREFIX):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    kernels: Dict[str, List[float]] = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (min(t, t1_ns) - max(s, t0_ns)) / 1e9 if t > t0_ns and s < t1_ns else 0.0
    busy_ns, gaps = _union_and_gaps(dev, t0_ns, t1_ns)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "kernels": {n: {"count": c, "seconds": s} for n, (c, s) in kernels.items()},
        "device_ops": [[n[:_NAME_CHARS], s] for n, (c, s) in top],
        "idle_gaps": _label_gaps(gaps, host),
    }


def _union_and_gaps(dev, t0_ns: int, t1_ns: int):
    """(busy nanoseconds, gaps as an (n, 2) array) of the device intervals
    clipped to [t0, t1]."""
    if not dev:
        return 0, np.asarray([[t0_ns, t1_ns]], dtype=np.int64)
    iv = np.asarray([(s, t) for s, t, _ in dev], dtype=np.int64)
    iv = np.clip(iv, t0_ns, t1_ns)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new busy run starts where an interval begins after every earlier end
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    run_ends = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    busy = int((run_ends - starts).sum())
    lo = np.concatenate([[t0_ns], run_ends])
    hi = np.concatenate([starts, [t1_ns]])
    keep = hi > lo
    return busy, np.stack([lo[keep], hi[keep]], axis=1)


def _label_gaps(gaps, host) -> List[List]:
    """The ten largest sums of idle seconds by what the host was doing at
    each gap's middle: the benchmark's span around it (or none) and the
    innermost host operation running then (among the last `_CANDIDATES` to
    start: host operations nest, so the innermost started last)."""
    if len(gaps) == 0:
        return []
    length = (gaps[:, 1] - gaps[:, 0]) / 1e9
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    spans = sorted((s, t, n) for s, t, n in host if n.startswith(_SPAN_PREFIX))
    ops = sorted((s, t, n) for s, t, n in host if not n.startswith(_SPAN_PREFIX))
    outer = np.full(len(mids), "outside calls", dtype=object)
    if spans:
        ss = np.asarray([s for s, _, _ in spans], dtype=np.int64)
        se = np.asarray([t for _, t, _ in spans], dtype=np.int64)
        j = np.searchsorted(ss, mids, side="right") - 1
        inside = (j >= 0) & (se[np.maximum(j, 0)] >= mids)
        names = np.asarray([n for _, _, n in spans], dtype=object)
        outer[inside] = names[j[inside]]
    inner = np.full(len(mids), "", dtype=object)
    if ops:
        os_ = np.asarray([s for s, _, _ in ops], dtype=np.int64)
        oe = np.asarray([t for _, t, _ in ops], dtype=np.int64)
        names = np.asarray([n[:_NAME_CHARS] for _, _, n in ops], dtype=object)
        last = np.searchsorted(os_, mids, side="right") - 1
        for lo in range(0, len(mids), 1 << 14):
            sl = slice(lo, lo + (1 << 14))
            cand = last[sl, None] - np.arange(_CANDIDATES)[None, :]
            ok = cand >= 0
            c = np.maximum(cand, 0)
            ok &= oe[c] >= mids[sl, None]
            dur = np.where(ok, oe[c] - os_[c], np.iinfo(np.int64).max)
            best = np.argmin(dur, axis=1)
            found = ok[np.arange(len(best)), best]
            pick = c[np.arange(len(best)), best]
            inner[sl] = np.where(found, names[pick], "")
    sums: Dict[str, float] = {}
    for o, i, g in zip(outer, inner, length):
        label = f"{o} > {i}" if i else o
        sums[label] = sums.get(label, 0.0) + float(g)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]
