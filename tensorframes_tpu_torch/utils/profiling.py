"""Plan counters: which execution plan a verb took.

The PyTorch counterpart of the counter surface of
`tensorframes_tpu/utils/profiling.py` (``count`` / ``stats`` /
``reset_stats``), with the same keys: ``aggregate.plan.segment``,
``aggregate.plan.exact``, ``aggregate.plan.chunk``, and the port's own
keys:

- ``reduce_rows.plan.monoid`` / ``reduce_rows.plan.general``;
- ``map_rows.plan.vmap`` (a graph that does not lift: conds select and
  loops run batched under `torch.func.vmap`), ``map_rows.plan.lifted`` (a
  row-local graph with control flow, run once per block) and
  ``map_rows.plan.per_row`` (control flow with ``config.row_vectorize``
  off);
- ``map_rows.plan.ragged``: a `map_rows` over ragged columns, one plan
  run per shape bucket; ``map_rows.ragged.buckets``: those buckets;
- ``host_sync``: a device column's first copy to the host
  (`Column.host_values`);
- ``control.cond.host_syncs``: host reads of a scalar `_Cond` predicate;
  ``control.while.trips`` / ``control.while.host_syncs``: trips of a
  scalar `_While`, or of one batched under `vmap` (the trips of its
  longest row), and host reads of its predicate;
- ``vectorize.lowered.cond`` / ``vectorize.lowered.while``: masked dense
  lowerings run (one per call of the rule, not per compile as in the JAX
  package); ``vectorize.while.trips`` / ``vectorize.while.host_syncs``:
  dense trips of a masked `_While` and its ``active.any()`` reads;
  ``vectorize.fallback.<reason>``: graphs kept off the row-local path
  (``cond-branch-not-row-local``, ``while-body-not-row-local``, ...) or
  off any one-call plan (``disabled``).

Meta-device probes (`graph.analysis`) count nothing.

`record(verb, rows)` times one verb call on one clock, as the JAX
package's: a ``verb`` span, the telemetry counters ``<verb>.calls`` /
``.seconds`` / ``.rows`` and the ``verb_seconds{verb=}`` histogram.
`verb_entry(verb)` wraps a verb so that each call is one `record` with
its input frame's rows: every public verb keeps its span there
(`runtime.deadline.deadline_entry` applies it to the verbs that take a
budget).

`trace(logdir)` records a `torch.profiler` trace of the enclosed region
(CPU and, on a card, CUDA activity) into ``logdir`` as Chrome trace JSON;
`annotate(name)` labels a region on that timeline
(`torch.profiler.record_function`).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import Counter
from typing import Dict

__all__ = ["count", "stats", "reset_stats", "record", "verb_entry", "trace", "annotate"]

_counts: Counter = Counter()
_lock = threading.Lock()


def count(key: str, value: float = 1.0) -> None:
    """Bump a named counter (e.g. which aggregate plan engaged)."""
    with _lock:
        _counts[key] += value


def stats() -> Dict[str, float]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset_stats() -> None:
    with _lock:
        _counts.clear()


@contextlib.contextmanager
def record(verb: str, rows: int = 0):
    """Time one verb call: a ``verb`` span (when telemetry is on), the
    telemetry counters ``<verb>.calls`` / ``.seconds`` (and ``.rows`` for a
    nonzero ``rows``), and the ``verb_seconds{verb=}`` histogram. One
    clock: the span's own ``t0``/``t1`` feed the counter and the histogram;
    a second pair is read only when telemetry is off and no span is kept."""
    from . import telemetry as _tele

    ctx = _tele.span(verb, kind="verb", rows=rows or None)
    t0 = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        dt = getattr(ctx, "seconds", None)
        if dt is None:  # telemetry off: the shared no-op context
            dt = time.perf_counter() - t0
        _tele.counter_inc(f"{verb}.calls")
        _tele.counter_inc(f"{verb}.seconds", dt)
        if rows:
            _tele.counter_inc(f"{verb}.rows", float(rows))
        if _tele.enabled():
            _tele.histogram_observe("verb_seconds", dt, verb=verb)


def input_rows(frame) -> int:
    """Rows of a verb's input: a frame's (plain, lazy, global or spanning),
    a `GroupedFrame`'s frame's; 0 for anything else (a stream's iterator
    of chunks)."""
    if hasattr(frame, "keys") and hasattr(frame, "frame"):  # a GroupedFrame
        frame = frame.frame
    n = getattr(frame, "nrows", 0)
    return n if isinstance(n, int) else 0


def verb_entry(verb: str, frame_at: int = 1):
    """Decorator: each call of the verb is one `record(verb, rows)`, with
    ``rows`` those of its input frame, the positional argument
    ``frame_at`` (0 for a frame's own method), else ``frame=`` or
    ``grouped=``. A verb that another verb calls records a span nested in
    the caller's."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if len(args) > frame_at:
                frame = args[frame_at]
            else:
                frame = kwargs.get("frame", kwargs.get("grouped"))
            with record(verb, input_rows(frame)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `torch.profiler` trace of the enclosed region into
    ``logdir`` (one ``trace.json``, loadable in Perfetto): host activity,
    and the card's kernels when CUDA is available. Yields the profiler."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the profiler timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
