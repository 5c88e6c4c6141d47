"""The host's milliseconds of a verb call in the front end's own code: the
median, over the window's calls, of the root ``verb`` span's time not covered
by the union of its child spans (block dispatches, plan stages: what is left
is planning and output assembly), in ms. The window as in `verb_host_ms`."""

import statistics

from portbench.metrics.verb_host_ms import window


def _uncovered(verb, kids) -> float:
    ivs = sorted((max(c.t0, verb.t0), min(c.t1, verb.t1)) for c in kids)
    covered, end = 0.0, verb.t0
    for lo, hi in ivs:
        lo = max(lo, end)
        if hi > lo:
            covered += hi - lo
            end = hi
    return verb.seconds - covered


def read(run):
    w = window(run)
    if w is None:
        return None
    roots, children = w
    return 1e3 * statistics.median(_uncovered(v, children.get(v.span_id, ())) for v in roots)
