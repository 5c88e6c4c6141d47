"""The aggregate's key stage on the card: the median, over the window's calls,
of the device milliseconds of each call's ``aggregate.keys`` span (the keys'
factorization, timed by its event pair; the host span off a card). The window
as in `verb_host_ms`; raises where a window call has no such span."""

import statistics

from portbench.metrics.verb_host_ms import descendants, window


def read(run):
    from tensorframes_tpu_torch.utils import telemetry

    w = window(run)
    if w is None:
        return None
    roots, children = w
    per_call = []
    for v in roots:
        keys = [s for s in descendants(v, children) if s.name == "aggregate.keys"]
        if not keys:
            raise RuntimeError(f"agg_keys_ms: the {v.name} call {v.span_id} has no aggregate.keys span")
        per_call.append(sum(telemetry.exec_seconds(s) for s in keys))
    return 1e3 * statistics.median(per_call)
