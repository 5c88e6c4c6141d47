"""The routed-expert layer's dispatch on the card: the median, over the
window's calls, of each call's device milliseconds summed over its
``moe.route`` and ``moe.combine`` spans (gate, softmax, top k, the pairs'
sort and gather, the counts' host read; the weighted scatter back), timed by
their event pairs (the host spans off a card). The window as in
`verb_host_ms`. None where no window call has such a span (a program
without the layer); raises where some have and some have not."""

import statistics

from portbench.metrics.verb_host_ms import descendants, window

_SPANS = ("moe.route", "moe.combine")


def per_call_seconds(run, names):
    """Each window call's summed exec seconds of its spans named in
    ``names``, or None where no call has one."""
    from tensorframes_tpu_torch.utils import telemetry

    w = window(run)
    if w is None:
        return None
    roots, children = w
    found = [[s for s in descendants(v, children) if s.name in names] for v in roots]
    if not any(found):
        return None
    if not all(found):
        raise RuntimeError(f"a window call has no {' / '.join(names)} span")
    return [sum(telemetry.exec_seconds(s) for s in spans) for spans in found]


def read(run):
    per_call = per_call_seconds(run, _SPANS)
    return None if per_call is None else 1e3 * statistics.median(per_call)
