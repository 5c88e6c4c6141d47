"""The host's milliseconds inside a verb call: the median, over the window's
calls, of each call's root ``verb`` span from the verb's entry to its return
(the harness synchronises after it), in ms.

The program's spans (`tensorframes_tpu_torch.utils.telemetry`) are read after
the window, their device times resolved first: the window's calls are the last
``run.calls`` root verb spans of the ring, since the harness calls no verb
between the window's last call and the readers. `window` raises where the ring
holds fewer, and the readers where a window call lacks a span they need. A
program whose verbs keep no span of their own (one without
`utils.profiling.verb_entry`) gives None."""

import statistics


def window(run):
    """(the window's root verb spans, oldest first; every span of the ring
    by its parent's id), or None where the program has no verb spans."""
    from tensorframes_tpu_torch.utils import profiling, telemetry

    if not hasattr(profiling, "verb_entry"):
        return None
    telemetry.resolve_device_times()
    spans = telemetry.spans()
    roots = [s for s in spans if s.kind == "verb" and s.parent_id is None]
    if len(roots) < run.calls:
        raise RuntimeError(f"{len(roots)} root verb spans in the ring for {run.calls} calls")
    children = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    return roots[len(roots) - run.calls:], children


def descendants(span, children):
    """Every span under ``span``."""
    out, todo = [], [span.span_id]
    while todo:
        for c in children.get(todo.pop(), ()):
            out.append(c)
            todo.append(c.span_id)
    return out


def read(run):
    w = window(run)
    if w is None:
        return None
    return 1e3 * statistics.median(s.seconds for s in w[0])
