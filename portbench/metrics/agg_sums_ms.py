"""The aggregate's reductions on the card: the median, over the window's calls,
of each call's device milliseconds summed over its ``aggregate.*`` dispatch
spans (the segment plan's one dispatch: the row-wise transform, the group
counts and the segment sums; the sorted plans' per-size calls), whichever plan
ran. The window as in `verb_host_ms`; raises where a window call has no such
span."""

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
        disp = [s for s in descendants(v, children)
                if s.kind == "dispatch" and s.name.startswith("aggregate.")]
        if not disp:
            raise RuntimeError(f"agg_sums_ms: the {v.name} call {v.span_id} has no aggregate dispatch span")
        per_call.append(sum(telemetry.exec_seconds(s) for s in disp))
    return 1e3 * statistics.median(per_call)
