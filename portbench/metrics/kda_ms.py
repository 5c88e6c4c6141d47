"""The KDA layers' own work on the card: the median, over the window's
calls, of each call's device milliseconds summed over its ``kda.prep`` (the
short convolutions, SiLU, the L2 norms, the decay and beta from their
products), ``kda.core`` (the recurrence kernel) and ``kda.out`` (the output
gate's sigmoid and the gated norm) spans, timed by their event pairs (the
host spans off a card). The layers' products lie outside the spans:
`gemm_roofline` reads them. The window as in `verb_host_ms`. None where no
window call has such a span (a program without the layer); raises where
some have and some have not."""

import statistics

from portbench.metrics.moe_route_ms import per_call_seconds

_SPANS = ("kda.prep", "kda.core", "kda.out")


def read(run):
    per_call = per_call_seconds(run, _SPANS)
    return None if per_call is None else 1e3 * statistics.median(per_call)
