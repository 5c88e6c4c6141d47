"""Seconds from the process's start to the window's start: imports, the
kernels' build where the checkout has none, inputs and weights drawn on the
card, and the warm-up calls (host clock)."""


def read(run):
    return run.setup_s
