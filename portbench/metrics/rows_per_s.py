"""Table rows aggregated in the window, on every rank, over the window's
seconds (host clock, from the first call's start to the last call's end)."""


def read(run):
    return run.work["items"] * run.calls / run.window_s
