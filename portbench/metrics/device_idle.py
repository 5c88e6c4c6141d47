"""The share of the traced window in which no operation ran on the card:
1 - (the union of its kernel, copy and set intervals) / (the window), in %."""


def read(run):
    busy = run.mean_busy_s()
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / run.window_s)
