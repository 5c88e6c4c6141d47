"""The keyed aggregate's share of its bytes bound: what one card's share of
a call must move (keys and values read once, the tables written once) at
3.35 TB/s, times the calls, over the card's busy seconds in the traced
window (averaged over the ranks), in %."""

from portbench.yardstick import bytes_bound_s


def read(run):
    busy = run.mean_busy_s()
    if not busy:
        return None
    return 100.0 * bytes_bound_s(run.work["bytes"]) * run.calls / busy
