"""The 95th percentile of the window's call times in milliseconds: a call
from the moment it is issued until its outputs are ready on the card, on every rank
(host clock). Linear interpolation between order statistics."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
