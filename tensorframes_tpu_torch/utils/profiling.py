"""Plan counters: which execution plan a verb took.

The PyTorch counterpart of the counter surface of
`tensorframes_tpu/utils/profiling.py` (``count`` / ``stats`` /
``reset_stats``), with the same keys: ``aggregate.plan.segment``,
``aggregate.plan.exact``, and the port's own keys:

- ``reduce_rows.plan.monoid`` / ``reduce_rows.plan.general``;
- ``map_rows.plan.vmap`` (no control flow), ``map_rows.plan.lifted`` (a
  row-local graph with control flow, run once per block) and
  ``map_rows.plan.per_row`` (any other graph with control flow);
- ``map_rows.plan.ragged``: a `map_rows` over ragged columns, one plan
  run per shape bucket; ``map_rows.ragged.buckets``: those buckets;
- ``host_sync``: a device column's first copy to the host
  (`Column.host_values`);
- ``control.cond.host_syncs``: host reads of a scalar `_Cond` predicate;
  ``control.while.trips`` / ``control.while.host_syncs``: trips of a
  scalar `_While` and host reads of its predicate;
- ``vectorize.lowered.cond`` / ``vectorize.lowered.while``: masked dense
  lowerings run (one per call of the rule, not per compile as in the JAX
  package); ``vectorize.while.trips`` / ``vectorize.while.host_syncs``:
  dense trips of a masked `_While` and its ``active.any()`` reads;
  ``vectorize.fallback.<reason>``: graphs kept off the row-local path.

Meta-device probes (`graph.analysis`) count nothing.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

__all__ = ["count", "stats", "reset_stats"]

_counts: Counter = Counter()
_lock = threading.Lock()


def count(key: str, value: float = 1.0) -> None:
    """Bump a named counter (e.g. which aggregate plan engaged)."""
    with _lock:
        _counts[key] += value


def stats() -> Dict[str, float]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset_stats() -> None:
    with _lock:
        _counts.clear()
