"""Plan counters: which execution plan a verb took.

The PyTorch counterpart of the counter surface of
`tensorframes_tpu/utils/profiling.py` (``count`` / ``stats`` /
``reset_stats``), with the same keys: ``aggregate.plan.segment``,
``aggregate.plan.exact``, and the port's own ``reduce_rows.plan.monoid``
and ``reduce_rows.plan.general``.
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
