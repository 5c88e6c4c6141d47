"""The bucket ladder: the serving half of `tensorframes_tpu/shape_policy.py`.

Rung k of the ladder holds ``shape_bucket_min * shape_bucket_growth^k``
rows (rounded up, each rung strictly larger than the last). The serving
micro-batcher pads every coalesced dispatch to a rung with `pad_lead`
(the last valid row replicated), so the shapes steady-state traffic
dispatches are the ladder's, and `serving.Endpoint.warm` can run each of
them once at registration. Padding is safe only for row-local programs:
`rowwise_fetches` is the registry's batchability test, the same walk the
port's chunked reduce planner runs (`aggregate._rowwise_transform`).

The verbs' own bucketing and masked reduces are not in the port: eager
PyTorch builds nothing per shape, so the port's verbs dispatch each block
at its own size. Only the batcher pads, and it pads to its own rung.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .aggregate import _rowwise_transform
from .graph.ir import Graph

__all__ = [
    "bucket_for",
    "bucket_ladder",
    "observe_fill",
    "pad_lead",
    "rowwise_fetches",
]


def bucket_for(
    n: int,
    growth: Optional[float] = None,
    min_bucket: Optional[int] = None,
) -> int:
    """Smallest ladder rung >= ``n``; ``n <= 0`` maps to 0."""
    from . import config as _config

    cfg = _config.get()
    g = float(growth if growth is not None else cfg.shape_bucket_growth)
    b = int(min_bucket if min_bucket is not None else cfg.shape_bucket_min)
    if g <= 1.0:
        raise ValueError(f"shape_bucket_growth must be > 1, got {g}")
    if b < 1:
        raise ValueError(f"shape_bucket_min must be >= 1, got {b}")
    if n <= 0:
        return 0
    while b < n:
        b = max(b + 1, int(-(-b * g // 1)))  # ceil(b * g), monotone
    return b


def bucket_ladder(
    max_rows: int,
    growth: Optional[float] = None,
    min_bucket: Optional[int] = None,
) -> List[int]:
    """The distinct rungs covering sizes 1..max_rows."""
    rungs: List[int] = []
    n = 1
    while n <= max_rows:
        r = bucket_for(n, growth, min_bucket)
        rungs.append(r)
        n = r + 1
    return rungs


def pad_lead(a, n: int, bucket: int):
    """Pad ``a``'s lead dim from ``n`` to ``bucket`` rows by replicating
    the last valid row (numerically ordinary pad rows). A tensor pads on
    its own device; host arrays with numpy."""
    if bucket <= n:
        return a
    rep = (bucket - n,) + tuple(a.shape[1:])
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(rep)])
    a = np.asarray(a)
    return np.concatenate([a, np.broadcast_to(a[-1:], rep)])


def observe_fill(n: int, bucket: int, verb: str) -> None:
    """One padded dispatch's fill fraction (valid rows / rung rows) into
    the ``bucket_fill{verb=}`` histogram (gated on telemetry)."""
    from .utils import telemetry as _tele

    if bucket <= 0 or not _tele.enabled():
        return
    _tele.histogram_observe("bucket_fill", min(1.0, n / bucket), verb=verb)


def rowwise_fetches(
    graph: Graph, fetches: Sequence[str], ph_ranks: Dict[str, int]
) -> bool:
    """True when every fetch is a row-local function of the placeholders
    (output row i depends only on input row i), so pad rows cannot
    perturb valid rows and slicing the output undoes the padding."""
    return _rowwise_transform(graph, list(fetches), ph_ranks.get)
