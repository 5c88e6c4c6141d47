"""Executor: build-once, run-many graph execution.

The PyTorch counterpart of `tensorframes_tpu/runtime/executor.py`. A graph
is lowered once per (kind, graph fingerprint, fetches, feeds, device) and
the callable is kept in a thread-safe LRU, so B blocks cost one lowering
and B eager calls. `torch.compile` and CUDA graphs are later work.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..graph.ir import Graph
from ..ops.lowering import build_callable

__all__ = ["Executor", "default_executor"]


class Executor:
    """LRU of lowered callables. A miss builds OUTSIDE the lock (lowering
    folds constants and uploads them); a lost insert race keeps the
    winner's callable and costs only the redundant build."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._lock = threading.Lock()
        self.compile_count = 0  # distinct lowered callables built
        self.cache_hits = 0
        self.cache_misses = 0

    def cached(
        self,
        kind: str,
        graph: Graph,
        fetches: Sequence[str],
        feed_names: Sequence[str],
        device: torch.device,
        make: Callable[[], Callable],
    ) -> Callable:
        """``kind`` distinguishes execution styles of one graph (a block
        call, a per-row vmap)."""
        key = (kind, graph.fingerprint(), tuple(fetches), tuple(feed_names), str(device))
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                return fn
        fn = make()
        with self._lock:
            winner = self._cache.get(key)
            if winner is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                return winner
            self._cache[key] = fn
            self.compile_count += 1
            self.cache_misses += 1
            while len(self._cache) > max(1, self.max_entries):
                self._cache.popitem(last=False)
        return fn

    def callable_for(
        self,
        graph: Graph,
        fetches: Sequence[str],
        feed_names: Sequence[str],
        device: torch.device,
    ) -> Callable:
        return self.cached(
            "block", graph, fetches, feed_names, device,
            lambda: build_callable(graph, list(fetches), list(feed_names), device),
        )

    def cache_keys(self) -> List[Tuple]:
        with self._lock:
            return list(self._cache)


_default: Optional[Executor] = None
_default_lock = threading.Lock()


def default_executor() -> Executor:
    """The process-wide executor verbs use when no ``executor=`` is passed."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Executor()
        return _default
