"""Executor: build-once, run-many graph execution.

The PyTorch counterpart of `tensorframes_tpu/runtime/executor.py`. A graph
is lowered once per (kind, graph fingerprint, fetches, feeds, device) and
the callable is kept in a thread-safe LRU, so B blocks cost one lowering
and B eager calls. `torch.compile` and CUDA graphs are later work.

Every callable the cache holds is wrapped (`Executor._instrument`, as the
JAX executor's): the first dispatch of each input shape signature has the
cost ledger count the program on the meta device (`costmodel.capture`,
from a second build for ``torch.device("meta")`` that neither bumps
`compile_count` nor enters the LRU), every dispatch counts one execution
(`costmodel.count`), and a program dispatched with more than
``config.recompile_warn_shapes`` distinct signatures warns once. A cache
miss records a ``trace`` build span and a capture a ``meta`` one
(`telemetry.record_compile`); just before the program runs, the wrapper
marks the enclosing dispatch span's launch (`telemetry.launching`).

``make(device)`` builds the callable for a device: the executor calls it
with the verb's device for the cache and with the meta device for the
ledger.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config as _config
from ..graph.ir import Graph
from ..ops.lowering import build_callable
from ..utils import telemetry as _tele
from . import costmodel as _cm

__all__ = ["Executor", "default_executor", "set_fault_injector"]

# Fault-injection seam (`testing.faults.inject`): when installed,
# ``hook(fn, key) -> fn`` wraps every callable `Executor.cached` hands out
# (the one boundary every dispatch crosses), on the way OUT of the cache,
# so the cached callable itself is never poisoned. None = production path.
_fault_injector = None


def set_fault_injector(hook) -> None:
    global _fault_injector
    _fault_injector = hook


class Executor:
    """LRU of lowered callables, bounded by
    ``config.executor_cache_entries`` (read at every insert). A miss builds
    OUTSIDE the lock (lowering folds constants and uploads them); a lost
    insert race keeps the winner's callable and costs only the redundant
    build."""

    # the block scheduler may place this executor's dispatches
    # (`scheduler.resolve`)
    supports_scheduling = True

    def __init__(self):
        self._cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._lock = threading.Lock()
        self.compile_count = 0  # distinct lowered callables built
        # per-device ledgers (device label -> count): block dispatches the
        # scheduler placed (`scheduler.BlockSchedule`) and lowered
        # callables built for the device (a cache miss)
        self.device_dispatches: Dict[str, int] = {}
        self.device_compiles: Dict[str, int] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        # cached-program keys already flagged by the shape-storm warning
        self._storm_warned: set = set()

    def cached(
        self,
        kind: str,
        graph: Graph,
        fetches: Sequence[str],
        feed_names: Sequence[str],
        device: torch.device,
        make: Callable[[torch.device], Callable],
    ) -> Callable:
        """``kind`` distinguishes execution styles of one graph (a block
        call, a per-row vmap); ``make(device)`` builds the callable."""
        key = (kind, graph.fingerprint(), tuple(fetches), tuple(feed_names), str(device))

        def timed_make():
            from ..graph import vectorize as _vec

            t0 = time.perf_counter()
            fn = make(device)
            t1 = time.perf_counter()
            _tele.record_compile(key[1], kind, t1 - t0, "trace", t0, t1)
            # a graph with control flow does data-dependent work: the meta
            # replay cannot count it (the ledger keeps None)
            replayable = not any(
                n.op in _vec.CONTROL_OPS for n in graph.toposort(list(fetches))
            )
            return self._instrument(key, fn, make if replayable else None)

        fn = self._lookup(key, timed_make)
        if _fault_injector is not None:
            fn = _fault_injector(fn, key)
        return fn

    def _instrument(self, key: Tuple, fn: Callable, make) -> Callable:
        """Wrap a freshly built callable with the cost ledger and the
        shape-storm check (see the module docstring). Per dispatch: one
        signature lookup, the launch mark and one locked ledger update;
        the first dispatch of a signature (again after a ledger reset)
        captures. The meta build runs once per program."""
        cells: Dict[Tuple, Optional[Dict]] = {}  # signature -> ledger cell
        lock = threading.Lock()
        meta = []  # [meta callable or None], built on first capture

        def meta_fn():
            if not meta:
                try:
                    meta.append(make(torch.device("meta")) if make else None)
                except Exception:
                    meta.append(None)  # the ledger keeps None
            return meta[0]

        def first(sig, args):
            """A signature without a live ledger cell: count it toward the
            storm check when new, and capture it when the ledger is on."""
            with lock:
                new = sig not in cells
                cells[sig] = None
            if new:
                self._storm_check(key, len(cells), _config.get().recompile_warn_shapes)
            if not _cm.enabled():
                return None
            t0 = time.perf_counter()
            ent = _cm.capture(key, meta_fn(), args)
            t1 = time.perf_counter()
            _tele.record_compile(key[1], key[0], t1 - t0, "meta", t0, t1)
            cells[sig] = ent
            return ent

        def wrapped(*args):
            sig = _cm.signature(args)
            ent = cells.get(sig)
            on = _config._config.cost_ledger
            if (ent is None or "gone" in ent) and (on or sig not in cells):
                ent = first(sig, args)
            _tele.launching()
            out = fn(*args)
            if ent is not None and on:
                run = _tele.current_run()
                if run is not None and ent["out_bytes"] is not None:
                    run.ledger.append((ent, key, sig))  # counted at the run's end
                else:
                    _cm.count(ent, key, args, out, sig)
            return out

        wrapped.shapes = cells
        wrapped.__wrapped__ = fn
        return wrapped

    def _storm_check(self, key: Tuple, n: int, threshold: int) -> None:
        if not threshold or n <= threshold or key in self._storm_warned:
            return
        with self._lock:
            if key in self._storm_warned:
                return
            while len(self._storm_warned) >= 1024:
                self._storm_warned.pop()
            self._storm_warned.add(key)
        from ..utils.log import get_logger

        get_logger("executor").warning(
            "shape storm: program %s/%s has been dispatched with %d distinct "
            "input shapes (> recompile_warn_shapes=%d); block shapes are "
            "drifting per call — repartition to stable block sizes, or "
            "raise recompile_warn_shapes",
            key[0], str(key[1])[:12], n, threshold,
        )

    def _lookup(self, key: Tuple, make: Callable[[], Callable]) -> Callable:
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
            label = _device_label(key[-1])
            self.device_compiles[label] = self.device_compiles.get(label, 0) + 1
            self.cache_misses += 1
            while len(self._cache) > max(1, int(_config.get().executor_cache_entries)):
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
            lambda d: build_callable(graph, list(fetches), list(feed_names), d),
        )

    def run(
        self,
        graph: Graph,
        fetches: Sequence[str],
        feeds: Dict[str, object],
        materialize: bool = False,
        device=None,
    ) -> List[Union[torch.Tensor, np.ndarray]]:
        """Execute the graph once over ``feeds`` (placeholder name -> array
        or tensor) on ``device`` (default the card; ``"cpu"`` when asked),
        through the cached callable of `callable_for`.

        Returns device tensors by default, so chained runs stay on the
        device; ``materialize=True`` copies the results to host numpy."""
        from ..device import resolve_device
        from ..frame import _to_numpy, as_tensor

        dev = resolve_device(device)
        feed_names = sorted(feeds)
        fn = self.callable_for(graph, fetches, feed_names, dev)
        out = fn(*[as_tensor(feeds[n], dev) for n in feed_names])
        if materialize:
            return [_to_numpy(o) for o in out]
        return list(out)

    def cache_keys(self) -> List[Tuple]:
        with self._lock:
            return list(self._cache)

    def clear(self) -> None:
        """Drop every cached callable (the counters stay)."""
        with self._lock:
            self._cache.clear()

    def program_shape_compiles(self) -> Dict[Tuple, int]:
        """Per-program distinct input shape signatures dispatched: cache
        key -> count (what `diagnostics` renders as the shape-storm
        table). A program never dispatched counts 0."""
        with self._lock:
            items = list(self._cache.items())
        return {k: len(getattr(fn, "shapes", ())) for k, fn in items}


def _device_label(dev: str) -> str:
    d = torch.device(dev)
    return f"{d.type}:{d.index or 0}"


_default: Optional[Executor] = None
_default_lock = threading.Lock()


def default_executor() -> Executor:
    """The process-wide executor verbs use when no ``executor=`` is passed."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Executor()
        return _default
