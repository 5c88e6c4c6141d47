"""Cross-request micro-batching: many small requests, one padded dispatch.

The PyTorch counterpart of `tensorframes_tpu/serving/batcher.py`. Serving
traffic is many concurrent SMALL evaluations of a few programs; the
per-request cost (verb entry, a host-to-device copy, kernel launches)
dwarfs the per-row work. Concurrent requests to one ``(endpoint, program
fingerprint)`` coalesce into ONE dispatch:

- Requests queue into a per-key **lane**; the lane's daemon dispatcher
  thread holds an open batch for the endpoint's window (its tuned
  ``batch_window_ms``, else ``config.serve_batch_window_ms``), closing
  EARLY when the row total lands exactly on a bucket-ladder rung or
  reaches ``max_batch_rows``. An oversized request dispatches alone.
- The closed batch concatenates the requests' host rows (one host-to-
  device copy for the batch), pads to the rung with `shape_policy.pad_lead`
  so the dispatch shape is a warmed rung, runs the endpoint's program
  through the verb (one admission slot for the batch), copies each output
  column to the host ONCE, and scatters per-request row slices of it
  through `concurrent.futures.Future`s. A copy per request slice would put
  a device sync per request on the lane thread.
- **Bit-identity**: only endpoints whose fetches are proven row-local are
  batchable, so concat + dispatch + slice equals per-request execution.
- An error in the dispatch (a sticky CUDA error included) is classified
  (`runtime.faults.classify`), stamped, and set on every member's future;
  the lane goes on serving.

Overload: a lane whose queue holds ``config.serve_queue_limit`` requests
sheds new arrivals with the admission controller's typed `OverloadError`
(retry-after from the live ``verb_seconds`` histogram); the HTTP front-end
maps it to 429 + ``Retry-After``. Deadlines: the caller's ambient deadline
rides with its request; a batch runs under its LOOSEST member's budget,
and a waiter whose deadline expired while queued is dropped at dispatch.

An endpoint that is not batchable, or a window of 0, runs inline on the
caller's thread.

Telemetry: ``serve_requests`` / ``serve_batches`` / ``serve_shed``
counters by endpoint, ``serve_batch_rows`` / ``serve_batch_fill`` /
``serve_queue_seconds`` histograms, and the registered ``serve_pending``
gauge.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frame import Column, TensorFrame
from ..runtime import deadline as _dl

__all__ = ["MicroBatcher", "batcher"]



def _window_s(endpoint, cfg) -> float:
    """Effective coalescing window of one endpoint, in seconds: its own
    ``batch_window_ms`` (the autotuner's per-endpoint value) when set,
    else ``config.serve_batch_window_ms``. Read per batch, so a tuned
    change applies to the next window; an operator pin of the global knob
    wins over a tuned endpoint value at read time."""
    from .. import config as _config

    w = getattr(endpoint, "batch_window_ms", None)
    if w is None or _config.is_explicit("serve_batch_window_ms"):
        w = float(cfg.serve_batch_window_ms)
    return float(w) / 1e3

class _Request:
    __slots__ = ("frame", "rows", "future", "request_id", "deadline_at", "t_enq")

    def __init__(self, frame, rows, future, request_id, deadline_at):
        self.frame = frame
        self.rows = rows
        self.future = future
        self.request_id = request_id
        self.deadline_at = deadline_at  # absolute monotonic, or None
        self.t_enq = time.monotonic()


class _Lane:
    """One (endpoint, program) batching lane: a bounded queue drained by a
    dedicated daemon dispatcher thread."""

    def __init__(self, key: Tuple[str, str], endpoint):
        self.key = key
        self.endpoint = endpoint
        self.cond = threading.Condition(threading.Lock())
        self.queue: deque = deque()
        self.stop = False
        self.thread: Optional[threading.Thread] = None

    def depth(self) -> int:
        return len(self.queue)  # GIL-atomic len: a gauge read


class MicroBatcher:
    """Process-wide batcher: one lane per (endpoint, fingerprint)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lanes: Dict[Tuple[str, str], _Lane] = {}
        # accounting (under self._lock)
        self.requests = 0
        self.batches = 0
        self.batched_requests = 0
        self.inline = 0
        self.shed = 0

    # -- introspection --------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(lane.depth() for lane in lanes)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "lanes": len(self._lanes),
                "pending": sum(lane.depth() for lane in self._lanes.values()),
                "requests": self.requests,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "inline": self.inline,
                "shed": self.shed,
            }

    # -- the entry point ------------------------------------------------
    def submit(
        self,
        endpoint,
        frame: TensorFrame,
        request_id: Optional[str] = None,
        validate: bool = True,
    ) -> Future:
        """Queue one request; a Future resolving to the endpoint's
        outputs-only response frame. Validation errors and lane overload
        raise here (the server maps them to 400 / 429); execution errors
        surface through the future. The caller's ambient deadline bounds
        the batch dispatch."""
        from .. import config as _config
        from ..utils import telemetry as _tele

        if validate:
            endpoint.validate_request(frame)
        with self._lock:
            self.requests += 1
        _tele.counter_inc("serve_requests", 1.0, endpoint=endpoint.name)

        cfg = _config.get()
        fut: Future = Future()
        if not endpoint.batchable or _window_s(endpoint, cfg) <= 0.0:
            # unbatched: inline on the caller's thread, under its scope
            with self._lock:
                self.inline += 1
            if not fut.set_running_or_notify_cancel():
                return fut
            try:
                fut.set_result(endpoint.run_frame(frame))
            except BaseException as e:
                fut.set_exception(e)
            return fut

        scope = _dl.current_scope()
        deadline_at = None
        if scope is not None and scope.deadline is not None:
            deadline_at = scope.deadline.at
        req = _Request(frame, frame.nrows, fut, request_id, deadline_at)

        qlimit = int(cfg.serve_queue_limit or 0)
        while True:
            lane = self._lane(endpoint)
            with lane.cond:
                if lane.stop:
                    # lost a race with drop()/shutdown(): the dispatcher
                    # may have exited; _lane() makes a fresh lane
                    continue
                if qlimit > 0 and len(lane.queue) >= qlimit:
                    with self._lock:
                        self.shed += 1
                    _tele.counter_inc("serve_shed", 1.0, endpoint=endpoint.name)
                    depth = len(lane.queue)
                    mean = _dl._mean_verb_seconds()
                    retry_after = max(0.001, (mean or 0.05) * (depth + 1))
                    raise _dl.OverloadError(
                        f"endpoint {endpoint.name!r}: batching lane full "
                        f"— {depth} request(s) queued (limit {qlimit}); "
                        f"retry in ~{retry_after:.3f}s",
                        queue_depth=depth, limit=qlimit,
                        retry_after_s=retry_after,
                    )
                lane.queue.append(req)
                lane.cond.notify()
            return fut

    # -- lanes ----------------------------------------------------------
    def _lane(self, endpoint) -> _Lane:
        key = (endpoint.name, endpoint.fingerprint)
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None or lane.stop:
                lane = _Lane(key, endpoint)
                lane.thread = threading.Thread(
                    target=self._run_lane,
                    args=(lane,),
                    daemon=True,
                    name=f"tfs-serve-{endpoint.name}",
                )
                self._lanes[key] = lane
                lane.thread.start()
            return lane

    def drop(self, endpoint_name: str) -> None:
        """Stop every lane of one endpoint (unregister / replace); queued
        requests still dispatch before the thread exits."""
        with self._lock:
            doomed = [
                lane for key, lane in self._lanes.items() if key[0] == endpoint_name
            ]
            for lane in doomed:
                self._lanes.pop(lane.key, None)
        for lane in doomed:
            with lane.cond:
                lane.stop = True
                lane.cond.notify_all()
            lane.thread.join(timeout=30.0)

    def shutdown(self) -> None:
        """Stop every lane (tests, process teardown); queued requests drain
        through one final dispatch per lane."""
        with self._lock:
            lanes = list(self._lanes.values())
            self._lanes.clear()
            self.requests = self.batches = 0
            self.batched_requests = self.inline = self.shed = 0
        for lane in lanes:
            with lane.cond:
                lane.stop = True
                lane.cond.notify_all()
        for lane in lanes:
            lane.thread.join(timeout=30.0)

    # -- the dispatcher -------------------------------------------------
    def _run_lane(self, lane: _Lane) -> None:
        from .. import config as _config
        from .. import shape_policy as _sp

        ep = lane.endpoint
        while True:
            with lane.cond:
                while not lane.queue and not lane.stop:
                    lane.cond.wait(0.25)
                if not lane.queue and lane.stop:
                    return
                window_s = _window_s(ep, _config.get())
                max_rows = ep.max_batch_rows
                t_close = time.monotonic() + window_s
                batch: List[_Request] = []
                rows = 0
                while True:
                    while lane.queue:
                        r = lane.queue[0]
                        if batch and rows + r.rows > max_rows:
                            break  # r starts the NEXT batch
                        lane.queue.popleft()
                        batch.append(r)
                        rows += r.rows
                    if rows >= max_rows:
                        break
                    # rung-fill early close: more coalescing could only
                    # push the batch into the next rung
                    if rows and rows == _sp.bucket_for(rows):
                        break
                    if lane.stop:
                        break
                    left = t_close - time.monotonic()
                    if left <= 0.0:
                        break
                    lane.cond.wait(left)
            if batch:
                self._dispatch(ep, batch)

    def _dispatch(self, ep, batch: List[_Request]) -> None:
        from .. import shape_policy as _sp
        from ..runtime import faults as _faults
        from ..utils import telemetry as _tele

        now = time.monotonic()
        # claim the futures at dispatch time: a waiter whose deadline
        # expired while queued has cancel()led; drop it here
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not live:
            return
        for r in live:
            _tele.histogram_observe("serve_queue_seconds", max(0.0, now - r.t_enq))
        rows = sum(r.rows for r in live)
        # the batch runs under the LOOSEST member budget; any unbounded
        # member leaves it on the config default
        timeout_s = None
        deadlines = [r.deadline_at for r in live]
        if all(d is not None for d in deadlines):
            timeout_s = max(0.001, max(deadlines) - now)
        try:
            # ONE single-block host frame of exactly the program's columns:
            # the verb makes one host-to-device copy per column
            cols = []
            for c in ep.required_columns:
                parts = [r.frame.column(c).host_values() for r in live]
                cols.append(
                    Column(c, parts[0] if len(parts) == 1 else np.concatenate(parts))
                )
            base = TensorFrame(cols, offsets=[0, rows])
            # pad to the rung here (replicated last row) so the dispatch
            # shape is a warmed rung; the pad rows are sliced off below
            rung = _sp.bucket_for(rows)
            if rows == rung or (rung > rows and rows <= ep.max_batch_rows):
                _sp.observe_fill(rows, rung, verb=f"serve:{ep.name}")
            if rung > rows and rows <= ep.max_batch_rows:
                padded = TensorFrame(
                    [
                        Column(c, _sp.pad_lead(base.column(c).values, rows, rung))
                        for c in ep.required_columns
                    ],
                    offsets=[0, rung],
                )
            else:
                padded = base
            ids = ",".join(r.request_id for r in live if r.request_id) or None
            ctx = _tele.request_scope(ids) if ids is not None else contextlib.nullcontext()
            with ctx:
                out = ep.run_frame(padded, timeout_s=timeout_s)
            with self._lock:
                self.batches += 1
                self.batched_requests += len(live)
            _tele.counter_inc("serve_batches", 1.0, endpoint=ep.name)
            _tele.histogram_observe("serve_batch_rows", float(rows))
            _tele.histogram_observe("serve_batch_fill", float(len(live)))
            # scatter: each output column crosses to the host once, then
            # every request gets its row slice of the host array
            out_vals = [(name, out.column(name).host_values()) for name in ep.output_names]
            lo = 0
            for r in live:
                hi = lo + r.rows
                res = TensorFrame(
                    [Column(name, v[lo:hi]) for name, v in out_vals],
                    offsets=[0, r.rows],
                )
                lo = hi
                try:
                    r.future.set_result(res)
                except Exception:
                    pass  # waiter gone; nothing to tell
        except BaseException as e:  # typed errors flow to every member
            _faults._tag_fault(e, _faults.classify(e))
            for r in live:
                try:
                    r.future.set_exception(e)
                except Exception:
                    pass  # cancelled waiter: the error has no audience


_batcher = MicroBatcher()


def batcher() -> MicroBatcher:
    """The process-wide micro-batcher."""
    return _batcher


def _register_gauge() -> None:
    from ..utils import telemetry as _tele

    _tele.gauge_register("serve_pending", lambda: float(_batcher.pending()))


_register_gauge()
