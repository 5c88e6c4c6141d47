"""HTTP front-end: Arrow IPC request/response over the shared endpoint.

The PyTorch counterpart of `tensorframes_tpu/serving/server.py`. It mounts
onto the ONE process HTTP server (`utils.telemetry_http`, which also serves
/metrics, /healthz and /trace), so the serving data plane and its
observability share a port:

- ``POST /serve/<endpoint>`` — body: Arrow IPC stream bytes of the request
  frame (`io.frame_to_ipc_bytes`); response: Arrow IPC stream bytes of the
  outputs-only result frame. Headers:

  - ``X-TFS-Timeout-S`` (request) — the request's budget; it enters a
    `deadline_scope`, so queueing, the coalesced dispatch and the wait
    share one clock. Defaults to ``config.serve_default_timeout_s``: a
    serving request is never unbounded.
  - ``X-TFS-Request-Id`` (request, optional) — echoed back and stamped as
    ``request=`` on every verb span the request triggers (a batched
    dispatch carries the joined ids).

- ``GET /serve`` — JSON listing: registered endpoints and the batcher's
  accounting.

Error mapping (typed, never a hang):

| raised                      | HTTP | extra                          |
|-----------------------------|------|--------------------------------|
| `OverloadError` (lane full, | 429  | ``Retry-After`` (whole s)      |
|  admission shed)            |      |                                |
| `DeadlineExceeded`          | 504  | budget/elapsed in the body     |
| `Cancelled`, draining       | 503  |                                |
| unknown endpoint            | 404  |                                |
| schema/body validation      | 400  |                                |
| anything else               | 500  |                                |

A request mapped to 429 or a 5xx is handed to the flight recorder
(`runtime.blackbox`). Binds 127.0.0.1 by default, with no auth.
"""

from __future__ import annotations

import json
import math
import threading
import uuid
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, Optional, Tuple

from ..runtime import deadline as _dl

__all__ = [
    "serve",
    "active",
    "draining",
    "set_draining",
    "ServingHandle",
    "ARROW_CONTENT_TYPE",
    "PREFIX",
]

PREFIX = "/serve"
ARROW_CONTENT_TYPE = "application/vnd.apache.arrow.stream"

_lock = threading.Lock()
_handle: Optional["ServingHandle"] = None

# Rolling-restart readiness (`serving.drain()`): while set, NEW
# serving requests shed with 503 and /healthz reports ready=false, so
# an external balancer stops routing here while in-flight batcher
# lanes finish. Cleared by serve() (a remount is a fresh replica) and
# serving.reset().
_draining = threading.Event()


def draining() -> bool:
    """True while `serving.drain()` is shedding new requests."""
    return _draining.is_set()


def set_draining(on: bool) -> None:
    if on:
        _draining.set()
    else:
        _draining.clear()


def _error_body(e: BaseException, **extra) -> bytes:
    payload = {"error": type(e).__name__, "message": str(e)}
    payload.update(extra)
    return json.dumps(payload).encode()


def _json(obj) -> Tuple[int, str, bytes, None]:
    return 200, "application/json", json.dumps(obj).encode(), None


def _handle_run(
    name: str, headers, body: bytes
) -> Tuple[int, str, bytes, Optional[Dict[str, str]]]:
    from .. import config as _config
    from ..io import frame_from_ipc_bytes, frame_to_ipc_bytes
    from ..utils import telemetry as _tele
    from .batcher import batcher as _the_batcher
    from . import registry as _registry

    rid = headers.get("X-TFS-Request-Id") or f"req-{uuid.uuid4().hex[:12]}"
    echo = {"X-TFS-Request-Id": rid}
    if _draining.is_set():
        # rolling restart: shed BEFORE any work — the balancer already
        # sees ready=false on /healthz; stragglers get a typed 503
        return 503, "application/json", json.dumps(
            {
                "error": "Draining",
                "message": (
                    "serving is draining for a rolling restart; retry "
                    "against another replica"
                ),
                "draining": True,
            }
        ).encode(), echo
    try:
        ep = _registry.get(name)
    except KeyError as e:
        return 404, "application/json", _error_body(e), echo
    try:
        timeout_hdr = headers.get("X-TFS-Timeout-S")
        timeout_s = (
            float(timeout_hdr)
            if timeout_hdr
            else float(_config.get().serve_default_timeout_s)
        )
        if not (timeout_s > 0):
            raise ValueError(
                f"X-TFS-Timeout-S must be > 0, got {timeout_s!r}"
            )
        if not body:
            raise ValueError("empty request body (expected Arrow IPC bytes)")
        frame = frame_from_ipc_bytes(body)
    except Exception as e:
        return 400, "application/json", _error_body(e), echo

    try:
        with _tele.request_scope(rid):
            with _dl.deadline_scope(
                timeout_s=timeout_s, verb=f"serve:{name}"
            ) as scope:
                # validates synchronously (a bad request fails alone,
                # before it can join a batch), may shed synchronously
                fut = _the_batcher().submit(ep, frame, request_id=rid)
                rem = scope.remaining()
                try:
                    result = fut.result(timeout=rem)
                except _FutureTimeout:
                    # give up our queue slot if the batch has not
                    # claimed it; the dispatcher drops cancelled work
                    fut.cancel()
                    raise _dl.DeadlineExceeded(
                        f"serve:{name}: request {rid} exceeded its "
                        f"budget ({timeout_s:.3f}s) waiting for dispatch",
                        verb=f"serve:{name}", budget_s=timeout_s,
                    )
        out = frame_to_ipc_bytes(result)
        return 200, ARROW_CONTENT_TYPE, out, echo
    except _dl.OverloadError as e:
        hdrs = dict(echo)
        hdrs["Retry-After"] = str(max(1, math.ceil(e.retry_after_s)))
        _incident(e, name, rid, 429)
        return 429, "application/json", _error_body(
            e,
            retry_after_s=e.retry_after_s,
            queue_depth=e.queue_depth,
            limit=e.limit,
        ), hdrs
    except _dl.DeadlineExceeded as e:
        _incident(e, name, rid, 504)
        return 504, "application/json", _error_body(
            e, budget_s=e.budget_s, elapsed_s=e.elapsed_s
        ), echo
    except _dl.Cancelled as e:
        _incident(e, name, rid, 503)
        return 503, "application/json", _error_body(e), echo
    except ValueError as e:
        return 400, "application/json", _error_body(e), echo
    except Exception as e:
        _incident(e, name, rid, 500)
        return 500, "application/json", _error_body(e), echo


def _incident(e: BaseException, name: str, rid: str, status: int) -> None:
    """Flight-recorder hook for a request mapped to an error status.
    Faults already captured at the verb layer are stamped with
    ``tfs_incident_id`` and dedup to the same bundle; a server-side
    failure (batcher future, IPC encode, a fresh 504 built here) gets
    its first capture with the serving context attached."""
    try:
        from ..runtime import blackbox as _blackbox

        _blackbox.capture(
            "serving", e, verb=f"serve:{name}",
            extra={"endpoint": name, "request_id": rid, "status": status},
        )
    except Exception:
        pass  # the recorder must never turn a 5xx into a crash


def _route(method: str, path: str, headers, body: bytes):
    """The mounted handler (`telemetry_http.mount` signature)."""
    from .batcher import batcher as _the_batcher
    from . import registry as _registry

    sub = path[len(PREFIX):].strip("/")
    if method == "GET":
        if not sub:
            return _json(
                {
                    "service": "tensorframes_tpu_torch serving",
                    "draining": _draining.is_set(),
                    "endpoints": _registry.endpoints(),
                    "batcher": _the_batcher().snapshot(),
                }
            )
        try:
            return _json(_registry.get(sub).describe())
        except KeyError as e:
            return 404, "application/json", _error_body(e), None
    if method == "POST":
        if not sub or "/" in sub:
            return 404, "application/json", _error_body(
                KeyError(f"POST {path!r}: expected {PREFIX}/<endpoint>")
            ), None
        return _handle_run(sub, headers, body)
    return 405, "application/json", _error_body(
        ValueError(f"method {method} not allowed on {path!r}")
    ), None


class ServingHandle:
    """Handle to the mounted serving front-end. ``url`` points at the
    ``/serve`` prefix on the shared process server; ``close()``
    unmounts the routes (the shared server keeps running — stop it with
    ``telemetry.shutdown()``)."""

    def __init__(self, server):
        self._server = server
        self.host = server.host
        self.port = server.port

    @property
    def url(self) -> str:
        return f"{self._server.url}{PREFIX}"

    @property
    def running(self) -> bool:
        return self._server.running

    def close(self) -> None:
        global _handle
        from ..utils import telemetry_http as _http

        _http.unmount(PREFIX)
        with _lock:
            if _handle is self:
                _handle = None


def serve(
    port: Optional[int] = None, host: Optional[str] = None
) -> ServingHandle:
    """Mount the serving routes on the process HTTP server (starting it
    if none is running — ``port=0`` binds an ephemeral port) and return
    the handle. Registered endpoints become immediately servable; the
    same port keeps serving /metrics, /healthz and /trace."""
    # the request codec's first import on the caller's thread: pyarrow
    # 25.0.0 crashes in later use when its first import ran on a thread
    # that has since exited, as every HTTP handler thread does
    import pyarrow  # noqa: F401

    from ..utils import telemetry_http as _http

    srv = _http.active_server()
    if srv is None or not srv.running:
        srv = _http.serve(port=port if port is not None else 0, host=host)
    elif port not in (None, 0, srv.port):
        raise RuntimeError(
            f"process HTTP server already bound to port {srv.port}; "
            f"cannot serve on {port} (telemetry.shutdown() first)"
        )
    _http.mount(PREFIX, _route, replace=True)
    _draining.clear()  # a (re)mounted front-end is a ready replica
    handle = ServingHandle(srv)
    global _handle
    with _lock:
        _handle = handle
    from ..utils.log import get_logger

    get_logger("serving").info(
        "serving front-end mounted at %s (POST %s/<endpoint>)",
        handle.url, PREFIX,
    )
    return handle


def active() -> Optional[ServingHandle]:
    """The mounted front-end, if any."""
    with _lock:
        return _handle
