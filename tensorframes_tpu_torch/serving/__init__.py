"""Serving runtime: the piece that turns the library into a service.

The PyTorch counterpart of `tensorframes_tpu/serving/`:

- `registry` — named endpoints: schema-validated programs on one device,
  warmed across every bucket-ladder rung (no new lowering at steady
  state).
- `batcher` — cross-request micro-batching: concurrent small requests
  coalesce into ONE padded dispatch, results scatter back through
  futures, bit-identical to unbatched execution.
- `server` / `client` — Arrow IPC over HTTP on the shared process
  endpoint, with typed overload (429 + Retry-After) and deadline (504)
  mapping.

Quick start::

    import tensorframes_tpu_torch as tft

    fetch = ...  # dsl tensor / Graph / GraphDef / LazyFrame
    tft.serving.register("score", fetch, {"x": "float32"}, device="cuda")
    handle = tft.serving.serve(port=0)

    client = tft.serving.ServingClient(handle.url)
    out = client.run("score", {"x": np.arange(8, dtype=np.float32)})
"""

from __future__ import annotations

from .batcher import MicroBatcher, batcher
from .client import ServingClient, ServingError
from .registry import (
    Endpoint,
    endpoints,
    get,
    register,
    unregister,
)
from .server import ServingHandle, active, serve

__all__ = [
    "Endpoint",
    "register",
    "unregister",
    "get",
    "endpoints",
    "MicroBatcher",
    "batcher",
    "serve",
    "active",
    "drain",
    "ServingHandle",
    "ServingClient",
    "ServingError",
    "reset",
]


def drain(timeout_s=30.0, stop_server: bool = True) -> dict:
    """Graceful rolling-restart drain:

    1. flips the readiness flag: ``/healthz`` reports
       ``ready: false`` / ``status: "draining"`` and every NEW
       ``POST /serve/<endpoint>`` sheds with a typed 503 (the balancer
       stops routing here; stragglers retry another replica);
    2. lets in-flight batcher lanes finish: waits (up to ``timeout_s``
       seconds; ``None`` = unbounded) for every queued request to
       dispatch, then stops the lanes through the existing
       `MicroBatcher.shutdown()` (which itself drains each lane
       through one final dispatch);
    3. unmounts the front-end and — with ``stop_server=True``, the
       default — stops the shared process HTTP server via the
       existing `telemetry_http.shutdown()`, so the port frees for
       the replacement replica.

    Endpoint registrations survive (a restart re-serves them with one
    `serve()` call, which also clears the draining flag). Idempotent.
    Returns accounting: ``{"drained": all lanes empty before shutdown,
    "waited_s": ..., "stopped_server": ...}``."""
    import time as _time

    from . import server as _server
    from .batcher import batcher as _the_batcher

    _server.set_draining(True)
    t0 = _time.monotonic()
    b = _the_batcher()
    while b.pending() > 0:
        if timeout_s is not None and _time.monotonic() - t0 >= timeout_s:
            break
        _time.sleep(0.005)
    drained = b.pending() == 0
    b.shutdown()
    handle = _server.active()
    if handle is not None:
        handle.close()
    stopped = False
    if stop_server:
        from ..utils import telemetry_http as _http

        stopped = _http.shutdown()
    from ..utils.log import get_logger

    get_logger("serving").info(
        "serving drained in %.3fs (lanes empty: %s, server stopped: %s)",
        _time.monotonic() - t0, drained, stopped,
    )
    return {
        "drained": drained,
        "waited_s": _time.monotonic() - t0,
        "stopped_server": stopped,
    }


def reset() -> None:
    """Test hook: unmount the front-end, stop every batching lane, forget
    every endpoint."""
    from . import server as _server

    _server.set_draining(False)
    handle = _server.active()
    if handle is not None:
        handle.close()  # unmounts AND clears the active-handle global
    else:
        from ..utils import telemetry_http as _http

        _http.unmount(_server.PREFIX)
    from . import registry as _registry

    _registry.reset()
