"""Live telemetry endpoint: a stdlib HTTP server over the observability
surfaces.

The PyTorch counterpart of `tensorframes_tpu/utils/telemetry_http.py`.
Routes:

- ``/metrics`` — Prometheus text exposition (`telemetry.export_prometheus`),
  content type ``text/plain; version=0.0.4``.
- ``/healthz`` — JSON device-health overview (`scheduler.health_overview`)
  with the admission controller's state: 200 always (liveness), with
  ``degraded: true`` when a device's failover circuit is open or
  admission is overloaded, and ``ready: false`` while the serving
  front-end drains.
- ``/diagnostics`` — the `telemetry.diagnostics_data` JSON payload.
- ``/trace`` — the span ring as Chrome trace JSON (load it in Perfetto).
- ``/profile`` — a live `runtime.profiler.snapshot()` of the workload
  profile (the JSON `WorkloadProfile.save` writes).
- ``/`` — the route listing.

Concurrency: `ThreadingHTTPServer` (one thread per request) over
registries that snapshot under their own locks. The server thread is a
daemon. It binds ``config.telemetry_host`` = 127.0.0.1 by default and has
NO authentication.

Route mounts: other subsystems share this one process server —
`mount(prefix, handler)` registers a handler for every GET/POST under
``prefix`` (longest prefix wins; the serving front-end mounts ``/serve``,
the flight recorder ``/incidents``). `shutdown()` unbinds the port and
joins the serve thread, keeping mounts registered for the next `serve()`.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "TelemetryServer",
    "serve",
    "shutdown",
    "active_server",
    "mount",
    "unmount",
    "mounts",
]

_lock = threading.Lock()
_server: Optional["TelemetryServer"] = None

# prefix -> handler(method, path, headers, body) ->
#   (status, content_type, body_bytes, extra_headers | None).
# A handler raising returns a JSON 500: a bad route never kills the server.
MountHandler = Callable[..., Tuple[int, str, bytes, Optional[Dict[str, str]]]]
_mounts: Dict[str, MountHandler] = {}

_ROUTES = ("/metrics", "/healthz", "/diagnostics", "/trace", "/profile")


def mount(prefix: str, handler: MountHandler, replace: bool = False) -> None:
    """Register ``handler`` for every request whose path is ``prefix`` or
    lives under ``prefix/`` (``replace=True`` swaps an existing one)."""
    if not prefix.startswith("/") or prefix.rstrip("/") == "":
        raise ValueError(f"mount prefix must be a non-root path, got {prefix!r}")
    prefix = prefix.rstrip("/")
    with _lock:
        if prefix in _mounts and not replace:
            raise ValueError(
                f"route prefix {prefix!r} is already mounted; pass "
                "replace=True to swap the handler"
            )
        _mounts[prefix] = handler


def unmount(prefix: str) -> bool:
    """Remove a mounted prefix; True when something was removed."""
    with _lock:
        return _mounts.pop(prefix.rstrip("/"), None) is not None


def mounts() -> Dict[str, MountHandler]:
    """Snapshot of the mounted prefixes."""
    with _lock:
        return dict(_mounts)


def _json_default(o):
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass  # non-scalar .item(): fall through to str()
    if isinstance(o, (set, frozenset, tuple)):
        return list(o)
    return str(o)


def _healthz_payload() -> dict:
    from ..runtime.deadline import controller
    from ..runtime.scheduler import health_overview

    rows = health_overview()
    admission = controller().snapshot()
    circuits = any(r.get("state") not in (None, "closed") for r in rows)
    overloaded = bool(admission.get("overloaded"))
    degraded = circuits or overloaded
    # rolling-restart readiness (`serving.drain()`): read the flag only
    # when THIS package's serving front-end is loaded (a pure-telemetry
    # process never imports the serving stack for a health scrape)
    draining = False
    srv = sys.modules.get("tensorframes_tpu_torch.serving.server")
    if srv is not None:
        try:
            draining = bool(srv.draining())
        except Exception:
            draining = False
    return {
        "status": (
            "draining" if draining
            else ("degraded" if degraded else "ok")
        ),
        "ready": not draining,
        "draining": draining,
        "degraded": degraded,
        "overloaded": overloaded,
        "devices": rows,
        "admission": admission,
    }


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: the server keeps a connection open after its response until
    # the client closes it, so the client closes first and the server holds
    # no TIME_WAIT entry. Answering HTTP/1.0, the server closed first, and on
    # the network stack of the H100 test machine a connect now and then
    # waited out 63 s of SYN retransmits (PERF.md, "The 63 s connect
    # stall"). Every response carries Content-Length; a client that sends
    # "Connection: close" is answered and closed as before.
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - stdlib signature
        pass  # scrapes are frequent; per-request stderr logging is noise

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj, default=_json_default).encode()
        self._send(code, body, "application/json")

    def _try_mounted(self, method: str) -> bool:
        """Dispatch to the mounted handler owning this path (longest
        prefix wins); True when one did, errors included."""
        path = self.path.split("?", 1)[0]
        norm = path.rstrip("/") or "/"
        best = None
        for prefix, fn in mounts().items():
            if norm == prefix or path.startswith(prefix + "/"):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, fn)
        if best is None:
            return False
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length > 0 else b""
            status, ctype, out, extra = best[1](method, path, self.headers, body)
            self.send_response(int(status))
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(out)))
            for k, v in (extra or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(out)
        except Exception as e:  # a mounted route must never kill the server
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"}, code=500)
            except Exception:
                pass  # client hung up mid-error
        return True

    def do_POST(self):  # noqa: N802 - stdlib name
        if self._try_mounted("POST"):
            return
        self._send_json({"error": f"no POST route {self.path!r}"}, code=404)

    def do_GET(self):  # noqa: N802 - stdlib name
        from . import telemetry as _tele

        if self._try_mounted("GET"):
            return
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(
                    200,
                    _tele.export_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/healthz":
                self._send_json(_healthz_payload())
            elif path == "/diagnostics":
                self._send_json(_tele.diagnostics_data())
            elif path == "/trace":
                self._send_json(_tele.export_chrome_trace())
            elif path == "/profile":
                from ..runtime import profiler as _prof

                self._send_json(
                    _prof.snapshot(note="telemetry_http:/profile").to_dict()
                )
            elif path == "/":
                self._send_json(
                    {
                        "service": "tensorframes_tpu_torch telemetry",
                        "routes": list(_ROUTES) + sorted(mounts()),
                    }
                )
            else:
                self._send_json({"error": f"no route {path!r}"}, code=404)
        except Exception as e:  # a scrape must never kill the server
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"}, code=500)
            except Exception:
                pass  # client hung up mid-error


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: the stdlib's 5 holds six connects the accept
    # loop has not reached; a burst of more serving clients loses a SYN,
    # and its client waits out a 1 s retransmit
    request_queue_size = 128


class TelemetryServer:
    """Handle to one running endpoint: ``.port`` (resolved, useful with
    ``port=0``), ``.url``, ``.close()`` (joins the serve thread and frees
    the port synchronously)."""

    def __init__(self, host: str, port: int):
        self._httpd = _HTTPServer((host, port), _Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name="tfs-telemetry-http",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        global _server
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        with _lock:
            if _server is self:
                _server = None


def active_server() -> Optional[TelemetryServer]:
    """The process-wide endpoint, if one is serving."""
    with _lock:
        return _server


def shutdown() -> bool:
    """Stop the process-wide endpoint: unbind the port and join the serve
    thread (in-flight requests finish). False when nothing was serving;
    mounted routes stay registered for the next `serve()`."""
    with _lock:
        srv = _server
    if srv is None:
        return False
    srv.close()
    from .log import get_logger

    get_logger("telemetry").info("telemetry endpoint on port %d shut down", srv.port)
    return True


def serve(port: Optional[int] = None, host: Optional[str] = None) -> TelemetryServer:
    """Start the process-wide endpoint (one per process: a second call
    while one serves returns it when no conflicting port was asked for,
    and raises otherwise). ``port`` defaults to ``config.telemetry_port``;
    0 binds an ephemeral port."""
    from .. import config as _config
    from .log import get_logger

    cfg = _config.get()
    if port is None:
        port = int(cfg.telemetry_port)
        if not port:
            raise ValueError(
                "telemetry.serve(): no port given and "
                "config.telemetry_port is 0 (off); pass serve(port=...) "
                "or set TFS_TELEMETRY_PORT"
            )
    if host is None:
        host = str(cfg.telemetry_host)
    global _server
    with _lock:
        if _server is not None and _server.running:
            if port in (0, _server.port):
                return _server
            raise RuntimeError(
                f"telemetry endpoint already serving on port "
                f"{_server.port}; close() it before binding {port}"
            )
        srv = TelemetryServer(host, int(port))
        _server = srv
    get_logger("telemetry").info(
        "telemetry endpoint serving on %s (/metrics /healthz /trace)", srv.url
    )
    return srv
