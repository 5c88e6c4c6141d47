"""Stdlib HTTP client for the serving front-end.

The PyTorch counterpart of `tensorframes_tpu/serving/client.py`. It speaks
the wire format of `serving.server` (both ends share
`io.frame_to_ipc_bytes` / `frame_from_ipc_bytes`) and re-raises the
server's typed errors as the port's own types: a 429 becomes
`OverloadError` carrying the server's retry-after hint, a 504 becomes
`DeadlineExceeded`. Everything else raises `ServingError` with the status
and the decoded body. One ``http.client`` connection per call.
"""

from __future__ import annotations

import json
from http.client import HTTPConnection
from typing import Dict, Optional
from urllib.parse import urlparse

from ..frame import TensorFrame
from ..runtime.deadline import DeadlineExceeded, OverloadError

__all__ = ["ServingClient", "ServingError"]


class ServingError(RuntimeError):
    """Non-typed serving failure: carries ``status`` and the decoded
    ``body`` dict (or raw text) the server returned."""

    # the typed retryable cases already re-raise as OverloadError /
    # DeadlineExceeded; what is left (4xx/5xx bodies) does not improve
    # on a blind re-send — and a relayed server traceback containing a
    # status token must never pattern-match into the transient class
    tfs_fault_class = "deterministic"

    def __init__(self, message: str, status: int, body):
        super().__init__(message)
        self.status = int(status)
        self.body = body


def _decode_error(status: int, raw: bytes):
    try:
        return json.loads(raw.decode())
    except Exception:
        return {"error": "unknown", "message": raw[:200].decode("replace")}


class ServingClient:
    """Client for one serving front-end: ``ServingClient(url)`` (the
    `ServingHandle.url` or the bare ``http://host:port``) or
    ``ServingClient(host=..., port=...)``."""

    def __init__(
        self,
        url: Optional[str] = None,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ):
        if url is not None:
            u = urlparse(url if "//" in url else f"http://{url}")
            host = u.hostname or host
            port = u.port if u.port is not None else port
        if port is None:
            raise ValueError("ServingClient needs a port (or a full url)")
        self.host = host
        self.port = int(port)
        self.timeout_s = timeout_s  # default per-request budget

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/serve"

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        timeout_s: Optional[float] = None,
    ):
        # socket timeout = the request budget + slack: the server
        # enforces the real deadline and answers 504; the socket bound
        # only protects against a dead server (run() always resolves an
        # explicit budget, so the bound always exceeds it)
        sock_timeout = (timeout_s if timeout_s is not None else 30.0) + 10.0
        conn = HTTPConnection(self.host, self.port, timeout=sock_timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    # -- the verbs ------------------------------------------------------
    def run(
        self,
        endpoint: str,
        data,
        timeout_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> TensorFrame:
        """Evaluate ``endpoint`` on ``data`` (a `TensorFrame` or a dict
        of column arrays) and return the outputs-only response frame.
        Raises `OverloadError` (shed — back off by ``retry_after_s``),
        `DeadlineExceeded` (budget blown) or `ServingError`."""
        from .. import config as _config
        from ..io import frame_from_ipc_bytes, frame_to_ipc_bytes

        if not isinstance(data, TensorFrame):
            data = TensorFrame.from_dict(dict(data))
        if timeout_s is None:
            timeout_s = self.timeout_s
        if timeout_s is None:
            # resolve the budget CLIENT-side and state it explicitly, so
            # the socket bound below always exceeds the server's actual
            # budget — a remote server with a raised default can never
            # outlive our socket and turn a typed 504 into a raw
            # socket.timeout
            timeout_s = float(_config.get().serve_default_timeout_s)
        headers = {
            "Content-Type": "application/vnd.apache.arrow.stream",
            "X-TFS-Timeout-S": repr(float(timeout_s)),
        }
        if request_id is not None:
            headers["X-TFS-Request-Id"] = str(request_id)
        status, hdrs, raw = self._request(
            "POST",
            f"/serve/{endpoint}",
            body=frame_to_ipc_bytes(data),
            headers=headers,
            timeout_s=timeout_s,
        )
        if status == 200:
            return frame_from_ipc_bytes(raw)
        body = _decode_error(status, raw)
        msg = body.get("message", f"HTTP {status}")
        if status == 429:
            raise OverloadError(
                msg,
                queue_depth=int(body.get("queue_depth", 0)),
                limit=int(body.get("limit", 0)),
                retry_after_s=float(
                    body.get(
                        "retry_after_s", hdrs.get("Retry-After", 1.0)
                    )
                ),
            )
        if status == 504:
            raise DeadlineExceeded(
                msg,
                verb=f"serve:{endpoint}",
                budget_s=body.get("budget_s"),
                elapsed_s=body.get("elapsed_s"),
            )
        raise ServingError(
            f"endpoint {endpoint!r}: HTTP {status}: {msg}", status, body
        )

    def endpoints(self) -> dict:
        """The server's GET /serve listing (endpoints + batcher
        accounting)."""
        status, _hdrs, raw = self._request("GET", "/serve")
        if status != 200:
            raise ServingError(
                f"GET /serve: HTTP {status}", status, _decode_error(status, raw)
            )
        return json.loads(raw.decode())
