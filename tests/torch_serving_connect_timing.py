"""Where a slow served request waits: connect, send, or the server.

Serves phase 15 (b)'s endpoint of ``chip_smoke.py`` (BASELINE config 3's
MLP, 512-512-512-10, 2,048-row requests of 4 MiB) from the port's HTTP
server and runs rounds of 8 client threads x 16 requests through
``ServingClient``. Every request is timestamped on both ends: the client's
connect, send and response, the server's handler-thread start, body read
and response write. Each round prints its slowest request; a round whose
slowest request takes over 1 s counts as stalled.

Before the rounds it prints the machine's network facts and two socket
checks: how many of 32 non-blocking connects a listener that does not
accept holds at backlog 5 and 128, and whether a connect from a client
port the server side still holds in TIME_WAIT (the server closed first)
goes through, after 1 byte, 8 KiB or 4 MiB on the old connection.

    python tests/torch_serving_connect_timing.py ROUNDS [http10|http11]

The second argument sets the server's HTTP version (default: the
server's own, HTTP/1.1). It runs on the card when there is one, else on
the CPU. Not collected by pytest.
"""

import http.client
import json
import math
import os
import select
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pyarrow  # noqa: F401 - first import on the main thread
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import MLP
from tensorframes_tpu_torch.serving import client as sclient
from tensorframes_tpu_torch.utils import telemetry_http as thttp


def network_facts() -> None:
    print(open("/proc/version").read().strip(), flush=True)
    for k in ("tcp_syn_retries", "tcp_synack_retries", "tcp_rmem", "tcp_wmem"):
        try:
            print(k, open(f"/proc/sys/net/ipv4/{k}").read().strip(), flush=True)
        except OSError as e:
            print(k, "unreadable:", type(e).__name__, flush=True)


def connect_burst(backlog: int, n: int = 32) -> int:
    """Connects that complete within 3 s against a listener that never
    accepts."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(backlog)
    socks = []
    for _ in range(n):
        c = socket.socket()
        c.setblocking(False)
        c.connect_ex(ls.getsockname())
        socks.append(c)
    pending, deadline = list(socks), time.monotonic() + 3.0
    while pending and time.monotonic() < deadline:
        _r, ready, _x = select.select([], pending, [], 0.05)
        pending = [c for c in pending if c not in ready]
    for c in socks:
        c.close()
    ls.close()
    return n - len(pending)


def reconnect_from_time_wait_port(nbytes: int, gap_s: float = 0.3) -> str:
    """The server closes first after ``nbytes`` from the client; then a new
    connect from the same client port."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(128)
    server = ls.getsockname()
    c = socket.socket()
    c.bind(("127.0.0.1", 0))
    port = c.getsockname()[1]
    c.connect(server)
    a, _ = ls.accept()
    sender = threading.Thread(target=c.sendall, args=(b"x" * nbytes,))
    sender.start()
    got = 0
    while got < nbytes:
        got += len(a.recv(1 << 20))
    sender.join()
    a.sendall(b"y")
    a.close()
    assert c.recv(1) == b"y" and c.recv(1) == b""
    c.close()
    time.sleep(gap_s)
    c2 = socket.socket()
    c2.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    c2.bind(("127.0.0.1", port))
    c2.settimeout(10.0)
    t0 = time.monotonic()
    try:
        c2.connect(server)
        out = f"connected after {time.monotonic() - t0:.3f} s"
    except OSError as e:
        out = f"no connection after {time.monotonic() - t0:.3f} s ({e!r})"
    c2.close()
    ls.close()
    return out


CLIENT, SERVER = {}, {}


class _TimedConnection(http.client.HTTPConnection):
    def request(self, method, url, body=None, headers={}, **kw):
        self._rec = CLIENT.setdefault(headers.get("X-TFS-Request-Id"), {})
        self._rec["t0"] = time.monotonic()
        self.connect()
        self._rec["connected"] = time.monotonic()
        self._rec["port"] = self.sock.getsockname()[1]
        super().request(method, url, body=body, headers=headers, **kw)
        self._rec["sent"] = time.monotonic()

    def getresponse(self):
        r = super().getresponse()
        self._rec["headers"] = time.monotonic()
        return r


class _TimedReader:
    def __init__(self, raw, port):
        self._raw, self._port = raw, port

    def __getattr__(self, name):
        return getattr(self._raw, name)

    def read(self, n=-1):
        rec = SERVER.setdefault(self._port, {})
        rec["body_start"] = time.monotonic()
        out = self._raw.read(n)
        rec["body_read"] = time.monotonic()
        return out


def _instrument() -> None:
    sclient.HTTPConnection = _TimedConnection
    handle, setup, mounted = (
        thttp._Handler.handle, thttp._Handler.setup, thttp._Handler._try_mounted
    )

    def timed_handle(self):
        SERVER.setdefault(self.client_address[1], {})["thread_start"] = time.monotonic()
        handle(self)

    def timed_setup(self):
        setup(self)
        self.rfile = _TimedReader(self.rfile, self.client_address[1])

    def timed_mounted(self, method):
        rec = SERVER.setdefault(self.client_address[1], {})
        rec["headers_parsed"] = time.monotonic()
        ok = mounted(self, method)
        rec["written"] = time.monotonic()
        return ok

    thttp._Handler.handle = timed_handle
    thttp._Handler.setup = timed_setup
    thttp._Handler._try_mounted = timed_mounted


def main() -> int:
    rounds = int(sys.argv[1])
    if len(sys.argv) > 2:
        thttp._Handler.protocol_version = {"http10": "HTTP/1.0", "http11": "HTTP/1.1"}[sys.argv[2]]
    network_facts()
    for backlog in (5, 128):
        print(f"burst: backlog {backlog} holds {connect_burst(backlog)} of 32 connects", flush=True)
    for nbytes in (1, 8192, 4 << 20):
        print(f"reconnect from a TIME_WAIT port after {nbytes} bytes: "
              f"{reconnect_from_time_wait_port(nbytes)}", flush=True)
    _instrument()
    print("server protocol", thttp._Handler.protocol_version, flush=True)

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    sizes = [512, 512, 512, 10]
    rng = np.random.default_rng(0)
    params = [
        ((rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
         (rng.standard_normal(b) * 0.1).astype(np.float32))
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    probs = MLP.from_jax_params(params, device=dev).scoring_graph("features", block=True)
    tft.serving.register("mlp", probs, {"features": ("float32", [512])}, device=dev)
    handle = tft.serving.serve(port=0)
    feats = [rng.standard_normal((2048, 512)).astype(np.float32) for _ in range(128)]
    stalled = 0
    for rnd in range(rounds):
        CLIENT.clear()
        SERVER.clear()

        def work(c):
            cl = tft.serving.ServingClient(handle.url)
            for k in range(16):
                rid = f"r{rnd}-{c * 16 + k}"
                cl.run("mlp", {"features": feats[c * 16 + k]}, timeout_s=120.0, request_id=rid)
                CLIENT[rid]["done"] = time.monotonic()

        threads = [threading.Thread(target=work, args=(c,)) for c in range(8)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        rid, rec = max(CLIENT.items(), key=lambda kv: kv[1]["done"] - kv[1]["t0"])

        def rel(d):
            return {k: round(v - rec["t0"], 4) for k, v in d.items() if isinstance(v, float)}

        stalled += rec["done"] - rec["t0"] > 1.0
        print(json.dumps({
            "round": rnd, "wall": round(wall, 3), "slowest": rid,
            "client": rel(rec), "server": rel(SERVER.get(rec["port"], {})),
        }), flush=True)
    print(f"stalled rounds: {stalled} of {rounds}", flush=True)
    tft.serving.drain(timeout_s=30.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
