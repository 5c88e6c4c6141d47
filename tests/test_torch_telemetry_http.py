"""PyTorch port: the telemetry HTTP surface (`utils/telemetry_http.py`), the
exporters and request attribution of `utils/telemetry.py`, and device
health (`runtime/scheduler.py`), held to the JAX package on the CPU.

Mirrors the serving and exporter parts of `tests/test_telemetry.py` and
the /healthz rows of the JAX scheduler. The same sequence of counter,
gauge and histogram calls gives the same Prometheus metric names, types,
label sets and bucket bounds in both packages; ``/healthz`` has the JAX
package's keys, and its ``ready`` flag follows the port's OWN serving
front-end while both packages' servers run in one process; ``/trace`` is
Chrome-trace JSON whose verb spans carry the request ids.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.runtime import deadline as jdl
from tensorframes_tpu.serving import server as jserver
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu.utils import telemetry_http as jhttp
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.runtime import blackbox as tblackbox
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as rtf
from tensorframes_tpu_torch.runtime import scheduler as tsched
from tensorframes_tpu_torch.serving import server as tserver
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele
from tensorframes_tpu_torch.utils import telemetry_http as thttp

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    tft.serving.reset()
    ttele.shutdown()
    ttele.reset()
    tprof.reset_stats()
    rtf.reset_ledger()
    tdl.reset()
    tblackbox.reset_state()
    tfs.serving.reset()
    jtele.shutdown()


TELE = {"jax": jtele, "torch": ttele}


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


def _drive(tele):
    tele.counter_inc("serve_requests", 1.0, endpoint="score")
    tele.counter_inc("serve_requests", 2.0, endpoint="bench")
    tele.counter_inc("checkpoint_commits", 3.0)
    tele.counter_inc("odd_name.with-dots", 1.0, path='a"b\\c\nd')
    tele.gauge_set("stream_queue_depth", 4.0)
    tele.gauge_set("ingest_queue_depth", 2.0, stage="decode")
    for v in (0.0004, 0.02, 3.0, 50.0):
        tele.histogram_observe("verb_seconds", v, verb="map_blocks")
    for v in (5.0, 700.0, 3e6):
        tele.histogram_observe("serve_batch_rows", v)
    tele.histogram_observe("serve_batch_fill", 8.0)
    tele.histogram_observe("bucket_fill", 0.73, verb="serve:score")
    tele.histogram_observe("h2d_bytes", 70000.0)
    tele.histogram_observe("serve_queue_seconds", 0.001)


_DRIVEN = (
    "tfs_serve_requests", "tfs_checkpoint_commits", "tfs_odd_name_with_dots",
    "tfs_stream_queue_depth", "tfs_ingest_queue_depth", "tfs_verb_seconds",
    "tfs_serve_batch_rows", "tfs_serve_batch_fill", "tfs_bucket_fill",
    "tfs_h2d_bytes", "tfs_serve_queue_seconds",
)


def _parse(text):
    """{family: type}, {sample line without HELP} for the driven families."""
    types, samples = {}, set()
    for line in text.splitlines():
        m = re.match(r"# TYPE (\S+) (\S+)", line)
        if m:
            types[m.group(1)] = m.group(2)
            continue
        if line.startswith("#") or not line:
            continue
        name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
        fam = re.sub(r"_(bucket|sum|count)$", "", name)
        if fam in _DRIVEN or name in _DRIVEN:
            samples.add(line)
    return {k: v for k, v in types.items() if k in _DRIVEN}, samples


def test_prometheus_names_types_labels_buckets_match_jax():
    texts = {}
    for key, tele in TELE.items():
        tele.reset()
        _drive(tele)
        texts[key] = tele.export_prometheus()
    types_j, samples_j = _parse(texts["jax"])
    types_t, samples_t = _parse(texts["torch"])
    assert types_t == types_j and set(types_t) == set(_DRIVEN)
    assert samples_t == samples_j
    # every TYPE line is preceded by its HELP line
    lines = texts["torch"].splitlines()
    for i, line in enumerate(lines):
        if line.startswith("# TYPE "):
            assert lines[i - 1].startswith("# HELP " + line.split()[2] + " ")


@pytest.mark.parametrize(
    "name", ["verb_seconds", "serve_batch_rows", "serve_batch_fill", "bucket_fill",
             "h2d_bytes", "d2h_bytes", "checkpoint_write_seconds",
             "incident_capture_seconds", "serve_queue_seconds"],
)
def test_bucket_ladders_equal_jax(name):
    assert ttele._buckets_for(name) == jtele._buckets_for(name)


def test_histogram_bucket_override_matches_jax():
    over = {"seconds": [0.5, 1.0, 2.0], "serve_batch_rows": [10.0, 100.0], "rows": [3.0, 1.0]}
    with jconfig.override(histogram_buckets=over), tconfig.override(histogram_buckets=over):
        for name in ("verb_seconds", "serve_batch_rows", "serve_batch_fill", "bucket_fill"):
            assert ttele._buckets_for(name) == jtele._buckets_for(name), name


def test_chrome_trace_schema(tmp_path):
    with ttele.span("outer", kind="verb", rows=np.int64(3)):
        with ttele.span("inner", kind="stage"):
            pass
    path = str(tmp_path / "trace.json")
    obj = ttele.export_chrome_trace(path)
    with open(path) as f:
        assert json.load(f) == obj
    ev = {e["name"]: e for e in obj["traceEvents"]}
    assert ev["inner"]["args"]["parent_id"] == ev["outer"]["args"]["span_id"]
    assert ev["outer"]["args"]["rows"] == 3 and ev["outer"]["ph"] == "X"
    assert obj["otherData"]["producer"] == "tensorframes_tpu_torch.telemetry"


def test_span_aggregates_match_jax_shape():
    for tele in TELE.values():
        tele.reset()
        with tele.span("map_blocks", kind="verb", rows=4):
            with tele.span("plan", kind="stage", program="p1"):
                pass
    aj, at = jtele.span_aggregates(), ttele.span_aggregates()
    assert at.keys() == aj.keys()
    assert at["by_verb"]["map_blocks"]["calls"] == aj["by_verb"]["map_blocks"]["calls"] == 1
    assert at["by_kind"].keys() == aj["by_kind"].keys()
    assert at["by_program"].keys() == aj["by_program"].keys() == {"p1"}
    assert ttele.span_aggregates([])["spans"] == 0


def test_request_scope_labels_verb_spans_only():
    df = tft.TensorFrame.from_dict({"x": np.arange(4.0)})
    with ttele.request_scope("req-9"):
        assert ttele.current_request() == "req-9"
        with ttele.span("stage-only", kind="stage"):
            pass
        tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU)
    assert ttele.current_request() is None
    spans = {s.name: s for s in ttele.spans()}
    assert spans["map_blocks"].kind == "verb"
    assert spans["map_blocks"].attrs["request"] == "req-9"
    assert "request" not in spans["stage-only"].attrs


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


@pytest.fixture
def both_servers():
    servers = {"jax": jhttp.serve(port=0), "torch": thttp.serve(port=0)}
    yield servers
    for mod in (jhttp, thttp):
        mod.shutdown()


def test_healthz_keys_match_jax(both_servers):
    payloads = {k: json.loads(_get(s.url + "/healthz")[2]) for k, s in both_servers.items()}
    assert payloads["torch"].keys() == payloads["jax"].keys()
    assert payloads["torch"]["status"] == "ok" and payloads["torch"]["ready"] is True
    row_j, row_t = payloads["jax"]["devices"][0], payloads["torch"]["devices"][0]
    assert row_t.keys() == row_j.keys()
    assert [r["device"] for r in payloads["torch"]["devices"]] == ["cpu:0"]
    assert row_t["state"] == "closed"
    assert payloads["torch"]["admission"].keys() == payloads["jax"]["admission"].keys()


def test_healthz_ready_follows_own_serving_drain(both_servers):
    urls = {k: s.url + "/healthz" for k, s in both_servers.items()}
    tserver.set_draining(True)
    try:
        pt = json.loads(_get(urls["torch"])[2])
        pj = json.loads(_get(urls["jax"])[2])
        assert pt["ready"] is False and pt["status"] == "draining" and pt["draining"]
        assert pj["ready"] is True
    finally:
        tserver.set_draining(False)
    jserver.set_draining(True)
    try:
        assert json.loads(_get(urls["torch"])[2])["ready"] is True
        assert json.loads(_get(urls["jax"])[2])["ready"] is False
    finally:
        jserver.set_draining(False)


@pytest.mark.parametrize("overloaded", [False, True])
def test_healthz_degraded_follows_admission_like_jax(both_servers, monkeypatch, overloaded):
    for dl in (jdl, tdl):
        snap = dl.controller().snapshot()
        monkeypatch.setattr(
            dl.controller(), "snapshot", lambda snap=snap: {**snap, "overloaded": overloaded}
        )
    payloads = {k: json.loads(_get(s.url + "/healthz")[2]) for k, s in both_servers.items()}
    for key in ("status", "degraded", "overloaded", "ready"):
        assert payloads["torch"][key] == payloads["jax"][key], key
    assert payloads["torch"]["status"] == ("degraded" if overloaded else "ok")


def test_listen_backlog_holds_a_client_burst():
    """Connections the accept loop has not reached yet wait in the kernel's
    accept queue. The stdlib's backlog of 5 holds six; a seventh SYN is
    dropped and its client waits out a 1 s retransmit. The port's server
    holds a burst of 32 clients without one."""
    import select
    import socket
    import time

    httpd = thttp._HTTPServer(("127.0.0.1", 0), thttp._Handler)  # listening, not accepting
    socks = []
    try:
        for _ in range(32):
            c = socket.socket()
            c.setblocking(False)
            c.connect_ex(httpd.server_address)
            socks.append(c)
        pending, deadline = list(socks), time.monotonic() + 0.5
        while pending and time.monotonic() < deadline:
            _r, ready, _x = select.select([], pending, [], 0.05)
            pending = [c for c in pending if c not in ready]
        assert not pending, f"{len(pending)} of 32 connects still waiting after 0.5 s"
        assert all(c.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR) == 0 for c in socks)
    finally:
        for c in socks:
            c.close()
        httpd.server_close()


def test_metrics_route_and_content_type(both_servers):
    ttele.counter_inc("serve_requests", 1.0, endpoint="e")
    status, ctype, body = _get(both_servers["torch"].url + "/metrics")
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert 'tfs_serve_requests{endpoint="e"} 1' in body.decode()


def test_trace_route_spans_carry_request_ids(both_servers):
    df = tft.TensorFrame.from_dict({"x": np.arange(4.0)})
    for rid in ("t-1", "t-2"):
        with ttele.request_scope(rid):
            tft.map_blocks((tft.block(df, "x") * 2.0).named("y"), df, device=CPU)
    trace = json.loads(_get(both_servers["torch"].url + "/trace")[2])
    rids = [e["args"].get("request") for e in trace["traceEvents"] if e["cat"] == "verb"]
    assert rids == ["t-1", "t-2"]


def test_root_lists_existing_routes_and_unported_routes_404(both_servers):
    """The port serves the JAX package's routes, /diagnostics and /profile
    included; an unknown route answers 404 with a JSON error body."""
    url = both_servers["torch"].url
    root = json.loads(_get(url + "/")[2])
    jroot = json.loads(_get(both_servers["jax"].url + "/")[2])
    assert root["routes"][:5] == jroot["routes"][:5] == [
        "/metrics", "/healthz", "/diagnostics", "/trace", "/profile"
    ]
    assert "/incidents" in root["routes"]
    for path in ("/diagnostics", "/profile"):
        assert _get(url + path)[0] == 200
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url + "/nope")
    assert ei.value.code == 404
    assert "error" in json.loads(ei.value.read().decode())


def test_mount_unmount_and_handler_errors(both_servers):
    url = both_servers["torch"].url

    def ok(method, path, headers, body):
        return 200, "application/json", json.dumps({"m": method, "p": path}).encode(), {"X-A": "1"}

    def boom(method, path, headers, body):
        raise RuntimeError("route bug")

    thttp.mount("/ext", ok)
    thttp.mount("/ext/deep", boom)
    try:
        with pytest.raises(ValueError, match="already mounted"):
            thttp.mount("/ext", ok)
        with pytest.raises(ValueError):
            thttp.mount("/", ok)
        with urllib.request.urlopen(url + "/ext/x", timeout=10) as r:
            assert json.loads(r.read()) == {"m": "GET", "p": "/ext/x"}
            assert r.headers.get("X-A") == "1"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url + "/ext/deep/y")  # the longest prefix wins
        assert ei.value.code == 500
        # the server survived the broken route
        assert _get(url + "/healthz")[0] == 200
    finally:
        assert thttp.unmount("/ext") and thttp.unmount("/ext/deep")
    assert not thttp.unmount("/ext")


def test_concurrent_scrapes_while_counting(both_servers):
    url = both_servers["torch"].url
    stop = threading.Event()
    errors = []

    def bump():
        while not stop.is_set():
            ttele.counter_inc("serve_requests", 1.0, endpoint="hot")
            ttele.histogram_observe("verb_seconds", 0.01, verb="map_blocks")

    def scrape():
        try:
            for _ in range(10):
                for path in ("/metrics", "/healthz", "/trace"):
                    assert _get(url + path)[0] == 200
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    writer = threading.Thread(target=bump)
    writer.start()
    ts = [threading.Thread(target=scrape) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    stop.set()
    writer.join(timeout=10)
    assert not errors, errors


def test_serve_is_idempotent_and_shutdown_frees_port():
    srv = ttele.serve(port=0)
    assert ttele.serve(port=0) is srv and thttp.active_server() is srv
    with pytest.raises(RuntimeError, match="already serving"):
        ttele.serve(port=srv.port + 1 if srv.port < 65535 else srv.port - 1)
    assert ttele.shutdown() is True and ttele.shutdown() is False
    assert thttp.active_server() is None
    with pytest.raises(OSError):
        _get(srv.url + "/healthz")


def test_maybe_serve_follows_config():
    assert ttele.maybe_serve() is None  # telemetry_port 0: off
    with pytest.raises(ValueError, match="telemetry_port"):
        ttele.serve()
    with tconfig.override(telemetry_port=0, telemetry_host="127.0.0.1"):
        assert ttele.maybe_serve() is None
    srv = thttp.serve(port=0)
    with tconfig.override(telemetry_port=srv.port):
        assert ttele.maybe_serve() is srv


# ---------------------------------------------------------------------------
# device health
# ---------------------------------------------------------------------------


def test_device_labels_and_overview():
    import torch

    assert tsched.device_label(torch.device("cpu")) == "cpu:0"
    assert tsched.device_label("cuda:1") == "cuda:1"
    assert tsched.device_label(torch.device("cuda")) == "cuda:0"
    rows = tsched.health_overview()
    assert [r["device"] for r in rows] == ["cpu:0"]
    assert rows[0]["device_kind"] == "cpu"
    assert (rows[0]["state"], rows[0]["failures"], rows[0]["retry_in_s"]) == ("closed", 0, 0.0)


def test_health_overview_lists_cuda_cards(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: f"Card {i}")
    rows = tsched.health_overview()
    assert [(r["device"], r["device_kind"]) for r in rows] == [
        ("cuda:0", "Card 0"), ("cuda:1", "Card 1"),
    ]
