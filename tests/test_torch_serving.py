"""PyTorch port: the serving runtime (`serving/`, `shape_policy.py`, the
executor fault seam), held to the JAX package on the CPU.

Mirrors `tests/test_serving.py`. The same programs, made from a numpy
seed, are registered with both packages (the port with ``device="cpu"``):
their `describe()` payloads and batchability agree, and the same bad
registrations raise `ValueError` in both. The bucket ladder equals JAX's.
The port's micro-batcher coalesces concurrent requests, and each batched
response is bit-identical to the port's unbatched `map_blocks` and within
rtol 1e-6 of the JAX package's response. Over HTTP, each error path gives
the same status code and the same typed client error in both packages.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu import shape_policy as jsp
from tensorframes_tpu.testing import faults as jchaos
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch import shape_policy as tsp
from tensorframes_tpu_torch.runtime import blackbox as tblackbox
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import executor as texec
from tensorframes_tpu_torch.runtime import faults as rtf
from tensorframes_tpu_torch.runtime import materialize as tmat
from tensorframes_tpu_torch.testing import faults as tchaos
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _reset_serving_state():
    yield
    tft.serving.reset()
    ttele.shutdown()
    ttele.reset()
    tprof.reset_stats()
    rtf.reset_ledger()
    tdl.reset()
    tmat.reset_state()
    tblackbox.reset_state()
    tfs.serving.reset()
    jtele.shutdown()


PKGS = {"jax": tfs, "torch": tft}
CHAOS = {"jax": jchaos, "torch": tchaos}
CONFIG = {"jax": jconfig, "torch": tconfig}


def _dev(pkg):
    return {"device": CPU} if pkg is tft else {}


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def _x(pkg, cell=()):
    return pkg.dsl.placeholder(
        pkg.ScalarType.float32, pkg.Shape((None,) + tuple(cell)), name="x"
    )


def _score(pkg, name="score"):
    """2x + 1: elementwise, so batchable."""
    x = _x(pkg)
    return ((x * pkg.dsl.constant(np.float32(2.0))) + pkg.dsl.constant(np.float32(1.0))).named(name)


def _bench_chain(pkg):
    """The elementwise chain of `benchmarks/serving_bench.py`."""
    x = _x(pkg)
    two = pkg.dsl.constant(np.float32(2.0))
    one = pkg.dsl.constant(np.float32(1.0))
    return ((((x * two) + one) * ((x * x) + two)) + one).named("score")


def _mlp_params(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (
            (rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32),
            (rng.randn(b) * 0.1).astype(np.float32),
        )
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


def _mlp_graph(pkg, sizes=(512, 512, 512, 10), seed=0):
    params = _mlp_params(sizes, seed)
    if pkg is tfs:
        import jax.numpy as jnp

        from tensorframes_tpu.models.mlp import MLP

        model = MLP(list(sizes))
        model.params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    else:
        from tensorframes_tpu_torch.models.mlp import MLP

        model = MLP.from_jax_params(params, device=CPU)
    return model.scoring_graph("features", block=True)


def _centered(pkg):
    """x - mean(x): row-preserving but not row-local (a reduce over rows)."""
    x = _x(pkg)
    return (x - pkg.dsl.reduce_mean(x, axes=[0])).named("c")


def _lazy_chain(pkg):
    proto = pkg.TensorFrame.from_dict({"x": np.zeros(4, np.float32)})
    lz = proto.lazy(**_dev(pkg))
    lz = pkg.map_blocks(_score(pkg, "s1"), lz)
    s1 = pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape((None,)), name="s1")
    return pkg.map_blocks((s1 * pkg.dsl.constant(np.float32(3.0))).named("s2"), lz)


PROGRAMS = {
    # name -> (program builder, schema, batchable in JAX)
    "score": (_score, {"x": "float32"}, True),
    "bench_chain": (_bench_chain, {"x": "float32"}, True),
    "mlp": (_mlp_graph, {"features": ("float32", [512])}, False),
    "centered": (_centered, {"x": "float32"}, False),
    "lazy_chain": (_lazy_chain, {"x": "float32"}, True),
}


def _register(pkg, name, fetch, schema, **kw):
    return pkg.serving.register(name, fetch, schema, **_dev(pkg), **kw)


def _req(pkg, n, seed=0, col="x", cell=()):
    rng = np.random.RandomState(seed)
    return pkg.TensorFrame.from_dict({col: rng.rand(n, *cell).astype(np.float32)})


def _host(frame, col):
    return np.asarray(frame.column(col).host_values())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class TestRegistry:
    @pytest.mark.parametrize("program", sorted(PROGRAMS))
    def test_describe_and_batchable_match_jax(self, program):
        build, schema, batchable = PROGRAMS[program]
        eps = {
            key: _register(pkg, program, build(pkg), schema, warm=False, max_batch_rows=64)
            for key, pkg in PKGS.items()
        }
        assert eps["jax"].batchable is batchable
        assert eps["torch"].batchable is batchable
        dj, dt = eps["jax"].describe(), eps["torch"].describe()
        dj.pop("program"), dt.pop("program")
        assert dt == dj
        assert tft.serving.get(program) is eps["torch"]
        assert [e["name"] for e in tft.serving.endpoints()] == [program]

    @pytest.mark.parametrize("program", sorted(PROGRAMS))
    def test_endpoint_output_matches_jax(self, program):
        build, schema, _ = PROGRAMS[program]
        col, cell = next(iter(schema.items()))
        cell = cell[1] if isinstance(cell, tuple) else ()
        outs = {}
        for key, pkg in PKGS.items():
            ep = _register(pkg, program, build(pkg), schema, warm=False, max_batch_rows=64)
            res = ep.run_frame(_req(pkg, 5, seed=3, col=col, cell=cell))
            outs[key] = {c: _host(res, c) for c in res.columns}
        assert outs["torch"].keys() == outs["jax"].keys()
        for c, v in outs["jax"].items():
            np.testing.assert_allclose(outs["torch"][c], v, rtol=1e-5, atol=1e-6)

    def _bad(self, pkg, case):
        if case == "dtype":
            _register(pkg, "bad", _score(pkg), {"x": "int32"}, warm=False)
        elif case == "missing_column":
            _register(pkg, "bad", _score(pkg), {"y": "float32"}, warm=False)
        elif case == "scalar_fetch":
            total = pkg.dsl.reduce_sum(_x(pkg), axes=[0]).named("t")
            _register(pkg, "bad", total, {"x": "float32"}, warm=False)
        elif case == "duplicate":
            _register(pkg, "dup", _score(pkg), {"x": "float32"}, warm=False)
            _register(pkg, "dup", _score(pkg), {"x": "float32"}, warm=False)
        elif case == "lazy_feed_dict":
            _register(
                pkg, "bad", _lazy_chain(pkg), {"x": "float32"}, feed_dict={"x": "x"}, warm=False
            )

    @pytest.mark.parametrize(
        "case", ["dtype", "missing_column", "scalar_fetch", "duplicate", "lazy_feed_dict"]
    )
    def test_bad_registration_raises_in_both(self, case):
        messages = {}
        for key, pkg in PKGS.items():
            with pytest.raises(ValueError) as ei:
                self._bad(pkg, case)
            messages[key] = str(ei.value)
        expect = {
            "dtype": "does not fit the declared",
            "missing_column": "does not fit the declared",
            "scalar_fetch": "row-preserving",
            "duplicate": "already registered",
            "lazy_feed_dict": "feed_dict",
        }[case]
        assert expect in messages["jax"] and expect in messages["torch"]

    def test_replace_and_unregister(self):
        _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        ep2 = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False, replace=True)
        assert tft.serving.get("score") is ep2
        assert tft.serving.unregister("score")
        assert not tft.serving.unregister("score")
        with pytest.raises(KeyError):
            tft.serving.get("score")

    def test_request_validation(self):
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        with pytest.raises(ValueError, match="missing column"):
            ep.validate_request(tft.TensorFrame.from_dict({"y": np.zeros(2, np.float32)}))
        with pytest.raises(ValueError, match="dtype"):
            ep.validate_request(tft.TensorFrame.from_dict({"x": np.zeros(2, np.float64)}))

    def test_warm_then_compile_count_flat(self):
        ex = texec.default_executor()
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, max_batch_rows=64)
        assert list(ep.warmed_rungs) == jsp.bucket_ladder(64)
        base = ex.compile_count
        for n in (1, 3, 5, 8, 13, 21, 34, 55, 64):
            assert ep.run_frame(_req(tft, n, seed=n)).nrows == n
            fut = tft.serving.batcher().submit(ep, _req(tft, n, seed=n + 100))
            assert fut.result(timeout=30).nrows == n
        assert ex.compile_count == base

    def test_default_device_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.serving.register("score", _score(tft), {"x": "float32"}, warm=False)
        assert tft.serving.endpoints() == []


# ---------------------------------------------------------------------------
# the bucket ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "knobs", [{}, {"shape_bucket_growth": 1.5, "shape_bucket_min": 16},
              {"shape_bucket_growth": 3.0, "shape_bucket_min": 4}],
    ids=["default", "g1.5-m16", "g3-m4"],
)
def test_bucket_ladder_equals_jax(knobs):
    with jconfig.override(**knobs), tconfig.override(**knobs):
        ns = range(1, 20_001)
        assert [tsp.bucket_for(n) for n in ns] == [jsp.bucket_for(n) for n in ns]
        for n in ns:
            assert tsp.bucket_ladder(n) == jsp.bucket_ladder(n), n


def test_pad_lead_replicates_last_row():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = jsp.pad_lead(a, 3, 5)
    np.testing.assert_array_equal(tsp.pad_lead(a, 3, 5), want)
    np.testing.assert_array_equal(tsp.pad_lead(torch.from_numpy(a), 3, 5).numpy(), want)
    assert tsp.pad_lead(a, 3, 3) is a


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------


def _concurrent(pkg, ep, reqs):
    results = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def client(i):
        barrier.wait(timeout=30)
        fut = pkg.serving.batcher().submit(ep, reqs[i], request_id=f"r{i}")
        results[i] = _host(fut.result(timeout=60), "score")

    ts = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
    assert not any(t.is_alive() for t in ts)
    return results


class TestBatcher:
    def test_concurrent_submits_coalesce_bit_identical(self):
        sizes = [3, 5, 7, 2, 9, 4, 6, 1]
        out = {}
        for key, pkg in PKGS.items():
            ep = _register(pkg, "bench", _bench_chain(pkg), {"x": "float32"}, warm=False)
            reqs = [_req(pkg, n, seed=i) for i, n in enumerate(sizes)]
            with CONFIG[key].override(serve_batch_window_ms=50.0):
                out[key] = _concurrent(pkg, ep, reqs)
            if pkg is tft:
                snap = tft.serving.batcher().snapshot()
                assert snap["batches"] < snap["batched_requests"] == len(sizes)
                for i, r in enumerate(reqs):
                    direct = tft.map_blocks(_bench_chain(tft), r, device=CPU)
                    np.testing.assert_array_equal(out[key][i], _host(direct, "score"))
        for got, want in zip(out["torch"], out["jax"]):
            np.testing.assert_allclose(got, want, rtol=RTOL)

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_rung_fill_closes_early(self, key):
        pkg = PKGS[key]
        ep = _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        with CONFIG[key].override(serve_batch_window_ms=10_000.0):
            t0 = time.perf_counter()
            pkg.serving.batcher().submit(ep, _req(pkg, 8)).result(timeout=30)
            assert time.perf_counter() - t0 < 5.0

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_window_zero_disables_coalescing(self, key):
        pkg = PKGS[key]
        ep = _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        with CONFIG[key].override(serve_batch_window_ms=0.0):
            pkg.serving.batcher().submit(ep, _req(pkg, 4)).result(timeout=30)
        snap = pkg.serving.batcher().snapshot()
        assert snap["inline"] == 1 and snap["batches"] == 0

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_queue_limit_sheds_typed(self, key):
        pkg, chaos = PKGS[key], CHAOS[key]
        ep = _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        b = pkg.serving.batcher()
        with CONFIG[key].override(serve_queue_limit=1, serve_batch_window_ms=5.0):
            with chaos.inject(rate=1.0, seed=1, fault="hang", delay_s=2.0, max_faults=1) as plan:
                with pkg.deadline_scope(timeout_s=20.0):
                    first = b.submit(ep, _req(pkg, 2))
                _wait_for(lambda: plan.injected == 1, "the dispatcher to enter the hang")
                with pkg.deadline_scope(timeout_s=20.0):
                    b.submit(ep, _req(pkg, 2))  # fills the queue
                    with pytest.raises(pkg.OverloadError) as ei:
                        b.submit(ep, _req(pkg, 2))
                assert ei.value.retry_after_s > 0
                assert ei.value.limit == 1
                first.result(timeout=30)
        assert b.snapshot()["shed"] == 1

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_bad_request_fails_alone(self, key):
        pkg = PKGS[key]
        ep = _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        with pytest.raises(ValueError, match="missing column"):
            pkg.serving.batcher().submit(
                ep, pkg.TensorFrame.from_dict({"nope": np.zeros(2, np.int32)})
            )
        assert pkg.serving.batcher().submit(ep, _req(pkg, 2)).result(timeout=30).nrows == 2

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_multi_block_request_is_one_dispatch(self, key):
        pkg = PKGS[key]
        ep = _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        req = pkg.TensorFrame.from_dict({"x": np.arange(9, dtype=np.float32)}, num_blocks=3)
        out = pkg.serving.batcher().submit(ep, req).result(timeout=30)
        np.testing.assert_array_equal(
            _host(out, "score"), (np.arange(9) * 2.0 + 1.0).astype(np.float32)
        )
        assert pkg.serving.batcher().snapshot()["batches"] == 1

    def test_scatter_copies_each_output_to_host_once(self):
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        reqs = [_req(tft, 2, seed=i) for i in range(6)]
        with tconfig.override(serve_batch_window_ms=200.0):
            _concurrent(tft, ep, reqs)
        snap = tft.serving.batcher().snapshot()
        # host_sync counts device columns crossing to the host; on the CPU
        # the verb's outputs are CPU tensors, one crossing per batch
        assert tprof.stats().get("host_sync", 0) == snap["batches"]

    def test_dispatch_error_reaches_every_member_typed(self):
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        reqs = [_req(tft, 2, seed=i) for i in range(4)]
        errors = []
        with tconfig.override(serve_batch_window_ms=200.0):
            with tchaos.inject(rate=1.0, fault="deterministic", max_faults=1):
                futs = [tft.serving.batcher().submit(ep, r) for r in reqs]
                for f in futs:
                    with pytest.raises(tchaos.InjectedFault) as ei:
                        f.result(timeout=30)
                    errors.append(ei.value)
        assert len({id(e) for e in errors}) == 1
        assert rtf.classify(errors[0]) == "deterministic"
        # the lane goes on serving
        assert tft.serving.batcher().submit(ep, _req(tft, 3)).result(timeout=30).nrows == 3

    def test_sticky_cuda_error_is_deterministic_for_every_member(self, monkeypatch):
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)

        def sticky(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(ep, "run_frame", sticky)
        with tconfig.override(serve_batch_window_ms=200.0):
            futs = [tft.serving.batcher().submit(ep, _req(tft, 2, seed=i)) for i in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError, match="illegal memory access") as ei:
                    f.result(timeout=30)
                assert ei.value.tfs_fault_class == "deterministic"

    def test_reset_stops_lane_threads(self):
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        tft.serving.batcher().submit(ep, _req(tft, 2)).result(timeout=30)
        assert any(t.name == "tfs-serve-score" for t in threading.enumerate())
        tft.serving.reset()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and any(
            t.name == "tfs-serve-score" for t in threading.enumerate()
        ):
            time.sleep(0.05)
        assert not any(t.name == "tfs-serve-score" for t in threading.enumerate())

    def test_submit_after_drop_gets_fresh_lane(self):
        ep = _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        tft.serving.batcher().submit(ep, _req(tft, 2)).result(timeout=30)
        tft.serving.batcher().drop(ep.name)
        assert tft.serving.batcher().submit(ep, _req(tft, 3)).result(timeout=30).nrows == 3

    def test_duplicate_register_rejected_before_warm(self):
        def warm_count():
            return sum(
                v for k, v in ttele.flat_counters().items() if k.startswith("serve_warm_rungs")
            )

        _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        before = warm_count()
        with pytest.raises(ValueError, match="already registered"):
            _register(tft, "score", _score(tft), {"x": "float32"}, max_batch_rows=4096)
        assert warm_count() == before


# ---------------------------------------------------------------------------
# HTTP front-end and client
# ---------------------------------------------------------------------------


@pytest.fixture
def served():
    """Both packages' front-ends, each on its own ephemeral port."""
    handles = {key: pkg.serving.serve(port=0) for key, pkg in PKGS.items()}
    clients = {key: PKGS[key].serving.ServingClient(h.url) for key, h in handles.items()}
    yield handles, clients
    for key, pkg in PKGS.items():
        handles[key].close()
        pkg.telemetry.shutdown()


def _status_and_error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return getattr(e, "status", None), type(e).__name__
    return 200, None


def _swallow(fn):
    try:
        return fn()
    except Exception:
        return None


def _wait_for(cond, what, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


class TestServer:
    def test_round_trip_and_request_id_echo(self, served):
        handles, clients = served
        outs = {}
        for key, pkg in PKGS.items():
            _register(pkg, "bench", _bench_chain(pkg), {"x": "float32"}, warm=False)
            req = _req(pkg, 5, seed=4)
            outs[key] = _host(clients[key].run("bench", req, timeout_s=10.0, request_id="rt-1"), "score")
            r = urllib.request.Request(
                f"{handles[key].url}/bench",
                data=pkg.io.frame_to_ipc_bytes(req),
                method="POST",
                headers={"X-TFS-Request-Id": "echo-7", "X-TFS-Timeout-S": "10"},
            )
            with urllib.request.urlopen(r, timeout=10) as resp:
                assert resp.headers.get("X-TFS-Request-Id") == "echo-7"
        direct = tft.map_blocks(_bench_chain(tft), _req(tft, 5, seed=4), device=CPU)
        np.testing.assert_array_equal(outs["torch"], _host(direct, "score"))
        np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=RTOL)

    def test_unknown_endpoint_404(self, served):
        _handles, clients = served
        got = {
            key: _status_and_error(lambda k=key: clients[k].run("ghost", _req(PKGS[k], 2), timeout_s=5.0))
            for key in PKGS
        }
        assert got["torch"] == got["jax"] == (404, "ServingError")

    def test_malformed_body_400(self, served):
        handles, _clients = served
        codes = {}
        for key in PKGS:
            _register(PKGS[key], "score", _score(PKGS[key]), {"x": "float32"}, warm=False)
            r = urllib.request.Request(f"{handles[key].url}/score", data=b"not arrow", method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(r, timeout=10)
            codes[key] = (ei.value.code, json.loads(ei.value.read().decode())["error"])
        assert codes["torch"][0] == codes["jax"][0] == 400
        assert codes["torch"] == codes["jax"]

    def test_schema_violation_400(self, served):
        _handles, clients = served
        got = {}
        for key, pkg in PKGS.items():
            _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
            got[key] = _status_and_error(
                lambda k=key: clients[k].run("score", {"x": np.zeros(3, np.float64)}, timeout_s=5.0)
            )
        assert got["torch"] == got["jax"] == (400, "ServingError")

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_deadline_504_within_budget(self, served, key):
        _handles, clients = served
        pkg = PKGS[key]
        _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        t0 = time.perf_counter()
        with CHAOS[key].inject(rate=1.0, seed=1, fault="hang", delay_s=30.0):
            with pytest.raises(pkg.DeadlineExceeded):
                clients[key].run("score", _req(pkg, 3), timeout_s=0.3)
        assert time.perf_counter() - t0 < 0.3 + 3.0
        req = _req(pkg, 3, seed=9)
        out = clients[key].run("score", req, timeout_s=10.0)
        np.testing.assert_array_equal(
            _host(out, "score"), (_host(req, "x") * 2.0 + 1.0).astype(np.float32)
        )

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_overload_429_with_retry_after(self, served, key):
        handles, clients = served
        pkg = PKGS[key]
        _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        client = clients[key]
        with CONFIG[key].override(serve_queue_limit=1):
            with CHAOS[key].inject(rate=1.0, seed=2, fault="hang", delay_s=3.0, max_faults=1) as plan:
                hold = threading.Thread(
                    target=lambda: _swallow(lambda: client.run("score", _req(pkg, 2), timeout_s=15.0))
                )
                hold.start()
                _wait_for(lambda: plan.injected == 1, "the dispatcher to enter the hang")
                filler = threading.Thread(
                    target=lambda: _swallow(lambda: client.run("score", _req(pkg, 2), timeout_s=15.0))
                )
                filler.start()
                _wait_for(lambda: pkg.serving.batcher().pending() == 1, "the filler to queue")
                r = urllib.request.Request(
                    f"{handles[key].url}/score",
                    data=pkg.io.frame_to_ipc_bytes(_req(pkg, 2)),
                    method="POST",
                    headers={"X-TFS-Timeout-S": "15"},
                )
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(r, timeout=10)
                assert ei.value.code == 429
                assert int(ei.value.headers.get("Retry-After")) >= 1
                assert json.loads(ei.value.read().decode())["error"] == "OverloadError"
                with pytest.raises(pkg.OverloadError) as oe:
                    client.run("score", _req(pkg, 2), timeout_s=15.0)
                assert oe.value.retry_after_s > 0 and oe.value.limit == 1
                filler.join(timeout=60)
                hold.join(timeout=60)
        assert not filler.is_alive() and not hold.is_alive()

    @pytest.mark.parametrize("key", sorted(PKGS))
    def test_draining_503_then_drain_frees_port(self, served, key):
        handles, clients = served
        pkg = PKGS[key]
        _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
        from importlib import import_module

        srv = import_module(f"{pkg.__name__}.serving.server")
        srv.set_draining(True)
        status, err = _status_and_error(lambda: clients[key].run("score", _req(pkg, 2), timeout_s=5.0))
        assert (status, err) == (503, "ServingError")
        acct = pkg.serving.drain(timeout_s=5.0)
        assert acct["drained"] and acct["stopped_server"]
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://{handles[key].host}:{handles[key].port}/healthz", timeout=5)
        # registrations survive; a fresh serve() clears the flag
        handle2 = pkg.serving.serve(port=0)
        out = pkg.serving.ServingClient(handle2.url).run("score", _req(pkg, 2), timeout_s=10.0)
        assert out.nrows == 2 and not srv.draining()

    def test_telemetry_served_beside_serving(self, served):
        handles, _clients = served
        h = handles["torch"]
        base = f"http://{h.host}:{h.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert b"tfs_" in r.read()
        with urllib.request.urlopen(base, timeout=10) as r:
            assert "/serve" in json.loads(r.read().decode())["routes"]
        with urllib.request.urlopen(f"{base}/serve", timeout=10) as r:
            listing = json.loads(r.read().decode())
        assert listing["service"] == "tensorframes_tpu_torch serving"

    def test_concurrent_clients_spans_carry_request_ids(self, served):
        _handles, clients = served
        _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        errors = []

        def one(i):
            try:
                req = _req(tft, 3, seed=i)
                out = clients["torch"].run("score", req, timeout_s=15.0, request_id=f"cc-{i}")
                np.testing.assert_array_equal(
                    _host(out, "score"), (_host(req, "x") * 2.0 + 1.0).astype(np.float32)
                )
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append((i, repr(e)))

        ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors
        labeled = [s for s in ttele.spans() if s.kind == "verb" and "request" in s.attrs]
        seen = ",".join(str(s.attrs["request"]) for s in labeled)
        for i in range(8):
            assert f"cc-{i}" in seen, f"request cc-{i} unattributed"
        trace = ttele.export_chrome_trace()
        ids = {ev["args"]["span_id"] for ev in trace["traceEvents"]}
        for ev in trace["traceEvents"]:
            parent = ev["args"].get("parent_id")
            assert parent is None or parent in ids, f"orphan parent {parent}"

    def test_close_unmounts_but_keeps_server(self, served):
        handles, clients = served
        got = {}
        for key, pkg in PKGS.items():
            _register(pkg, "score", _score(pkg), {"x": "float32"}, warm=False)
            handles[key].close()
            got[key] = _status_and_error(lambda k=key: clients[k].run("score", _req(PKGS[k], 2), timeout_s=5.0))
            base = f"http://{handles[key].host}:{handles[key].port}"
            with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
                assert r.status == 200
        assert got["torch"] == got["jax"] == (404, "ServingError")

    def test_shutdown_frees_port_and_remount(self):
        handle = tft.serving.serve(port=0)
        _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        client = tft.serving.ServingClient(handle.url)
        assert client.run("score", _req(tft, 2), timeout_s=10.0).nrows == 2
        assert ttele.shutdown() is True
        assert ttele.shutdown() is False
        with pytest.raises(OSError):
            client.run("score", _req(tft, 2), timeout_s=2.0)
        handle2 = tft.serving.serve(port=0)
        out = tft.serving.ServingClient(handle2.url).run("score", _req(tft, 2), timeout_s=10.0)
        assert out.nrows == 2

    def test_reset_clears_active_handle(self):
        handle = tft.serving.serve(port=0)
        assert tft.serving.active() is handle
        tft.serving.reset()
        assert tft.serving.active() is None

    def test_client_closes_first_so_the_server_keeps_no_time_wait(self):
        """The side that closes a TCP connection first holds it in TIME_WAIT.
        The server answers HTTP/1.1 and waits for the client's close, so its
        port never pins a client's next connect from the same port."""
        handle = tft.serving.serve(port=0)
        _register(tft, "score", _score(tft), {"x": "float32"}, warm=False)
        client = tft.serving.ServingClient(handle.url)
        for seed in range(5):
            assert client.run("score", _req(tft, 3, seed=seed), timeout_s=10.0).nrows == 3

        def time_wait(side):
            states = []
            for name in ("/proc/net/tcp", "/proc/net/tcp6"):
                with open(name) as f:
                    for line in f.read().splitlines()[1:]:
                        fields = line.split()
                        local, remote, st = fields[1], fields[2], fields[3]
                        port = int((local if side == "server" else remote).rsplit(":", 1)[1], 16)
                        states.append(port == handle.port and st == "06")
            return sum(states)

        deadline = time.monotonic() + 5.0
        while time_wait("client") < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert time_wait("client") >= 5  # the client closed each connection first
        assert time_wait("server") == 0

    def test_serve_imports_the_codec_on_the_callers_thread(self):
        """A fresh process: serve() imports pyarrow on its own thread, and
        rounds of client threads (each exits after its requests, like the
        server's handler threads) encode and decode without crashing."""
        import os
        import subprocess
        import sys

        code = (
            "import sys, threading\n"
            "import numpy as np\n"
            "import tensorframes_tpu_torch as tft\n"
            "assert 'pyarrow' not in sys.modules\n"
            "h = tft.serving.serve(port=0)\n"
            "assert 'pyarrow' in sys.modules\n"
            "x = tft.dsl.placeholder(tft.ScalarType.float32, tft.Shape((None, 64)), name='x')\n"
            "w = tft.dsl.constant(np.eye(64, 8, dtype=np.float32))\n"
            "tft.serving.register('mm', tft.dsl.matmul(x, w).named('y'),\n"
            "                     {'x': ('float32', [64])}, device='cpu')\n"
            "feats = np.random.RandomState(0).rand(256, 64).astype(np.float32)\n"
            "def work():\n"
            "    c = tft.serving.ServingClient(h.url)\n"
            "    for _ in range(4):\n"
            "        assert c.run('mm', {'x': feats}, timeout_s=30).nrows == 256\n"
            "for _ in range(4):\n"
            "    ts = [threading.Thread(target=work) for _ in range(8)]\n"
            "    [t.start() for t in ts]; [t.join(timeout=60) for t in ts]\n"
            "tft.serving.drain(timeout_s=10)\n"
            "print('ok')\n"
        )
        r = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


# ---------------------------------------------------------------------------
# the executor fault seam
# ---------------------------------------------------------------------------


class TestFaultSeam:
    def _run(self, pkg, chaos, **plan_kw):
        df = pkg.TensorFrame.from_dict({"x": np.arange(16, dtype=np.float32)}, num_blocks=8)
        fetch = (pkg.block(df, "x") * 2.0).named("y")
        with chaos.inject(**plan_kw) as plan:
            try:
                pkg.map_blocks(fetch, df, **_dev(pkg))
                err = None
            except Exception as e:  # noqa: BLE001 - compared below
                err = e
        return plan, err

    @pytest.mark.parametrize(
        "plan_kw",
        [
            {"nth": [3], "fault": "deterministic"},
            {"rate": 0.5, "seed": 7, "fault": "deterministic"},
            {"rate": 1.0, "fault": "resource", "kind": "no-such-kind"},
        ],
        ids=["nth", "rate", "kind-filter"],
    )
    def test_verdicts_match_jax(self, plan_kw):
        got = {}
        for key, pkg in PKGS.items():
            plan, err = self._run(pkg, CHAOS[key], **plan_kw)
            got[key] = (plan.injected, list(plan.faulted_ordinals), type(err).__name__)
        assert got["torch"] == got["jax"]

    def test_hang_sleeps_then_dispatches(self):
        plan, err = self._run(tft, tchaos, nth=[0], fault="hang", delay_s=0.05)
        assert err is None and plan.injected == 1 and plan.dispatches == 8

    def test_nesting_raises(self):
        with tchaos.inject(rate=0.0):
            with pytest.raises(RuntimeError, match="already active"):
                with tchaos.inject(rate=0.0):
                    pass
        assert texec._fault_injector is None

    def test_device_label_filter(self):
        plan, err = self._run(tft, tchaos, rate=1.0, fault="deterministic", device="cpu:0")
        assert plan.injected == 1 and plan.faulted_devices == ["cpu:0"]
        plan, err = self._run(tft, tchaos, rate=1.0, fault="deterministic", device="cuda:0")
        assert plan.injected == 0 and err is None
