"""PyTorch port: deadlines, cancellation, admission (`runtime/deadline.py`)
and the fault taxonomy (`runtime/faults.py`), held to the JAX package on
the CPU.

Mirrors `tests/test_deadline.py`: the primitives; ``timeout_s=`` and
admission on `map_blocks`, `map_rows` and `reduce_blocks` (each package
against its own controller, same verdicts and results); backoff clipped to
the deadline; the stage hang injection. `classify` agrees with the JAX
package on the cases they share, and sorts torch's out-of-memory error
as ``resource`` and a sticky CUDA error as ``deterministic`` — never
retried, since the CUDA context is lost after one.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.runtime import deadline as jdl
from tensorframes_tpu.runtime import faults as jfaults
from tensorframes_tpu_torch import api as tapi
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.runtime import deadline as dl
from tensorframes_tpu_torch.runtime import faults as rtf
from tensorframes_tpu_torch.runtime import retry as tretry
from tensorframes_tpu_torch.testing import faults as chaos
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
VERBS = ["map_blocks", "map_rows", "reduce_blocks"]


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    ttele.reset()
    tprof.reset_stats()
    rtf.reset_ledger()
    dl.reset()


def _data(n=64, seed=0):
    return np.random.RandomState(seed).rand(n).astype(np.float32)


def _call(pkg, verb, x, **kw):
    """One verb of ``pkg`` over a 4-block frame of ``x``, as numpy."""
    df = pkg.TensorFrame.from_dict({"x": x}, num_blocks=4)
    dev = {"device": CPU} if pkg is tft else {}
    if verb == "reduce_blocks":
        fetch = pkg.dsl.reduce_sum(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
        return np.asarray(pkg.reduce_blocks(fetch, df, **dev, **kw))
    if verb == "map_blocks":
        fetch = (pkg.block(df, "x") * 2.0 + 1.0).named("y")
        out = pkg.map_blocks(fetch, df, **dev, **kw)
    else:
        fetch = (pkg.row(df, "x") * 2.0 + 1.0).named("y")
        out = pkg.map_rows(fetch, df, **dev, **kw)
    return np.asarray(out["y"].host_values())


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class TestPrimitives:
    def test_deadline_after_remaining_expired(self):
        d = dl.Deadline.after(0.05)
        assert 0.0 < d.remaining() <= 0.05 and not d.expired()
        time.sleep(0.07)
        assert d.expired() and d.remaining() < 0.0

    def test_tightened_min_wins(self):
        a, b = dl.Deadline.after(10.0), dl.Deadline.after(0.1)
        assert a.tightened(b) is b and b.tightened(a) is b and a.tightened(None) is a

    def test_cancel_raises_and_wakes_sleep(self):
        s = dl.CancelScope(verb="t")
        done = []

        def sleeper():
            try:
                s.sleep(10.0, "test")
            except dl.Cancelled as e:
                done.append(e)

        th = threading.Thread(target=sleeper)
        th.start()
        time.sleep(0.1)
        s.cancel("user abort")
        th.join(timeout=5.0)
        assert not th.is_alive()
        assert done and done[0].reason == "user abort"
        with pytest.raises(dl.Cancelled):
            s.check("after")

    def test_sleep_clips_to_deadline(self):
        s = dl.CancelScope(deadline=dl.Deadline.after(0.15), verb="t")
        t0 = time.monotonic()
        with pytest.raises(dl.DeadlineExceeded) as ei:
            s.sleep(10.0, "test")
        assert time.monotonic() - t0 < 2.0
        assert ei.value.verb == "t"
        assert ei.value.budget_s == pytest.approx(0.15, abs=0.05)

    def test_module_level_check_without_scope(self):
        assert dl.current_scope() is None and dl.remaining() is None
        dl.check("free")

    def test_nested_scope_tightens_never_loosens(self):
        with dl.verb_scope("outer", timeout_s=5.0) as outer:
            with dl.verb_scope("inner", timeout_s=0.05) as inner:
                assert inner.remaining() <= 0.05 + 1e-6
            with dl.verb_scope("inner2", timeout_s=100.0) as inner2:
                outer_rem = outer.remaining()
                assert inner2.remaining() <= outer_rem + 1e-6
            with dl.verb_scope("inner3") as inner3:
                outer.cancel("stop")
                assert inner3.cancelled

    def test_deadline_never_burned_as_retry(self):
        calls = [0]

        def thunk():
            calls[0] += 1
            raise dl.DeadlineExceeded("boom")

        with pytest.raises(dl.DeadlineExceeded):
            rtf.scope("t", attempts=5).dispatch(thunk, what="t")
        assert calls[0] == 1


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

SHARED_CASES = {
    "memory-error": MemoryError("no room"),
    "status-unavailable": RuntimeError("UNAVAILABLE: tunnel went away"),
    "status-internal": RuntimeError("INTERNAL: runtime hiccup"),
    "resource-exhausted": RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    "prose-only": RuntimeError("worker thread aborted"),
    "user-value-error": ValueError("UNAVAILABLE: in user text"),
    "connection-reset": ConnectionError("connection reset by peer"),
    "deadline": dl.DeadlineExceeded("x"),
    "cancelled": dl.Cancelled("x"),
    "overload": dl.OverloadError("x", 1, 1, 0.1),
}


@pytest.mark.parametrize("case", list(SHARED_CASES))
def test_classify_agrees_with_jax(case):
    exc = SHARED_CASES[case]
    jexc = {
        "deadline": jdl.DeadlineExceeded("x"),
        "cancelled": jdl.Cancelled("x"),
        "overload": jdl.OverloadError("x", 1, 1, 0.1),
    }.get(case, exc)
    assert rtf.classify(exc) == jfaults.classify(jexc)


@pytest.mark.parametrize(
    "exc,want",
    [
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "resource"),
        (RuntimeError("CUDA out of memory. Tried to allocate 512.00 MiB"), "resource"),
        (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)"), "resource"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "deterministic"),
        (RuntimeError("CUDA error: misaligned address"), "deterministic"),
        (RuntimeError("CUDA error: device-side assert triggered"), "deterministic"),
        (RuntimeError("INTERNAL: CUDA error: an illegal memory access was encountered"), "deterministic"),
    ],
    ids=["torch-oom", "oom-text", "cublas-alloc", "illegal-access", "misaligned", "device-assert",
         "sticky-beats-status"],
)
def test_classify_torch_and_cuda_errors(exc, want):
    assert rtf.classify(exc) == want


def test_sticky_cuda_error_is_never_retried():
    calls = [0]

    def thunk():
        calls[0] += 1
        raise RuntimeError("UNAVAILABLE: CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError) as ei:
        rtf.scope("t", attempts=5).dispatch(thunk, what="t", sleep=lambda s: None)
    assert calls[0] == 1
    assert ei.value.tfs_fault_class == "deterministic"
    assert rtf.ledger_snapshot()["failfast"] == 1


def test_tagged_class_wins_and_retry_shim():
    e = RuntimeError("plain")
    e.tfs_fault_class = "transient"
    assert rtf.classify(e) == "transient"
    assert tretry.run_with_retries is rtf.run_with_retries
    calls = [0]

    def flaky(x):
        calls[0] += 1
        if calls[0] < 3:
            raise RuntimeError("UNAVAILABLE: twice")
        return x + 1

    assert rtf.run_with_retries(flaky, 1, attempts=3, sleep=lambda s: None) == 2


@pytest.mark.parametrize("attempt", [1, 2, 5])
def test_backoff_delay_equals_jax(attempt):
    assert rtf.backoff_delay(attempt, "blk") == jfaults.backoff_delay(attempt, "blk")


class TestInterruptibleBackoff:
    def test_backoff_clipped_to_deadline(self):
        calls = [0]

        def always_transient():
            calls[0] += 1
            raise RuntimeError("UNAVAILABLE: injected for backoff test")

        t0 = time.monotonic()
        with tconfig.override(retry_backoff_base_s=30.0, retry_backoff_max_s=30.0, retry_jitter=0.0):
            with dl.verb_scope("t", timeout_s=0.2):
                with pytest.raises(dl.DeadlineExceeded):
                    rtf.scope("t", attempts=3, budget=10).dispatch(always_transient, what="t")
        assert calls[0] == 1 and time.monotonic() - t0 < 2.0

    def test_explicit_sleep_callable_still_honored(self):
        slept, calls = [], [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise RuntimeError("UNAVAILABLE: twice")
            return 1

        assert rtf.scope("t", attempts=3, budget=10).dispatch(flaky, what="t", sleep=slept.append) == 1
        assert len(slept) == 2


# ---------------------------------------------------------------------------
# timeout_s= on the verbs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verb", VERBS)
def test_generous_timeout_same_result_as_jax(verb):
    x = _data(seed=VERBS.index(verb))
    got = _call(tft, verb, x, timeout_s=60.0)
    want = _call(tfs, verb, x, timeout_s=60.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got, _call(tft, verb, x))


@pytest.mark.parametrize("verb", VERBS)
def test_expired_budget_raises_like_jax(verb):
    x = _data()
    with pytest.raises(jdl.DeadlineExceeded) as jei:
        _call(tfs, verb, x, timeout_s=0.0)
    with pytest.raises(tft.DeadlineExceeded) as ei:
        _call(tft, verb, x, timeout_s=0.0)
    assert ei.value.verb == jei.value.verb == verb
    assert ttele.flat_counters().get(f"deadline_exceeded{{verb={verb}}}") == 1
    assert rtf.ledger_snapshot()["deadlines"] == 1
    assert dl.controller().in_flight_now() == 0  # the slot was released


@pytest.mark.parametrize("verb", VERBS)
def test_slow_blocks_trip_the_timeout(verb, monkeypatch):
    """Each block takes 0.2 s: a 0.3 s budget stops the verb at the next
    block boundary, not after all four blocks."""
    feeds, fed = tapi._feeds, []

    def slow_feeds(*a, **k):
        fed.append(1)
        time.sleep(0.2)
        return feeds(*a, **k)

    monkeypatch.setattr(tapi, "_feeds", slow_feeds)
    t0 = time.monotonic()
    with pytest.raises(tft.DeadlineExceeded) as ei:
        _call(tft, verb, _data(), timeout_s=0.3)
    assert time.monotonic() - t0 >= 0.3
    assert len(fed) < 4  # stopped at a block boundary
    assert ei.value.verb == verb


def test_deadline_scope_shared_budget_and_cancel(monkeypatch):
    feeds = tapi._feeds

    def slow_feeds(*a, **k):
        time.sleep(0.1)
        return feeds(*a, **k)

    monkeypatch.setattr(tapi, "_feeds", slow_feeds)
    with pytest.raises(tft.DeadlineExceeded):
        with tft.deadline_scope(timeout_s=0.5):
            _call(tft, "map_blocks", _data())  # ~0.4 s of the budget
            _call(tft, "reduce_blocks", _data())  # runs out here
    errs = []

    def run(holder):
        with tft.deadline_scope() as sc:
            holder.append(sc)
            try:
                for _ in range(50):
                    _call(tft, "map_blocks", _data())
            except tft.Cancelled as e:
                errs.append(e)

    holder = []
    th = threading.Thread(target=run, args=(holder,))
    th.start()
    time.sleep(0.3)
    holder[0].cancel("test abort")
    th.join(timeout=10.0)
    assert not th.is_alive() and errs


def test_default_verb_timeout_config_knob():
    with tconfig.override(default_verb_timeout_s=1e-9):
        with pytest.raises(tft.DeadlineExceeded):
            _call(tft, "map_blocks", _data())
    assert _call(tft, "map_blocks", _data()).shape == (64,)


def test_verb_seconds_feed_the_retry_hint():
    for _ in range(3):
        _call(tft, "map_blocks", _data())
    mean = dl._mean_verb_seconds()
    assert mean is not None and mean > 0.0


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verb", VERBS)
def test_admission_sheds_like_jax(verb):
    x = _data()
    jrelease = jdl.controller().admit("holder", None)
    release = dl.controller().admit("holder", None)
    try:
        with jconfig.override(max_concurrent_verbs=1, admission_queue_limit=0):
            with pytest.raises(jdl.OverloadError) as jei:
                _call(tfs, verb, x)
        with tconfig.override(max_concurrent_verbs=1, admission_queue_limit=0):
            with pytest.raises(tft.OverloadError) as ei:
                _call(tft, verb, x)
    finally:
        release()
        jrelease()
    assert (ei.value.limit, ei.value.queue_depth) == (jei.value.limit, jei.value.queue_depth) == (1, 0)
    assert ei.value.retry_after_s > 0.0
    assert dl.controller().snapshot()["shed"] == 1
    assert ttele.flat_counters()["verbs_shed"] == 1
    assert rtf.ledger_snapshot()["shed"] == 1
    np.testing.assert_allclose(_call(tft, verb, x), _call(tfs, verb, x), rtol=1e-5)


def test_queue_then_admitted():
    x = _data()
    release = dl.controller().admit("holder", None)
    got = []
    with tconfig.override(max_concurrent_verbs=1, admission_queue_limit=4, admission_wait_timeout_s=30.0):
        th = threading.Thread(target=lambda: got.append(_call(tft, "map_blocks", x)))
        th.start()
        end = time.monotonic() + 5.0
        while dl.controller().queue_depth() == 0 and time.monotonic() < end:
            time.sleep(0.01)
        assert dl.controller().queue_depth() == 1
        release()
        th.join(timeout=30.0)
    assert not th.is_alive() and got
    np.testing.assert_array_equal(got[0], x * 2.0 + 1.0)
    assert ttele.flat_counters().get("admission_wait_seconds", 0.0) > 0.0


def test_deadline_while_queued():
    release = dl.controller().admit("holder", None)
    try:
        with tconfig.override(max_concurrent_verbs=1, admission_queue_limit=4, admission_wait_timeout_s=30.0):
            t0 = time.monotonic()
            with pytest.raises(tft.DeadlineExceeded):
                _call(tft, "reduce_blocks", _data(), timeout_s=0.15)
            assert time.monotonic() - t0 < 5.0
    finally:
        release()
    assert dl.controller().queue_depth() == 0 and dl.controller().in_flight_now() == 0


def test_nested_verbs_take_one_slot():
    """A stream's per-chunk reduces never re-enter admission, so a limit
    of one cannot deadlock."""
    probe = tft.TensorFrame.from_dict({"x": np.zeros(2, np.float32)})
    fetch = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
    chunks = [tft.TensorFrame.from_dict({"x": np.ones(8, np.float32) * (i + 1)}) for i in range(4)]
    with tconfig.override(max_concurrent_verbs=1, admission_queue_limit=0):
        s = tft.reduce_blocks_stream(fetch, iter(chunks), device=CPU)
    assert float(s) == 8 * (1 + 2 + 3 + 4)
    assert dl.controller().snapshot()["peak_in_flight"] == 1
    assert dl.controller().in_flight_now() == 0


def test_admission_gauges_registered():
    _, gauges, _ = ttele.metrics_snapshot()
    assert ("admission_queue_depth", ()) in gauges
    assert ("admission_in_flight", ()) in gauges


# ---------------------------------------------------------------------------
# stage hang injection
# ---------------------------------------------------------------------------


class TestStageHangInjection:
    def test_nth_hang_fires_once_and_proceeds(self):
        from tensorframes_tpu_torch.ingest import PipeStage, pipelined

        t0 = time.monotonic()
        with chaos.inject_stage(stage="decode", nth=[1], fault="hang", delay_s=0.2) as plan:
            out = list(pipelined(iter(range(4)), [PipeStage("decode", lambda i: i)], depth=1))
        assert out == [0, 1, 2, 3]
        assert plan.injected == 1 and plan.attempts == 4
        assert time.monotonic() - t0 >= 0.2

    def test_rate_verdicts_deterministic(self):
        from tensorframes_tpu_torch.ingest import PipeStage, pipelined

        runs = []
        for _ in range(2):
            with chaos.inject_stage(stage="decode", rate=0.5, seed=3, fault="hang", delay_s=0.0) as plan:
                list(pipelined(iter(range(20)), [PipeStage("decode", lambda i: i)], depth=1))
            runs.append(list(plan.faulted_ordinals))
        assert runs[0] == runs[1] and runs[0]

    def test_unknown_fault_class_and_nesting_rejected(self):
        with pytest.raises(ValueError):
            with chaos.inject_stage(fault="explode"):
                pass
        with chaos.inject_stage():
            with pytest.raises(RuntimeError, match="already active"):
                with chaos.inject_stage():
                    pass

    def test_hang_in_a_stream_trips_the_deadline(self):
        probe = tft.TensorFrame.from_dict({"x": np.zeros(2, np.float32)})
        fetch = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
        chunks = [tft.TensorFrame.from_dict({"x": np.ones(8, np.float32)}) for _ in range(6)]
        t0 = time.monotonic()
        with chaos.inject_stage(stage="transfer-stage", nth=[2], fault="hang", delay_s=30.0):
            with pytest.raises(tft.DeadlineExceeded):
                tft.reduce_blocks_stream(fetch, iter(chunks), device=CPU, timeout_s=0.5)
        assert time.monotonic() - t0 < 3.0
        end = time.monotonic() + 5.0
        while time.monotonic() < end and any(
            t.name.startswith("tfs-ingest") for t in threading.enumerate()
        ):
            time.sleep(0.05)
        assert not [t.name for t in threading.enumerate() if t.name.startswith("tfs-ingest")]
