"""PyTorch port: device failover, held to the JAX package on the CPU.

The circuit breaker (`runtime.scheduler.DeviceHealth`), the schedule's
eviction (`BlockSchedule.evict`), the retry path that feeds them
(`runtime.faults.FaultScope.dispatch` with ``sched=`` / ``index=``), the
flight recorder's ``eviction`` trigger and ``circuits`` rows, and /healthz
``degraded`` on an open circuit. Mirrors `tests/test_faults.py::
TestDeviceHealth` / `TestFailover`, `tests/test_blackbox.py::
test_eviction_capture` and `tests/test_observability.py::
test_healthz_degraded_on_open_circuit`.

Several devices are 8 labelled CPU slots, ``torch.device("cpu", i)``
(`scheduler._local_devices` patched), the stand-in for the JAX package's
8 virtual CPU devices; the injected fault targets a slot by the label the
executor's program key names. Results after a failover are exact (a map
of exactly representable floats).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.runtime import scheduler as jrs
from tensorframes_tpu_torch.runtime import faults as rtf
from tensorframes_tpu_torch.runtime import scheduler as trs
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.runtime.scheduler import BlockSchedule, device_health
from tensorframes_tpu_torch.testing import faults as chaos
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import FAST_RETRY, reset_port

SLOTS = [torch.device("cpu", i) for i in range(8)]


@pytest.fixture(autouse=True)
def _slots(monkeypatch):
    reset_port()
    jrs.device_health().reset()
    monkeypatch.setattr(trs, "_local_devices", lambda: list(SLOTS))
    yield
    reset_port()
    jrs.device_health().reset()


class TestDeviceHealth:
    def test_circuit_opens_and_half_open_probe(self):
        rows = {}
        for side, h in (("jax", jrs.device_health()), ("torch", device_health())):
            h.mark_failure("cpu:9", now=100.0)
            assert not h.usable("cpu:9", now=100.1)
            cooldown = h.table()[0]["cooldown_s"]
            assert h.usable("cpu:9", now=100.0 + cooldown + 0.01)
            rows[side] = h.table()[0]
            assert rows[side]["state"] == "half-open"
            h.mark_success("cpu:9")
            assert h.table() == []
        assert rows["torch"].keys() == rows["jax"].keys()
        assert rows["torch"]["cooldown_s"] == rows["jax"]["cooldown_s"] == 30.0

    def test_half_open_failure_doubles_cooldown(self):
        h = device_health()
        with tft.config.override(device_cooldown_s=10.0):
            h.mark_failure("cpu:9", now=0.0)
            assert h.usable("cpu:9", now=10.5)  # half-open
            assert not h.usable("cpu:9", now=10.6)  # one probe only
            h.mark_failure("cpu:9", now=10.5)
            row = h.table()[0]
            assert (row["state"], row["cooldown_s"], row["failures"]) == ("open", 20.0, 2)
            assert not h.usable("cpu:9", now=20.0)
            assert h.usable("cpu:9", now=31.0)

    def test_cooldown_caps_at_eight_times(self):
        h = device_health()
        with tft.config.override(device_cooldown_s=1.0):
            for t in range(6):
                h.mark_failure("cpu:1", now=float(t))
        assert h.table()[0]["cooldown_s"] == 8.0

    def test_resolve_filters_open_circuits(self):
        device_health().mark_failure("cpu:0")
        with tft.config.override(block_scheduler="on"):
            out = trs.resolve()
        assert SLOTS[0] not in out and len(out) == 7

    def test_all_open_falls_back_to_full_set(self):
        for d in SLOTS:
            device_health().mark_failure(trs.device_label(d))
        with tft.config.override(block_scheduler="on"):
            assert len(trs.resolve()) == 8

    def test_explicit_pin_bypasses_failover_and_warns_once(self):
        h = device_health()
        h.mark_failure("cpu:2")
        assert trs.resolve(devices=[2]) == (SLOTS[2],)
        assert not h.warn_pinned("cpu:2")  # already warned by resolve

    def test_evictions_counted_in_ledger_and_counter(self):
        device_health().mark_failure("cpu:4")
        assert rtf.ledger_snapshot()["evictions"] == 1
        assert ttele.flat_counters()["device_evictions{device=cpu:4}"] == 1.0

    def test_health_overview_lists_tripped_stand_ins(self):
        device_health().mark_failure("cpu:3")
        tj = {r["device"]: r for r in trs.health_overview()}
        assert tj["cpu:0"]["state"] == "closed" and tj["cpu:3"]["state"] == "open"
        jrs.device_health().mark_failure("cpu:3")
        jrows = {r["device"]: r for r in jrs.health_overview()}
        assert set(tj["cpu:3"]) == set(jrows["cpu:3"])


class TestFailover:
    def _schedules(self, ndev=4, items=8):
        weights = [8, 7, 6, 5, 4, 3, 2, 1][:items]
        jdevs = tuple(jax.local_devices()[:ndev])
        return (
            BlockSchedule(tuple(SLOTS[:ndev]), trs.plan(weights, ndev), weights=weights),
            jrs.BlockSchedule(jdevs, jrs.plan(weights, ndev), weights=weights),
        )

    def test_evict_replaces_unissued_items_as_jax(self):
        t, j = self._schedules()
        for s in (t, j):
            s._issued[1] = True
        victim = t.assignment[0]
        before = list(t.assignment)
        assert t.evict(0) == t.labels[victim]
        device_health().reset()
        assert j.evict(0) == j.labels[victim]
        jrs.device_health().reset()
        assert t.assignment == j.assignment
        assert t.assignment[1] == before[1]
        assert all(s != victim for i, s in enumerate(t.assignment) if i != 1)

    def test_evict_deterministic(self):
        a, _ = self._schedules()
        b, _ = self._schedules()
        a.evict(0)
        device_health().reset()
        b.evict(0)
        assert a.assignment == b.assignment

    def test_evict_unscheduled_item_noop(self):
        sched = BlockSchedule(tuple(SLOTS[:2]), [None, 0], weights=[0, 4])
        assert sched.evict(0) is None

    def test_one_device_schedule_retries_in_place(self):
        sched = BlockSchedule((SLOTS[0],), [0, 0], weights=[3, 3])
        assert sched.evict(0) is None
        assert device_health().table() == []
        assert rtf.ledger_snapshot()["evictions"] == 0

    def test_progress_stamps(self):
        t, _ = self._schedules()
        t.put(0, [torch.zeros(1)])
        assert t.progress() == {"planned": 8, "issued": 1, "unissued": 7}
        assert t.bind(1, lambda a: a + 1)(torch.ones(1)).item() == 2.0
        assert t.progress() == {"planned": 8, "issued": 2, "unissued": 6}

    def _drill(self, ex, df, z, **knobs):
        with tft.config.override(block_retry_attempts=8, verb_retry_budget=100, **FAST_RETRY,
                                 **knobs):
            with chaos.inject(rate=1.0, fault="transient", device="cpu:0", max_faults=1) as plan:
                got = tft.map_blocks(z, df, executor=ex)
        return got, plan

    def test_e2e_failover_replaces_blocks(self, tmp_path):
        ex = Executor()
        df = tft.TensorFrame.from_dict({"x": np.arange(4096.0)}, num_blocks=8)
        z = (tft.block(df, "x") + 1.0).named("z")
        ttele.reset()
        with tft.config.override(incident_dir=str(tmp_path)):
            got, plan = self._drill(ex, df, z, block_scheduler="on")
            rows = tft.incidents()
        np.testing.assert_array_equal(got.host_values("z"), np.arange(4096.0) + 1.0)
        assert plan.injected == 1 and plan.faulted_devices == ["cpu:0"]
        assert rtf.ledger_snapshot()["evictions"] == 1
        assert ttele.flat_counters()["device_evictions{device=cpu:0}"] == 1.0
        assert [r["trigger"] for r in rows] == ["eviction"]
        # block 0 ran on cpu:0's schedule slot, failed there, and moved
        labels = [s.attrs.get("device") for s in ttele.spans()
                  if s.kind == "dispatch" and s.name == "map_blocks.block"]
        assert labels[0] == "cpu:0" and labels[1] != "cpu:0" and len(labels) == 9
        assert sum(ex.device_dispatches.values()) == 8
        assert ex.device_dispatches.get("cpu:0", 0) == 0
        # the circuit is open: a fresh call schedules around cpu:0
        before = ex.device_dispatches.get("cpu:0", 0)
        with tft.config.override(block_scheduler="on"):
            tft.map_blocks(z, df, executor=ex)
        assert ex.device_dispatches.get("cpu:0", 0) == before
        assert device_health().table()[0]["device"] == "cpu:0"

    def test_one_device_drill_retries_in_place(self, monkeypatch):
        monkeypatch.setattr(trs, "_local_devices", lambda: SLOTS[:1])
        ex = Executor()
        df = tft.TensorFrame.from_dict({"x": np.arange(64.0)}, num_blocks=4)
        z = (tft.block(df, "x") * 2.0).named("z")
        got, plan = self._drill(ex, df, z, block_scheduler="on")
        np.testing.assert_array_equal(got.host_values("z"), np.arange(64.0) * 2.0)
        assert plan.injected == 1
        assert rtf.ledger_snapshot()["evictions"] == 0 and rtf.ledger_snapshot()["retries"] == 1
        assert device_health().table() == []
        assert ex.device_dispatches == {"cpu:0": 4}

    def test_failover_of_a_scheduled_reduce(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(1000, dtype=np.int64)}, num_blocks=8)
        g = tft.dsl.reduce_max(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
        with tft.config.override(block_retry_attempts=8, verb_retry_budget=100, **FAST_RETRY):
            with chaos.inject(rate=1.0, fault="transient", device="cpu:1", max_faults=1) as plan:
                assert int(tft.reduce_blocks(g, df)) == 999
        assert plan.injected == 1 and rtf.ledger_snapshot()["evictions"] == 1

    def test_deadline_stamps_progress(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(64.0)}, num_blocks=8)
        z = (tft.block(df, "x") + 1.0).named("z")
        with chaos.inject(nth=[2], fault="hang", delay_s=5.0):
            with pytest.raises(tft.DeadlineExceeded) as ei:
                tft.map_blocks(z, df, timeout_s=0.3)
        assert ei.value.tfs_blocks_issued == 2
        assert ei.value.tfs_blocks_unissued == 6

    def test_diagnostics_shows_health_and_retries(self):
        device_health().mark_failure("cpu:6")
        text = tft.diagnostics()
        assert "device health" in text and "cpu:6" in text
        assert tft.diagnostics(format="json")["health"][0]["device"] == "cpu:6"


def test_eviction_capture(tmp_path):
    with tft.config.override(incident_dir=str(tmp_path)):
        device_health().mark_failure("cpu:7")
        rows = tft.incidents()
        assert len(rows) == 1 and rows[0]["trigger"] == "eviction"
        bundle = tft.incidents(rows[0]["id"])
        assert bundle["extra"]["device"] == "cpu:7" and bundle["extra"]["failures"] == 1
        assert bundle["scheduler"]["circuits"][0]["device"] == "cpu:7"
        # a flapping device rate-limits instead of flooding
        device_health().mark_failure("cpu:7")
        assert len(tft.incidents()) == 1
    from tensorframes_tpu_torch.runtime import blackbox

    assert blackbox.state()["suppressed"].get("rate_limit", 0) >= 1


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        return json.loads(r.read().decode())


def test_healthz_degraded_on_open_circuit():
    srv = ttele.serve(port=0)
    try:
        assert _healthz(srv.url)["degraded"] is False
        device_health().mark_failure("cpu:0")
        h = _healthz(srv.url)
        assert h["degraded"] and h["status"] == "degraded"
        states = {r["device"]: r["state"] for r in h["devices"]}
        assert states["cpu:0"] == "open"
        device_health().reset()
        assert _healthz(srv.url)["status"] == "ok"
    finally:
        srv.close()
