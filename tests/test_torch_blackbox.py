"""PyTorch port: the incident flight recorder (`runtime/blackbox.py`) and
its hooks in `runtime/deadline.py`, `runtime/checkpoint.py`,
`runtime/scheduler.py` and the serving front-end, held to the JAX package
on the CPU.

Mirrors `tests/test_blackbox.py`. For the same injected fault each package
writes one bundle with the same top-level keys and the same ``fault``
section; the rate limit, the LRU prune and the store-quota suppression
behave as in the JAX package. The ``program`` cost entry, ``memory`` and
``autotune_decisions`` sections read modules the port does not have yet
and come out as ``{"error": ...}``.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.runtime import blackbox as jblackbox
from tensorframes_tpu.runtime import checkpoint as jckpt
from tensorframes_tpu.runtime import deadline as jdl
from tensorframes_tpu.testing import faults as jchaos
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.runtime import blackbox as tblackbox
from tensorframes_tpu_torch.runtime import checkpoint as tckpt
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as rtf
from tensorframes_tpu_torch.testing import faults as tchaos
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


SIDES = {
    "jax": dict(pkg=tfs, bb=jblackbox, cfg=jconfig, dl=jdl, chaos=jchaos, ckpt=jckpt,
                tele=jtele, dev={}),
    "torch": dict(pkg=tft, bb=tblackbox, cfg=tconfig, dl=tdl, chaos=tchaos, ckpt=tckpt,
                  tele=ttele, dev={"device": CPU}),
}


def _frame(pkg, n=64, blocks=4, seed=3):
    rng = np.random.RandomState(seed)
    return pkg.TensorFrame.from_dict({"x": rng.rand(n).astype(np.float32)}, num_blocks=blocks)


def _double(pkg, df):
    return (pkg.block(df, "x") * 2.0 + 1.0).named("y")


def _deadline_bundle(side, tmp_path):
    s = SIDES[side]
    pkg = s["pkg"]
    df = _frame(pkg)
    with s["cfg"].override(incident_dir=str(tmp_path / side)):
        pkg.map_blocks(_double(pkg, df), df, **s["dev"])  # fault-free: no bundle
        assert pkg.incidents() == []
        with s["chaos"].inject(nth=[0], fault="hang", delay_s=30.0):
            with pytest.raises(s["dl"].DeadlineExceeded) as ei:
                pkg.map_blocks(_double(pkg, df), df, timeout_s=0.3, **s["dev"])
        rows = pkg.incidents()
        assert len(rows) == 1 and rows[0]["trigger"] == "deadline"
        assert ei.value.tfs_incident_id == rows[0]["id"]
        return rows[0], pkg.incidents(rows[0]["id"])


def test_deadline_bundle_keys_and_fault_section_match_jax(tmp_path):
    rows, bundles = {}, {}
    for side in SIDES:
        rows[side], bundles[side] = _deadline_bundle(side, tmp_path)
    bj, bt = bundles["jax"], bundles["torch"]
    assert bt.keys() == bj.keys()
    assert rows["torch"].keys() == rows["jax"].keys()
    assert bt["verb"] == bj["verb"] == "map_blocks"
    assert bt["fault"]["type"] == bj["fault"]["type"] == "DeadlineExceeded"
    assert bt["fault"]["class"] == bj["fault"]["class"]
    assert bt["fault"]["verb"] == bj["fault"]["verb"]
    assert abs(bt["fault"]["budget_s"] - 0.3) < 0.05
    assert bt["trace"]["traceEvents"] and bt["trace"]["otherData"].keys() == bj["trace"]["otherData"].keys()
    assert bt["metrics"].keys() == bj["metrics"].keys()
    assert bt["config"].keys() == bj["config"].keys() and bt["config"]["digest"]
    assert bt["scheduler"].keys() == bj["scheduler"].keys()
    assert bt["scheduler"]["devices"][0]["device"] == "cpu:0"
    assert bt["scheduler"]["circuits"] == []
    # the cost model's memory overview has one row per CUDA device: none on
    # the CPU (the JAX package lists its CPU device, without statistics)
    assert bt["memory"] == [] and isinstance(bj["memory"], list)
    # the autotuner's decision ring, empty here in both packages' form
    assert bt["autotune_decisions"] == [] and isinstance(bj["autotune_decisions"], list)


def test_program_section_needs_the_cost_model(tmp_path):
    """The program section carries the cost ledger's entry of the offending
    program (None for a program the ledger never saw), as in JAX."""
    from tensorframes_tpu_torch.runtime import costmodel as tcost

    ttele.reset()
    tcost.reset()
    with tconfig.override(incident_dir=str(tmp_path)):
        # no span in the ring carries a program yet
        plain = tft.incidents(tblackbox.capture("deadline", RuntimeError("y")))
    df = tft.TensorFrame.from_dict({"x": np.arange(8.0)}, num_blocks=2)
    z = (tft.block(df, "x") * 2.0).named("z")
    tft.map_blocks(z, df, device="cpu")
    fp = tft.dsl.build(z)[0].fingerprint()
    with tconfig.override(incident_dir=str(tmp_path)):
        known = tft.incidents(tblackbox.capture("fault", RuntimeError("k"), program=fp))
        iid = tblackbox.capture("fault", RuntimeError("x"), program="abc123")
        bundle = tft.incidents(iid)
    assert known["program"]["fingerprint"] == fp
    assert known["program"]["cost"]["execs"] == 2
    assert known["program"]["cost"]["flops_per_exec"] == 4.0
    assert bundle["program"] == {"fingerprint": "abc123", "cost": None, "residual_ratio": None}
    assert plain["program"] == {"fingerprint": None, "cost": None, "residual_ratio": None}


def _shed_burst(side, tmp_path, sheds=5):
    s = SIDES[side]
    pkg = s["pkg"]
    df = _frame(pkg)
    pkg.map_blocks(_double(pkg, df), df, **s["dev"])
    release = s["dl"].controller().admit("holder", None)
    try:
        with s["cfg"].override(
            incident_dir=str(tmp_path / side), max_concurrent_verbs=1, admission_queue_limit=0
        ):
            for _ in range(sheds):
                with pytest.raises(pkg.OverloadError):
                    pkg.map_blocks(_double(pkg, df), df, **s["dev"])
            rows = pkg.incidents()
            bundle = pkg.incidents(rows[0]["id"])
    finally:
        release()
    flat = s["tele"].flat_counters()
    return (
        len(rows), rows[0]["trigger"], rows[0]["suppressed_since"],
        flat.get("incidents_captured{trigger=shed}", 0),
        flat.get("incidents_suppressed{reason=rate_limit}", 0),
        bundle["fault"]["type"], sorted(bundle["fault"]),
    )


def test_shed_burst_rate_limited_like_jax(tmp_path):
    got = {side: _shed_burst(side, tmp_path) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"][:5] == (1, "shed", 4, 1.0, 4.0)


def _prune(side, tmp_path):
    s = SIDES[side]
    with s["cfg"].override(
        incident_dir=str(tmp_path / side), incident_max_bundles=2, incident_rate_limit_s=0.0
    ):
        ids = []
        for i in range(4):
            ids.append(s["bb"].capture(f"trig{i}"))
            time.sleep(0.02)  # distinct mtimes for the LRU order
        rows = s["pkg"].incidents()
    st = s["bb"].state()
    return len(rows), {r["id"] for r in rows} == set(ids[-2:]), st["bundles"], st["captured"]


def test_lru_prune_keeps_newest_like_jax(tmp_path):
    got = {side: _prune(side, tmp_path) for side in SIDES}
    assert got["torch"] == got["jax"] == (2, True, 2, 4)


def _quota(side, tmp_path):
    s = SIDES[side]
    with s["cfg"].override(incident_dir=str(tmp_path / side), incident_max_bytes=0):
        iid = s["bb"].capture("deadline", RuntimeError("full store"))
    return iid, s["bb"].state()["suppressed"], s["tele"].flat_counters().get(
        "incidents_suppressed{reason=store}", 0
    )


def test_full_store_degrades_to_counted_suppression_like_jax(tmp_path):
    got = {side: _quota(side, tmp_path) for side in SIDES}
    assert got["torch"] == got["jax"] == (None, {"store": 1}, 1.0)


def test_unwritable_dir_degrades_not_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with tconfig.override(incident_dir=str(blocker / "sub")):
        assert tblackbox.capture("deadline", RuntimeError("x")) is None
    assert tblackbox.state()["suppressed"] == {"store": 1}


def test_disarmed_recorder_is_a_noop(tmp_path):
    with tconfig.override(incident_dir=str(tmp_path), incident_capture=False):
        assert tblackbox.capture("deadline", RuntimeError("x")) is None
        assert tft.incidents() == []


@pytest.mark.parametrize("side", sorted(SIDES))
def test_checkpoint_corruption_capture(side, tmp_path):
    s = SIDES[side]
    victim = tmp_path / "stream.ckpt"
    victim.write_bytes(b"definitely not a checkpoint")
    with s["cfg"].override(incident_dir=str(tmp_path / "incidents")):
        with pytest.raises(s["ckpt"].CheckpointError) as ei:
            s["ckpt"].CheckpointStore(str(victim)).load()
        rows = s["pkg"].incidents()
        assert len(rows) == 1 and rows[0]["trigger"] == "checkpoint"
        assert ei.value.tfs_incident_id == rows[0]["id"]
        assert s["pkg"].incidents(rows[0]["id"])["fault"]["kind"] == "corrupt"


def test_checkpoint_commit_failure_capture(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with tconfig.override(incident_dir=str(tmp_path / "incidents")):
        with pytest.raises(tckpt.CheckpointError):
            tckpt.CheckpointStore(str(blocker / "c.ckpt")).commit({}, b"payload")
        rows = tft.incidents()
    assert [r["trigger"] for r in rows] == ["checkpoint"]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_serving_504_capture(side, tmp_path):
    s = SIDES[side]
    pkg = s["pkg"]
    x = pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape((None,)), name="x")
    fetch = ((x * pkg.dsl.constant(np.float32(2.0))) + pkg.dsl.constant(np.float32(1.0))).named("score")
    pkg.serving.register("bb_score", fetch, {"x": "float32"}, warm=False, **s["dev"])
    handle = pkg.serving.serve(port=0)
    with s["cfg"].override(incident_dir=str(tmp_path)):
        body = pkg.io.frame_to_ipc_bytes(pkg.TensorFrame.from_dict({"x": np.ones(8, np.float32)}))
        req = urllib.request.Request(
            handle.url + "/bb_score", data=body,
            headers={"X-TFS-Timeout-S": "0.000001"}, method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 504
        deadline = time.monotonic() + 5.0
        while not pkg.incidents() and time.monotonic() < deadline:
            time.sleep(0.02)
        rows = pkg.incidents()
        assert rows
        bundle = pkg.incidents(rows[0]["id"])
    assert bundle["extra"]["status"] == 504 and bundle["extra"]["endpoint"] == "bb_score"
    s["tele"].shutdown()


def test_cross_layer_dedup_stamps_one_id(tmp_path):
    e = tdl.DeadlineExceeded("x", verb="map_blocks", budget_s=0.1)
    with tconfig.override(incident_dir=str(tmp_path)):
        first = tblackbox.capture("deadline", e)
        assert tblackbox.capture("serving", e) == first
        assert len(tft.incidents()) == 1
    assert tblackbox.state()["captured"] == 1


def test_untyped_errors_are_not_incidents(tmp_path):
    with tconfig.override(incident_dir=str(tmp_path)):
        assert tblackbox.capture_escape(ValueError("user error")) is None
        df = _frame(tft)
        with pytest.raises(ValueError):
            tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, feed_dict={"x": "nope"},
                           device=CPU)
        assert tft.incidents() == []


def test_http_routes_and_bit_identical_load(tmp_path):
    srv = thttp.serve(port=0)
    with tconfig.override(incident_dir=str(tmp_path)):
        iid = tblackbox.capture("deadline", tdl.DeadlineExceeded("x", verb="v", budget_s=1.0))
        with urllib.request.urlopen(srv.url + "/incidents", timeout=10) as r:
            listing = json.loads(r.read())
        assert [row["id"] for row in listing["incidents"]] == [iid]
        assert listing["recorder"]["captured"] == 1
        with urllib.request.urlopen(srv.url + f"/incidents/{iid}", timeout=10) as r:
            assert json.loads(r.read()) == tft.incidents(iid)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/incidents/nope", timeout=10)
        assert ei.value.code == 404
        path = tft.incidents()[0]["path"]
        assert json.loads(tblackbox.load_payload(path).decode()) == tblackbox.load_file(path)
    with pytest.raises(KeyError):
        tft.incidents("inc-missing")


def test_reset_state_forgets_everything(tmp_path):
    with tconfig.override(incident_dir=str(tmp_path)):
        tblackbox.capture("deadline", RuntimeError("x"))
    tblackbox.reset_state()
    st = tblackbox.state()
    assert st["captured"] == 0 and st["dedup"] == {} and st["last"] is None


def test_process_private_dir_reaped_on_reset():
    tblackbox.capture("deadline", RuntimeError("x"))
    d = tblackbox.state()["dir"]
    assert d and tft.incidents()
    tblackbox.reset_state()
    import os

    assert not os.path.exists(d)


def test_incident_metrics_registered(tmp_path):
    with tconfig.override(incident_dir=str(tmp_path)):
        tblackbox.capture("deadline", RuntimeError("x"))
    text = ttele.export_prometheus()
    for fam in ("tfs_incidents_captured", "tfs_incident_bytes", "tfs_incident_capture_seconds"):
        assert f"# TYPE {fam} " in text
