"""PyTorch port: the materialization cache (`runtime/materialize.py`) behind
serving `Endpoint.run_frame`, held to the JAX package on the CPU.

Mirrors the cache parts of `tests/test_materialize.py`. Host frames
fingerprint to the same key in both packages; a repeated host request to
an endpoint is served from the cache with no dispatch, and its response
serializes to IPC bytes equal to the first response's; a frame with a
column on a device fingerprints to ``None`` (a ``meta`` tensor and a
foreign array type stand in for a card on the CPU); LRU eviction, the
admission price, corrupt entries and drifted manifests behave as in the
JAX package.
"""

import os
import time

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.runtime import materialize as jmat
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.frame import Column
from tensorframes_tpu_torch.runtime import blackbox as tblackbox
from tensorframes_tpu_torch.runtime import checkpoint as tckpt
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as rtf
from tensorframes_tpu_torch.runtime import materialize as tmat
from tensorframes_tpu_torch.testing import faults as tchaos
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

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
    tmat.reset_state()
    tblackbox.reset_state()
    tfs.serving.reset()
    jtele.shutdown()


@pytest.fixture
def always_admit(monkeypatch):
    """Pin the admission price open: the hit path must not depend on this
    machine's disk being slower than a toy program's recompute."""
    monkeypatch.setattr(tmat, "_priced_out", lambda *a, **k: False)
    monkeypatch.setattr(jmat, "_priced_out", lambda *a, **k: False)


def _frames(seed=0):
    rng = np.random.RandomState(seed)
    data = {
        "x": rng.rand(10).astype(np.float32),
        "v": rng.randint(0, 9, (10, 3)).astype(np.int64),
    }
    return (
        tfs.TensorFrame.from_dict(data, num_blocks=2),
        tft.TensorFrame.from_dict(data, num_blocks=2),
    )


def _register(pkg, name="mat-score"):
    dev = {"device": CPU} if pkg is tft else {}
    x = pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape((None,)), name="x")
    score = (x * pkg.dsl.constant(np.float32(2.0))).named("score")
    return pkg.serving.register(name, score, {"x": "float32"}, warm=False, **dev)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def test_host_frame_fingerprint_equals_jax():
    jf, tf = _frames()
    assert tmat.frame_fingerprint(tf) == jmat.frame_fingerprint(jf) is not None
    jf2, tf2 = _frames(seed=1)
    assert tmat.frame_fingerprint(tf2) != tmat.frame_fingerprint(tf)


def test_cpu_tensor_column_hashes_as_its_host_bytes():
    _jf, tf = _frames()
    as_tensor = tft.TensorFrame(
        [Column(c, torch.from_numpy(np.asarray(tf.column(c).values))) for c in tf.columns],
        tf.offsets,
    )
    assert tmat.frame_fingerprint(as_tensor) == tmat.frame_fingerprint(tf)


@pytest.mark.parametrize(
    "data",
    [
        {"s": np.array(["a", "bb", "c"], dtype=object), "x": np.arange(3.0)},
        {"r": [np.arange(2.0), np.arange(3.0)]},
    ],
    ids=["string", "ragged"],
)
def test_string_and_ragged_columns_are_not_fingerprinted_like_jax(data):
    assert jmat.frame_fingerprint(tfs.TensorFrame.from_dict(data)) is None
    assert tmat.frame_fingerprint(tft.TensorFrame.from_dict(data)) is None


def test_device_resident_frame_fingerprints_to_none():
    meta = tft.TensorFrame([Column("x", torch.empty(4, device="meta"))])
    assert tmat.frame_fingerprint(meta) is None

    class FakeCudaArray:
        """A stand-in for an array on the card: not numpy, not a CPU tensor."""

        shape = (4,)

    _jf, tf = _frames()
    tf.column("x").values = FakeCudaArray()
    assert tmat.frame_fingerprint(tf) is None


def test_plan_fingerprint_equals_jax():
    args = ("abc123", {"x_input": "x"}, ["z", "y"])
    assert tmat.plan_fingerprint(*args) == jmat.plan_fingerprint(*args)
    assert tmat.plan_fingerprint("abc123", {"x_input": "w"}, ["z", "y"]) != tmat.plan_fingerprint(*args)


def test_plan_fingerprint_names_the_device():
    args = ("abc123", {"x_input": "x"}, ["z", "y"])
    keys = {tmat.plan_fingerprint(*args, device=d) for d in (None, "cpu:0", "cuda:0", "cuda:1")}
    assert len(keys) == 4
    assert tmat.plan_fingerprint(*args, device=None) == jmat.plan_fingerprint(*args)


def test_endpoints_on_two_devices_never_share_an_entry(tmp_path, always_admit, monkeypatch):
    import copy

    ep = _register(tft)
    req = tft.TensorFrame.from_dict({"x": np.arange(8, dtype=np.float32)})
    looked_up = []
    lookup = tmat.lookup
    monkeypatch.setattr(tmat, "lookup", lambda d, p: looked_up.append(p) or lookup(d, p))
    with tconfig.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        ep.run_frame(req)
        ep.run_frame(req)
        assert tmat.state()["hits"] == 1
        # the same program on another device: a miss, computed there (a
        # meta tensor cannot be serialized, so its store is skipped)
        other = copy.copy(ep)
        other.device = torch.device("meta")
        monkeypatch.setattr(tmat, "store", lambda *a, **k: False)
        out = other.run_frame(req)
        st = tmat.state()
    assert out.column("score").values.device.type == "meta"
    assert st["hits"] == 1 and st["misses"] == 2
    assert looked_up[0] == looked_up[1] != looked_up[2]


# ---------------------------------------------------------------------------
# the serving hit path
# ---------------------------------------------------------------------------


def test_disabled_by_default_never_stores():
    ep = _register(tft)
    req = tft.TensorFrame.from_dict({"x": np.arange(8, dtype=np.float32)})
    ep.run_frame(req)
    ep.run_frame(req)
    st = tmat.state()
    assert not st["enabled"] and st["stores"] == 0 and st["hits"] == 0


@pytest.mark.parametrize("pkg_name", ["jax", "torch"])
def test_repeat_request_hit_is_byte_equal_ipc(tmp_path, always_admit, pkg_name):
    pkg, cfg, mat = {
        "jax": (tfs, jconfig, jmat), "torch": (tft, tconfig, tmat),
    }[pkg_name]
    ep = _register(pkg)
    req = pkg.TensorFrame.from_dict({"x": np.arange(8, dtype=np.float32)})
    with cfg.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        cold = ep.run_frame(req)
        if pkg is tft:
            with tchaos.inject(rate=0.0) as plan:
                warm = ep.run_frame(req)
            assert plan.dispatches == 0
        else:
            warm = ep.run_frame(req)
        st = mat.state()
    assert st["hits"] == 1 and st["stores"] == 1
    assert pkg.io.frame_to_ipc_bytes(warm) == pkg.io.frame_to_ipc_bytes(cold)


def test_hit_matches_jax_response_bytes(tmp_path, always_admit):
    wire = {}
    for pkg, cfg in ((tfs, jconfig), (tft, tconfig)):
        ep = _register(pkg)
        req = pkg.TensorFrame.from_dict({"x": np.arange(8, dtype=np.float32)})
        with cfg.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path / pkg.__name__)):
            ep.run_frame(req)
            wire[pkg.__name__] = np.asarray(ep.run_frame(req).column("score").host_values())
    np.testing.assert_array_equal(wire["tensorframes_tpu_torch"], wire["tensorframes_tpu"])


def test_hit_survives_a_fresh_index(tmp_path, always_admit):
    ep = _register(tft)
    req = tft.TensorFrame.from_dict({"x": np.arange(8, dtype=np.float32)})
    with tconfig.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        ep.run_frame(req)
        tmat.reset_state()  # a configured dir keeps its files; the index rescans
        ep.run_frame(req)
        assert tmat.state()["hits"] == 1


def test_device_resident_request_is_never_cached(tmp_path, always_admit):
    ep = _register(tft)
    req = tft.TensorFrame([Column("x", torch.arange(8, dtype=torch.float32))])
    req.column("x").values = req.column("x").values.to("meta")
    with tconfig.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        data_fp = tmat.frame_fingerprint(req)
    assert data_fp is None
    assert tmat.lookup(data_fp, "p") is None and not tmat.store(data_fp, "p", req)


def test_admission_rejects_cheap_recompute(tmp_path):
    _jf, tf = _frames()
    with tconfig.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        assert not tmat.store("d1", "p1", tf, compute_s=0.0)
        assert tmat.store("d2", "p1", tf, compute_s=None)  # unpriced: admitted
        st = tmat.state()
    assert st["rejected"] == 1 and st["stores"] == 1


def _eviction_trace(mat, cfg, io, frame, tmp_path):
    budget = int(len(io.frame_to_ipc_bytes(frame)) * 2.5)  # room for two entries
    with cfg.override(materialize_cache_bytes=budget, materialize_cache_dir=str(tmp_path)):
        for i in range(4):
            mat.store(f"d{i}", "p", frame)
            time.sleep(0.02)  # distinct LRU clocks
        st = mat.state()
        alive = [mat.lookup(f"d{i}", "p") is not None for i in range(4)]
    return st["entries"], st["evictions"], st["bytes"] <= budget, alive


def test_lru_eviction_holds_bytes_bound_like_jax(tmp_path, always_admit):
    jf, tf = _frames()
    got_t = _eviction_trace(tmat, tconfig, tft.io, tf, tmp_path / "t")
    got_j = _eviction_trace(jmat, jconfig, tfs.io, jf, tmp_path / "j")
    assert got_t == got_j == (2, 2, True, [False, False, True, True])


def test_oversized_payload_rejected(tmp_path):
    _jf, tf = _frames()
    with tconfig.override(materialize_cache_bytes=16, materialize_cache_dir=str(tmp_path)):
        assert not tmat.store("d", "p", tf)
    assert tmat.state()["rejected"] == 1


def test_drifted_manifest_refused_naming_field(tmp_path, always_admit):
    _jf, tf = _frames()
    with tconfig.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        assert tmat.store("d", "p", tf)
        path = next(iter(tmat._index.values()))["path"]
        manifest, payload = tckpt.CheckpointStore(path).load()
        manifest["program_fingerprint"] = "other"
        for k in ("schema_version", "payload_len", "payload_sha256"):
            manifest.pop(k)
        tckpt.CheckpointStore(path).commit(manifest, payload)
        with pytest.raises(tckpt.CheckpointError) as ei:
            tmat.lookup("d", "p")
    assert ei.value.kind == "drift" and ei.value.field == "program_fingerprint"
    assert tmat.state()["drift_refusals"] == 1


def test_corrupt_entry_dropped_and_recomputed(tmp_path, always_admit):
    ep = _register(tft)
    req = tft.TensorFrame.from_dict({"x": np.arange(8, dtype=np.float32)})
    with tconfig.override(materialize_cache_bytes=10_000_000, materialize_cache_dir=str(tmp_path)):
        cold = ep.run_frame(req)
        path = next(iter(tmat._index.values()))["path"]
        with open(path, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            f.write(b"\x00\x01\x02")
        again = ep.run_frame(req)
        st = tmat.state()
    assert st["corrupt_dropped"] == 1 and st["hits"] == 0
    np.testing.assert_array_equal(
        again.column("score").host_values(), cold.column("score").host_values()
    )


def test_materialize_bytes_gauge_and_counters():
    text = ttele.export_prometheus()
    assert "tfs_materialize_bytes 0" in text


# ---------------------------------------------------------------------------
# LazyFrame.force and RelationalFrame.force through the cache (mirrors
# tests/test_materialize.py::TestCachePath / TestIntegrity)
# ---------------------------------------------------------------------------


def _chain_frames(seed=0, n=64, blocks=4):
    rng = np.random.RandomState(seed)
    data = {"x": rng.rand(n).astype(np.float32), "k": rng.randint(0, 5, n).astype(np.int64)}
    return (
        tfs.TensorFrame.from_dict(data, num_blocks=blocks),
        tft.TensorFrame.from_dict(data, num_blocks=blocks),
    )


def _chain(pkg, df):
    """A fused map chain over ``df`` (tanh(x) * 0.5 + x), then x * 3."""
    xi = pkg.block(df, "x", tf_name="x_input")
    z = (pkg.dsl.tanh(xi) * pkg.dsl.constant(np.float32(0.5)) + xi).named("z")
    dev = {"device": CPU} if pkg is tft else {}
    lf = df.lazy(**dev).map_blocks(z, feed_dict={"x_input": "x"})
    return lf.map_blocks((pkg.block(lf, "z") * 3.0).named("w"))


def _dispatches(since_id):
    return [s for s in ttele.spans() if s.span_id > since_id and s.kind == "dispatch"]


def test_force_disabled_by_default_never_stores():
    _jdf, tdf = _chain_frames()
    _chain(tft, tdf).force()
    _chain(tft, tdf).force()
    st = tmat.state()
    assert st["enabled"] is False and st["stores"] == 0 and st["hits"] == 0


def test_force_hit_dispatches_nothing_and_equals_the_miss(tmp_path, always_admit):
    jdf, tdf = _chain_frames()
    with tconfig.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path)):
        cold = _chain(tft, tdf).force()
        assert tmat.state()["stores"] == 1
        sid = ttele.allocate_span_id()
        warm = _chain(tft, tdf).force()
        assert _dispatches(sid) == []  # no block program ran
        stages = [s.name for s in ttele.spans() if s.span_id > sid and s.kind == "stage"]
        assert "materialize.load" in stages and "lazy.force.blocks" not in stages
        assert tmat.state()["hits"] == 1
    assert warm.columns == cold.columns and warm.offsets == cold.offsets
    for c in ("w", "z", "x", "k"):
        assert torch.equal(torch.as_tensor(warm.host_values(c)),
                           torch.as_tensor(cold.host_values(c)))
    # the outputs come back on the force's device; the base's columns are
    # the base's own
    assert warm.column("w").values.device == torch.device("cpu")
    assert warm.column("x") is tdf.column("x")
    # and the JAX package's force of the same chain
    ref = _chain(tfs, jdf).force()
    np.testing.assert_allclose(warm.host_values("w"), np.asarray(ref.column("w").values),
                               rtol=1e-6)


def test_force_keys_data_program_and_device(tmp_path, always_admit):
    with tconfig.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path)):
        _chain(tft, _chain_frames(seed=0)[1]).force()
        _chain(tft, _chain_frames(seed=1)[1]).force()  # same program, new data
        st = tmat.state()
        assert st["hits"] == 0 and st["stores"] == 2
        _jdf, tdf = _chain_frames(seed=0)
        xi = tft.block(tdf, "x", tf_name="x_input")
        other = tdf.lazy(device=CPU).map_blocks((xi + 1.0).named("z"), feed_dict={"x_input": "x"})
        other.force()  # same data, another program
        assert tmat.state()["hits"] == 0
        # a device-resident base is never fingerprinted (meta stands in for
        # the card): no lookup, no store
        meta = tft.TensorFrame([Column("x", torch.empty(8, device="meta"))])
        assert tmat.frame_fingerprint(meta) is None


def test_force_with_an_explicit_executor_bypasses_the_cache(tmp_path, always_admit):
    _jdf, tdf = _chain_frames()
    with tconfig.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path)):
        _chain(tft, tdf).force(executor=tft.Executor())
        assert tmat.state()["stores"] == 0


def test_failed_force_commits_nothing(tmp_path, always_admit):
    _jdf, tdf = _chain_frames()
    with tconfig.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path)):
        with tchaos.inject(nth=[1], fault="deterministic"):
            with pytest.raises(tchaos.InjectedFault):
                _chain(tft, tdf).force()
        st = tmat.state()
        assert st["stores"] == 0 and st["entries"] == 0
        assert list(tmp_path.glob("*.tfsmat")) == []
        _chain(tft, tdf).force()
        assert tmat.state()["stores"] == 1


def test_corrupt_force_entry_is_recomputed(tmp_path, always_admit):
    _jdf, tdf = _chain_frames()
    with tconfig.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path)):
        cold = _chain(tft, tdf).force()
        path = next(iter(tmat._index.values()))["path"]
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
        tmat.reset_state()
        out = _chain(tft, tdf).force()
        st = tmat.state()
        assert st["corrupt_dropped"] == 1 and st["hits"] == 0 and st["stores"] == 1
        _chain(tft, tdf).force()
        assert tmat.state()["hits"] == 1
    np.testing.assert_array_equal(out.host_values("w"), cold.host_values("w"))


def _relational(pkg, df):
    dev = {"device": CPU} if pkg is tft else {}
    lf = df.lazy(**dev)
    return lf.filter(pkg.col("x") > 0.3).group_by("k").agg(s=("sum", "x"), m=("max", "x"))


def test_relational_force_hit_and_data_fingerprint(tmp_path, always_admit):
    from tensorframes_tpu.graph import plan as jplan
    from tensorframes_tpu_torch.graph import plan as tplan

    jdf, tdf = _chain_frames(n=200)
    # the DAG's data fingerprint is the JAX package's over the same frame
    assert tplan.data_fingerprint(_relational(tft, tdf).optimize()[0]) == jplan.data_fingerprint(
        _relational(tfs, jdf).optimize()[0]
    )
    with tconfig.override(materialize_cache_bytes=10_000_000,
                          materialize_cache_dir=str(tmp_path)):
        tplan.reset_state()
        cold = _relational(tft, tdf).force()
        assert tmat.state()["stores"] == 1
        sid = ttele.allocate_span_id()
        warm = _relational(tft, tdf).force()
        assert _dispatches(sid) == []
        assert tmat.state()["hits"] == 1 and tplan.state()["cache_hits"] == 1
    ref = _relational(tfs, jdf).force()
    assert warm.columns == cold.columns
    for c in warm.columns:
        np.testing.assert_array_equal(warm.host_values(c), cold.host_values(c))
        np.testing.assert_allclose(warm.host_values(c), np.asarray(ref.column(c).host_values()),
                                   rtol=1e-6)


def test_relational_force_over_a_device_frame_is_not_cached(tmp_path, always_admit):
    from tensorframes_tpu_torch.graph import plan as tplan

    meta = tft.TensorFrame([Column("x", torch.empty(8, device="meta")),
                            Column("k", torch.empty(8, dtype=torch.int64, device="meta"))])
    rel = meta.lazy(device=CPU).filter(tft.col("x") > 0.3)
    assert tplan.data_fingerprint(rel.optimize()[0]) is None
