"""PyTorch port: the out-of-core streaming reduce (`streaming.py`), held to
the JAX package on the CPU.

The same seeded numpy chunks stream through `tensorframes_tpu.
reduce_blocks_stream` and the port's (``device="cpu"``). Tolerances:
float32 sums and means rtol 1e-5 (torch and XLA reduce in different
orders); min, max and integer sums exact. The tree-fold and host-spill
counters match the JAX package's. The CUDA transfer stage (pinned
staging, copy stream, events) runs only on the card: `chip_smoke.py`
phase 12 drives it; here the stage takes its CPU path.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.utils import profiling as jprof
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import api as tapi
from tensorframes_tpu_torch import streaming as tstream
from tensorframes_tpu_torch.runtime import checkpoint as tckpt
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
F32_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's process-wide counters never leak across tests."""
    yield
    ttele.reset()
    tprof.reset_stats()
    tfaults.reset_ledger()
    tdl.reset()
    tckpt.reset_state()


def _chunks(n_chunks, rows, dtype=np.float32, width=None, seed=0, empty_at=(),
            uneven=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        n = 0 if i in empty_at else rows + (i if uneven else 0)
        shape = (n,) if width is None else (n, width)
        if np.dtype(dtype).kind == "f":
            out.append(rng.standard_normal(shape).astype(dtype))
        else:
            out.append(rng.integers(-1000, 1000, shape).astype(dtype))
    return out


def _graphs(pkg, dtype, width, ops):
    """One fetch per entry of ``ops`` (``sum`` | ``mean`` | ``min`` |
    ``max`` | ``prod`` | ``sumsq``), each with its own ``<name>_input``
    placeholder, all fed from column ``x``."""
    cell = (2,) if width is None else (2, width)
    probe = pkg.TensorFrame.from_dict({"x": np.zeros(cell, dtype=dtype)})
    red = {
        "sum": pkg.dsl.reduce_sum, "mean": pkg.dsl.reduce_mean,
        "min": pkg.dsl.reduce_min, "max": pkg.dsl.reduce_max,
        # the DSL has no reduce_prod; its reducer builds TF's Prod node
        "prod": lambda x, axes: pkg.dsl._reducer("Prod", x, axes, False),
    }
    fetches, feed = [], {}
    for op in ops:
        name = f"f_{op}"
        ph = pkg.block(probe, "x", tf_name=f"{name}_input")
        if op == "sumsq":
            fetches.append(pkg.dsl.reduce_sum(ph * ph, axes=[0]).named(name))
        else:
            fetches.append(red[op](ph, axes=[0]).named(name))
        feed[f"{name}_input"] = "x"
    return fetches, feed


def _run_both(ops, arrays, dtype, width=None, **kw):
    """(port dict, jax dict) of every fetch over the same chunks."""
    def frames(pkg):
        return iter([pkg.TensorFrame.from_dict({"x": a}) for a in arrays])

    tf_fetches, feed = _graphs(tft, dtype, width, ops)
    jf_fetches, _ = _graphs(tfs, dtype, width, ops)
    got = tft.reduce_blocks_stream(tf_fetches, frames(tft), feed, device=CPU, **kw)
    want = tfs.reduce_blocks_stream(jf_fetches, frames(tfs), feed, **kw)
    if len(ops) == 1:
        got, want = {f"f_{ops[0]}": got}, {f"f_{ops[0]}": want}
    return (
        {k: v.numpy() for k, v in got.items()},
        {k: np.asarray(v) for k, v in want.items()},
    )


def _assert_parity(got, want, dtype):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        exact = np.dtype(dtype).kind != "f" or k.endswith(("_min", "_max"))
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=F32_RTOL, err_msg=k)


CASES = {
    "f32-sum": (["sum"], np.float32, None),
    "f32-mean": (["mean"], np.float32, None),
    "f32-min": (["min"], np.float32, None),
    "f32-max": (["max"], np.float32, None),
    "i64-sum": (["sum"], np.int64, None),
    "i32-min-max": (["min", "max"], np.int32, None),
    "i64-prod": (["prod"], np.int64, None),
    "f32-multi-fetch": (["sum", "min", "max", "mean"], np.float32, None),
    "f32-vector-sum-min": (["sum", "min"], np.float32, 8),
    "f32-sum-of-squares": (["sumsq"], np.float32, None),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fold_every", ["auto", 3, None])
def test_stream_matches_jax(case, fold_every):
    ops, dtype, width = CASES[case]
    rows = 5 if "prod" in ops[0] else 40
    arrays = _chunks(9, rows, dtype, width, seed=len(case))
    if "prod" in ops:
        arrays = [np.clip(a, -2, 2) for a in arrays]
    got, want = _run_both(ops, arrays, dtype, width, fold_every=fold_every)
    _assert_parity(got, want, dtype)


@pytest.mark.parametrize("case", ["f32-sum", "i64-sum", "f32-multi-fetch"])
def test_empty_chunks_are_skipped(case):
    ops, dtype, width = CASES[case]
    arrays = _chunks(7, 30, dtype, width, seed=3, empty_at=(0, 3, 6))
    got, want = _run_both(ops, arrays, dtype, width)
    _assert_parity(got, want, dtype)


@pytest.mark.parametrize("arrays", [[], [np.zeros(0, np.float32)] * 3], ids=["no-chunks", "all-empty"])
def test_empty_stream_raises_like_jax(arrays):
    tf_fetches, _ = _graphs(tft, np.float32, None, ["sum"])
    jf_fetches, _ = _graphs(tfs, np.float32, None, ["sum"])
    with pytest.raises(ValueError, match="empty iterator"):
        tfs.reduce_blocks_stream(
            jf_fetches[0], iter([tfs.TensorFrame.from_dict({"x": a}) for a in arrays])
        )
    with pytest.raises(ValueError, match="empty iterator"):
        tft.reduce_blocks_stream(
            tf_fetches[0],
            iter([tft.TensorFrame.from_dict({"x": a}) for a in arrays]),
            device=CPU,
        )


def _counts_port():
    spans = ttele.spans()
    return (
        sum(s.name == "reduce_blocks_stream.fold" for s in spans),
        sum(s.name == "reduce_blocks_stream.spill" for s in spans),
        tprof.stats().get("host_sync", 0),
    )


def _counts_jax():
    spans = jtele.spans()
    return (
        sum(s.name == "reduce_blocks_stream.fold" for s in spans),
        sum(s.name == "reduce_blocks_stream.spill" for s in spans),
        jprof.stats().get("host_sync", 0),
    )


@pytest.mark.parametrize(
    "ops,n_chunks,fold_every",
    [
        (["sum"], 130, "auto"),  # two tree-folds at 64, one final combine
        (["min", "max"], 70, "auto"),
        (["sum"], 10, 4),
        (["sumsq"], 6, "auto"),  # unfoldable: spills every older partial
        (["mean"], 5, "auto"),
        (["sum"], 6, None),
    ],
)
def test_fold_and_spill_counters_match_jax(ops, n_chunks, fold_every):
    # one chunk size: the JAX package compiles once per block shape
    arrays = _chunks(n_chunks, 3, np.float32, seed=n_chunks, uneven=False)
    jtele.reset()
    jprof.reset_stats()
    ttele.reset()
    tprof.reset_stats()
    got, want = _run_both(ops, arrays, np.float32, fold_every=fold_every)
    _assert_parity(got, want, np.float32)
    port, jax_ = _counts_port(), _counts_jax()
    assert port == jax_, (port, jax_)
    assert tprof.stats().get("reduce_blocks_stream.fold", 0) == port[0]
    assert tprof.stats().get("reduce_blocks_stream.chunks", 0) == n_chunks


def test_spill_accounts_d2h_bytes():
    arrays = _chunks(4, 3, np.float32)
    ttele.reset()
    tprof.reset_stats()
    fetches, feed = _graphs(tft, np.float32, None, ["sumsq"])
    tft.reduce_blocks_stream(
        fetches[0], iter([tft.TensorFrame.from_dict({"x": a}) for a in arrays]),
        feed, device=CPU,
    )
    spills = [s for s in ttele.spans() if s.name == "reduce_blocks_stream.spill"]
    assert len(spills) == 3 and all(s.kind == "host_sync" for s in spills)
    _, _, hists = ttele.metrics_snapshot()
    d2h = [v for (name, _), v in hists.items() if name == "d2h_bytes"]
    assert d2h and d2h[0][3] == len(spills)  # one observation per spill


@pytest.mark.parametrize("pipeline", [True, False], ids=["threaded", "serial"])
def test_ingest_pipeline_on_and_off_agree(pipeline):
    arrays = _chunks(8, 50, np.int64, seed=11)
    with tft.config.override(ingest_pipeline=pipeline):
        got, want = _run_both(["sum", "min"], arrays, np.int64)
    _assert_parity(got, want, np.int64)


def test_device_resident_and_pandas_chunks():
    pd = pytest.importorskip("pandas")
    arrays = _chunks(4, 20, np.int64, seed=5)
    fetches, feed = _graphs(tft, np.int64, None, ["sum"])
    frames = [
        tft.TensorFrame.from_dict({"x": arrays[0]}).to_device(CPU),
        pd.DataFrame({"x": arrays[1]}),
        tft.TensorFrame.from_dict({"x": arrays[2]}),
        tft.TensorFrame.from_dict({"x": arrays[3]}),
    ]
    got = tft.reduce_blocks_stream(fetches[0], iter(frames), feed, device=CPU)
    assert int(got) == int(np.concatenate(arrays).sum())
    assert tprof.stats().get("reduce_blocks_stream.transfer_fallback", 0) == 0


def test_transfer_stage_on_the_cpu():
    stage = tstream._TransferStage(torch.device(CPU))
    f = tft.TensorFrame.from_dict(
        {"x": np.arange(6, dtype=np.float32), "s": np.array(list("abcdef"), dtype=object)}
    )
    out = stage(f)
    assert isinstance(out.column("x").values, torch.Tensor)
    assert out.column("s").device is None  # string cells stay on the host
    assert stage.receive(out) is out
    empty = tft.TensorFrame.from_dict({"x": np.zeros(0, np.float32)})
    assert stage(empty) is empty
    stage.close()


def test_stack_parts_mixes_host_and_tensor_partials():
    parts = [np.float32(1.5), torch.tensor(2.5), np.float32(3.0)]
    stacked = tapi._stack_parts(parts)
    assert isinstance(stacked, torch.Tensor) and stacked.tolist() == [1.5, 2.5, 3.0]
    host = tapi._stack_parts([np.arange(2), np.arange(2)])
    assert isinstance(host, np.ndarray) and host.shape == (2, 2)


def test_stream_timeout_tears_down_the_pipeline():
    def slow():
        for i in range(1000):
            time.sleep(0.05)
            yield tft.TensorFrame.from_dict({"x": np.ones(8, np.float32) * i})

    fetches, feed = _graphs(tft, np.float32, None, ["sum"])
    t0 = time.monotonic()
    with pytest.raises(tft.DeadlineExceeded) as ei:
        tft.reduce_blocks_stream(fetches[0], slow(), feed, device=CPU, timeout_s=0.3)
    assert time.monotonic() - t0 < 2.0
    assert ei.value.verb == "reduce_blocks_stream"
    end = time.monotonic() + 5.0
    while time.monotonic() < end and any(
        t.name.startswith("tfs-ingest") for t in threading.enumerate()
    ):
        time.sleep(0.05)
    assert not [t.name for t in threading.enumerate() if t.name.startswith("tfs-ingest")]


def test_stream_over_a_graphdef():
    """The README vector sum as GraphDef bytes, with a min beside it."""
    arrays = _chunks(5, 64, np.float32, width=4, seed=9)
    probe = tft.TensorFrame.from_dict({"x": np.zeros((2, 4), np.float32)})
    s = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
    mn = tft.dsl.reduce_min(tft.block(probe, "x", tf_name="m_input"), axes=[0]).named("m")
    graph_bytes = tft.dsl.build([s, mn])[0].to_bytes()
    got = tft.reduce_blocks_stream(
        graph_bytes, iter([tft.TensorFrame.from_dict({"x": a}) for a in arrays]),
        {"x_input": "x", "m_input": "x"}, fetch_names=["x", "m"], device=CPU,
    )
    want = tfs.reduce_blocks_stream(
        graph_bytes, iter([tfs.TensorFrame.from_dict({"x": a}) for a in arrays]),
        {"x_input": "x", "m_input": "x"}, fetch_names=["x", "m"],
    )
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=F32_RTOL)
    np.testing.assert_array_equal(got["m"].numpy(), np.asarray(want["m"]))
    np.testing.assert_allclose(
        got["x"].numpy(), np.concatenate(arrays).sum(axis=0, dtype=np.float64), rtol=F32_RTOL
    )
