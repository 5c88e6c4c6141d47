"""PyTorch port: multi-process execution (`parallel/multihost.py`), held to
the JAX package on the CPU.

- One process: the counterparts of `tests/test_parallel.py`'s
  `TestMultihost` and `TestMultihostHelpersSingleProcess`, each against the
  JAX package on the same numpy inputs (the port's global mesh over 8 CPU
  slots, JAX's over its 8 virtual devices).
- Real worlds of 2 and 4 processes (gloo on the CPU, two CPU slots a
  process, `tests/_torch_multihost_worker.py`): every scenario of
  `tests/test_multiprocess.py` (reduce, map, aggregate with int, string and
  bytes keys, analyze, checkpoint), at 4 processes where that file runs 4,
  and what the JAX package refuses over rows of several processes, with
  its error types. A module-scoped fixture runs each world once with all
  its scenarios; every process has a 60 s group timeout, and every world a
  `communicate` timeout.
- Parity: the JAX package's worker and the port's on the same seeded
  random per-process inputs, at 2 processes.
- A mesh over several processes makes every lockstep path raise.

Float sums match within rtol 1e-12 in float64; keys, min, max and maps are
exact.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu.parallel import multihost as jmh
from tensorframes_tpu_torch.parallel import Mesh, P, collectives, multihost as mh
from tensorframes_tpu_torch.parallel.verbs import _mesh_sig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
SCENARIOS = ["reduce", "map", "aggregate", "aggregate-strings", "aggregate-bytes",
             "analyze", "checkpoint", "refusals", "gather"]
RTOL = 1e-12


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _run_world(workdir, pkg: str, nprocs: int, scenarios):
    """Run one world; ``{scenario: [rank 0's line, rank 1's, ...]}``."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, pkg, str(p), str(nprocs), port, str(workdir),
             ",".join(scenarios)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env,
        )
        for p in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    by_scenario = {}
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{pkg} worker {rank} failed:\n{out}\n{err[-3000:]}"
        assert f"proc {rank} OK" in out
        for line in out.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                by_scenario.setdefault(rec["scenario"], [None] * nprocs)[rank] = rec
    return by_scenario


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``worlds(pkg, nprocs)``: one run of that world, all its scenarios."""
    memo = {}

    def get(pkg, nprocs):
        if (pkg, nprocs) not in memo:
            scenarios = ["parity"] if pkg == "jax" else SCENARIOS + (["parity"] if nprocs == 2 else [])
            workdir = tmp_path_factory.mktemp(f"{pkg}{nprocs}")
            memo[(pkg, nprocs)] = _run_world(workdir, pkg, nprocs, scenarios)
        return memo[(pkg, nprocs)]

    return get


def _per_rank(worlds, nprocs, scenario):
    recs = worlds("torch", nprocs)[scenario]
    assert len(recs) == nprocs and all(r is not None for r in recs)
    return recs


# ---------------------------------------------------------------------------
# real multi-process worlds: the scenarios of tests/test_multiprocess.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nprocs", [2, 4])
def test_global_reduce(worlds, nprocs):
    want = float(np.arange(4.0 * nprocs).sum())
    ksum = int(sum(((np.arange(4) + p) % 3).sum() for p in range(nprocs)))
    for rec in _per_rank(worlds, nprocs, "reduce"):
        np.testing.assert_allclose(rec["sum"], want, rtol=RTOL)
        np.testing.assert_allclose(rec["fold"], want, rtol=RTOL)
        assert rec["min"] == 0.0
        # a float max and an int64 sum in one call (the JAX package returns
        # process 0's max and a wrong sum here: ROADMAP, known defects)
        assert rec["two_max"] == 4.0 * nprocs - 1 and rec["two_ksum"] == ksum


@pytest.mark.parametrize("nprocs", [2, 4])
def test_global_map_blocks(worlds, nprocs):
    allx = np.arange(4.0 * nprocs)
    for rank, rec in enumerate(_per_rank(worlds, nprocs, "map")):
        assert rec["nrows"] == 4 * nprocs and rec["trim_nrows"] == 2 * nprocs
        # this process's shards of the global output, at their global rows
        assert [lo for lo, _ in rec["z"]] == [4 * rank, 4 * rank + 2]
        for lo, vals in rec["z"]:
            assert vals == (allx * 2.0 + 1.0)[lo:lo + len(vals)].tolist()
        for lo, vals in rec["w"]:  # map_rows over the map's output
            assert vals == (allx * 2.0)[lo:lo + len(vals)].tolist()
        # a trimmed map: one row a shard, its block sum
        assert rec["t"] == [[2 * rank + j, [allx[4 * rank + 2 * j:4 * rank + 2 * j + 2].sum()]]
                            for j in range(2)]


def _check_keyed(recs, keys_of, nprocs):
    all_k = np.concatenate([keys_of(p) for p in range(nprocs)])
    all_x = np.arange(4.0 * nprocs)
    uniq = sorted(set(all_k.tolist()))
    for rec in recs:
        assert rec["keys"] == uniq
        for i, k in enumerate(uniq):
            sel = all_x[all_k == k]
            np.testing.assert_allclose(rec["s"][i], sel.sum(), rtol=RTOL)
            np.testing.assert_allclose(rec["m"][i], sel.mean(), rtol=RTOL)
            assert rec["x"][i] == sel.max()


@pytest.mark.parametrize("nprocs", [2, 4])
def test_global_aggregate(worlds, nprocs):
    _check_keyed(_per_rank(worlds, nprocs, "aggregate"), lambda p: (np.arange(4) + p) % 3, nprocs)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_global_aggregate_string_keys(worlds, nprocs):
    names = np.array(["alpha", "b", "gamma"])
    _check_keyed(_per_rank(worlds, nprocs, "aggregate-strings"),
                 lambda p: names[(np.arange(4) + p) % 3], nprocs)


def test_global_aggregate_bytes_keys(worlds):
    # bytes keys decode before they travel: never the repr "b'alpha'"
    names = np.array(["alpha", "b", "gamma"])
    _check_keyed(_per_rank(worlds, 2, "aggregate-bytes"),
                 lambda p: names[(np.arange(4) + p) % 3], 2)


def test_distributed_analyze(worlds):
    # 3 values a row on process 0, 4 on process 1: the dim widens
    for rec in _per_rank(worlds, 2, "analyze"):
        assert rec["dims"] == [None]


def test_checkpoint_across_processes(worlds):
    for rec in _per_rank(worlds, 2, "checkpoint"):
        assert rec["restored"] == np.arange(8.0).tolist()
        np.testing.assert_allclose(rec["sum"], 28.0, rtol=RTOL)


def test_refusals_take_the_jax_packages_error_types(worlds):
    """Over rows of 2 processes (JAX's types, read from its 2-process CPU
    run): a verb without ``mesh=`` raises ValueError (JAX's ``device_put``
    of a non-addressable array); a keyed aggregate, `aggregate_global` of
    such a frame and a host read raise RuntimeError (JAX's fetch of a
    non-addressable array); local rows the local slots do not divide raise
    ValueError. Per-process row counts that differ raise ValueError here:
    JAX builds a global shape that disagrees across processes and the
    first collective aborts the job."""
    want = dict(reduce_without_mesh="ValueError", map_without_mesh="ValueError",
                aggregate="RuntimeError", aggregate_global="RuntimeError",
                host_values="RuntimeError", uneven="ValueError", differ="ValueError")
    for rec in _per_rank(worlds, 2, "refusals"):
        assert {k: rec[k] for k in want} == want


@pytest.mark.parametrize("nprocs", [2, 4])
def test_partials_gather_in_rank_order(worlds, nprocs):
    """Rank 1 holds no partial; the others two each, of three dtypes; with
    the fetches' shapes known (one all-gather) and with a dim unknown (a
    descriptor gather first), every rank gets the same list."""
    want = [[[r, i], [r + 0.5 * i] * 3, i % 2 == 0]
            for r in range(nprocs) if r != 1 for i in range(2)]
    for rec in _per_rank(worlds, nprocs, "gather"):
        assert rec["known"] == want and rec["unknown"] == want


def test_parity_with_the_jax_worker(worlds):
    """Both packages' workers on the same seeded random inputs: reduce,
    keyed aggregates over int and string keys, analyze."""
    jax_recs = worlds("jax", 2)["parity"]
    for j, t in zip(jax_recs, _per_rank(worlds, 2, "parity")):
        np.testing.assert_allclose(t["sum"], j["sum"], rtol=RTOL)
        assert t["min"] == j["min"]
        for what in ("numeric", "strings"):
            assert t[what]["keys"] == j[what]["keys"]
            assert t[what]["x"] == j[what]["x"]
            for f in ("s", "m"):
                np.testing.assert_allclose(t[what][f], j[what][f], rtol=RTOL)
        assert t["analyze"] == j["analyze"]
    assert jax_recs[0]["analyze"]["v"] == [None] and jax_recs[0]["analyze"]["u"] == [2, 3]


# ---------------------------------------------------------------------------
# one process: tests/test_parallel.py's multihost classes
# ---------------------------------------------------------------------------

CPU8 = ["cpu"] * 8


class TestMultihost:
    def test_single_host_global_frame(self):
        mh.initialize_distributed()  # no-op in one process
        gmesh = mh.global_data_mesh(devices=CPU8)
        df = tft.TensorFrame.from_dict({"x": np.arange(16.0)})
        gdf = mh.host_local_frame_to_global(df, gmesh)
        shards = gdf.shards("x")
        assert len(shards) == 8 and [s.index.start for s in shards] == list(range(0, 16, 2))
        x_input = tft.block(gdf, "x", tf_name="x_input")
        s = tft.dsl.reduce_sum(x_input, axes=[0]).named("x")
        assert float(tft.reduce_blocks(s, gdf, mesh=gmesh)) == 120.0
        # JAX on the same rows
        jmh.initialize_distributed()
        jmesh = jmh.global_data_mesh()
        jdf = jmh.host_local_frame_to_global(tfs.TensorFrame.from_dict({"x": np.arange(16.0)}), jmesh)
        assert len(jdf["x"].values.sharding.device_set) == len(shards)
        js = jdsl.reduce_sum(tfs.block(jdf, "x", tf_name="x_input"), axes=[0]).named("x")
        assert float(tfs.reduce_blocks(js, jdf, mesh=jmesh)) == 120.0

    def test_single_host_map_keeps_the_frame_global(self):
        gmesh = mh.global_data_mesh(devices=CPU8)
        gdf = mh.host_local_frame_to_global(tft.TensorFrame.from_dict({"x": np.arange(16.0)}), gmesh)
        out = tft.map_blocks((tft.block(gdf, "x") + 3.0).named("z"), gdf, mesh=gmesh)
        assert isinstance(out, mh.SpanningFrame) and out.nrows == 16
        jmesh = jmh.global_data_mesh()
        jdf = jmh.host_local_frame_to_global(tfs.TensorFrame.from_dict({"x": np.arange(16.0)}), jmesh)
        jout = tfs.map_blocks((tfs.block(jdf, "x") + 3.0).named("z"), jdf, mesh=jmesh)
        np.testing.assert_array_equal(out.host_values("z"), np.asarray(jout["z"].values))
        # every row is here: the verbs also take the frame without a mesh
        np.testing.assert_array_equal(
            tft.map_blocks((tft.block(gdf, "x") + 3.0).named("z"), gdf, device="cpu")
            .host_values("z"), out.host_values("z"))

    def test_ragged_rejected(self):
        df = tft.TensorFrame.from_dict({"v": [np.ones(2), np.ones(3)]})
        with pytest.raises(ValueError, match="dense"):
            mh.host_local_frame_to_global(df, mh.global_data_mesh(devices=CPU8))
        jdf = tfs.TensorFrame.from_dict({"v": [np.ones(2), np.ones(3)]})
        with pytest.raises(ValueError, match="dense"):
            jmh.host_local_frame_to_global(jdf, jmh.global_data_mesh())

    def test_rows_the_local_slots_do_not_divide_are_refused(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(12.0)})
        with pytest.raises(ValueError, match="do not divide"):
            mh.host_local_frame_to_global(df, mh.global_data_mesh(devices=CPU8))
        with pytest.raises(ValueError):
            jmh.host_local_frame_to_global(tfs.TensorFrame.from_dict({"x": np.arange(12.0)}),
                                           jmh.global_data_mesh())


class TestMultihostHelpersSingleProcess:
    def test_analyze_global_one_process(self):
        cells = [np.arange(3.0), np.arange(3.0) + 1]
        out = mh.analyze_global(tft.TensorFrame.from_dict({"v": cells}))
        jout = jmh.analyze_global(tfs.TensorFrame.from_dict({"v": cells}))
        assert out.info["v"].cell_shape.dims == jout.info["v"].cell_shape.dims == (3,)

    def test_aggregate_global_one_process(self):
        data = {"k": np.array([0, 1, 0], dtype=np.int64), "x": np.arange(3.0)}
        df = tft.TensorFrame.from_dict(data)
        s = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
        out = mh.aggregate_global(s, tft.group_by(df, "k"), device="cpu")
        got = dict(zip(out.host_values("k").tolist(), out.host_values("x").tolist()))
        jdf = tfs.TensorFrame.from_dict(data)
        js = jdsl.reduce_sum(tfs.block(jdf, "x", tf_name="x_input"), axes=[0]).named("x")
        jout = jmh.aggregate_global(js, tfs.group_by(jdf, "k"))
        assert got == dict(zip(jout["k"].values.tolist(), jout["x"].values.tolist())) == {0: 2.0, 1: 1.0}

    def test_aggregate_global_rejects_unclassifiable(self):
        data = {"k": np.array([0, 1], dtype=np.int64), "x": np.arange(2.0)}
        df = tft.TensorFrame.from_dict(data)
        wrapped = tft.dsl.identity(
            tft.dsl.reduce_min(tft.block(df, "x", tf_name="x_input"), axes=[0])).named("x")
        with pytest.raises(ValueError, match="aggregate_global"):
            mh.aggregate_global(wrapped, tft.group_by(df, "k"), device="cpu")
        jdf = tfs.TensorFrame.from_dict(data)
        jwrapped = jdsl.identity(
            jdsl.reduce_min(tfs.block(jdf, "x", tf_name="x_input"), axes=[0])).named("x")
        with pytest.raises(ValueError, match="aggregate_global"):
            jmh.aggregate_global(jwrapped, tfs.group_by(jdf, "k"))


# ---------------------------------------------------------------------------
# a mesh over several processes: identity, and the lockstep paths refuse it
# ---------------------------------------------------------------------------


def _spanning_mesh(shape=(4,), names=("data",)):
    """Four CPU slots of which ranks 0 and 1 own two each."""
    devs = np.asarray([torch.device("cpu")] * 4, dtype=object).reshape(shape)
    return Mesh(devs, names, ranks=np.asarray([0, 0, 1, 1]).reshape(shape))


def test_the_mesh_key_names_the_rank():
    one = Mesh(np.asarray([torch.device("cpu")] * 4, dtype=object), ("data",))
    two = _spanning_mesh()
    assert one != two and hash(one) != hash(two)
    assert _mesh_sig(one) != _mesh_sig(two) and "r1/" in _mesh_sig(two)
    assert two.process_count == 2 and two.local_slots(1) == [2, 3]


def _mlp_step(mesh2d):
    from tensorframes_tpu_torch.models import MLP

    rng = np.random.RandomState(0)
    m = MLP.from_jax_params([(rng.rand(4, 8).astype(np.float32), np.zeros(8, np.float32)),
                             (rng.rand(8, 2).astype(np.float32), np.zeros(2, np.float32))],
                            device="cpu")
    return m.sharded_train_step(mesh2d)(m.params, torch.rand(8, 4), torch.zeros(8, dtype=torch.long))


@pytest.mark.parametrize("path", ["psum", "ring_attention", "seq_all_to_all", "pipeline",
                                  "shard", "mlp_sharded_step", "to_global", "aggregate"])
def test_lockstep_paths_refuse_a_mesh_over_processes(path):
    mesh = _spanning_mesh()
    q = torch.rand(1, 8, 4)
    calls = {
        "psum": lambda: collectives.psum([torch.ones(1)] * 4, collectives.axis_devices(mesh, "data")),
        "ring_attention": lambda: tft.parallel.ring_attention(q, q, q, mesh),
        "seq_all_to_all": lambda: tft.parallel.seq_all_to_all(
            torch.rand(8, 4, 2), mesh, seq_axis=0, head_axis=1),
        "pipeline": lambda: tft.parallel.pipeline_apply(
            lambda p, h: h * p, torch.ones(4), torch.rand(8, 2), _spanning_mesh(names=("stage",)),
            num_microbatches=2),
        "shard": lambda: tft.parallel.shard(torch.rand(8, 2), mesh, P("data")),
        "mlp_sharded_step": lambda: _mlp_step(_spanning_mesh((2, 2), ("data", "model"))),
        "to_global": lambda: tft.TensorFrame.from_dict({"x": np.arange(8.0)}).to_global(mesh=mesh),
        "aggregate": lambda: tft.aggregate(
            tft.dsl.reduce_sum(tft.block(_kv(), "x", tf_name="x_input"), axes=[0]).named("x"),
            tft.group_by(_kv(), "k"), mesh=mesh),
    }
    with pytest.raises(ValueError, match="2 processes"):
        calls[path]()


def _kv():
    return tft.TensorFrame.from_dict({"k": np.arange(8) % 2, "x": np.arange(8.0)})


def test_a_plain_frame_over_a_mesh_of_processes_is_refused():
    df = tft.TensorFrame.from_dict({"x": np.arange(8.0)})
    with pytest.raises(ValueError, match="host_local_frame_to_global"):
        tft.map_blocks((tft.block(df, "x") + 1.0).named("z"), df, mesh=_spanning_mesh())


# ---------------------------------------------------------------------------
# the process group's bring-up
# ---------------------------------------------------------------------------


def test_initialize_distributed_bring_up_rules(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mh.initialize_distributed()  # one process, no coordinator: nothing to join
    assert mh.process_count() == 1 and mh.process_index() == 0
    with pytest.raises(ValueError, match="coordinator"):
        mh.initialize_distributed(num_processes=2, process_id=0)
    if not torch.cuda.is_available():
        # device=None is NCCL on a card: without one it raises, never gloo
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mh.initialize_distributed(coordinator_address="127.0.0.1:1", num_processes=2,
                                      process_id=0)
    with pytest.raises(ValueError, match="multi-axis"):
        mh.global_data_mesh(axes=("data", "model"), devices=["cpu"])
