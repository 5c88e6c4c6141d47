"""One process of a multi-process world for `tests/test_torch_multihost.py`.

    python tests/_torch_multihost_worker.py PKG RANK WORLD PORT WORKDIR SCENARIO[,SCENARIO...]

``PKG`` is ``torch`` (the port: gloo on the CPU, two CPU slots a process)
or ``jax`` (the JAX package: `jax.distributed` over two virtual CPU
devices a process, for the ``parity`` scenario only). Each scenario runs
in order and prints one JSON line ``{"scenario": ..., "rank": ..., ...}``
with what it computed, and the test checks it. The process group's
timeout is 60 s: a lost peer fails the world instead of hanging it.
"""

import json
import os
import sys

PKG, RANK, WORLD, PORT, WORKDIR = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
)
SCENARIOS = sys.argv[6].split(",")

if PKG == "jax":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tensorframes_tpu as pkg
    from tensorframes_tpu.parallel import multihost as mh

    mh.initialize_distributed(
        coordinator_address=f"127.0.0.1:{PORT}", num_processes=WORLD, process_id=RANK
    )
    MESH = mh.global_data_mesh()
    DEV = {}
else:
    import torch.distributed as dist

    import tensorframes_tpu_torch as pkg
    from tensorframes_tpu_torch.parallel import multihost as mh

    mh.initialize_distributed(
        coordinator_address=f"127.0.0.1:{PORT}", num_processes=WORLD, process_id=RANK,
        device="cpu", timeout_s=60.0,
    )
    MESH = mh.global_data_mesh(devices=["cpu"] * 2)
    DEV = {"device": "cpu"}

import numpy as np  # noqa: E402

dsl = pkg.dsl
assert MESH.devices.size == 2 * WORLD


def emit(scenario, **numbers):
    print(json.dumps({"scenario": scenario, "rank": RANK, **numbers}), flush=True)


def host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def sum_graph(df, col="x"):
    return dsl.reduce_sum(pkg.block(df, col, tf_name=f"{col}_input"), axes=[0]).named(col)


def keyed(df):
    """A keyed sum, mean and max of ``x`` (one fetch each)."""
    s = dsl.reduce_sum(pkg.block(df, "x", tf_name="s_input"), axes=[0]).named("s")
    m = dsl.reduce_mean(pkg.block(df, "x", tf_name="m_input"), axes=[0]).named("m")
    x = dsl.reduce_max(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
    return [s, m, x], {"s_input": "x", "m_input": "x"}


def agg_out(out, fetches):
    keys = [k if isinstance(k, str) else int(k) for k in out["k"].host_values().tolist()]
    return {"keys": keys, **{f: host(out[f].values).tolist() for f in fetches}}


LOCAL = pkg.TensorFrame.from_dict({"x": np.arange(4.0) + 4 * RANK})


def scenario_reduce():
    df = mh.host_local_frame_to_global(LOCAL, MESH)
    total = pkg.reduce_blocks(sum_graph(df), df, mesh=MESH)
    low = pkg.reduce_blocks(
        dsl.reduce_min(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x"), df, mesh=MESH)
    x1, x2 = pkg.row(df, "x", tf_name="x_1"), pkg.row(df, "x", tf_name="x_2")
    folded = pkg.reduce_rows((x1 + x2).named("x"), df, mesh=MESH)
    # two fetches of two dtypes in one reduce
    kdf = mh.host_local_frame_to_global(pkg.TensorFrame.from_dict(
        {"x": np.arange(4.0) + 4 * RANK, "k": ((np.arange(4) + RANK) % 3).astype(np.int64)}), MESH)
    two = pkg.reduce_blocks(
        [dsl.reduce_max(pkg.block(kdf, "x", tf_name="x_input"), axes=[0]).named("x"),
         dsl.reduce_sum(pkg.block(kdf, "k", tf_name="k_input"), axes=[0]).named("k")],
        kdf, mesh=MESH)
    emit("reduce", sum=float(total), min=float(low), fold=float(folded),
         two_max=float(two["x"]), two_ksum=int(two["k"]))


def scenario_map():
    df = mh.host_local_frame_to_global(LOCAL, MESH)
    out = pkg.map_blocks((pkg.block(df, "x") * 2.0 + 1.0).named("z"), df, mesh=MESH)
    rows = pkg.map_rows((pkg.row(out, "z") - 1.0).named("w"), out, mesh=MESH)
    one = dsl.reduce_sum(pkg.block(df, "x"), axes=[0], keep_dims=True).named("t")
    trimmed = pkg.map_blocks(one, df, trim=True, mesh=MESH)
    emit("map", nrows=out.nrows, trim_nrows=trimmed.nrows,
         z=[[sh.index.start, host(sh.data).tolist()] for sh in out.shards("z")],
         w=[[sh.index.start, host(sh.data).tolist()] for sh in rows.shards("w")],
         t=[[sh.index.start, host(sh.data).tolist()] for sh in trimmed.shards("t")])


def _aggregate(scenario, keys):
    kv = pkg.TensorFrame.from_dict({"k": keys, "x": np.arange(4.0) + 4 * RANK})
    fetches, feed = keyed(kv)
    out = mh.aggregate_global(fetches, pkg.group_by(kv, "k"), feed_dict=feed, **DEV)
    emit(scenario, **agg_out(out, ["s", "m", "x"]))


def scenario_aggregate():
    _aggregate("aggregate", ((np.arange(4) + RANK) % 3).astype(np.int64))


NAMES = np.array(["alpha", "b", "gamma"], dtype=object)


def scenario_aggregate_strings():
    _aggregate("aggregate-strings", NAMES[(np.arange(4) + RANK) % 3])


def scenario_aggregate_bytes():
    raw = np.array([b"alpha", b"b", b"gamma"], dtype="S5")
    _aggregate("aggregate-bytes", raw[(np.arange(4) + RANK) % 3].astype(object))


def scenario_analyze():
    n = 3 + RANK
    loc = pkg.TensorFrame.from_dict({"v": [np.arange(float(n)) for _ in range(4)]})
    dims = mh.analyze_global(loc).info["v"].cell_shape.dims
    emit("analyze", dims=list(dims))


def scenario_checkpoint():
    import torch.distributed as dist

    from tensorframes_tpu_torch.utils import checkpoint as ckpt

    ckpt.save_frame(os.path.join(WORKDIR, f"shard{RANK}.npz"), LOCAL)
    dist.barrier()  # every shard written before any is read
    parts = [ckpt.load_frame(os.path.join(WORKDIR, f"shard{p}.npz")) for p in range(WORLD)]
    glob = np.concatenate([p.host_values("x") for p in parts])
    df = mh.host_local_frame_to_global(parts[RANK], MESH)
    total = pkg.reduce_blocks(sum_graph(df), df, mesh=MESH)
    emit("checkpoint", restored=glob.tolist(), sum=float(total))


def scenario_refusals():
    """What the JAX package refuses over rows of several processes, with
    its error types; then row counts it cannot take."""
    df = mh.host_local_frame_to_global(LOCAL, MESH)
    got = {}
    for name, call in (
        ("reduce_without_mesh", lambda: pkg.reduce_blocks(sum_graph(df), df, device="cpu")),
        ("map_without_mesh", lambda: pkg.map_blocks(
            (pkg.block(df, "x") + 1.0).named("z"), df, device="cpu")),
        ("aggregate", lambda: pkg.aggregate(sum_graph(df), pkg.group_by(df, "x"), mesh=MESH)),
        ("aggregate_global", lambda: mh.aggregate_global(
            sum_graph(df), pkg.group_by(df, "x"), device="cpu")),
        ("host_values", lambda: df.host_values("x")),
        ("uneven", lambda: mh.host_local_frame_to_global(
            pkg.TensorFrame.from_dict({"x": np.arange(3.0)}), MESH)),
        ("differ", lambda: mh.host_local_frame_to_global(
            pkg.TensorFrame.from_dict({"x": np.arange(2.0 + 2 * RANK)}), MESH)),
    ):
        try:
            call()
            got[name] = None
        except Exception as e:  # the error type is the result
            got[name] = type(e).__name__
    emit("refusals", **got)


def scenario_gather():
    """`gather_partials` with one rank holding no partial, fetches of
    three dtypes, and a dim the analysis left unknown (the descriptor
    path)."""
    import types

    import torch

    def out(dims, st):
        return types.SimpleNamespace(shape=pkg.Shape(dims), dtype=st)

    st = pkg.ScalarType
    mine = [] if RANK == 1 else [
        (torch.tensor([RANK, i]), torch.full((3,), RANK + 0.5 * i), torch.tensor(i % 2 == 0))
        for i in range(2)]
    got = {}
    for name, dims in (("known", (3,)), ("unknown", (None,))):
        parts = mh.gather_partials(
            mine, MESH, torch.device("cpu"),
            [out((2,), st.int64), out(dims, st.float32), out((), st.bool_)])
        got[name] = [[t.tolist() for t in p] for p in parts]
    emit("gather", **got)


def scenario_parity():
    """Seeded random per-process inputs, the same in both packages."""
    rng = np.random.default_rng(1234 + RANK)
    x = rng.standard_normal(8)
    keys = rng.integers(0, 5, 8).astype(np.int64)
    names = np.array(["k%d" % i for i in rng.integers(0, 4, 8)], dtype=object)
    df = mh.host_local_frame_to_global(pkg.TensorFrame.from_dict({"x": x}), MESH)
    total = pkg.reduce_blocks(sum_graph(df), df, mesh=MESH)
    low = pkg.reduce_blocks(
        dsl.reduce_min(pkg.block(df, "x", tf_name="x_input"), axes=[0]).named("x"), df, mesh=MESH)
    out = {"sum": float(total), "min": float(low)}
    for what, k in (("numeric", keys), ("strings", names)):
        kv = pkg.TensorFrame.from_dict({"k": k, "x": x})
        fetches, feed = keyed(kv)
        got = mh.aggregate_global(fetches, pkg.group_by(kv, "k"), feed_dict=feed, **DEV)
        out[what] = agg_out(got, ["s", "m", "x"])
    lens = rng.integers(2, 5)
    loc = pkg.TensorFrame.from_dict({"v": [rng.standard_normal(lens) for _ in range(3)],
                                     "u": [rng.standard_normal((2, 3)) for _ in range(3)]})
    merged = mh.analyze_global(loc)
    out["analyze"] = {c: list(merged.info[c].cell_shape.dims) for c in ("v", "u")}
    emit("parity", **out)


for s in SCENARIOS:
    globals()["scenario_" + s.replace("-", "_")]()
print(f"proc {RANK} OK", flush=True)
if PKG == "torch":
    dist.destroy_process_group()
