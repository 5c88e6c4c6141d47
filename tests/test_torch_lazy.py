"""PyTorch port: lazy verb fusion (`lazy.py`, `graph/fuse.py`), held to the
JAX package on the CPU.

Mirrors `tests/test_fusion.py`. A chained ``map_blocks -> map_blocks ->
reduce_blocks`` pipeline deferred with ``df.lazy(device="cpu")`` runs as
ONE lowered callable per block — the executor gains exactly one "block"
entry — and its results equal the port's eager chain bit for bit
(`torch.equal`) and the JAX package's on the same seeded inputs (float32
rtol 1e-6, float64 rtol 1e-12; integers, min and max exact).

The plan-prep pipeline (``config.plan_pipeline``) runs here with its CPU
path; the CUDA copies through pinned staging run only on the card
(`chip_smoke.py` phase 13). Not ported yet, so not tested here: JAX's mesh
fusion cases (ROADMAP Queue 1 item 12), the materialization cache,
`explain_analyze` and the diagnostics sections (item 11).
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.lazy import LazyFrame, LazyPlan, lazy_active
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.schema import ScalarType, Shape
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
RTOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's process-wide counters never leak across tests."""
    yield
    ttele.reset()
    tprof.reset_stats()
    tfaults.reset_ledger()
    tdl.reset()


def _data(rows=24, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(rows).astype(dtype)


def _frame(pkg, x, blocks=3):
    return pkg.TensorFrame.from_dict({"x": x}, num_blocks=blocks)


def _lazy(pkg, df):
    return df.lazy(device=CPU) if pkg is tft else df.lazy()


def _kw(pkg):
    return {"device": CPU} if pkg is tft else {}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _eager_chain(pkg, df, executor=None):
    m1 = pkg.map_blocks(
        (pkg.block(df, "x") * 2.0 + 1.0).named("y"), df, executor=executor, **_kw(pkg)
    )
    return pkg.map_blocks(
        (pkg.block(m1, "y") * 3.0).named("z"), m1, executor=executor, **_kw(pkg)
    )


def _lazy_chain(pkg, df, executor=None):
    lf = _lazy(pkg, df)
    lf = lf.map_blocks((pkg.block(lf, "x") * 2.0 + 1.0).named("y"), executor=executor)
    return lf.map_blocks((pkg.block(lf, "y") * 3.0).named("z"), executor=executor)


def _reduce_of(pkg, frame_like, col, op="sum"):
    ph = pkg.block(frame_like, col, tf_name=col + "_input")
    return getattr(pkg.dsl, f"reduce_{op}")(ph, axes=[0]).named(col)


def _ingest_threads():
    return [t for t in threading.enumerate() if t.name.startswith("tfs-ingest-")]


# ---------------------------------------------------------------------------
# splice correctness
# ---------------------------------------------------------------------------


class TestSpliceCorrectness:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("pipeline", [True, False])
    def test_force_matches_eager_bitwise_and_jax(self, dtype, pipeline):
        x = _data(dtype=dtype)
        df = _frame(tft, x)
        with tconfig.override(plan_pipeline=pipeline):
            forced = _lazy_chain(tft, df).force()
        eager = _eager_chain(tft, df)
        ref = _lazy_chain(tfs, _frame(tfs, x)).force()
        # the eager chain orders each verb's outputs first: z, y, x
        assert forced.columns == list(ref.columns) == ["y", "z", "x"]
        assert eager.columns == ["z", "y", "x"]
        for c in ("y", "z"):
            assert torch.equal(forced[c].values, eager[c].values), c
            assert forced[c].values.dtype == eager[c].values.dtype
            np.testing.assert_allclose(
                forced[c].values.numpy(), np.asarray(ref[c].values), rtol=RTOL[dtype]
            )

    @pytest.mark.parametrize("op", ["sum", "min", "max"])
    def test_reduce_terminal_matches_eager_bitwise_and_jax(self, op):
        x = _data(rows=4000)
        df = _frame(tft, x, blocks=4)
        eager_frame = _eager_chain(tft, df)
        eager = tft.reduce_blocks(_reduce_of(tft, eager_frame, "z", op), eager_frame, device=CPU)
        lf = _lazy_chain(tft, df)
        fused = lf.reduce_blocks(_reduce_of(tft, lf, "z", op))
        assert torch.equal(fused, eager)
        jlf = _lazy_chain(tfs, _frame(tfs, x, blocks=4))
        ref = np.asarray(jlf.reduce_blocks(_reduce_of(tfs, jlf, "z", op)))
        if op == "sum":
            np.testing.assert_allclose(fused.numpy(), ref, rtol=1e-5)
        else:
            assert fused.item() == ref.item()

    def test_integer_chain_exact(self):
        x = np.arange(30, dtype=np.int64) - 7
        df = _frame(tft, x)
        lf = df.lazy(device=CPU)
        lf = lf.map_blocks((tft.block(lf, "x") * tft.dsl.constant(np.int64(3))).named("y"))
        s = lf.reduce_blocks(_reduce_of(tft, lf, "y"))
        jdf = _frame(tfs, x)
        jlf = jdf.lazy()
        jlf = jlf.map_blocks((tfs.block(jlf, "x") * tfs.dsl.constant(np.int64(3))).named("y"))
        ref = jlf.reduce_blocks(_reduce_of(tfs, jlf, "y"))
        assert s.dtype == torch.int64 and s.item() == int(np.asarray(ref)) == int((x * 3).sum())

    def test_single_block_no_combine(self):
        x = _data(rows=10, dtype=np.float64)
        lf = _lazy_chain(tft, _frame(tft, x, blocks=1))
        ex = Executor()
        r = lf.reduce_blocks(_reduce_of(tft, lf, "z"), executor=ex)
        assert not [k for k in ex.cache_keys() if k[0] == "reduce-combine"]
        np.testing.assert_allclose(r.item(), ((x * 2 + 1) * 3).sum(), rtol=1e-12)

    def test_multi_fetch_reduce_feed_order(self):
        # fetches (s, m) sort as feeds (m_input, s_input): the combine
        # must re-key partials by NAME, not position
        x = _data()
        outs = []
        for pkg in (tft, tfs):
            lf = _lazy_chain(pkg, _frame(pkg, x))
            s = pkg.dsl.reduce_sum(
                pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape((None,)), name="s_input"),
                axes=[0],
            ).named("s")
            m = pkg.dsl.reduce_max(
                pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape((None,)), name="m_input"),
                axes=[0],
            ).named("m")
            outs.append(lf.reduce_blocks([s, m], feed_dict={"s_input": "z", "m_input": "z"}))
        got, ref = outs
        z = (x * 2 + 1) * 3
        assert got["m"].item() == float(np.asarray(ref["m"])) == float(z.max())
        np.testing.assert_allclose(got["s"].item(), float(np.asarray(ref["s"])), rtol=1e-5)

    def test_shadowing_graph_output_wins(self):
        # a later stage that re-defines an existing virtual column shadows
        # it, exactly like the eager output-frame rule
        x = _data()
        for pkg in (tft, tfs):
            df = _frame(pkg, x)
            lf = _lazy(pkg, df).map_blocks((pkg.block(df, "x") * 2.0).named("y"))
            lf = lf.map_blocks((pkg.block(lf, "x") + 5.0).named("y"))
            forced = lf.force()
            np.testing.assert_array_equal(_np(forced["y"].values), x + np.float32(5.0))
            assert list(forced.columns) == ["y", "x"]

    def test_empty_blocks_skipped(self):
        x = np.arange(6.0, dtype=np.float32)
        df = tft.TensorFrame([tft.Column("x", x)], [0, 0, 3, 3, 6])
        lf = df.lazy(device=CPU).map_blocks((tft.block(df, "x") * 2.0).named("y"))
        forced = lf.force()
        np.testing.assert_array_equal(forced["y"].values.numpy(), x * 2)
        assert forced.offsets == [0, 0, 3, 3, 6]
        assert lf.reduce_blocks(_reduce_of(tft, lf, "y")).item() == 30.0

    def test_all_empty_frame_forces_typed_zero_rows(self):
        for pkg in (tft, tfs):
            df = pkg.TensorFrame.from_dict({"x": np.zeros((0, 3), np.float32)})
            lf = _lazy(pkg, df).map_blocks((pkg.block(df, "x") * 2.0).named("y"))
            forced = lf.force()
            y = _np(forced["y"].values)
            assert y.shape == (0, 3) and y.dtype == np.float32


class TestNameCollisions:
    def test_anonymous_node_uniquification(self):
        x = _data()
        df = _frame(tft, x)
        lf = df.lazy(device=CPU)
        lf = lf.map_blocks((tft.block(lf, "x") * 2.0).named("y"))
        lf = lf.map_blocks((tft.block(lf, "y") * 2.0).named("z"))
        names = [n.name for n in lf.plan().graph.nodes]
        assert len(names) == len(set(names))
        assert any(n.endswith("__f1") for n in names), names
        np.testing.assert_array_equal(lf.force()["z"].values.numpy(), x * np.float32(4.0))

    def test_explicit_same_name_stages(self):
        x = _data()
        lf = _frame(tft, x).lazy(device=CPU)
        lf = lf.map_blocks((tft.block(lf, "x") + 1.0).named("t"))
        lf2 = lf.map_blocks((tft.block(lf, "t") + 1.0).named("u"))
        np.testing.assert_array_equal(
            lf2.force()["u"].values.numpy(), (x + np.float32(1.0)) + np.float32(1.0)
        )

    def test_fused_graph_fingerprint_equals_jax(self):
        """The port's copy of `splice` builds the same fused graph."""
        x = _data()
        assert (
            _lazy_chain(tft, _frame(tft, x)).plan().fingerprint()
            == _lazy_chain(tfs, _frame(tfs, x)).plan().fingerprint()
        )


class TestSpliceTimeValidation:
    def test_dtype_mismatch_raises_at_splice(self):
        df = _frame(tft, _data())
        lf = df.lazy(device=CPU).map_blocks((tft.block(df, "x") * 2.0).named("y"))
        bad = tft.dsl.placeholder(ScalarType.float64, Shape((None,)), name="y")
        with pytest.raises(ValueError, match="dtype"):
            lf.map_blocks((bad + 1.0).named("z"))  # raises HERE, not at force

    def test_shape_mismatch_raises_at_splice(self):
        df = _frame(tft, _data())
        lf = df.lazy(device=CPU).map_blocks((tft.block(df, "x") * 2.0).named("y"))
        bad = tft.dsl.placeholder(ScalarType.float32, Shape((None, 3)), name="y")
        with pytest.raises(ValueError, match="shape|compatible"):
            lf.map_blocks((bad + 1.0).named("z"))

    def test_unknown_column_raises_at_splice(self):
        lf = _frame(tft, _data()).lazy(device=CPU)
        ph = tft.dsl.placeholder(ScalarType.float32, Shape((None,)), name="nope")
        with pytest.raises(ValueError, match="nope"):
            lf.map_blocks((ph + 1.0).named("z"))

    def test_trim_and_bindings_rejected(self):
        df = _frame(tft, _data())
        lf = df.lazy(device=CPU)
        t = (tft.block(df, "x") * 2.0).named("y")
        with pytest.raises(ValueError, match="trim"):
            lf.map_blocks(t, trim=True)
        with pytest.raises(ValueError, match="bindings"):
            lf.map_blocks(t, bindings={"x": np.zeros(3, np.float32)})

    def test_function_and_bytes_fetches_rejected_on_lazyframe(self):
        df = tft.TensorFrame.from_dict({"x": _data(4), "s": [b"a", b"b", b"c", b"d"]})
        lf = df.lazy(device=CPU)
        with pytest.raises(ValueError, match="function front-end"):
            lf.map_blocks(lambda x: {"y": x + 1.0})
        s = tft.dsl.identity(
            tft.dsl.placeholder(ScalarType.string, Shape(()), name="s")
        ).named("t")
        with pytest.raises(ValueError, match="bytes placeholders"):
            lf.map_blocks(s)

    def test_mesh_and_devices_arguments_raise(self):
        from tensorframes_tpu_torch.parallel import data_mesh

        df = _frame(tft, _data())
        lf = df.lazy(device=CPU)
        t = (tft.block(df, "x") * 2.0).named("y")
        mesh = data_mesh(devices=[CPU] * 2)
        # a lazy plan takes one placement: mesh=, devices= and device=
        # beside each other raise, as on the eager verbs
        with pytest.raises(ValueError, match="mesh= or device="):
            tft.map_blocks(t, lf, mesh=mesh, device=CPU)
        with pytest.raises(ValueError, match="mesh= or device="):
            lf.map_blocks(t, mesh=mesh, device=CPU)
        with pytest.raises(ValueError, match="devices= or device="):
            lf.map_blocks(t, devices=[CPU], device=CPU)
        lf = lf.map_blocks(t)
        with pytest.raises(ValueError, match="mutually exclusive"):
            lf.force(mesh=mesh, devices=[CPU])
        with pytest.raises(ValueError, match="mesh= or device="):
            lf.reduce_blocks(_reduce_of(tft, lf, "y"), mesh=mesh, device=CPU)
        with pytest.raises(ValueError, match="ambiguous"):
            lf.reduce_blocks(_reduce_of(tft, lf, "y"), devices=[])

    def test_no_card_means_no_silent_cpu_run(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device: device=None is valid there")
        df = _frame(tft, _data())
        lf = df.lazy().map_blocks((tft.block(df, "x") * 2.0).named("y"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lf.force()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lf.reduce_blocks(_reduce_of(tft, lf, "y"))


# ---------------------------------------------------------------------------
# terminal actions
# ---------------------------------------------------------------------------


class TestTerminalForcing:
    def test_reduce_rows_forces(self):
        x = _data()
        outs = []
        for pkg in (tft, tfs):
            lf = _lazy_chain(pkg, _frame(pkg, x))
            z1 = pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape(()), name="z_1")
            z2 = pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape(()), name="z_2")
            outs.append(pkg.reduce_rows((z1 + z2).named("z"), lf, **_kw(pkg)))
        np.testing.assert_allclose(outs[0].item(), float(np.asarray(outs[1])), rtol=1e-5)

    def test_aggregate_forces(self):
        k = np.array([0, 0, 1, 1, 2, 2], dtype=np.int64)
        x = np.arange(6, dtype=np.float32)
        outs = []
        for pkg in (tft, tfs):
            df = pkg.TensorFrame.from_dict({"k": k, "x": x}, num_blocks=2)
            lf = _lazy(pkg, df).map_blocks((pkg.block(df, "x") * 10.0).named("v"))
            outs.append(pkg.aggregate(_reduce_of(pkg, lf, "v"), lf.group_by("k"), **_kw(pkg)))
        got, ref = outs
        np.testing.assert_array_equal(got.host_values("k"), np.asarray(ref.host_values("k")))
        np.testing.assert_array_equal(got.host_values("v"), np.asarray(ref.host_values("v")))
        np.testing.assert_array_equal(got.host_values("v"), [10.0, 50.0, 90.0])

    def test_host_values_collect_to_pandas(self):
        x = _data()
        lf = _lazy_chain(tft, _frame(tft, x))
        ref = _lazy_chain(tfs, _frame(tfs, x))
        np.testing.assert_array_equal(lf.host_values("z"), np.asarray(ref.host_values("z")))
        rows = lf.collect()
        assert len(rows) == 24 and float(rows[3]["z"]) == float(np.asarray(ref.host_values("z"))[3])
        pdf = lf.to_pandas()
        np.testing.assert_array_equal(pdf["z"].to_numpy(), np.asarray(ref.host_values("z")))
        np.testing.assert_array_equal(lf["z"].values.numpy(), lf.column("z").values.numpy())
        assert lf.to_host()["z"].device is None

    def test_force_is_cached(self):
        lf = _lazy_chain(tft, _frame(tft, _data()))
        assert lf.force() is lf.force()
        assert lf.force(executor=Executor()) is not lf.force()

    def test_collect_async(self):
        x = _data()
        lf = _lazy_chain(tft, _frame(tft, x))
        rows = lf.collect_async().result(timeout=60)
        assert [float(r["z"]) for r in rows] == [float(v) for v in lf.host_values("z")]

    def test_module_level_verbs_route_lazyframe(self):
        x = _data()
        lf = _frame(tft, x).lazy(device=CPU)
        lf = tft.map_blocks((tft.block(lf, "x") * 2.0).named("y"), lf)
        assert isinstance(lf, LazyFrame)
        r = tft.reduce_blocks(_reduce_of(tft, lf, "y"), lf)
        np.testing.assert_allclose(r.item(), float((x * 2).sum()), rtol=1e-5)
        xr = tft.dsl.placeholder(ScalarType.float32, Shape(()), name="y")
        m = tft.map_rows((xr + 1.0).named("w"), lf, device=CPU)
        assert isinstance(m, tft.TensorFrame)
        np.testing.assert_array_equal(m.host_values("w"), x * np.float32(2.0) + np.float32(1.0))

    def test_non_terminal_frame_ops(self):
        x = _data()
        lf = _lazy_chain(tft, _frame(tft, x))
        moved = lf.to_device(CPU)
        assert isinstance(moved, LazyFrame) and moved._base["x"].device == torch.device(CPU)
        rep = lf.repartition(6)
        assert rep.num_blocks == 6 and rep.nrows == 24
        np.testing.assert_array_equal(rep.host_values("z"), lf.host_values("z"))
        assert lf.analyze().columns == lf.columns


# ---------------------------------------------------------------------------
# executor cache keying
# ---------------------------------------------------------------------------


class TestCacheKeying:
    def test_one_block_program_vs_eager_n(self):
        df = _frame(tft, _data(rows=4000), blocks=4)
        exf, exe = Executor(), Executor()
        lf = _lazy_chain(tft, df, executor=exf)
        fused = lf.reduce_blocks(_reduce_of(tft, lf, "z"), executor=exf)
        m = _eager_chain(tft, df, executor=exe)
        eager = tft.reduce_blocks(_reduce_of(tft, m, "z"), m, executor=exe, device=CPU)
        fused_kinds = Counter(k[0] for k in exf.cache_keys())
        eager_kinds = Counter(k[0] for k in exe.cache_keys())
        # the whole 3-verb pipeline is ONE per-block callable, plus the
        # combine's plain reduce graph; eager lowered one per verb
        assert fused_kinds == Counter({"block": 1, "reduce-combine": 1})
        assert eager_kinds == Counter({"block": 3})
        assert torch.equal(fused, eager)

    def test_fused_fingerprint_second_run_zero_misses(self):
        df = _frame(tft, _data())
        ex = Executor()

        def run():
            lf = _lazy_chain(tft, df, executor=ex)
            return lf.reduce_blocks(_reduce_of(tft, lf, "z"), executor=ex)

        r1 = run()
        misses = ex.cache_misses
        r2 = run()  # freshly spliced graph, identical fused fingerprint
        assert ex.cache_misses == misses
        assert torch.equal(r1, r2)


# ---------------------------------------------------------------------------
# lazy mode, explain, plan
# ---------------------------------------------------------------------------


class TestLazyModeAndPlan:
    def test_context_manager_defers_and_restores(self):
        df = _frame(tft, _data())
        assert not lazy_active()
        with tft.lazy():
            assert lazy_active()
            out = tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU)
            assert isinstance(out, LazyFrame)
        assert not lazy_active()
        eager = tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device=CPU)
        assert isinstance(eager, tft.TensorFrame)
        assert torch.equal(out.force()["y"].values, eager["y"].values)

    def test_function_frontend_stays_eager_under_mode(self):
        df = _frame(tft, _data())
        with tft.lazy():
            out = tft.map_blocks(lambda x: {"y": x + 1.0}, df, device=CPU)
        assert isinstance(out, tft.TensorFrame)

    def test_trim_and_bindings_stay_eager_under_mode(self):
        df = _frame(tft, _data())
        with tft.lazy():
            t = tft.map_blocks(
                tft.dsl.reduce_sum(tft.block(df, "x"), axes=[0], keep_dims=True).named("s"),
                df, trim=True, device=CPU,
            )
            ph = tft.dsl.placeholder(ScalarType.float32, Shape(()), name="a")
            b = tft.map_blocks(
                (tft.block(df, "x") * ph).named("y"), df, bindings={"a": np.float32(2.0)},
                device=CPU,
            )
        assert isinstance(t, tft.TensorFrame) and isinstance(b, tft.TensorFrame)

    def test_bytes_passthrough_stays_eager_under_mode(self):
        df = tft.TensorFrame.from_dict(
            {"x": np.arange(4, dtype=np.float32), "s": [b"a", b"b", b"c", b"d"]}
        )
        y = (tft.block(df, "x") + 1.0).named("y")
        s = tft.dsl.identity(
            tft.dsl.placeholder(ScalarType.string, Shape(()), name="s")
        ).named("t")
        with tft.lazy():
            out = tft.map_blocks([y, s], df, device=CPU)
        assert isinstance(out, tft.TensorFrame)
        np.testing.assert_array_equal(out["y"].values.numpy(), np.arange(4, dtype=np.float32) + 1)
        assert list(out["t"].rows())[0] == b"a"

    def test_pandas_in_gives_pandas_out_under_mode(self):
        import pandas as pd

        pdf = pd.DataFrame({"x": np.arange(5.0)})
        with tft.lazy():
            out = tft.map_blocks(
                (tft.block(pdf, "x") + 1.0).named("y"), pdf, device=CPU
            )
        assert isinstance(out, pd.DataFrame)
        np.testing.assert_array_equal(out["y"].to_numpy(), np.arange(5.0) + 1)

    def test_library_collision_refuses_to_fuse(self):
        # two stages carrying the same function NAME with different bodies
        # must refuse to splice, not silently pick one
        from tensorframes_tpu_torch.graph.fuse import splice
        from tensorframes_tpu_torch.graph.ir import Graph, GraphNode
        from tensorframes_tpu_torch.proto.graphdef import ArgDef, AttrValue, FunctionDef

        def lib_graph(mul_by):
            g = Graph([
                GraphNode("p", "Placeholder", [], {
                    "dtype": AttrValue.of_type(ScalarType.float32),
                    "shape": AttrValue.of_shape(Shape((None,))),
                })
            ])
            g.library = {
                "f": FunctionDef(
                    name="f",
                    input_args=[ArgDef("a", ScalarType.float32)],
                    output_args=[ArgDef("o", ScalarType.float32)],
                    nodes=[GraphNode(f"mul{mul_by}", "Mul", ["a", "a"]).to_node_def()],
                    ret={"o": f"mul{mul_by}:z:0"},
                )
            }
            return g

        with pytest.raises(ValueError, match="collision"):
            splice(lib_graph(2), lib_graph(3), {}, ["p"])
        fused, fetches, rename = splice(lib_graph(2), lib_graph(2), {}, ["p"])
        assert set(fused.library) == {"f"} and fetches == ["p__f1"]

    def test_explain_renders_stage_provenance(self):
        x = _data()
        lf = _lazy_chain(tft, _frame(tft, x))
        text = tft.explain(lf)
        assert "stage 1: map_blocks -> [y]" in text
        assert "stage 2: map_blocks -> [z]" in text
        assert "feed: x <- column 'x'" in text
        assert text == tfs.explain(_lazy_chain(tfs, _frame(tfs, x)))
        plan = tft.explain_detailed(lf)
        assert isinstance(plan, LazyPlan)
        assert [s.outputs for s in plan.stages] == [("y",), ("z",)]
        assert plan.feeds == {"x": "x"}
        assert set(plan.sources) == {"y", "z"}
        assert "LazyPlan(2 stages" in tft.explain(plan)

    def test_virtual_schema_matches_forced_schema(self):
        lf = _lazy_chain(tft, _frame(tft, _data()))
        forced = lf.force()
        assert lf.columns == forced.columns
        assert [c.dtype for c in lf.info] == [c.dtype for c in forced.info]
        assert [c.cell_shape for c in lf.info] == [c.cell_shape for c in forced.info]


# ---------------------------------------------------------------------------
# the plan-prep pipeline
# ---------------------------------------------------------------------------


class _FailingExecutor(Executor):
    """An executor whose block callable raises on its ``fail_at``-th call."""

    def __init__(self, fail_at):
        super().__init__()
        self.fail_at = fail_at
        self.calls = 0

    def callable_for(self, graph, fetches, feed_names, device):
        fn = super().callable_for(graph, fetches, feed_names, device)

        def run(*feeds):
            self.calls += 1
            if self.calls == self.fail_at:
                raise RuntimeError("dispatch failed")
            return fn(*feeds)

        return run


class TestPlanPipeline:
    @pytest.mark.parametrize("device_resident", [False, True])
    def test_pipeline_on_off_bitwise_equal(self, device_resident):
        x = _data(rows=4096)
        w = _data(rows=4096, seed=1)
        df = tft.TensorFrame.from_dict({"x": x, "w": w}, num_blocks=8)
        if device_resident:
            df = df.to_device(CPU)
        results = {}
        for on in (True, False):
            ttele.reset()
            with tconfig.override(plan_pipeline=on, plan_pipeline_depth=3):
                lf = df.lazy(device=CPU)
                lf = lf.map_blocks((tft.block(lf, "x") * tft.block(lf, "w") + 1.0).named("y"))
                results[on] = lf.force()["y"].values
            prep = ttele.flat_counters().get("ingest_chunks{stage=plan-prep}", 0.0)
            assert prep == (8.0 if on else 0.0)
        assert torch.equal(results[True], results[False])
        np.testing.assert_array_equal(results[True].numpy(), x * w + np.float32(1.0))
        assert tprof.stats().get("lazy.force.transfer_fallback", 0.0) == 0.0

    def test_consumer_error_closes_prep_stage(self):
        df = _frame(tft, _data(rows=8000), blocks=8)
        ex = _FailingExecutor(fail_at=2)
        lf = _lazy_chain(tft, df, executor=ex)
        with tconfig.override(plan_pipeline=True):
            with pytest.raises(RuntimeError, match="dispatch failed"):
                lf.force()
        deadline = time.time() + 10.0
        while _ingest_threads() and time.time() < deadline:
            time.sleep(0.01)
        assert not _ingest_threads()
        assert ex.calls == 2

    def test_deadline_cuts_a_pipelined_force(self):
        df = _frame(tft, _data(rows=8000), blocks=8)
        lf = _lazy_chain(tft, df)
        with tconfig.override(plan_pipeline=True):
            with pytest.raises(tft.DeadlineExceeded):
                lf.force(timeout_s=0.0)
        deadline = time.time() + 10.0
        while _ingest_threads() and time.time() < deadline:
            time.sleep(0.01)
        assert not _ingest_threads()


# ---------------------------------------------------------------------------
# LazyFrame chunks in the streaming reduce
# ---------------------------------------------------------------------------


class TestStreamingFusedChunks:
    @staticmethod
    def _chunks(pkg, lazy_mode, parts):
        for x in parts:
            df = pkg.TensorFrame.from_dict({"x": x}, num_blocks=2)
            if lazy_mode:
                yield _lazy(pkg, df).map_blocks((pkg.block(df, "x") * 2.0).named("y"))
            else:
                yield pkg.map_blocks((pkg.block(df, "x") * 2.0).named("y"), df, **_kw(pkg))

    @staticmethod
    def _fetch(pkg):
        ph = pkg.dsl.placeholder(pkg.ScalarType.float32, pkg.Shape((None,)), name="y_input")
        return pkg.dsl.reduce_sum(ph, axes=[0]).named("y")

    @pytest.mark.parametrize("ingest_pipeline", [True, False])
    def test_stream_of_lazy_chunks_matches_eager_and_jax(self, ingest_pipeline):
        rng = np.random.default_rng(3)
        parts = [rng.standard_normal(10 + i).astype(np.float32) for i in range(5)]
        with tconfig.override(ingest_pipeline=ingest_pipeline):
            r_lazy = tft.reduce_blocks_stream(
                self._fetch(tft), self._chunks(tft, True, parts), device=CPU
            )
            r_eager = tft.reduce_blocks_stream(
                self._fetch(tft), self._chunks(tft, False, parts), device=CPU
            )
        r_jax = tfs.reduce_blocks_stream(self._fetch(tfs), self._chunks(tfs, True, parts))
        assert torch.equal(r_lazy, r_eager)
        np.testing.assert_allclose(r_lazy.item(), float(np.asarray(r_jax)), rtol=1e-5)
        assert tprof.stats()["reduce_blocks_stream.chunks"] == 10.0
