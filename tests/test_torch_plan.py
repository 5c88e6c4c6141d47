"""PyTorch port: relational verbs and the cost-based plan optimizer
(`graph/plan.py`, `graph/optimizer.py`, `api.scan`, `Dataset.decode`'s
row-group pushdown), held to the JAX package on the CPU.

Mirrors `tests/test_plan.py`. `filter` / `select` / `sort_by` /
`group_by(...).agg(...)` / `join` compose lazily into a plan DAG that
`graph.optimizer` rewrites; every rewrite is priced and kept only when the
modeled cost strictly drops. The port's results equal the JAX package's
`RelationalFrame` results and pandas' on the same seeded inputs: row sets
and row orders exactly, float64 aggregates rtol 1e-12. The optimizer's
decision records (rule, verdict, both prices, detail) equal JAX's for the
same plan, with JAX's cost model reset first so both price with the
cold-start throughput.

Not ported yet, so not tested here: the GlobalFrame lowering and its
counted fallbacks (ROADMAP Queue 1 item 12), the materialization cache,
`explain_analyze`, the diagnostics section and the planner-throughput
rollup (item 11).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import plan as jplan
from tensorframes_tpu.runtime import costmodel as jcost
from tensorframes_tpu.utils import telemetry as jtele
from tensorframes_tpu_torch import col
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch.graph import plan as tplan
from tensorframes_tpu_torch.lazy import RelationalFrame
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
F64_RTOL = 1e-12

pytest.importorskip("pyarrow")


@pytest.fixture(autouse=True)
def _reset_port_state():
    tplan.reset_state()
    yield
    ttele.reset()
    tprof.reset_stats()
    tplan.reset_state()


def _data(rows=600, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": np.arange(rows, dtype=np.float64),
        "y": np.arange(rows, dtype=np.float64) % 3,
        "w": rng.standard_normal(rows),
    }


def _frame(pkg, rows=600, blocks=4, seed=0):
    return pkg.TensorFrame.from_dict(_data(rows, seed), num_blocks=blocks)


def _lazy(pkg, df):
    return df.lazy(device=CPU) if pkg is tft else df.lazy()


def _force(pkg, rel):
    return rel.force(device=CPU) if pkg is tft else rel.force()


def _scan(pkg, path):
    return tft.scan(path, device=CPU) if pkg is tft else tfs.scan(path)


def _pdf(frame):
    """A forced frame of either package as pandas, float columns exact."""
    return frame.to_pandas().reset_index(drop=True)


def _write_shards(root, shards=1, groups=10, group_rows=1000, fmt="parquet", seed=0):
    """Shards of ``groups`` row groups each, x ascending across the whole
    dataset, so row-group min/max stats genuinely prune a selective
    x-predicate. Written by the port."""
    rng = np.random.default_rng(seed)
    for i in range(shards):
        lo = i * groups * group_rows
        x = np.arange(lo, lo + groups * group_rows, dtype=np.float64)
        df = tft.TensorFrame.from_dict(
            {"x": x, "y": np.floor(rng.random(len(x)) * 4.0), "w": rng.random(len(x))},
            num_blocks=groups,
        )
        ext = "parquet" if fmt == "parquet" else "arrow"
        (tio.write_parquet if fmt == "parquet" else tio.write_arrow_ipc)(
            df, os.path.join(root, f"shard-{i:03d}.{ext}")
        )
    return root


def _double_x(pkg):
    ph = pkg.dsl.placeholder(pkg.ScalarType.float64, pkg.Shape((None,)), name="x")
    return (ph * 2.0).named("z")


def _inc_z(pkg):
    ph = pkg.dsl.placeholder(pkg.ScalarType.float64, pkg.Shape((None,)), name="z")
    return (ph + 1.0).named("w2")


def _both(build):
    """``build(pkg)`` forced by each package: (port frame, JAX frame)."""
    return _force(tft, build(tft)), _force(tfs, build(tfs))


def _decisions(pkg, rel):
    if pkg is tfs:
        jcost.reset()  # price with the cold-start throughput, as the port does
    _, decisions = rel.optimize()
    return [
        (d["rule"], d["accepted"], d["cost_before_s"], d["cost_after_s"], d["detail"])
        for d in decisions
    ]


def _assert_same_decisions(build):
    port, ref = _decisions(tft, build(tft)), _decisions(tfs, build(tfs))
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# verb correctness vs JAX and pandas
# ---------------------------------------------------------------------------


class TestVerbCorrectness:
    def test_filter_matches_jax_and_pandas(self):
        got, ref = _both(
            lambda pkg: _lazy(pkg, _frame(pkg)).filter(
                (pkg.col("x") > 100.0) & ~(pkg.col("y") == 1.0)
            )
        )
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))
        src = _frame(tft).to_pandas()
        exp = src[(src.x > 100.0) & ~(src.y == 1.0)].reset_index(drop=True)
        pd.testing.assert_frame_equal(_pdf(got)[exp.columns.tolist()], exp)
        assert got.num_blocks == ref.num_blocks

    def test_filter_or_and_column_comparison(self):
        got, ref = _both(
            lambda pkg: _lazy(pkg, _frame(pkg)).filter(
                (pkg.col("w") > pkg.col("y")) | (pkg.col("x") <= 10.0)
            )
        )
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))

    def test_filter_over_device_columns_counts_d2h_bytes(self):
        df = _frame(tft).to_device(CPU)
        out = df.filter(col("x") >= 300.0).force(device=CPU)
        assert out.nrows == 300
        _, _, hists = ttele.metrics_snapshot()
        # (name, labels) -> (buckets, counts, sum, count)
        d2h = [v for (name, _), v in hists.items() if name == "d2h_bytes"]
        assert d2h and sum(h[2] for h in d2h) == 3 * 600 * 8
        # every device column crossed once, as `Column.host_values` counts
        assert tprof.stats()["host_sync"] == 3.0

    def test_filter_rejects_python_bool_combination(self):
        with pytest.raises(TypeError, match="combine predicates"):
            bool(col("x") > 1.0)
        with pytest.raises(TypeError, match="predicate"):
            _frame(tft).filter(lambda r: r)

    def test_select_narrows_columns(self):
        got, ref = _both(lambda pkg: _lazy(pkg, _frame(pkg)).select(["y"]))
        assert got.columns == list(ref.columns) == ["y"]

    @pytest.mark.parametrize("descending", [False, True])
    def test_sort_by_matches_jax_and_pandas(self, descending):
        got, ref = _both(
            lambda pkg: _lazy(pkg, _frame(pkg, rows=97, blocks=3)).sort_by(
                "y", "x", descending=descending
            )
        )
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))
        exp = (
            _frame(tft, rows=97).to_pandas()
            .sort_values(["y", "x"], ascending=not descending)
            .reset_index(drop=True)
        )
        pd.testing.assert_frame_equal(_pdf(got)[exp.columns.tolist()], exp)

    def test_sort_with_ties_keeps_jax_row_order(self):
        got, ref = _both(lambda pkg: _lazy(pkg, _frame(pkg, rows=50)).sort_by("y"))
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))

    def test_groupby_agg_matches_jax_and_pandas(self):
        got, ref = _both(
            lambda pkg: _lazy(pkg, _frame(pkg))
            .select(["x", "y", "w"])
            .group_by("y")
            .agg(x_sum=("sum", "x"), x_max=("max", "x"), w_mean=("mean", "w"), w_min=("min", "w"))
        )
        g, r = _pdf(got), _pdf(ref)
        assert list(g.columns) == list(r.columns)
        np.testing.assert_array_equal(g["y"], r["y"])
        for c in ("x_max", "w_min"):
            np.testing.assert_array_equal(g[c], r[c])
        for c in ("x_sum", "w_mean"):
            np.testing.assert_allclose(g[c], r[c], rtol=F64_RTOL)
        exp = _frame(tft).to_pandas().groupby("y", as_index=False).agg(
            x_sum=("x", "sum"), w_mean=("w", "mean")
        )
        np.testing.assert_allclose(g["w_mean"], exp["w_mean"], rtol=F64_RTOL)
        np.testing.assert_array_equal(g["x_sum"], exp["x_sum"])

    def test_agg_rejects_unknown_op_and_bad_specs(self):
        with pytest.raises(ValueError, match="agg"):
            _frame(tft).lazy(device=CPU).group_by("y").agg(bad=("median", "x"))
        rel = _frame(tft).lazy(device=CPU).select(["x", "y"])
        with pytest.raises(ValueError, match="agg"):
            rel.group_by("y").agg(bad=("median", "x"))
        with pytest.raises(TypeError, match="pair"):
            rel.group_by("y").agg(bad="x")
        with pytest.raises(ValueError, match="at least one"):
            rel.group_by("y").agg()
        with pytest.raises(TypeError, match="column names"):
            rel.group_by(0)

    def test_join_inner_equi_key(self):
        def build(pkg):
            right = pkg.TensorFrame.from_dict(
                {"y": np.array([2.0, 0.0, 1.0, 0.0]), "label": np.array([10.0, 20.0, 30.0, 40.0])}
            )
            return _lazy(pkg, _frame(pkg, rows=60, blocks=2)).join(_lazy(pkg, right), on="y")

        got, ref = _both(build)
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))
        left = _frame(tft, rows=60).to_pandas()
        right = pd.DataFrame({"y": [2.0, 0.0, 1.0, 0.0], "label": [10.0, 20.0, 30.0, 40.0]})
        exp = left.merge(right, on="y", how="inner")
        assert len(got.to_pandas()) == len(exp)
        g = _pdf(got).sort_values(["x", "label"]).reset_index(drop=True)
        e = exp.sort_values(["x", "label"]).reset_index(drop=True)
        pd.testing.assert_frame_equal(g[e.columns.tolist()], e)

    def test_join_name_collision_gets_right_suffix(self):
        def build(pkg):
            right = pkg.TensorFrame.from_dict({"y": np.arange(3.0), "w": np.arange(3.0) * 7})
            return _frame(pkg, rows=12, blocks=2).join(right, on="y")

        got = build(tft).force(device=CPU)
        ref = build(tfs).force()
        assert got.columns == list(ref.columns) == ["x", "y", "w", "w_right"]
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))

    def test_join_rejects_non_inner(self):
        with pytest.raises(ValueError, match="inner"):
            _frame(tft).lazy(device=CPU).join(_frame(tft).lazy(device=CPU), on="y", how="left")

    def test_chain_filter_map_groupby(self):
        got, ref = _both(
            lambda pkg: _lazy(pkg, _frame(pkg))
            .filter(pkg.col("x") > 99.0)
            .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
            .group_by("y")
            .agg(z_sum=("sum", "z"))
        )
        g, r = _pdf(got), _pdf(ref)
        np.testing.assert_array_equal(g["y"], r["y"])
        np.testing.assert_allclose(g["z_sum"], r["z_sum"], rtol=F64_RTOL)
        src = _frame(tft).to_pandas()
        exp = src[src.x > 99.0].assign(z=lambda d: d.x * 2.0)
        exp = exp.groupby("y", as_index=False).agg(z_sum=("z", "sum"))
        np.testing.assert_array_equal(g["z_sum"], exp["z_sum"])

    def test_traced_function_map_raises_helpfully(self):
        rel = _frame(tft).lazy(device=CPU).filter(col("x") > 0.0)
        with pytest.raises(TypeError, match="dsl"):
            rel.map_blocks(lambda x: {"z": x * 2.0})

    def test_force_is_memoized_and_counted(self):
        rel = _frame(tft).lazy(device=CPU).filter(col("x") > 10.0)
        assert rel.force() is rel.force()
        st = tplan.state()
        assert st["forces"] == 1 and st["executed_nodes"] == 2
        assert len(rel.collect()) == 589

    def test_no_card_means_no_silent_cpu_run(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device: device=None is valid there")
        path = _write_shards(str(tmp_path), groups=2, group_rows=10)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.scan(path).force()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _frame(tft).filter(col("x") > 1.0).force()


# ---------------------------------------------------------------------------
# optimizer rewrites, priced like the JAX package's
# ---------------------------------------------------------------------------


def _scan_chain(pkg, path, cutoff, sel):
    return (
        _scan(pkg, path)
        .filter(pkg.col("x") > cutoff, selectivity=sel)
        .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
        .group_by("y")
        .agg(z_sum=("sum", "z"), z_max=("max", "z"))
    )


class TestOptimizerRewrites:
    def test_pushdown_and_prune_into_scan(self, tmp_path):
        path = _write_shards(str(tmp_path))
        decisions = _assert_same_decisions(lambda pkg: _scan_chain(pkg, path, 9000.0, 0.1))
        accepted = {d[0] for d in decisions if d[1]}
        assert {"pushdown_into_scan", "prune_columns"} <= accepted, decisions
        node, _ = _scan_chain(tft, path, 9000.0, 0.1).optimize()
        leaf = node
        while leaf.inputs:
            leaf = leaf.inputs[0]
        assert leaf.op == "scan"
        assert leaf.payload["predicate"] is not None
        assert set(leaf.payload["columns"]) == {"x", "y"}

    @pytest.mark.parametrize("shards", [1, 4])
    def test_pushdown_proven_by_decode_counters(self, tmp_path, shards):
        """Rows decoded = rows surviving the filter, NOT the dataset's row
        count: the pushdown decodes less, it does not mask more."""
        groups, group_rows = 10, 1000
        total = shards * groups * group_rows
        path = _write_shards(str(tmp_path), shards=shards, groups=groups, group_rows=group_rows)
        cutoff = total * 0.9 + 250.0  # inside one row group
        survivors = int(total - cutoff - 1)
        ttele.reset()
        res = _force(tft, _scan_chain(tft, path, cutoff, 0.1))
        decoded = ttele.flat_counters().get("ingest_rows_decoded", 0.0)
        assert decoded == survivors <= survivors + shards * group_rows
        # every row group before the cutoff's is skipped from footer stats
        skipped = tplan.state()["pushdown_rows_skipped"]
        assert skipped == int(cutoff // group_rows) * group_rows
        assert ttele.flat_counters()["plan_pushdown_rows_skipped"] == skipped

        with tconfig.override(plan_optimizer=False):
            ttele.reset()
            off = _force(tft, _scan_chain(tft, path, cutoff, 0.1))
            assert ttele.flat_counters()["ingest_rows_decoded"] == total
        pd.testing.assert_frame_equal(_pdf(res), _pdf(off))

        jtele.reset()
        ref = _force(tfs, _scan_chain(tfs, path, cutoff, 0.1))
        assert jtele.metrics_snapshot()[0]["ingest_rows_decoded"] == decoded
        g, r = _pdf(res), _pdf(ref)
        np.testing.assert_array_equal(g["y"], r["y"])
        np.testing.assert_array_equal(g["z_max"], r["z_max"])
        np.testing.assert_allclose(g["z_sum"], r["z_sum"], rtol=F64_RTOL)
        src = pd.concat(
            [pd.read_parquet(os.path.join(path, f)) for f in sorted(os.listdir(path))]
        )
        src = src[src.x > cutoff].assign(z=lambda d: d.x * 2.0)
        exp = src.groupby("y", as_index=False).agg(z_sum=("z", "sum"), z_max=("z", "max"))
        np.testing.assert_allclose(g["z_sum"], exp["z_sum"], rtol=F64_RTOL)
        np.testing.assert_array_equal(g["z_max"], exp["z_max"])

    def test_ipc_scan_masks_without_stats(self, tmp_path):
        path = _write_shards(str(tmp_path), shards=2, groups=3, group_rows=50, fmt="ipc")
        got, ref = _both(lambda pkg: _scan(pkg, path).filter(pkg.col("x") >= 120.0, selectivity=0.2))
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))
        assert got.nrows == 180 and tplan.state()["pushdown_rows_skipped"] == 0

    def test_nonselective_pushdown_is_cost_rejected(self, tmp_path):
        """A rewrite priced as a regression is rejected AND visible in
        `explain`: at selectivity 1.0 the pushdown saves nothing and still
        pays the arrow-boundary filter pass."""
        path = _write_shards(str(tmp_path), groups=4, group_rows=250)
        decisions = _assert_same_decisions(
            lambda pkg: _scan(pkg, path).filter(pkg.col("x") > -1.0, selectivity=1.0)
        )
        rel = _scan(tft, path).filter(col("x") > -1.0, selectivity=1.0)
        txt = tft.explain(rel)
        assert "REJECTED (regression)" in txt, txt
        d = next(d for d in decisions if d[0] == "pushdown_into_scan")
        assert not d[1] and d[3] >= d[2] * (1 - 1e-9)
        assert tplan.state()["rejected"].get("pushdown_into_scan") == 2
        assert "plan_rewrites{rule=pushdown_into_scan}" not in ttele.flat_counters()

    def test_filter_reorders_below_independent_map(self):
        decisions = _assert_same_decisions(
            lambda pkg: _lazy(pkg, _frame(pkg))
            .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
            .filter(pkg.col("x") > 100.0)
        )
        assert ("filter_below_map", True) in [d[:2] for d in decisions]
        rel = (
            _frame(tft).lazy(device=CPU)
            .map_blocks(_double_x(tft), feed_dict={"x": "x"})
            .filter(col("x") > 100.0)
        )
        node, _ = rel.optimize()
        assert node.op == "map" and node.inputs[0].op == "filter"
        got, ref = _both(
            lambda pkg: _lazy(pkg, _frame(pkg))
            .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
            .filter(pkg.col("x") > 100.0)
        )
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))

    def test_filter_on_map_output_does_not_reorder(self):
        rel = (
            _frame(tft).lazy(device=CPU)
            .map_blocks(_double_x(tft), feed_dict={"x": "x"})
            .filter(col("z") > 100.0)  # depends on the map's output
        )
        node, _ = rel.optimize()
        assert node.op == "filter" and node.inputs[0].op == "map"
        got = rel.force().to_pandas()
        assert (got["z"] > 100.0).all() and len(got) == 549

    def test_adjacent_relational_maps_fuse(self):
        def build(pkg):
            return (
                _lazy(pkg, _frame(pkg))
                .filter(pkg.col("x") > 100.0)
                .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
                .map_blocks(_inc_z(pkg), feed_dict={"z": "z"})
            )

        decisions = _assert_same_decisions(build)
        assert ("fuse_maps", True) in [d[:2] for d in decisions]
        node, _ = build(tft).optimize()
        assert node.op == "map" and len(node.payload["stages"]) == 2
        got, ref = _both(build)
        pd.testing.assert_frame_equal(_pdf(got), _pdf(ref))
        src = _frame(tft).to_pandas()
        src = src[src.x > 100.0]
        np.testing.assert_array_equal(got.host_values("w2"), (src.x * 2.0 + 1.0).to_numpy())

    def test_common_subplan_dedup_executes_once(self):
        df = _frame(tft, rows=120, blocks=2)
        a = df.lazy(device=CPU).filter(col("x") > 60.0).select(["x", "y"])
        b = df.lazy(device=CPU).filter(col("x") > 60.0).select(["x", "y"])
        j = a.join(b, on=["x", "y"])
        node, decisions = j.optimize()
        assert any(d["rule"] == "dedup" and d["accepted"] for d in decisions)
        assert node.inputs[0] is node.inputs[1]  # the SAME object
        tplan.reset_state()
        out = j.force()
        # 4 unique nodes run (source, filter, select, join), not 7
        assert tplan.state()["executed_nodes"] == 4
        assert out.nrows == len(df.to_pandas().query("x > 60.0"))

    def test_optimizer_off_is_identity(self):
        rel = (
            _frame(tft).lazy(device=CPU)
            .map_blocks(_double_x(tft), feed_dict={"x": "x"})
            .filter(col("x") > 100.0)
        )
        with tconfig.override(plan_optimizer=False):
            node, decisions = rel.optimize()
            out = rel.force()
        assert decisions == [] and node is rel._node
        assert tplan.state()["optimize_runs"] == 0
        with tconfig.override(plan_optimizer=False):
            _, ref = _both(
                lambda pkg: _lazy(pkg, _frame(pkg))
                .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
                .filter(pkg.col("x") > 100.0)
            )
        pd.testing.assert_frame_equal(_pdf(out), _pdf(ref))

    def test_selectivity_hint_validated_and_default_knob_prices(self):
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            _frame(tft).filter(col("x") > 1.0, selectivity=1.5)
        with tconfig.override(plan_selectivity_default=0.25):
            from tensorframes_tpu_torch.graph.optimizer import Estimator

            rel = _frame(tft).filter(col("x") > 1.0)
            rows, _ = Estimator().shape(rel._node)
        assert rows == 150.0


# ---------------------------------------------------------------------------
# canonical fingerprints and explain
# ---------------------------------------------------------------------------


class TestPlanFingerprint:
    def test_commutative_predicates_share_fingerprint(self):
        df = _frame(tft)
        a = df.lazy(device=CPU).filter((col("x") > 10.0) & (col("y") < 2.0))
        b = df.lazy(device=CPU).filter((col("y") < 2.0) & (col("x") > 10.0))
        fa = tplan.plan_fingerprint(a.optimize()[0])
        assert fa == tplan.plan_fingerprint(b.optimize()[0])
        jdf = _frame(tfs)
        ja = jdf.lazy().filter((tfs.col("x") > 10.0) & (tfs.col("y") < 2.0))
        assert fa == jplan.plan_fingerprint(ja.optimize()[0])

    def test_pre_and_post_rewrite_converge(self, tmp_path):
        path = _write_shards(str(tmp_path), groups=4, group_rows=250)
        fp1 = tft.scan(path, device=CPU).filter(col("x") > 500.0, selectivity=0.2).plan().fingerprint()
        fp2 = tft.scan(path, device=CPU).filter(col("x") > 500.0, selectivity=0.2).plan().fingerprint()
        assert fp1 == fp2
        jcost.reset()
        assert fp1 == tfs.scan(path).filter(tfs.col("x") > 500.0, selectivity=0.2).plan().fingerprint()

    def test_map_plan_fingerprint_equals_jax(self):
        fps = []
        for pkg in (tft, tfs):
            rel = _lazy(pkg, _frame(pkg)).map_blocks(_double_x(pkg), feed_dict={"x": "x"})
            fps.append(rel.plan().fingerprint())
        assert fps[0] == fps[1]


class TestExplain:
    def test_explain_never_executes_and_equals_jax(self, tmp_path):
        path = _write_shards(str(tmp_path), groups=4, group_rows=250)

        def build(pkg):
            return (
                _scan(pkg, path)
                .filter(pkg.col("x") > 500.0, selectivity=0.2)
                .map_blocks(_double_x(pkg), feed_dict={"x": "x"})
            )

        txt = tft.explain(build(tft))
        assert "pre-optimization" in txt and "optimized plan" in txt
        assert "est" in txt and "ms" in txt  # per-node costed estimates
        assert tplan.state()["executed_nodes"] == 0
        assert "ingest_rows_decoded" not in ttele.flat_counters()
        jcost.reset()
        assert txt == tfs.explain(build(tfs))

    def test_explain_on_lazyplan_handle(self):
        p = _frame(tft).lazy(device=CPU).filter(col("x") > 10.0).plan()
        assert p.fingerprint()
        assert "filter" in tft.explain(p)
        assert "RelationalFrame<" in repr(RelationalFrame(p.relational))
