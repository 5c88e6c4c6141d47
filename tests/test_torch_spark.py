"""PyTorch port: the Spark adapter (`spark.py`), held to the JAX package's
`tensorframes_tpu.spark` on the CPU.

Mirrors `tests/test_spark_bridge.py::TestSparkAdapterPyarrowOnly`. Neither
this machine nor the card's has pyspark, so the DataFrame is the in-repo
shim `tests/_minispark.py` (``mapInArrow`` over real pyarrow record
batches, ``collect``). The same fake DataFrame goes through both
packages' one-call verbs: float64 results rtol 1e-12, keys, maps and
integer results exact, and the per-call ingest directory is gone
afterwards. The port runs with ``device="cpu"``.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")

import tensorframes_tpu as tfs  # noqa: E402
import tensorframes_tpu.spark as jspark  # noqa: E402
import tensorframes_tpu_torch as tft  # noqa: E402
import tensorframes_tpu_torch.spark as tspark  # noqa: E402
from _minispark import MiniDataFrame  # noqa: E402
from tensorframes_tpu_torch.utils import profiling as tprof  # noqa: E402
from tensorframes_tpu_torch.utils import telemetry as ttele  # noqa: E402

CPU = "cpu"
F64_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    ttele.reset()
    tprof.reset_stats()


def _fake_df(col_parts):
    return MiniDataFrame(
        [[pa.RecordBatch.from_pydict(dict(part))] for part in col_parts]
    )


def _sum_graph(pkg, col="x"):
    probe = pkg.TensorFrame.from_dict({col: np.zeros(4)})
    return pkg.dsl.reduce_sum(pkg.block(probe, col, tf_name=f"{col}_input"), axes=[0]).named(col)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _both(verb, fetches_of, fake, tmp_path, **kw):
    """``verb`` of each package over the same fake DataFrame, each into an
    ingest dir of its own that must be empty afterwards."""
    outs = []
    for pkg, mod, extra in ((tft, tspark, {"device": CPU}), (tfs, jspark, {})):
        d = str(tmp_path / f"ingest-{pkg.__name__}")
        outs.append(getattr(mod, verb)(fetches_of(pkg), fake, ingest_dir=d, **kw, **extra))
        assert os.listdir(d) == []
    return outs


def _parts(seed=0, sizes=(100, 57, 1, 204)):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal(n)} for n in sizes]


class TestSparkAdapter:
    def test_reduce_blocks_one_call(self, tmp_path):
        parts = _parts()
        got, ref = _both("reduce_blocks", _sum_graph, _fake_df(parts), tmp_path)
        want = np.concatenate([p["x"] for p in parts]).sum()
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.item(), float(np.asarray(ref)), rtol=F64_RTOL)
        np.testing.assert_allclose(got.item(), want, rtol=F64_RTOL)
        # one streamed chunk per partition file
        assert tprof.stats()["reduce_blocks_stream.chunks"] == 4.0

    def test_map_blocks_partitions_become_blocks(self, tmp_path):
        fake = _fake_df([{"x": np.arange(10.0)}, {"x": np.arange(10.0, 16.0)}])

        def z(pkg):
            probe = pkg.TensorFrame.from_dict({"x": np.zeros(4)})
            return (pkg.block(probe, "x") + 3.0).named("z")

        keep = str(tmp_path / "kept")
        out = tspark.map_blocks(z(tft), fake, ingest_dir=keep, keep_ingest=True, device=CPU)
        ref = jspark.map_blocks(z(tfs), fake, ingest_dir=str(tmp_path / "j"))
        np.testing.assert_array_equal(out["z"].values.numpy(), np.asarray(ref["z"].values))
        np.testing.assert_array_equal(out["z"].values.numpy(), np.arange(16.0) + 3.0)
        assert out.num_blocks == ref.num_blocks == 2  # partition boundaries kept
        assert out.offsets == [0, 10, 16]
        # keep_ingest=True leaves the dumped files for re-streaming
        assert len(glob.glob(os.path.join(keep, "*", "*.arrow"))) == 2

    def test_multi_batch_partition_is_one_block(self, tmp_path):
        # one PARTITION arrives as several record batches in one file;
        # batches are write granularity, never block boundaries
        part = [
            pa.RecordBatch.from_pydict({"x": np.arange(5.0)}),
            pa.RecordBatch.from_pydict({"x": np.arange(5.0, 12.0)}),
        ]
        fake = MiniDataFrame([part])

        def z(pkg):
            probe = pkg.TensorFrame.from_dict({"x": np.zeros(4)})
            return (pkg.block(probe, "x") + 0.0).named("z")

        out, ref = _both("map_blocks", z, fake, tmp_path)
        assert out.num_blocks == ref.num_blocks == 1
        total, jtotal = _both("reduce_blocks", _sum_graph, MiniDataFrame([part]), tmp_path / "r")
        assert total.item() == float(np.asarray(jtotal)) == np.arange(12.0).sum()

    def test_failed_ingest_removes_partial_files(self, tmp_path):
        class ExplodingDF(MiniDataFrame):
            def mapInArrow(self, fn, schema):  # noqa: N802
                # partition 1 dumps fine, partition 2's executor dies
                list(fn(iter(self._parts[0])))

                def collect():
                    raise RuntimeError("executor lost")

                return types.SimpleNamespace(collect=collect)

        part = [pa.RecordBatch.from_pydict({"x": np.arange(4.0)})]
        ingest_dir = str(tmp_path / "fail")
        with pytest.raises(RuntimeError, match="executor lost"):
            tspark.reduce_blocks(
                _sum_graph(tft), ExplodingDF([part, part]), ingest_dir=ingest_dir, device=CPU
            )
        assert os.listdir(ingest_dir) == []  # no orphaned partials

    def test_aggregate_one_call(self, tmp_path):
        fake = _fake_df([
            {"k": np.array([0.0, 1.0, 0.0]), "x": np.array([1.0, 2.0, 3.0])},
            {"k": np.array([1.0, 0.0]), "x": np.array([4.0, 5.0])},
        ])
        out, ref = _both("aggregate", _sum_graph, fake, tmp_path, keys=["k"])
        np.testing.assert_array_equal(out.host_values("k"), np.asarray(ref.host_values("k")))
        np.testing.assert_array_equal(out.host_values("x"), np.asarray(ref.host_values("x")))
        assert dict(zip(out.host_values("k").tolist(), out.host_values("x").tolist())) == {
            0.0: 9.0, 1.0: 6.0,
        }
        with pytest.raises(ValueError, match="at least one key"):
            tspark.aggregate(_sum_graph(tft), fake, keys=[], device=CPU)

    def test_aggregate_mean_by_int_key(self, tmp_path):
        rng = np.random.default_rng(1)
        parts = [
            {"k": rng.integers(0, 5, n).astype(np.int64), "x": rng.standard_normal(n)}
            for n in (40, 33, 27)
        ]

        def mean(pkg):
            probe = pkg.TensorFrame.from_dict({"x": np.zeros(4)})
            return pkg.dsl.reduce_mean(pkg.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")

        out, ref = _both("aggregate", mean, _fake_df(parts), tmp_path, keys=["k"])
        np.testing.assert_array_equal(out.host_values("k"), np.asarray(ref.host_values("k")))
        np.testing.assert_allclose(
            out.host_values("x"), np.asarray(ref.host_values("x")), rtol=F64_RTOL
        )

    def test_map_rows_and_reduce_rows(self, tmp_path):
        parts = [{"x": np.arange(6.0)}, {"x": np.arange(6.0, 9.0)}]

        def y(pkg):
            probe = pkg.TensorFrame.from_dict({"x": np.zeros(4)})
            return (pkg.row(probe, "x") * 2.0).named("y")

        out, ref = _both("map_rows", y, _fake_df(parts), tmp_path / "m")
        np.testing.assert_array_equal(out["y"].values.numpy(), np.asarray(ref["y"].values))
        np.testing.assert_array_equal(out["y"].values.numpy(), np.arange(9.0) * 2.0)

        def pair(pkg):
            x1 = pkg.dsl.placeholder(pkg.ScalarType.float64, pkg.Shape(()), name="x_1")
            x2 = pkg.dsl.placeholder(pkg.ScalarType.float64, pkg.Shape(()), name="x_2")
            return (x1 + x2).named("x")

        total, jtotal = _both("reduce_rows", pair, _fake_df(parts), tmp_path / "r")
        assert total.item() == float(np.asarray(jtotal)) == np.arange(9.0).sum()

    def test_string_keyed_aggregate(self, tmp_path):
        # Spark group keys arrive as Arrow strings
        fake = _fake_df([
            {"k": ["a", "b", "a"], "x": np.array([1.0, 2.0, 3.0])},
            {"k": ["b", "c"], "x": np.array([4.0, 5.0])},
        ])
        out, ref = _both("aggregate", _sum_graph, fake, tmp_path, keys=["k"])
        got = sorted(zip([str(v) for v in out.host_values("k")], out.host_values("x").tolist()))
        want = sorted(zip([str(v) for v in ref.host_values("k")], np.asarray(ref.host_values("x")).tolist()))
        assert got == want == [("a", 4.0), ("b", 6.0), ("c", 5.0)]

    def test_ragged_rows_through_adapter(self, tmp_path):
        # variable-length Arrow list columns survive collection as ragged
        # cells (the reference's variable-length map_rows case)
        fake = MiniDataFrame([
            [pa.RecordBatch.from_pydict({"v": pa.array([[1.0, 2.0], [3.0]])})],
            [pa.RecordBatch.from_pydict({"v": pa.array([[4.0, 5.0, 6.0]])})],
        ])
        out, ref = _both("map_rows", lambda pkg: (lambda v: {"s": v.sum()}), fake, tmp_path)
        assert out["s"].values.tolist() == _np(ref["s"].values).tolist() == [3.0, 3.0, 15.0]
        assert out.offsets == [0, 2, 3]

    def test_empty_ingest_raises(self, tmp_path):
        with pytest.raises(ValueError, match="empty|no rows"):
            tspark.reduce_blocks(
                _sum_graph(tft), MiniDataFrame([]), ingest_dir=str(tmp_path / "e"), device=CPU
            )
        with pytest.raises(ValueError, match="no rows"):
            tspark.map_blocks(
                _sum_graph(tft), MiniDataFrame([]), ingest_dir=str(tmp_path / "m"), device=CPU
            )
        assert os.listdir(str(tmp_path / "e")) == os.listdir(str(tmp_path / "m")) == []

    def test_ingest_writes_one_ipc_file_per_partition(self, tmp_path):
        parts = _parts(sizes=(3, 4, 5))
        ing = tspark.ingest(_fake_df(parts), str(tmp_path / "i"))
        assert len(ing.paths) == 3
        assert all(os.path.dirname(p) == ing.directory for p in ing.paths)
        frames = list(tspark._stream_paths(ing.paths))
        assert [f.num_blocks for f in frames] == [1, 1, 1]
        np.testing.assert_array_equal(
            np.concatenate([f.host_values("x") for f in frames]),
            np.concatenate([p["x"] for p in parts]),
        )
        tspark._cleanup(ing, keep=False)
        assert not os.path.exists(ing.directory)

    def test_no_card_means_no_silent_cpu_run(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device: device=None is valid there")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tspark.reduce_blocks(_sum_graph(tft), _fake_df(_parts()), ingest_dir=str(tmp_path / "n"))
        assert os.listdir(str(tmp_path / "n")) == []


@pytest.mark.parametrize("verb", ["reduce_blocks", "map_blocks", "reduce_rows", "aggregate"])
def test_mesh_parameter_as_jax(verb, tmp_path):
    """``mesh=`` on the four bridge functions that take it in the JAX
    package: the port's 8-entry CPU mesh against JAX's 8 devices."""
    import inspect

    from tensorframes_tpu.parallel import data_mesh as jmesh_of
    from tensorframes_tpu_torch.parallel import data_mesh

    assert list(inspect.signature(getattr(tspark, verb)).parameters) == list(
        inspect.signature(getattr(jspark, verb)).parameters)
    rng = np.random.default_rng(3)
    parts = [{"k": rng.integers(0, 5, n).astype(np.int64), "x": rng.standard_normal(n)}
             for n in (40, 9, 33)]
    fake = _fake_df(parts)
    x = np.concatenate([p["x"] for p in parts])
    meshes = {tft: data_mesh(devices=[CPU] * 8), tfs: jmesh_of()}

    def fetches(pkg):
        probe = pkg.TensorFrame.from_dict({"x": np.zeros(4)})
        if verb == "map_blocks":
            return (pkg.block(probe, "x") * 2.0).named("z")
        if verb == "reduce_rows":
            f64, s = pkg.ScalarType.float64, pkg.Shape(())
            return pkg.dsl.add(pkg.dsl.placeholder(f64, s, name="x_1"),
                               pkg.dsl.placeholder(f64, s, name="x_2")).named("x")
        return _sum_graph(pkg)

    outs = {}
    for pkg, mod in ((tft, tspark), (tfs, jspark)):
        kw = {"keys": ["k"]} if verb == "aggregate" else {}
        outs[pkg] = getattr(mod, verb)(fetches(pkg), fake, ingest_dir=str(tmp_path / pkg.__name__),
                                       mesh=meshes[pkg], **kw)
    got, ref = outs[tft], outs[tfs]
    if verb == "map_blocks":
        np.testing.assert_array_equal(got.host_values("z"), np.asarray(ref["z"].values))
        np.testing.assert_array_equal(got.host_values("z"), x * 2.0)
    elif verb == "aggregate":
        np.testing.assert_array_equal(got.host_values("k"), np.asarray(ref["k"].values))
        np.testing.assert_allclose(got.host_values("x"), np.asarray(ref["x"].values), rtol=F64_RTOL)
    else:
        np.testing.assert_allclose(float(got), float(np.asarray(ref)), rtol=F64_RTOL)
        np.testing.assert_allclose(float(got), x.sum(), rtol=F64_RTOL)
