"""PyTorch port: the ingest pipeline (`ingest/pipeline.py`), multi-file
datasets (`ingest/dataset.py`, the multi-path `io` readers) and the config
knobs they read, held to the JAX package on the CPU.

Mirrors `tests/test_ingest.py` on the port's copy of the stage-graph
runtime (in-order delivery, the W + 2d + 4 live-chunk bound, serial mode,
error stamping, abandonment, classified retries), then holds the port's
shard discovery, `Dataset.tasks()` and `fingerprint()` to the JAX
package's for the same files, and streams the same shards through both
packages' `reduce_blocks_stream`: min and max exact, float sums rtol 1e-5.
"""

import os
import threading
import time

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu import io as jio
from tensorframes_tpu.ingest import Dataset as JDataset
from tensorframes_tpu.ingest import discover_shards as jdiscover
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch.ingest import (
    Dataset,
    IngestStream,
    PipeStage,
    discover_shards,
    pipelined,
    stream_dataset,
)
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.testing import faults as chaos
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
F32_RTOL = 1e-5

pytest.importorskip("pyarrow")


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    ttele.reset()
    tprof.reset_stats()
    tfaults.reset_ledger()
    tdl.reset()


def _write_shards(root, sizes, fmt="parquet", blocks=2, seed=0):
    """One shard file per entry of ``sizes`` (written by the port);
    returns (dir, all rows)."""
    rng = np.random.RandomState(seed)
    parts = []
    ext = "parquet" if fmt == "parquet" else "arrow"
    for i, n in enumerate(sizes):
        x = rng.rand(n).astype(np.float32)
        parts.append(x)
        df = tft.TensorFrame.from_dict({"x": x}, num_blocks=min(blocks, max(1, n)))
        p = str(root / f"shard-{i:03d}.{ext}")
        (tio.write_parquet if fmt == "parquet" else tio.write_arrow_ipc)(df, p)
    return str(root), np.concatenate(parts) if parts else np.zeros(0, "f4")


def _fetch(pkg, op="sum"):
    probe = pkg.TensorFrame.from_dict({"x": np.arange(2.0, dtype=np.float32)})
    xi = pkg.block(probe, "x", tf_name="x_input")
    red = {"sum": pkg.dsl.reduce_sum, "min": pkg.dsl.reduce_min, "max": pkg.dsl.reduce_max}
    return red[op](xi, axes=[0]).named("x")


def _stream(pkg, source, op="sum", **kw):
    if pkg is tft:
        return float(tft.reduce_blocks_stream(_fetch(tft, op), source, device=CPU, **kw))
    return float(np.asarray(tfs.reduce_blocks_stream(_fetch(tfs, op), source, **kw)))


# ---------------------------------------------------------------------------
# the stage-graph runtime (tests/test_ingest.py::TestPipelineRuntime)
# ---------------------------------------------------------------------------


class TestPipelineRuntime:
    def test_in_order_delivery_from_out_of_order_workers(self):
        def slow_double(i):
            time.sleep(0.002 * (3 - i % 4))
            return i * 2

        out = list(
            pipelined(iter(range(40)), [PipeStage("decode", slow_double, workers=4)], depth=2)
        )
        assert out == [i * 2 for i in range(40)]

    @pytest.mark.parametrize("workers,depth", [(3, 2), (2, 1), (4, 3)])
    def test_peak_buffered_chunks_bound(self, workers, depth):
        live, peak = [0], [0]
        lock = threading.Lock()

        def decode(i):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            return i

        it = pipelined(
            iter(range(60)),
            [
                PipeStage("decode", decode, workers=workers, cheap_input=True),
                PipeStage("transfer-stage", lambda i: i),
            ],
            depth=depth,
        )
        for _ in it:
            with lock:
                live[0] -= 1
            time.sleep(0.002)  # slow consumer: the pipeline runs ahead
        assert peak[0] <= workers + 2 * depth + 4, peak[0]
        assert peak[0] >= 2

    def test_stream_prefetch_depth_config_respected(self):
        produced = [0]

        def src():
            for i in range(100):
                produced[0] += 1
                yield i

        with tconfig.override(stream_prefetch_depth=3):
            it = pipelined(src(), [])  # depth=None reads the knob
            assert next(it) == 0
            time.sleep(0.3)
            assert produced[0] <= 1 + 3 + 2, produced[0]
            it.close()

    def test_serial_mode_same_results_no_threads(self):
        with tconfig.override(ingest_pipeline=False):
            before = threading.active_count()
            out = list(pipelined(iter(range(10)), [PipeStage("decode", lambda i: i * 2)], depth=2))
            assert threading.active_count() == before
        assert out == [i * 2 for i in range(10)]

    def test_serial_mode_stamps_errors(self):
        def src():
            yield 0
            raise RuntimeError("bad shard")

        with tconfig.override(ingest_pipeline=False):
            it = pipelined(src(), [], depth=1)
            assert next(it) == 0
            with pytest.raises(RuntimeError, match="bad shard") as ei:
                next(it)
        assert ei.value.tfs_chunk_index == 1
        assert ei.value.tfs_pipeline_stage == "producer"

    def test_abandon_closes_source_promptly(self):
        closed = threading.Event()

        def src():
            try:
                for i in range(1000):
                    yield i
            finally:
                closed.set()

        it = pipelined(src(), [], depth=1)
        assert next(it) == 0
        it.close()
        assert closed.wait(5.0), "source generator was not closed"

    def test_stage_error_carries_context_and_fails_fast(self):
        attempts = {"n": 0}

        def decode(i):
            if i == 2:
                attempts["n"] += 1
                raise ValueError("corrupt chunk")
            return i

        it = pipelined(
            iter(range(5)),
            [PipeStage("decode", decode, workers=2,
                       context=lambda i: {"tfs_shard_path": f"shard-{i}"})],
            depth=1,
        )
        got = [next(it), next(it)]
        with pytest.raises(ValueError, match="corrupt chunk") as ei:
            list(it)
        assert got == [0, 1]
        assert ei.value.tfs_chunk_index == 2
        assert ei.value.tfs_pipeline_stage == "decode"
        assert ei.value.tfs_shard_path == "shard-2"
        assert attempts["n"] == 1  # deterministic: one attempt, no retry

    def test_non_iterable_source_raises_not_hangs(self):
        with pytest.raises(TypeError) as ei:
            next(pipelined(42, [], depth=1))
        assert ei.value.tfs_pipeline_stage == "producer"

    def test_transient_stage_error_retried_in_place(self):
        failed = {"n": 0}
        lock = threading.Lock()

        def decode(i):
            if i == 3:
                with lock:
                    failed["n"] += 1
                    if failed["n"] == 1:
                        raise RuntimeError("UNAVAILABLE: flaky reader")
            return i * 10

        with tconfig.override(retry_backoff_base_s=0.001):
            out = list(pipelined(iter(range(6)), [PipeStage("decode", decode, workers=2)], depth=1))
        assert out == [i * 10 for i in range(6)]
        assert failed["n"] == 2
        assert tfaults.ledger_snapshot()["retries"] == 1

    def test_stage_counters(self):
        list(pipelined(iter(range(5)), [PipeStage("decode", lambda i: i)], depth=1))
        flat = ttele.flat_counters()
        assert flat["ingest_chunks{stage=decode}"] == 5
        assert flat["ingest_chunks{stage=compute}"] == 5
        assert "ingest_stage_busy_seconds{stage=decode}" in flat
        assert "ingest_stage_wait_seconds{stage=compute}" in flat

    def test_ordinal_base_stamps_global_index(self):
        def src():
            yield 0
            raise RuntimeError("bad")

        it = pipelined(src(), [PipeStage("decode", lambda i: i)], depth=1, ordinal_base=10)
        assert next(it) == 0
        with pytest.raises(RuntimeError) as ei:
            next(it)
        assert ei.value.tfs_chunk_index == 11


# ---------------------------------------------------------------------------
# discovery, tasks and fingerprints, held to the JAX package
# ---------------------------------------------------------------------------


class TestDiscovery:
    def test_directory_sorted_deterministic(self, tmp_path):
        root, _ = _write_shards(tmp_path, [4, 4, 4])
        shards = discover_shards(root)
        assert [os.path.basename(p) for p, _ in shards] == [
            "shard-000.parquet", "shard-001.parquet", "shard-002.parquet"
        ]
        assert shards == jdiscover(root)

    def test_glob_and_list_mix(self, tmp_path):
        root, _ = _write_shards(tmp_path, [4, 4])
        ipc_root = tmp_path / "ipc"
        ipc_root.mkdir()
        _write_shards(ipc_root, [4], fmt="ipc")
        paths = [os.path.join(root, "*.parquet"), str(ipc_root)]
        shards = discover_shards(paths)
        assert [f for _, f in shards] == ["parquet", "parquet", "ipc"]
        assert shards == jdiscover(paths)

    def test_missing_and_empty_are_loud(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            discover_shards(str(tmp_path / "nope.parquet"))
        with pytest.raises(ValueError, match="matched no shards"):
            discover_shards(str(tmp_path / "*.parquet"))
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(ValueError, match="no Parquet/IPC shards"):
            discover_shards(str(empty))

    def test_format_inference_and_override(self, tmp_path):
        odd = str(tmp_path / "data.bin")
        tio.write_parquet(tft.TensorFrame.from_dict({"x": np.arange(3.0)}), odd)
        with pytest.raises(ValueError, match="cannot infer"):
            discover_shards(odd)
        assert discover_shards(odd, format="parquet") == [(odd, "parquet")]

    @pytest.mark.parametrize("fmt,chunk_groups", [("parquet", 1), ("parquet", 2), ("ipc", 1), ("ipc", 3)])
    def test_tasks_and_fingerprint_equal_jax(self, fmt, chunk_groups, tmp_path):
        root, _ = _write_shards(tmp_path, [10, 6, 0, 7], fmt=fmt, blocks=3)
        port, ref = Dataset(root, chunk_groups=chunk_groups), JDataset(root, chunk_groups=chunk_groups)
        tasks, jtasks = port.task_list(), ref.task_list()
        assert [
            (t.shard, t.format, t.groups, t.shard_index, t.rows) for t in tasks
        ] == [(t.shard, t.format, t.groups, t.shard_index, t.rows) for t in jtasks]
        assert port.fingerprint() == ref.fingerprint()
        assert port.fingerprint(tasks) == ref.fingerprint(jtasks)

    def test_tasks_group_metadata(self, tmp_path):
        root, _ = _write_shards(tmp_path, [10, 6], blocks=3)
        tasks = list(Dataset(root, chunk_groups=2).tasks())
        assert [t.shard_index for t in tasks] == [0, 0, 1, 1]
        assert sum(t.rows for t in tasks) == 16
        assert tasks[0].groups == (0, 1)

    def test_ipc_discovery_is_metadata_only(self, tmp_path):
        root, _ = _write_shards(tmp_path, [9], fmt="ipc", blocks=3)
        tasks = list(Dataset(root).tasks())
        assert len(tasks) == 3 and all(t.rows == -1 for t in tasks)

    def test_columns_projection_and_predicate_refused(self, tmp_path):
        df = tft.TensorFrame.from_dict(
            {"x": np.arange(4.0, dtype=np.float32), "y": np.arange(4, dtype=np.int64)}
        )
        for ext, write in (("parquet", tio.write_parquet), ("arrow", tio.write_arrow_ipc)):
            p = str(tmp_path / f"c.{ext}")
            write(df, p)
            ds = Dataset(p)
            (task,) = ds.task_list()
            assert ds.decode(task, columns=["y", "nope"]).columns == ["y"]
            with pytest.raises(NotImplementedError, match="item 7"):
                ds.decode(task, predicate=object())


# ---------------------------------------------------------------------------
# multi-file streaming end to end, held to the JAX package
# ---------------------------------------------------------------------------


class TestStreamDataset:
    @pytest.mark.parametrize("fmt", ["parquet", "ipc"])
    @pytest.mark.parametrize("workers", [1, 3])
    def test_mixed_shard_sizes_match_jax(self, fmt, workers, tmp_path):
        root, allx = _write_shards(tmp_path, [37, 5, 120, 1, 0], fmt=fmt, blocks=4)
        for op in ("sum", "min", "max"):
            got = _stream(tft, stream_dataset(root, decode_workers=workers), op)
            want = _stream(tfs, tfs.stream_dataset(root, decode_workers=workers), op)
            if op == "sum":
                np.testing.assert_allclose(got, want, rtol=F32_RTOL)
                np.testing.assert_allclose(got, allx.sum(dtype=np.float64), rtol=F32_RTOL)
            else:
                assert got == want

    def test_vector_column_dataset(self, tmp_path):
        rng = np.random.default_rng(0)
        vs = []
        for i, n in enumerate([9, 0, 14]):
            v = rng.standard_normal((n, 8)).astype(np.float32)
            vs.append(v)
            x = rng.standard_normal(n).astype(np.float32)
            df = tft.TensorFrame([tft.Column("x", x), tft.Column("v", v)])
            tio.write_parquet(df, str(tmp_path / f"s{i}.parquet"))
        probe = tft.TensorFrame.from_dict({"v": np.zeros((2, 8), np.float32)})
        s = tft.dsl.reduce_sum(tft.block(probe, "v", tf_name="v_input"), axes=[0]).named("v")
        got = tft.reduce_blocks_stream(s, stream_dataset(str(tmp_path)), device=CPU)
        np.testing.assert_allclose(
            got.numpy(), np.concatenate(vs).sum(axis=0, dtype=np.float64), rtol=F32_RTOL
        )

    def test_zero_row_record_batch_skipped(self, tmp_path):
        df = tft.TensorFrame([tft.Column("x", np.arange(6.0, dtype=np.float32))], offsets=[0, 3, 3, 6])
        p = str(tmp_path / "z.arrow")
        tio.write_arrow_ipc(df, p)
        assert _stream(tft, stream_dataset(p)) == 15.0 == _stream(tfs, tfs.stream_dataset(p))

    def test_io_multi_path_variants_route_to_pipeline(self, tmp_path):
        root, allx = _write_shards(tmp_path, [9, 9])
        by_dir = tio.stream_parquet(root)
        assert isinstance(by_dir, IngestStream)
        assert sum(f.nrows for f in by_dir) == allx.size
        by_glob = tio.stream_parquet(os.path.join(root, "*.parquet"))
        assert sum(f.nrows for f in by_glob) == allx.size
        (tmp_path / "i").mkdir()
        ipc_root, _ = _write_shards(tmp_path / "i", [7], fmt="ipc")
        by_list = tio.stream_arrow_ipc([os.path.join(ipc_root, "shard-000.arrow")])
        assert sum(f.nrows for f in by_list) == 7
        assert isinstance(tft.stream_dataset(root), IngestStream)

    def test_ingest_stream_is_an_iterator_with_close(self, tmp_path):
        root, allx = _write_shards(tmp_path, [6, 6, 6])
        it = tio.stream_parquet(root)
        assert next(it).nrows > 0
        it.close()
        it2 = stream_dataset(root, decode_workers=2)
        skipped = next(it2)
        rest = _stream(tft, it2)
        want = allx.sum(dtype=np.float64) - skipped["x"].host_values().sum(dtype=np.float64)
        np.testing.assert_allclose(rest, want, rtol=F32_RTOL)

    def test_single_file_keeps_plain_generator(self, tmp_path):
        root, _ = _write_shards(tmp_path, [6])
        it = tio.stream_parquet(os.path.join(root, "shard-000.parquet"))
        assert not isinstance(it, IngestStream)
        assert sum(f.nrows for f in it) == 6

    def test_corrupt_shard_fails_fast_with_context(self, tmp_path):
        root, _ = _write_shards(tmp_path, [8, 8])
        bad = str(tmp_path / "shard-001x.parquet")
        with open(bad, "wb") as f:
            f.write(b"PAR1 this is not a parquet file")
        with pytest.raises(Exception) as ei:
            _stream(tft, stream_dataset(root, decode_workers=2))
        assert getattr(ei.value, "tfs_shard_path", None) == bad
        assert getattr(ei.value, "tfs_chunk_index", None) is not None

    def test_injected_decode_fault_transient_recovers(self, tmp_path):
        root, allx = _write_shards(tmp_path, [16, 16, 16])
        with tconfig.override(retry_backoff_base_s=0.001):
            with chaos.inject_stage(stage="decode", nth=[1]) as plan:
                total = _stream(tft, stream_dataset(root, decode_workers=2))
        assert plan.injected == 1
        np.testing.assert_allclose(total, allx.sum(dtype=np.float64), rtol=F32_RTOL)

    def test_injected_decode_fault_deterministic_names_shard(self, tmp_path):
        root, _ = _write_shards(tmp_path, [16, 16, 16])
        with chaos.inject_stage(stage="decode", nth=[2], fault="deterministic") as plan:
            with pytest.raises(chaos.InjectedFault) as ei:
                _stream(tft, stream_dataset(root, decode_workers=2))
        assert plan.injected == 1
        assert ei.value.tfs_pipeline_stage == "decode"
        assert str(ei.value.tfs_shard_path).endswith(".parquet")
        assert ei.value.tfs_chunk_index is not None

    def test_jax_written_shards_stream_in_the_port(self, tmp_path):
        rng = np.random.RandomState(2)
        parts = []
        for i in range(3):
            x = rng.rand(20).astype(np.float32)
            parts.append(x)
            jio.write_arrow_ipc(tfs.TensorFrame.from_dict({"x": x}, num_blocks=2),
                                str(tmp_path / f"j{i}.arrow"))
        assert _stream(tft, stream_dataset(str(tmp_path)), "max") == float(np.concatenate(parts).max())


def _fds_for(path: str):
    out = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            if os.readlink(f"/proc/self/fd/{fd}") == path:
                out.append(fd)
        except OSError:
            continue
    return out


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"), reason="needs /proc fd table")
class TestHandleLeak:
    @pytest.mark.parametrize("fmt", ["parquet", "ipc"])
    def test_partial_consumption_closes(self, fmt, tmp_path):
        root, _ = _write_shards(tmp_path, [12], fmt=fmt, blocks=4)
        p = os.path.join(root, "shard-000." + ("parquet" if fmt == "parquet" else "arrow"))
        it = (tio.stream_parquet if fmt == "parquet" else tio.stream_arrow_ipc)(p)
        next(it)
        assert _fds_for(p)
        it.close()
        assert not _fds_for(p)

    def test_abandoned_pipelined_stream_closes_handles(self, tmp_path):
        root, _ = _write_shards(tmp_path, [40], blocks=8)
        p = os.path.join(root, "shard-000.parquet")
        it = iter(pipelined(tio.stream_parquet(p), [], depth=1))
        next(it)
        it.close()
        deadline = time.time() + 5.0
        while _fds_for(p) and time.time() < deadline:
            time.sleep(0.01)
        assert not _fds_for(p)


# ---------------------------------------------------------------------------
# config: every knob the port carries has the JAX package's default and env
# ---------------------------------------------------------------------------

_ENV_SAMPLES = {int: "7", float: "2.5"}


class TestConfigKnobs:
    def test_defaults_equal_jax(self):
        port, ref = tconfig.Config(), jconfig.Config()
        for name in (f.name for f in tconfig.dataclasses.fields(port)):
            assert getattr(port, name) == getattr(ref, name), name
        assert port.stream_prefetch_depth == 1 and port.ingest_pipeline is True
        assert port.stream_checkpoint_every == 16 and port.ingest_decode_workers == 0
        assert port.block_retry_attempts == 3 and port.verb_retry_budget == 32

    def test_jax_only_knobs_left_out(self):
        port = tconfig.Config()
        for name in ("matmul_precision", "shape_bucketing", "compilation_cache_dir"):
            assert not hasattr(port, name)
        assert not hasattr(port, "lax_precision")

    def test_env_names_equal_jax(self, monkeypatch):
        """Each knob's ``TFS_<KNOB>`` seeds both packages alike, to a value
        other than its default."""
        defaults = tconfig.Config()
        fields = tconfig.dataclasses.fields(tconfig.Config)
        for f in fields:
            d = getattr(defaults, f.name)
            raw = ("0" if d else "1") if isinstance(d, bool) else _ENV_SAMPLES[type(d)]
            monkeypatch.setenv(f"TFS_{f.name.upper()}", raw)
        port, ref = tconfig.Config(), jconfig.Config()
        for f in fields:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
            assert getattr(port, f.name) != getattr(defaults, f.name), f.name

    def test_malformed_env_falls_back(self, monkeypatch):
        monkeypatch.setenv("TFS_STREAM_PREFETCH_DEPTH", "lots")
        assert tconfig.Config().stream_prefetch_depth == 1

    def test_update_override_and_pins(self):
        assert not tconfig.is_explicit("ingest_decode_workers")
        with tconfig.override(ingest_decode_workers=5):
            assert tconfig.get().ingest_decode_workers == 5
            assert tconfig.is_explicit("ingest_decode_workers")
        assert tconfig.get().ingest_decode_workers == 0
        assert "ingest_decode_workers" not in tconfig.explicit_keys()
        assert tconfig.default_value("stream_checkpoint_every") == 16
        with pytest.raises(AttributeError):
            tconfig.update(no_such_knob=1)
