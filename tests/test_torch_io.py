"""PyTorch port: single-file Arrow IPC and Parquet I/O (`io.py`), held to the
JAX package on the CPU.

Mirrors `tests/test_frame.py::TestArrowIPC` and `TestParquet`, and
cross-reads: a file the port writes is read by both packages and by the
port, and a file the JAX package writes is read by the port; the same
frame comes back with the same block offsets. Everything is exact.
"""

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import io as jio
from tensorframes_tpu_torch import io as tio

CPU = "cpu"


def _data(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal(n),
        "v": rng.standard_normal((n, 2)).astype(np.float32),
        "i": rng.integers(-50, 50, n).astype(np.int32),
        "s": np.array([f"key_{k}" for k in rng.integers(0, 4, n)], dtype=object),
        "r": [rng.standard_normal(int(k)) for k in rng.integers(1, 5, n)],
    }


def _assert_same_frame(got, want):
    """``got`` (a port frame) holds ``want``'s (either package's) columns,
    cells, dtypes and offsets."""
    assert got.columns == want.columns
    assert got.offsets == [int(o) for o in want.offsets]
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.is_dense == w.is_dense and g.dtype.value == w.dtype.value
        assert repr(g.cell_shape) == repr(w.cell_shape)
        if g.is_dense:
            gv, wv = g.host_values(), np.asarray(w.host_values())
            assert gv.dtype == wv.dtype
            np.testing.assert_array_equal(gv, wv)
        else:
            grows = [np.asarray(r) for r in g.rows()]
            wrows = [np.asarray(r) for r in w.rows()]
            assert [r.tolist() for r in grows] == [r.tolist() for r in wrows]


_FORMATS = {
    "ipc": (tio.write_arrow_ipc, tio.read_arrow_ipc, jio.write_arrow_ipc, jio.read_arrow_ipc),
    "parquet": (tio.write_parquet, tio.read_parquet, jio.write_parquet, jio.read_parquet),
}


@pytest.mark.parametrize("fmt", list(_FORMATS))
class TestRoundTrips:
    def test_blocks_strings_and_ragged(self, fmt, tmp_path):
        write, read, _, jread = _FORMATS[fmt]
        data = _data()
        port = tft.TensorFrame.from_dict(data, num_blocks=3)
        p = str(tmp_path / f"t.{fmt}")
        write(port, p)
        _assert_same_frame(read(p), port)
        # the JAX package reads the port's file as its own frame
        _assert_same_frame(read(p), jread(p))
        _assert_same_frame(read(p), tfs.TensorFrame.from_dict(data, num_blocks=3))

    def test_reference_file_read_by_the_port(self, fmt, tmp_path):
        _, read, jwrite, _ = _FORMATS[fmt]
        data = _data(13, seed=4)
        ref = tfs.TensorFrame.from_dict(data, num_blocks=4)
        p = str(tmp_path / f"j.{fmt}")
        jwrite(ref, p)
        _assert_same_frame(read(p), ref)

    def test_device_columns_write_the_same_file(self, fmt, tmp_path):
        write, read, _, _ = _FORMATS[fmt]
        port = tft.TensorFrame.from_dict(_data(), num_blocks=2)
        a, b = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
        write(port, a)
        write(port.to_device(CPU), b)
        _assert_same_frame(read(b), read(a))

    def test_repartition_on_read(self, fmt, tmp_path):
        write, read, _, jread = _FORMATS[fmt]
        port = tft.TensorFrame.from_dict({"x": np.arange(12.0)}, num_blocks=3)
        p = str(tmp_path / f"r.{fmt}")
        write(port, p)
        back = read(p, num_blocks=6)
        assert back.num_blocks == 6
        _assert_same_frame(back, jread(p, num_blocks=6))

    def test_multi_file_paths_wait_for_the_ingest_pipeline(self, fmt, tmp_path):
        """The whole-file reader and the writer take one file; a list, a
        directory or a glob streams through the ingest pipeline."""
        write, read, _, _ = _FORMATS[fmt]
        stream = tio.stream_arrow_ipc if fmt == "ipc" else tio.stream_parquet
        p = str(tmp_path / f"m.{fmt}")
        write(tft.TensorFrame.from_dict({"x": np.arange(3.0)}), p)
        for path in ([p, p], str(tmp_path), str(tmp_path / f"*.{fmt}")):
            with pytest.raises(ValueError, match="stream_dataset"):
                read(path)
            with pytest.raises(ValueError, match="stream_dataset"):
                write(tft.TensorFrame.from_dict({"x": np.arange(3.0)}), path)
            rows = 6 if isinstance(path, list) else 3
            assert sum(f.nrows for f in stream(path)) == rows


def test_ipc_empty_blocks_preserved(tmp_path):
    port = tft.TensorFrame([tft.Column("x", np.arange(6.0))], offsets=[0, 3, 3, 6])
    p = str(tmp_path / "e.arrow")
    tio.write_arrow_ipc(port, p)
    back = tio.read_arrow_ipc(p)
    assert back.offsets == [0, 3, 3, 6]
    _assert_same_frame(back, jio.read_arrow_ipc(p))
    _assert_same_frame(back, port)


def test_parquet_drops_empty_blocks_as_the_reference_does(tmp_path):
    data = {"x": np.arange(6.0)}
    port = tft.TensorFrame([tft.Column("x", data["x"])], offsets=[0, 3, 3, 6])
    ref = tfs.TensorFrame([tfs.Column("x", data["x"])], offsets=[0, 3, 3, 6])
    a, b = str(tmp_path / "p.parquet"), str(tmp_path / "j.parquet")
    tio.write_parquet(port, a)
    jio.write_parquet(ref, b)
    assert tio.read_parquet(a).offsets == [0, 3, 6]
    _assert_same_frame(tio.read_parquet(a), jio.read_parquet(b))


@pytest.mark.parametrize("fmt", list(_FORMATS))
def test_all_empty_frame(fmt, tmp_path):
    write, read, _, jread = _FORMATS[fmt]
    port = tft.TensorFrame.from_dict({"x": np.zeros((0,), dtype=np.float32)})
    p = str(tmp_path / f"z.{fmt}")
    write(port, p)
    back = read(p)
    assert back.nrows == 0 and back.host_values("x").dtype == np.float32
    _assert_same_frame(back, jread(p))


def test_ipc_bytes_round_trip_and_cross_read():
    data = _data(9, seed=2)
    port = tft.TensorFrame([tft.Column(k, v) for k, v in data.items()], offsets=[0, 4, 4, 9])
    raw = tio.frame_to_ipc_bytes(port)
    back = tio.frame_from_ipc_bytes(raw)
    assert back.offsets == [0, 4, 4, 9]
    _assert_same_frame(back, port)
    _assert_same_frame(back, jio.frame_from_ipc_bytes(raw))
    ref = tfs.TensorFrame([tfs.Column(k, v) for k, v in data.items()], offsets=[0, 4, 4, 9])
    _assert_same_frame(tio.frame_from_ipc_bytes(jio.frame_to_ipc_bytes(ref)), ref)
    with pytest.raises(ValueError, match="empty byte string"):
        tio.frame_from_ipc_bytes(b"")


def test_parquet_block_larger_than_the_default_row_group(tmp_path):
    port = tft.TensorFrame.from_dict({"x": np.zeros(1_500_000, dtype=np.float32)})
    p = str(tmp_path / "big.parquet")
    tio.write_parquet(port, p)
    back = tio.read_parquet(p)
    assert back.num_blocks == 1 and back.nrows == 1_500_000
    assert jio.read_parquet(p).offsets == back.offsets


@pytest.mark.parametrize(
    "fmt,per_frame", [("ipc", 1), ("ipc", 3), ("parquet", 1), ("parquet", 2)]
)
def test_stream_generators(fmt, per_frame, tmp_path):
    write = tio.write_arrow_ipc if fmt == "ipc" else tio.write_parquet
    stream = tio.stream_arrow_ipc if fmt == "ipc" else tio.stream_parquet
    jstream = jio.stream_arrow_ipc if fmt == "ipc" else jio.stream_parquet
    data = _data(20, seed=3)
    port = tft.TensorFrame.from_dict(data, num_blocks=5)
    p = str(tmp_path / f"s.{fmt}")
    write(port, p)
    it = stream(p, per_frame)
    first = next(it)  # lazy: one group decoded at a time
    frames = [first] + list(it)
    refs = list(jstream(p, per_frame))
    assert [f.nrows for f in frames] == [r.nrows for r in refs]
    assert sum(f.nrows for f in frames) == 20
    for f, r in zip(frames, refs):
        _assert_same_frame(f, r)
    with pytest.raises(ValueError, match=">= 1"):
        stream(p, 0)
    # a list of paths and a directory are multi-file datasets: the ingest
    # pipeline yields the same frames as the JAX package's
    twice = list(stream([p, p], per_frame))
    jtwice = list(jstream([p, p], per_frame))
    assert [f.nrows for f in twice] == [r.nrows for r in jtwice] == [f.nrows for f in frames] * 2
    for f, r in zip(twice, jtwice):
        _assert_same_frame(f, r)
    by_dir = list(tio.stream_dataset(str(tmp_path), chunk_groups=per_frame))
    assert [f.nrows for f in by_dir] == [f.nrows for f in frames]


def test_read_frame_is_on_the_host_until_moved(tmp_path):
    p = str(tmp_path / "h.arrow")
    tio.write_arrow_ipc(tft.TensorFrame.from_dict(_data(), num_blocks=2), p)
    back = tio.read_arrow_ipc(p)
    assert all(back[c].device is None for c in back.columns)
    moved = back.to_device(CPU)
    assert moved["x"].device is not None and moved["s"].device is None
