"""PyTorch port: ragged and string columns, pandas/Arrow interchange and the
schema utilities, held to the JAX package on the CPU.

The same seeded numpy inputs build a frame in `tensorframes_tpu` and in
`tensorframes_tpu_torch`; the port runs with ``device="cpu"``. Everything
here is exact: cells, shapes, dtypes, offsets, strings and the text of
`explain`. The one float computation (the verbs' pandas in/out) compares
float64 results at rtol 1e-12.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

CPU = "cpu"


def _ragged(n=9, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(k)).astype(dtype) for k in rng.integers(1, 6, n)]


def _mixed(n=9, seed=0):
    """A frame's worth of columns: dense scalar and vector, ragged, string."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal(n),
        "v": rng.standard_normal((n, 3)).astype(np.float32),
        "r": _ragged(n, seed),
        "s": np.array([f"id_{i % 4}" for i in range(n)], dtype=object),
    }


def _assert_same_column(port_col, ref_col):
    assert port_col.is_dense == ref_col.is_dense
    assert (port_col.dtype.value, repr(port_col.cell_shape)) == (
        ref_col.dtype.value, repr(ref_col.cell_shape))
    assert len(port_col) == len(ref_col)
    if port_col.is_dense:
        got, want = port_col.host_values(), np.asarray(ref_col.host_values())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        for got, want in zip(port_col.rows(), ref_col.rows()):
            got, want = np.asarray(got), np.asarray(want)
            assert got.shape == want.shape
            if want.dtype.kind in "USO":
                assert got.tolist() == want.tolist()
            else:
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def _assert_same_frame(port, ref):
    assert port.columns == ref.columns
    assert port.offsets == [int(o) for o in ref.offsets]
    for c in ref.columns:
        _assert_same_column(port[c], ref[c])


def _both(data, **kw):
    return tft.TensorFrame.from_dict(data, **kw), tfs.TensorFrame.from_dict(data, **kw)


class TestColumn:
    @pytest.mark.parametrize(
        "data,dtype",
        [
            ([np.ones(3), np.zeros(3)], None),
            ([np.ones(2), np.zeros(3)], None),
            ([np.ones((2, 4)), np.zeros((3, 4))], None),
            ([np.arange(2), np.arange(5)], "float32"),
            ([1, 2, 3], "int32"),
            ([1.5, 2.5], None),
            ([[1.0, 2.0], [3.0, 4.0]], None),
            (["ab", "cde"], None),
            ([b"a", b"bb"], "string"),
            (np.array(["a", "bc"]), None),
            (np.array(["p", 3, "q"], dtype=object), None),
            ([], "float64"),
            ([], "string"),
        ],
        ids=["uniform", "ragged", "ragged_rank2", "ragged_coerced", "bulk_int32",
             "bulk_float", "bulk_rank1", "strings", "bytes", "fixed_width_strings",
             "mixed_objects", "empty_float", "empty_string"],
    )
    def test_forms_match_reference(self, data, dtype):
        port = tft.Column("c", data, None if dtype is None else getattr(tft.ScalarType, dtype))
        ref = tfs.Column("c", data, None if dtype is None else getattr(tfs.ScalarType, dtype))
        _assert_same_column(port, ref)
        assert port.device is None

    def test_rank_mismatch(self):
        for mod in (tft, tfs):
            with pytest.raises(ValueError, match="rank"):
                mod.Column("x", [np.ones(2), np.zeros((2, 2))])

    def test_empty_ragged_needs_a_dtype(self):
        for mod in (tft, tfs):
            with pytest.raises(ValueError, match="needs a dtype"):
                mod.Column("x", [])

    def test_bulk_path_never_aliases_caller_memory(self):
        s = pd.Series([1.0, 2.0, 3.0])
        lst = [np.array([1.0, 2.0]), np.array([3.0, 4.0])]
        c, r = tft.Column("x", s), tft.Column("r", lst)
        s.iloc[0] = 99.0
        lst[0][0] = 99.0
        assert float(c.values[0]) == 1.0 and float(r.values[0, 0]) == 1.0
        assert not np.shares_memory(c.values, s.to_numpy())
        assert c.values.dtype == tfs.Column("x", pd.Series([1.0, 2.0, 3.0])).values.dtype

    def test_generator_consumed_once(self):
        c = tft.Column("x", (np.array([i, i + 1.0]) for i in range(3)))
        assert c.is_dense and c.values.shape == (3, 2)

    def test_row_rows_and_with_info(self):
        data = _ragged(5)
        port, ref = tft.Column("r", data), tfs.Column("r", data)
        for i in range(5):
            np.testing.assert_array_equal(port.row(i), ref.row(i))
        info = tft.ColumnInfo("q", port.dtype, tft.Shape((None,)))
        renamed = port.with_info(info)
        assert renamed.name == "q" and renamed.ragged is port.ragged
        s = tft.Column("s", ["a", "bb"])
        assert [str(x) for x in s.rows()] == ["a", "bb"] and str(s.row(1)) == "bb"

    def test_ragged_host_values_refused(self):
        with pytest.raises(ValueError, match="ragged"):
            tft.Column("r", _ragged(4)).host_values()

    def test_string_host_values_is_the_object_vector(self):
        data = np.array(["b", "a", None], dtype=object)
        port, ref = tft.Column("s", data), tfs.Column("s", data)
        assert port.host_values().dtype == object
        assert port.host_values().tolist() == ref.host_values().tolist()


class TestFrameMethods:
    def test_blocks_of_ragged_and_string_columns(self):
        port, ref = _both(_mixed(11), num_blocks=3)
        _assert_same_frame(port, ref)
        for pb, rb in zip(port.blocks(), ref.blocks()):
            _assert_same_frame(pb, rb)

    def test_analyze_and_append_shape(self):
        data = {"a": [np.ones((2, 5)), np.ones((3, 5))], "b": [np.ones(3), np.ones(3)]}
        port, ref = _both(data)
        _assert_same_frame(port.analyze(), ref.analyze())
        assert repr(tft.analyze(port).info) == repr(tfs.analyze(ref).info)
        p2 = tft.append_shape(port, "a", [None, 5])
        r2 = tfs.append_shape(ref, "a", [None, 5])
        assert repr(p2.info) == repr(r2.info)
        assert p2["a"].ragged is port["a"].ragged

    def test_from_rows_with_columns_select_collect(self):
        rows = [{"x": float(i), "r": np.arange(i + 1.0), "s": f"k{i}"} for i in range(4)]
        port, ref = tft.TensorFrame.from_rows(rows, num_blocks=2), tfs.TensorFrame.from_rows(
            rows, num_blocks=2)
        _assert_same_frame(port, ref)
        extra = np.arange(4) * 10
        port = port.with_columns([tft.Column("e", extra), tft.Column("x", -extra)])
        ref = ref.with_columns([tfs.Column("e", extra), tfs.Column("x", -extra)])
        _assert_same_frame(port.select(["s", "e", "x"]), ref.select(["s", "e", "x"]))
        for pr, rr in zip(port.collect(), ref.collect()):
            assert pr.keys() == rr.keys()
            for k in pr:
                np.testing.assert_array_equal(np.asarray(pr[k]), np.asarray(rr[k]))

    def test_to_device_keeps_string_and_ragged_on_the_host(self):
        port = tft.TensorFrame.from_dict(_mixed(6), num_blocks=2)
        moved = port.to_device(CPU)
        assert isinstance(moved["x"].values, torch.Tensor)
        assert isinstance(moved["v"].values, torch.Tensor)
        assert moved["r"] is port["r"] and moved["s"] is port["s"]
        assert moved["r"].device is None and moved["s"].device is None
        fixed = tft.TensorFrame.from_dict({"u": np.array(["a", "b"])}).to_device(CPU)
        assert isinstance(fixed["u"].values, np.ndarray)

    def test_to_host_and_the_host_sync_count(self):
        port = tft.TensorFrame.from_dict(_mixed(6)).to_device(CPU)
        reset_stats()
        host = port.to_host()
        assert stats() == {"host_sync": 2.0}  # the two dense columns, once each
        assert isinstance(host["x"].values, np.ndarray) and host["x"].values.dtype == np.float64
        port.host_values("x")
        port.collect()
        assert stats() == {"host_sync": 2.0}  # cached
        _assert_same_frame(host, tfs.TensorFrame.from_dict(_mixed(6)))

    @pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
    def test_pad_ragged_matches_reference(self, dtype):
        data = {"r": _ragged(13, seed=3, dtype=dtype), "x": np.arange(13.0)}
        port, ref = _both(data, num_blocks=2)
        for kw in ({}, {"length_col": "n"}):
            p, r = port.pad_ragged("r", **kw), ref.pad_ragged("r", **kw)
            assert p.columns == r.columns
            for c in r.columns:
                want = np.asarray(r[c].values)
                assert p[c].values.dtype == want.dtype
                np.testing.assert_array_equal(p[c].values, want)
        assert port.pad_ragged("x") is port
        with pytest.raises(ValueError, match="rank-1"):
            tft.TensorFrame.from_dict({"m": [np.ones((1, 2)), np.ones((2, 2))]}).pad_ragged("m")

    def test_to_pandas_matches_reference(self):
        data = _mixed(7)
        data["b"] = np.arange(7) % 2 == 0
        port, ref = _both(data, num_blocks=2)
        pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas())
        pd.testing.assert_frame_equal(port.to_device(CPU).to_pandas(), ref.to_pandas())

    def test_from_pandas_matches_reference(self):
        pdf = pd.DataFrame({
            "x": [1.0, 2.0, 3.0], "y": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]],
            "r": [[1.0], [2.0, 3.0], []], "s": ["a", "bb", "c"], "i": [1, 2, 3],
        })
        _assert_same_frame(tft.TensorFrame.from_pandas(pdf, num_blocks=2),
                           tfs.TensorFrame.from_pandas(pdf, num_blocks=2))

    def test_to_arrow_matches_reference(self):
        data = _mixed(8)
        data["m"] = np.arange(16.0).reshape(8, 2, 1)
        port, ref = _both(data)
        assert port.to_arrow().equals(ref.to_arrow())
        assert port.to_device(CPU).to_arrow().equals(ref.to_arrow())

    def test_from_arrow_matches_reference(self):
        table = pa.table({
            "x": pa.array([1.5, 2.5, 3.5]),
            "f": pa.FixedSizeListArray.from_arrays(pa.array(np.arange(6.0)), 2),
            "l": pa.array([[1, 2], [3], [4, 5, 6]]),
            "s": pa.array(["a", None, "c"]),
        })
        _assert_same_frame(tft.TensorFrame.from_arrow(table), tfs.TensorFrame.from_arrow(table))
        _assert_same_frame(tft.TensorFrame.from_arrow(table, num_blocks=2),
                           tfs.TensorFrame.from_arrow(table, num_blocks=2))


class TestSchemaUtilities:
    def test_explain_and_explain_detailed(self):
        port, ref = _both(_mixed(5))
        assert tft.explain(port) == tfs.explain(ref)
        info = tft.explain_detailed(port)
        assert isinstance(info, tft.FrameInfo)
        assert info.names == ["x", "v", "r", "s"]
        assert repr(info) == repr(tfs.explain_detailed(ref))
        assert info["s"].dtype is tft.ScalarType.string

    @pytest.mark.parametrize("nrows,blocks", [(6, 2), (5, 2), (7, 3)], ids=["equal", "unequal", "three"])
    def test_block_to_row(self, nrows, blocks):
        data = {"x": np.arange(float(nrows)), "v": np.arange(2.0 * nrows).reshape(nrows, 2)}
        port, ref = _both(data, num_blocks=blocks)
        _assert_same_frame(tft.block_to_row(port), tfs.block_to_row(ref))
        _assert_same_frame(tft.block_to_row(port.to_device(CPU)), tfs.block_to_row(ref))

    def test_block_to_row_refuses_ragged(self):
        port = tft.TensorFrame.from_dict({"r": _ragged(4)})
        with pytest.raises(ValueError, match="ragged"):
            tft.block_to_row(port)


def _pdf(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"x": rng.standard_normal(n), "k": rng.integers(0, 3, n)})


class TestPandasInOut:
    def _run(self, mod, d, verb, pdf, **kw):
        ph = mod.block if verb in ("map_blocks", "reduce_blocks") else mod.row
        if verb == "map_blocks":
            return mod.map_blocks((ph(pdf, "x") * 2.0).named("z"), pdf, **kw)
        if verb == "map_rows":
            return mod.map_rows((ph(pdf, "x") + 1.0).named("z"), pdf, **kw)
        if verb == "reduce_blocks":
            return mod.reduce_blocks(
                d.reduce_sum(ph(pdf, "x", tf_name="x_input"), axes=[0]).named("x"), pdf, **kw)
        x1 = d.placeholder(d.ScalarType.float64, d.Shape(()), name="x_1")
        x2 = d.placeholder(d.ScalarType.float64, d.Shape(()), name="x_2")
        return mod.reduce_rows((x1 + x2).named("x"), pdf, **kw)

    @pytest.mark.parametrize("verb", ["map_blocks", "map_rows", "reduce_blocks", "reduce_rows"])
    def test_pandas_in_pandas_out(self, verb):
        pdf = _pdf()
        ref = self._run(tfs, jdsl, verb, pdf)
        out = self._run(tft, tdsl, verb, pdf, device=CPU)
        if isinstance(ref, pd.DataFrame):
            assert isinstance(out, pd.DataFrame)
            pd.testing.assert_frame_equal(out, ref, rtol=1e-12)
        else:
            assert isinstance(out, torch.Tensor)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)

    def test_function_front_end_takes_pandas(self):
        pdf = _pdf()
        ref = tfs.map_blocks(lambda x: {"y": x * 3.0}, pdf)
        out = tft.map_blocks(lambda x: {"y": x * 3.0}, pdf, device=CPU)
        pd.testing.assert_frame_equal(out, ref)


class TestFluentMethods:
    def test_frame_methods(self):
        data = {"x": np.arange(8.0), "k": np.arange(8) % 3}
        port, ref = _both(data, num_blocks=2)
        z = (port.block("x") + 1.0).named("z")
        out = port.map_blocks(z, device=CPU)
        want = ref.map_blocks((ref.block("x") + 1.0).named("z"))
        np.testing.assert_array_equal(out.host_values("z"), np.asarray(want["z"].values))
        rows = port.map_rows((port.row("x") * 2.0).named("y"), device=CPU)
        np.testing.assert_array_equal(rows.host_values("y"), data["x"] * 2.0)
        s = tdsl.reduce_sum(port.block("x", tf_name="x_input"), axes=[0]).named("x")
        assert float(port.reduce_blocks(s, device=CPU)) == 28.0
        x1 = tdsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x_1")
        x2 = tdsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x_2")
        assert float(port.reduce_rows((x1 + x2).named("x"), device=CPU)) == 28.0
        _assert_same_frame(port.block(1), ref.block(1))

    def test_grouped_aggregate_and_agg(self):
        data = {"x": np.arange(9.0), "k": np.array(list("abcabcaab"), dtype=object)}
        port, ref = _both(data)
        s = tdsl.reduce_sum(port.block("x", tf_name="x_input"), axes=[0]).named("x")
        js = jdsl.reduce_sum(ref.block("x", tf_name="x_input"), axes=[0]).named("x")
        got = port.group_by("k").aggregate(s, device=CPU)
        want = ref.group_by("k").aggregate(js)
        assert got.host_values("k").tolist() == want["k"].host_values().tolist()
        np.testing.assert_array_equal(got.host_values("x"), np.asarray(want["x"].values))
        got = port.group_by("k").agg(device=CPU, m=("mean", "x"), hi=("max", "x"))
        want = ref.group_by("k").agg(m=("mean", "x"), hi=("max", "x"))
        assert got.columns == want.columns
        pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas(), rtol=1e-12)
