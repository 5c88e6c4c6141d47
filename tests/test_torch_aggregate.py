"""PyTorch port: `group_by` + `aggregate` held to the JAX package on the CPU.

Mirrors `tests/test_verbs.py::TestAggregate` (numeric, string, mixed and
NaN keys), `TestMultiKeyAggregate`, `GroupedFrame.agg` and the plan choice
of `TestAggregateChunked` under the default config. The reference is the JAX package's unmeshed
plan: its meshed mean/variance test fails in the reference itself.
Both packages emit the distinct keys in sorted order (a NaN key last), so
the outputs compare row by row. Tolerances:
- keys, integer results, min and max: exact;
- float sums and means: rtol 1e-6 (float64) / 1e-5 (float32), because
  the segment plan sums in a different order than the reference.
"""

import sys

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.frame import factorize_keys
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

CPU = "cpu"
_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-6}


def _compare(ref, out, exact=()):
    assert out.columns == ref.columns
    for c in ref.columns:
        r, o = np.asarray(ref.host_values(c)), out.host_values(c)
        assert (o.shape, o.dtype) == (r.shape, r.dtype), c
        if r.dtype.kind in "OUS":  # string keys: host values, in the same order
            assert out[c].device is None and o.tolist() == r.tolist(), c
        elif r.dtype.kind in "biu" or c in exact:
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, rtol=_RTOL[r.dtype], atol=0)


def _aggregate_both(data, keys, prog, feed_dict=None, num_blocks=3):
    jdf = tfs.TensorFrame.from_dict(data, num_blocks=num_blocks)
    tdf = tft.TensorFrame.from_dict(data, num_blocks=num_blocks)
    ref = tfs.aggregate(prog(jdsl, jdf), tfs.group_by(jdf, *keys), feed_dict=feed_dict)
    reset_stats()
    out = tft.aggregate(prog(tdsl, tdf), tft.group_by(tdf, *keys), feed_dict=feed_dict, device=CPU)
    return ref, out


def _reduce(op, col="x", out=None):
    def prog(d, f):
        return getattr(d, f"reduce_{op}")(d.block(f, col, tf_name=f"{out or col}_input"),
                                          axes=[0]).named(out or col)
    return prog


def _keyed(n=200, nkeys=7, dtype=np.float64, key_dtype=np.int64, cols=None, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nkeys, n).astype(key_dtype)
    shape = (n,) if cols is None else (n, cols)
    vals = (rng.standard_normal(shape) * 5).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        vals = rng.integers(-100, 100, shape).astype(dtype)
    return {"k": keys, "x": vals}


_SEGMENT_CASES = [
    (op, dt, cols)
    for op in ("sum", "min", "max", "mean")
    for dt in (np.float32, np.float64, np.int32, np.int64)
    for cols in (None, 3)
    if not (op == "mean" and np.issubdtype(dt, np.integer))
]


@pytest.mark.parametrize(
    "op,dtype,cols", _SEGMENT_CASES,
    ids=[f"{o}-{np.dtype(d).name}-{c}" for o, d, c in _SEGMENT_CASES],
)
def test_segment_plan_matches_reference(op, dtype, cols):
    ref, out = _aggregate_both(_keyed(dtype=dtype, cols=cols), ["k"], _reduce(op))
    # a sum or mean takes the keyed sums, the plain version on the CPU
    sums = {"aggregate.segment.torch": 1.0} if op in ("sum", "mean") else {}
    assert stats() == {"aggregate.plan.segment": 1.0, **sums}
    _compare(ref, out, exact=("x",) if op in ("min", "max") else ())


def test_segment_plan_prod_and_transform_then_reduce():
    data = _keyed(n=60, nkeys=4)
    data["x"] = (1 + data["x"] / 50).astype(np.float64)

    def prog(d, f):
        xi = d.block(f, "x", tf_name="x_input")
        qi = d.block(f, "x", tf_name="q_input")
        p = d._nary("Prod", [xi, d.constant(np.array([0], np.int32))]).named("x")
        q = d.reduce_sum(d.square(qi) * 0.5 + 1.0, axes=[0]).named("q")
        return [p, q]

    ref, out = _aggregate_both(data, ["k"], prog, feed_dict={"q_input": "x"})
    assert stats() == {"aggregate.plan.segment": 1.0, "aggregate.segment.torch": 1.0}
    _compare(ref, out)


def test_mean_and_variance_of_float_vectors():
    """BASELINE config 4's graph at a small size: Mean(v) and
    Mean(Square(v)) per key, in one segment-plan pass."""
    n, dim = 1000, 8
    rng = np.random.RandomState(0)
    data = {"k": (np.arange(n) % 16).astype(np.int64), "v": rng.rand(n, dim).astype(np.float32)}

    def prog(d, f):
        m = d.reduce_mean(d.block(f, "v", tf_name="m_input"), axes=[0]).named("m")
        q = d.reduce_mean(d.square(d.block(f, "v", tf_name="q_input")), axes=[0]).named("q")
        return [m, q]

    ref, out = _aggregate_both(data, ["k"], prog, feed_dict={"m_input": "v", "q_input": "v"})
    assert stats() == {"aggregate.plan.segment": 1.0, "aggregate.segment.torch": 1.0}
    _compare(ref, out)
    var = out.host_values("q") - out.host_values("m") ** 2
    for k in range(16):
        np.testing.assert_allclose(var[k], data["v"][data["k"] == k].var(0), rtol=1e-3)


def _div_root(d, f):
    xi = d.block(f, "x", tf_name="x_input")
    return (d.reduce_sum(xi, axes=[0]) / d.reduce_max(xi, axes=[0])).named("x")


def _int_range(d, f):
    xi = d.block(f, "x", tf_name="x_input")
    return (d.reduce_max(xi, axes=[0]) - d.reduce_min(xi, axes=[0])).named("x")


def _identity_min(d, f):
    return d.identity(d.reduce_min(d.block(f, "x", tf_name="x_input"), axes=[0])).named("x")


@pytest.mark.parametrize(
    "name,prog,dtype",
    [
        ("div_root", _div_root, np.float64),
        ("div_root_f32", _div_root, np.float32),
        ("identity_wrapped_min", _identity_min, np.float64),
        ("integer_mean_truncates", _reduce("mean"), np.int64),
        ("int_range_sub_root", _int_range, np.int32),
    ],
)
def test_exact_plan_matches_reference(name, prog, dtype):
    # uneven group sizes: several vmapped calls, one per distinct size
    rng = np.random.default_rng(1)
    sizes = [1, 2, 2, 5, 3, 8, 1, 13]
    keys = np.repeat(np.arange(len(sizes)) * 3 - 4, sizes).astype(np.int64)
    rng.shuffle(keys)
    x = (rng.standard_normal(len(keys)) * 4 + 10).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        x = rng.integers(0, 50, len(keys)).astype(dtype)
    ref, out = _aggregate_both({"k": keys, "x": x}, ["k"], prog)
    assert stats() == {"aggregate.plan.exact": 1.0}
    _compare(ref, out, exact=("x",) if "min" in name else ())


def test_grouped_sum():
    data = {"key": np.array([1, 1, 2, 2, 2], np.int64), "x": np.array([1.0, 2.0, 10.0, 20.0, 30.0])}
    ref, out = _aggregate_both(data, ["key"], _reduce("sum"), num_blocks=1)
    assert dict(zip(out.host_values("key").tolist(), out.host_values("x").tolist())) == {
        1: 3.0, 2: 60.0}
    _compare(ref, out)


def test_grouped_vector_sum_two_outputs():
    data = {"k": np.array([0, 1, 0, 1], np.int64), "v": np.arange(8.0).reshape(4, 2),
            "cnt": np.ones(4)}

    def prog(d, f):
        return [_reduce("sum", "v")(d, f), _reduce("sum", "cnt")(d, f)]

    ref, out = _aggregate_both(data, ["k"], prog, num_blocks=1)
    assert out.columns == ["k", "cnt", "v"]
    np.testing.assert_array_equal(out.host_values("v")[0], [4.0, 6.0])
    _compare(ref, out)


@pytest.mark.parametrize(
    "keys,key_data",
    [
        (["a", "b"], {"a": np.array([0, 0, 1, 1, 0]), "b": np.array([0, 1, 0, 1, 0])}),
        (["g", "h"], {"g": np.array([1.5, 1.5, 2.5, -1.0, 2.5]), "h": np.array([7, 8, 7, 7, 7])}),
        (["a", "b", "c"], {"a": np.array([0, 0, 0, 1, 1]), "b": np.array([0, 0, 1, 0, 0]),
                           "c": np.array([5, 5, 5, 5, 5], np.int32)}),
    ],
    ids=["two_int_keys", "float_and_int_keys", "three_keys"],
)
def test_multi_key(keys, key_data):
    data = dict(key_data, x=np.arange(10.0).reshape(5, 2))
    for prog in (_reduce("sum"), _div_root):
        ref, out = _aggregate_both(data, keys, prog, num_blocks=2)
        _compare(ref, out)


@pytest.mark.parametrize("prog", [_reduce("sum"), _div_root], ids=["segment", "exact"])
def test_nan_keys_are_one_group_sorted_last(prog):
    k = np.array([2.0, np.nan, 1.0, np.nan, 2.0, -0.5, np.nan])
    data = {"k": k, "x": np.arange(7.0) + 1}
    ref, out = _aggregate_both(data, ["k"], prog, num_blocks=2)
    np.testing.assert_array_equal(out.host_values("k"), [-0.5, 1.0, 2.0, np.nan])
    _compare(ref, out)


def test_nan_keys_with_a_second_key():
    data = {"g": np.array([np.nan, 1.0, np.nan, 1.0]), "h": np.array([1, 1, 1, 2]),
            "x": np.arange(4.0)}
    ref, out = _aggregate_both(data, ["g", "h"], _reduce("sum"), num_blocks=1)
    _compare(ref, out)


def test_empty_frame():
    data = {"k": np.zeros(0, np.int64), "x": np.zeros(0)}
    ref, out = _aggregate_both(data, ["k"], _reduce("sum"), num_blocks=1)
    assert out.nrows == ref.nrows == 0
    assert stats() == {"aggregate.plan.exact": 1.0}
    _compare(ref, out)


def test_non_scalar_key_rejected():
    tdf = tft.TensorFrame.from_dict({"k": np.ones((3, 2)), "x": np.arange(3.0)})
    with pytest.raises(ValueError, match="scalar"):
        tft.group_by(tdf, "k")


def test_results_stay_on_the_verbs_device():
    data = _keyed(n=20)
    tdf = tft.TensorFrame.from_dict(data)
    out = tft.aggregate(_reduce("sum")(tdsl, tdf), tft.group_by(tdf, "k"), device=CPU)
    assert all(out.column(c).device is not None for c in out.columns)


_STRING_KEYS = {
    "strings": np.array(["b", "a", "c", "a", "b", "b", "d"] * 3, dtype=object),
    "bytes": np.array([b"y", b"x", b"y", b"z"] * 4, dtype=object),
    "fixed_width": np.array(["q", "p", "q", "r", "p"] * 3),
    "with_missing": np.array(["b", None, "a", np.nan, "b", "a", None], dtype=object),
    "strings_and_numbers": np.array(["b", 3, "a", 1, "b", 2.5, 3], dtype=object),
}


@pytest.mark.parametrize("name", list(_STRING_KEYS))
def test_factorize_keys_refuses_strings_naming_the_queue(name, monkeypatch):
    """String and object keys factorize on the host into the reference's
    codes and sorted key order (None and NaN one key, last; numbers before
    strings), with pandas and with pandas hidden, as on the card's
    machine."""
    keys = _STRING_KEYS[name]
    import pandas as pd

    want_codes, want_uniq = pd.factorize(keys, sort=True, use_na_sentinel=False)
    for hide in (False, True):
        if hide:
            monkeypatch.setitem(sys.modules, "pandas", None)
        key_out, inverse = factorize_keys(["s"], [keys], torch.device(CPU))
        assert inverse.dtype == torch.int64 and inverse.device == torch.device(CPU)
        np.testing.assert_array_equal(inverse.numpy(), want_codes)
        got = key_out["s"]
        assert got.dtype == np.asarray(want_uniq).dtype
        assert [x if x == x else "nan" for x in got.tolist()] == [
            x if x == x else "nan" for x in np.asarray(want_uniq).tolist()]
    if name in ("strings", "bytes", "fixed_width"):
        data = {"k": keys, "x": np.arange(len(keys), dtype=np.float64)}
        for prog in (_reduce("sum"), _div_root):
            ref, out = _aggregate_both(data, ["k"], prog, num_blocks=2)
            _compare(ref, out)


@pytest.mark.parametrize("prog,exact", [(_reduce("sum"), ()), (_reduce("max"), ("x",)),
                                        (_div_root, ())], ids=["segment", "segment_max", "exact"])
def test_string_keys(prog, exact):
    rng = np.random.default_rng(5)
    ids = np.array([f"user_{i:03d}" for i in range(40)], dtype=object)
    data = {"k": ids[rng.integers(0, 40, 300)], "x": rng.uniform(0.5, 1.5, (300, 2))}
    ref, out = _aggregate_both(data, ["k"], prog)
    _compare(ref, out, exact=exact)
    assert out.host_values("k").tolist() == sorted(set(data["k"]))


def test_string_keys_with_missing_values():
    data = {"k": np.array(["b", None, "a", "b", None, "a", "c"], dtype=object),
            "x": np.arange(7.0)}
    ref, out = _aggregate_both(data, ["k"], _reduce("sum"), num_blocks=2)
    keys = out.host_values("k").tolist()
    assert keys[:3] == ["a", "b", "c"] and np.isnan(keys[3])
    np.testing.assert_array_equal(out.host_values("x"), [7.0, 3.0, 6.0, 5.0])
    np.testing.assert_array_equal(out.host_values("x"), np.asarray(ref["x"].values))


@pytest.mark.parametrize("prog", [_reduce("sum"), _div_root], ids=["segment", "exact"])
def test_mixed_string_and_int_keys(prog):
    data = {"a": np.array(["p", "q", "p", "q", "p"], dtype=object),
            "b": np.array([1, 1, 2, 1, 1], dtype=np.int64), "x": np.arange(5.0) + 1}
    ref, out = _aggregate_both(data, ["a", "b"], prog, num_blocks=2)
    _compare(ref, out)
    assert [tuple(r) for r in out.to_pandas().to_numpy()] == [
        tuple(r) for r in ref.to_pandas().to_numpy()]
    ref, out = _aggregate_both(data, ["b", "a"], prog, num_blocks=2)
    _compare(ref, out)


def test_empty_string_keyed_aggregate():
    data = {"k": np.array([], dtype=object), "x": np.zeros(0)}
    dtypes_j, dtypes_t = {"k": tfs.ScalarType.string}, {"k": tft.ScalarType.string}
    jdf = tfs.TensorFrame.from_dict(data, dtypes=dtypes_j)
    tdf = tft.TensorFrame.from_dict(data, dtypes=dtypes_t)
    probe_j, probe_t = (m.TensorFrame.from_dict({"x": np.zeros(4)}) for m in (tfs, tft))
    ref = tfs.aggregate(_reduce("sum")(jdsl, probe_j), tfs.group_by(jdf, "k"))
    out = tft.aggregate(_reduce("sum")(tdsl, probe_t), tft.group_by(tdf, "k"), device=CPU)
    assert out.nrows == ref.nrows == 0
    assert out.columns == ref.columns == ["k", "x"]
    assert out["k"].dtype is tft.ScalarType.string
    assert out.host_values("x").dtype == np.float64


@pytest.mark.parametrize("key", ["k", "s"])
def test_grouped_agg_specs(key):
    rng = np.random.default_rng(6)
    data = {"k": rng.integers(0, 5, 60), "s": np.array(list("xyz"), dtype=object)[rng.integers(0, 3, 60)],
            "x": rng.uniform(0.5, 1.5, 60), "v": rng.uniform(0.5, 1.5, (60, 2)).astype(np.float32)}
    jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
    tdf = tft.TensorFrame.from_dict(data, num_blocks=3)
    specs = dict(total=("sum", "x"), avg=("mean", "v"), lo=("min", "x"), hi=("max", "v"))
    ref = tfs.group_by(jdf, key).agg(**specs)
    reset_stats()
    out = tft.group_by(tdf, key).agg(device=CPU, **specs)
    assert stats() == {"aggregate.plan.segment": 1.0, "aggregate.segment.torch": 1.0}
    _compare(ref, out, exact=("lo", "hi"))


def test_grouped_agg_spec_errors():
    tdf = tft.TensorFrame.from_dict({"k": np.arange(3), "x": np.arange(3.0)})
    with pytest.raises(ValueError, match="not one of"):
        tft.group_by(tdf, "k").agg(device=CPU, m=("median", "x"))
    with pytest.raises(TypeError, match="pair"):
        tft.group_by(tdf, "k").agg(device=CPU, m="x")
