"""PyTorch port: `reduce_rows` held to the JAX package on the CPU.

Mirrors `tests/test_verbs.py::TestReduceRows` and runs both of the port's
plans: the monoid plan (a fetch that is Add/AddV2/Mul/Maximum/Minimum of
exactly ``x_1`` and ``x_2``, one torch reduction per block) and the general
plan (the pair graph once per row). Tolerances:
- integer results, min and max: exact;
- the general plan runs the reference's fold order: float results within
  rtol 1e-6 (float64) / 1e-5 (float32), in practice equal;
- float sums and products of the monoid plan: rtol 1e-6 (float64) / 1e-5
  (float32), because the summation order differs.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.frame import Column, TensorFrame
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

CPU = "cpu"
_RTOL = {np.float32: 1e-5, np.float64: 1e-6}


def _data(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    return (rng.standard_normal(shape) * 3).astype(dtype)


def _pair(d, dtype, cell, op, name="x"):
    st = d.ScalarType.from_np_dtype(np.dtype(dtype))
    x1 = d.placeholder(st, d.Shape(cell), name=f"{name}_1")
    x2 = d.placeholder(st, d.Shape(cell), name=f"{name}_2")
    return op(d, x1, x2).named(name)


_OPS = {
    "add": lambda d, a, b: d.add(a, b),
    "mul": lambda d, a, b: d.mul(a, b),
    "max": lambda d, a, b: d._nary("Maximum", [a, b]),
    "min": lambda d, a, b: d._nary("Minimum", [b, a]),
    "half_carry_plus_row": lambda d, a, b: a * 0.5 + b,
    "div": lambda d, a, b: d.div(a, b),
    "max_of_abs": lambda d, a, b: d._nary("Maximum", [a, d._nary("Abs", [b])]),
}
_MONOID = {"add", "mul", "max", "min"}


def _both(op, data, num_blocks, cell=(), offsets=None):
    dtype = data.dtype.type
    jdf = tfs.TensorFrame.from_dict({"x": data}, num_blocks=num_blocks)
    tdf = (
        TensorFrame([Column("x", data)], offsets)
        if offsets is not None
        else tft.TensorFrame.from_dict({"x": data}, num_blocks=num_blocks)
    )
    ref = tfs.reduce_rows(_pair(jdsl, dtype, cell, _OPS[op]), jdf)
    reset_stats()
    out = tft.reduce_rows(_pair(tdsl, dtype, cell, _OPS[op]), tdf, device=CPU)
    return np.asarray(ref), out


def _assert_matches(out, ref, dtype, exact):
    assert isinstance(out, torch.Tensor)
    got = out.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if exact or np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=_RTOL[dtype], atol=0)


_CASES = [
    (op, dt, cell)
    for op in _OPS
    for dt in (np.float32, np.float64, np.int32, np.int64)
    for cell in ((), (3,))
    if not (op in ("half_carry_plus_row", "div") and np.issubdtype(dt, np.integer))
]


@pytest.mark.parametrize(
    "op,dtype,cell", _CASES, ids=[f"{o}-{np.dtype(d).name}-{len(c)}d" for o, d, c in _CASES]
)
def test_both_plans_match_reference(op, dtype, cell):
    data = _data(dtype, (29,) + cell)
    if op == "mul":
        data = (np.sign(data) * (1 + np.abs(data) % 2)).astype(dtype) if np.issubdtype(
            dtype, np.integer) else (1 + data / 40).astype(dtype)
    if op == "div":
        data = np.where(np.abs(data) < 0.5, 1.5, data).astype(dtype)
    ref, out = _both(op, data, num_blocks=4, cell=cell)
    plan = "monoid" if op in _MONOID else "general"
    assert stats() == {f"reduce_rows.plan.{plan}": 1.0}
    _assert_matches(out, ref, dtype, exact=op in ("max", "min", "max_of_abs"))


def test_pairwise_sum():
    ref, out = _both("add", np.arange(5.0), num_blocks=2)
    assert float(out) == float(ref) == 10.0


def test_single_row_frame():
    ref, out = _both("add", np.array([7.0]), num_blocks=1)
    assert float(out) == 7.0


def test_left_fold_order():
    # non-associative: (8/4)/2, the reference's oracle
    ref, out = _both("div", np.array([8.0, 4.0, 2.0]), num_blocks=1)
    assert float(out) == float(ref) == (8.0 / 4.0) / 2.0
    assert stats() == {"reduce_rows.plan.general": 1.0}


def test_block_partials_fold_left_in_block_order():
    # 0.5 * carry + row over 3 blocks: the partials fold left in block
    # order, which a tree combine or one fold over all rows would break
    data = np.arange(1.0, 10.0)
    ref, out = _both("half_carry_plus_row", data, num_blocks=3)
    parts = []
    for blk in np.split(data, 3):
        acc = blk[0]
        for v in blk[1:]:
            acc = 0.5 * acc + v
        parts.append(acc)
    want = parts[0]
    for p in parts[1:]:
        want = 0.5 * want + p
    assert float(out) == float(ref) == want


@pytest.mark.parametrize("op", ["add", "half_carry_plus_row"])
def test_empty_and_single_row_blocks(op):
    # blocks: [], [0,1,2], [], [3], [4,5]: empty blocks are skipped and a
    # single-row block's partial is its row
    data = np.array([3.0, -1.0, 2.0, 5.0, 0.5, 4.0])
    offsets = [0, 0, 3, 3, 4, 6]
    jdf = tfs.frame.TensorFrame([tfs.frame.Column("x", data)], offsets=offsets)
    ref = tfs.reduce_rows(_pair(jdsl, np.float64, (), _OPS[op]), jdf)
    out = tft.reduce_rows(
        _pair(tdsl, np.float64, (), _OPS[op]), TensorFrame([Column("x", data)], offsets),
        device=CPU,
    )
    assert float(out) == float(np.asarray(ref))


def test_empty_frame_raises():
    tdf = tft.TensorFrame.from_dict({"x": np.zeros(0)})
    with pytest.raises(ValueError, match="empty frame"):
        tft.reduce_rows(_pair(tdsl, np.float64, (), _OPS["add"]), tdf, device=CPU)


def test_two_fetches_return_a_dict():
    data = {"a": _data(np.int64, (17,)), "b": _data(np.float64, (17, 2), seed=1)}
    jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
    tdf = tft.TensorFrame.from_dict(data, num_blocks=3)

    def prog(d):
        return [_pair(d, np.int64, (), _OPS["max"], "a"), _pair(d, np.float64, (2,), _OPS["add"], "b")]

    ref = tfs.reduce_rows(prog(jdsl), jdf)
    out = tft.reduce_rows(prog(tdsl), tdf, device=CPU)
    assert sorted(out) == ["a", "b"]
    _assert_matches(out["a"], np.asarray(ref["a"]), np.int64, True)
    _assert_matches(out["b"], np.asarray(ref["b"]), np.float64, False)


def test_convention_enforced():
    tdf = tft.TensorFrame.from_dict({"x": np.arange(3.0)})
    x1 = tdsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x_1")
    bad = tdsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="other")
    with pytest.raises(ValueError, match="convention"):
        tft.reduce_rows(tdsl.add(x1, bad).named("x"), tdf, device=CPU)


def test_carry_and_row_must_read_one_column():
    tdf = tft.TensorFrame.from_dict({"x": np.arange(3.0), "y": np.arange(3.0)})
    with pytest.raises(ValueError, match="same column"):
        tft.reduce_rows(
            _pair(tdsl, np.float64, (), _OPS["add"]), tdf, feed_dict={"x_2": "y"}, device=CPU
        )
