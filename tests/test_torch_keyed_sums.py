"""PyTorch port: the keyed sums of the segment plans (`ops.keyed_sums`).

On the CPU: the plain version against float64 NumPy sums (group counts
from 1 to 300, rows of 1, 3, 8 and 17 values and cells of rank 2, one to
four outputs, ids outside ``[0, groups)`` dropped, empty groups reading 0
with count 0, two million rows), the kernel's path as a pure function of
device, dtypes and table size, and both segment plans (`aggregate` and
`aggregate(mesh=)`) giving the keys, sums and means of the segment sums
and counts they were built from, with one `bincount` a call and only for
a mean where the kernel does not take the sums.

On a card (marked ``card``, skipped without one): the kernel against the
plain version and float64 at the same cases, at the benchmark cell's shape
(100M rows of 8 float32 values, 16 keys, the values and their squares), the
tile-table layout the kernel plans, its launch counter and the plan's
counters, float64 values, and a table just past the kernel's limit taking
the segment sums. The file imports no JAX,
so the card's machine runs it without the repository's conftest:

    python3 -m pytest tests/test_torch_keyed_sums.py --noconftest -p no:cacheprovider -q
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dsl
from tensorframes_tpu_torch.ops import keyed_sums as ks
from tensorframes_tpu_torch.ops.standard import segment_reduce
from tensorframes_tpu_torch.parallel import data_mesh
from tensorframes_tpu_torch.utils import telemetry
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

from _torch_card import card  # noqa: F401 - the fixture

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _isolated():
    reset_stats()
    telemetry.reset()
    yield
    reset_stats()
    telemetry.reset()


# (groups, cell shape, outputs, dtype): group counts 1 to 300, rows of 1, 3, 8
# and 17 values, cells of rank 2, one to four outputs
_CASES = [
    (g, cell, k, dt)
    for g in (1, 7, 300)
    for cell in ((), (3,), (8,), (17,))
    for k in (1, 2, 4)
    for dt in (F32, F64)
    if (g + len(cell) + k) % 2 == (dt is F64)
] + [(5, (2, 3), 2, F32), (16, (4, 2), 3, F64), (300, (2, 2), 1, F32)]
_IDS = [f"g{g}-w{'x'.join(map(str, c)) or '1'}-k{k}-{str(d)[6:]}" for g, c, k, d in _CASES]


def _inputs(groups, cell, k, dtype, n=997, seed=0):
    """``(values, ids)``: ``k`` tensors of ``n`` rows of ``cell`` drawn
    uniformly from [-2, 2), ids from [-3, groups + 3) so some are dropped."""
    rng = np.random.default_rng(seed)
    values = [torch.from_numpy(rng.uniform(-2, 2, (n,) + cell)).to(dtype) for _ in range(k)]
    ids = torch.from_numpy(rng.integers(-3, groups + 3, n))
    return values, ids


def _float64_sums(values, ids, groups):
    """Per-group sums in float64 and counts, by NumPy; out-of-range ids dropped."""
    ids = ids.cpu().numpy()
    keep = (ids >= 0) & (ids < groups)
    sums = []
    for v in values:
        v = v.cpu().double().numpy()
        s = np.zeros((groups,) + v.shape[1:])
        np.add.at(s, ids[keep], v[keep])
        sums.append(s)
    return sums, np.bincount(ids[keep], minlength=groups)


def _check(tables, counts, values, ids, groups, rtol):
    want, want_counts = _float64_sums(values, ids, groups)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)
    assert counts.dtype == torch.int64
    for t, v, w in zip(tables, values, want):
        assert t.dtype == v.dtype and tuple(t.shape) == (groups,) + tuple(v.shape[1:])
        # a group's sum of |values| bounds the rounding of its sum
        scale = np.abs(w).max() + 1.0
        np.testing.assert_allclose(t.cpu().double().numpy(), w, rtol=rtol, atol=rtol * scale)


_RTOL = {F32: 1e-5, F64: 1e-12}


@pytest.mark.parametrize("groups,cell,k,dtype", _CASES, ids=_IDS)
def test_plain_version_matches_float64(groups, cell, k, dtype):
    values, ids = _inputs(groups, cell, k, dtype)
    tables, counts = ks.keyed_sums_reference(values, ids, groups)
    _check(tables, counts, values, ids, groups, _RTOL[dtype])


def test_plain_version_empty_groups_read_zero():
    values, ids = _inputs(300, (3,), 2, F32, n=50)
    tables, counts = ks.keyed_sums_reference(values, ids, 300)
    empty = np.setdiff1d(np.arange(300), ids.numpy())
    assert len(empty) > 200
    assert (counts.numpy()[empty] == 0).all()
    for t in tables:
        assert (t.numpy()[empty] == 0).all()


def test_plain_version_of_no_rows():
    tables, counts = ks.keyed_sums_reference([torch.zeros(0, 4)], torch.zeros(0, dtype=torch.int64), 3)
    assert counts.tolist() == [0, 0, 0] and tables[0].shape == (3, 4) and not tables[0].any()


def test_plain_version_of_many_rows_loses_no_small_addends():
    """Two million float32 values and their squares into 3 groups, against
    float64: the sums are added in bounded runs, so small addends are not
    rounded away against a large running sum."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((1 << 21, 2)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 3, 1 << 21))
    tables, counts = ks.keyed_sums_reference([x, x * x], ids, 3)
    _check(tables, counts, [x, x * x], ids, 3, 1e-6)


def test_values_and_ids_must_agree():
    with pytest.raises(ValueError, match="against 4 ids"):
        ks.keyed_sums([torch.zeros(5, 2)], torch.zeros(4, dtype=torch.int64), 2)


_PATHS = [
    ("cpu", [F32, F32], 16, [8, 8], False),
    ("cuda", [F32, F32], 16, [8, 8], True),  # the benchmark cell's table
    ("cuda", [F64], 300, [3], True),
    ("cuda", [torch.float16], 16, [8], False),
    ("cuda", [torch.bfloat16], 16, [8], False),
    ("cuda", [torch.int64], 16, [8], False),
    ("cuda", [F32, F64], 16, [8, 8], False),  # one dtype a launch
    ("cuda", [F32], 4096, [1], True),  # 4096 x (1 + 1) = 8192 accumulators
    ("cuda", [F32], 4097, [1], False),  # 8194
    ("cuda", [F32, F32], 1000, [8, 8], False),  # 17,000
    ("cuda", [F32] * 8, 4, [1] * 8, True),
    ("cuda", [F32] * 9, 4, [1] * 9, False),
    ("cuda", [F32], 16, [0], False),
    ("cuda", [F32], 0, [8], False),
]


@pytest.mark.parametrize("device,dtypes,groups,widths,kernel", _PATHS)
def test_path_is_a_function_of_device_dtype_and_table(device, dtypes, groups, widths, kernel):
    assert ks.takes_kernel(torch.device(device), dtypes, groups, widths) is kernel


def test_kernel_refuses_what_it_does_not_take():
    # checked before any launch, so it raises the same way without a card
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ks.keyed_sums([torch.zeros(4, 8, dtype=torch.float16, device="meta")], ids, 2)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_refuses_cpu_tensors(dtype):
    # the segment plans route CPU tensors; the kernel never takes them
    values, ids = _inputs(7, (8,), 2, dtype, n=50)
    before = ks.keyed_sums.launches
    with pytest.raises(ValueError, match="no kernel"):
        ks.keyed_sums(values, ids, 7)
    assert ks.keyed_sums.launches == before


# ---------------------------------------------------------------------------
# the segment plans
# ---------------------------------------------------------------------------


def _frame(n=1000, nkeys=16, width=8, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if width is None else (n, width)
    return {"k": rng.integers(0, nkeys, n).astype(np.int64),
            "v": rng.uniform(0, 1, shape).astype(dtype)}


def _fetches(df):
    s = dsl.reduce_sum(dsl.block(df, "v", tf_name="s_input"), axes=[0]).named("s")
    m = dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
    q = dsl.reduce_mean(dsl.square(dsl.block(df, "v", tf_name="q_input")), axes=[0]).named("q")
    hi = dsl.reduce_max(dsl.block(df, "v", tf_name="hi_input"), axes=[0]).named("hi")
    feed = {"s_input": "v", "m_input": "v", "q_input": "v", "hi_input": "v"}
    return [s, m, q, hi], feed


def _want(data):
    """Keys, sums, means, means of squares and maxima as the parent's segment
    plan built them: a segment sum a fetch, the counts by `bincount`."""
    keys, inverse = np.unique(data["k"], return_inverse=True)
    gid = torch.from_numpy(inverse.astype(np.int64))
    v = torch.from_numpy(data["v"])
    counts = torch.bincount(gid, minlength=len(keys)).to(v.dtype)
    per = counts.reshape((-1,) + (1,) * (v.dim() - 1))
    return {
        "k": keys,
        "s": segment_reduce(v, gid, len(keys), "sum").numpy(),
        "m": (segment_reduce(v, gid, len(keys), "sum") / per).numpy(),
        "q": (segment_reduce(v * v, gid, len(keys), "sum") / per).numpy(),
        "hi": segment_reduce(v, gid, len(keys), "amax").numpy(),
    }


_PLAN_CASES = [(np.float32, 8), (np.float32, None), (np.float64, 3), (np.float64, None)]


@pytest.mark.parametrize("dtype,width", _PLAN_CASES,
                         ids=[f"{np.dtype(d).name}-{w}" for d, w in _PLAN_CASES])
def test_segment_plan_gives_what_it_gave(dtype, width):
    data = _frame(dtype=dtype, width=width)
    df = tft.TensorFrame.from_dict(data, num_blocks=3)
    fetches, feed = _fetches(df)
    out = tft.aggregate(fetches, tft.group_by(df, "k"), feed_dict=feed, device="cpu")
    assert stats() == {"aggregate.plan.segment": 1.0, "aggregate.segment.torch": 1.0}
    want = _want(data)
    np.testing.assert_array_equal(out.host_values("k"), want["k"])
    rtol = 1e-6 if dtype == np.float32 else 1e-14
    for c in ("s", "m", "q", "hi"):
        got = out.host_values(c)
        assert got.dtype == dtype
        np.testing.assert_allclose(got, want[c], rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype,width", _PLAN_CASES,
                         ids=[f"{np.dtype(d).name}-{w}" for d, w in _PLAN_CASES])
def test_mesh_segment_plan_gives_what_it_gave(dtype, width):
    data = _frame(n=1003, dtype=dtype, width=width)  # 8 shards of 125 and 3 more rows
    df = tft.TensorFrame.from_dict(data)
    fetches, feed = _fetches(df)
    out = tft.aggregate(fetches, tft.group_by(df, "k"), feed_dict=feed,
                        mesh=data_mesh(devices=["cpu"] * 8))
    # one keyed-sums call a shard and one over the remainder
    assert stats()["aggregate.segment.torch"] == 9.0 and "aggregate.segment.kernel" not in stats()
    want = _want(data)
    np.testing.assert_array_equal(out.host_values("k"), want["k"])
    rtol = 1e-5 if dtype == np.float32 else 1e-13  # the shards sum in another order
    for c in ("s", "m", "q", "hi"):
        np.testing.assert_allclose(out.host_values(c), want[c], rtol=rtol, atol=0)


def test_segment_plan_without_sums_makes_no_keyed_sums_call():
    data = _frame()
    df = tft.TensorFrame.from_dict(data)
    hi = dsl.reduce_max(dsl.block(df, "v", tf_name="hi_input"), axes=[0]).named("hi")
    out = tft.aggregate([hi], tft.group_by(df, "k"), feed_dict={"hi_input": "v"}, device="cpu")
    assert stats() == {"aggregate.plan.segment": 1.0}
    np.testing.assert_array_equal(out.host_values("hi"), _want(data)["hi"])


_COUNTED = [("local", True, 1), ("local", False, 0), ("mesh", True, 1), ("mesh", False, 0)]


@pytest.mark.parametrize("plan,mean,bincounts", _COUNTED,
                         ids=[f"{p}-{'mean' if m else 'sums'}" for p, m, _ in _COUNTED])
def test_torch_path_counts_the_groups_only_for_a_mean(monkeypatch, plan, mean, bincounts):
    """Where the kernel does not take the sums, a plan counts the groups
    with one `bincount` of all the ids (the mesh plan's too, not one a
    shard), and only where a fetch is a mean."""
    data = _frame(n=1003)
    df = tft.TensorFrame.from_dict(data)
    block = dsl.block(df, "v", tf_name="x_input")
    fetch = (dsl.reduce_mean if mean else dsl.reduce_sum)(block, axes=[0]).named("x")
    grouped = tft.group_by(df, "k")
    where = {"mesh": data_mesh(devices=["cpu"] * 8)} if plan == "mesh" else {"device": "cpu"}
    tft.aggregate([fetch], grouped, feed_dict={"x_input": "v"}, **where)  # factorizes once
    calls = []
    real = torch.bincount

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "bincount", counted)
    out = tft.aggregate([fetch], grouped, feed_dict={"x_input": "v"}, **where)
    assert calls == [1003] * bincounts
    want = _want(data)["m" if mean else "s"]
    np.testing.assert_allclose(out.host_values("x"), want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("groups,cell,k,dtype", _CASES, ids=_IDS)
def test_kernel_matches_plain_and_float64(card, groups, cell, k, dtype):
    """The kernel where it takes the case; where the table is past its limit
    it refuses, and the plain version runs on the card."""
    values, ids = _inputs(groups, cell, k, dtype, n=100_003)
    on_card = [v.to(card) for v in values]
    before = ks.keyed_sums.launches
    if ks.takes_kernel(card, [dtype] * k, groups, [ks.row_width(v) for v in values]):
        tables, counts = ks.keyed_sums(on_card, ids.to(card), groups)
        torch.cuda.synchronize()
        assert ks.keyed_sums.launches == before + 1
    else:
        with pytest.raises(ValueError, match="no kernel"):
            ks.keyed_sums(on_card, ids.to(card), groups)
        tables, counts = ks.keyed_sums_reference(on_card, ids.to(card), groups)
        assert ks.keyed_sums.launches == before
    _check(tables, counts, values, ids, groups, _RTOL[dtype])
    plain, plain_counts = ks.keyed_sums_reference(values, ids, groups)
    assert torch.equal(counts.cpu(), plain_counts)
    for t, p in zip(tables, plain):
        scale = float(p.abs().max()) + 1.0
        torch.testing.assert_close(t.cpu(), p, rtol=_RTOL[dtype], atol=_RTOL[dtype] * scale)


_LAYOUTS = [
    # the benchmark cell: 16 groups, two outputs of 8 float32 values in 16-byte
    # chunks, 2 lanes a row, 16 rows an instruction: a table a row position
    ((16, [8, 8], F32), (32, 16, 1, 544, 4, 2, 1)),
    ((16, [8, 8], F64), (32, 8, 1, 544, 2, 4, 1)),
    ((16, [3, 3], F32), (32, 16, 1, 544, 1, 3, 1)),  # 12 rows: 16 positions
    ((16, [1, 1], F32), (3, 32, 1, 48, 1, 1, 0)),  # whole banks too large: odd stride
    ((64, [8, 8], F32), (17, 1, 8, 1088, 4, 2, 0)),  # a table a warp
    ((400, [8, 8], F32), (17, 1, 1, 6800, 4, 2, 0)),  # one table
    ((2, [64], F32), (96, 2, 1, 224, 4, 16, 1)),
]


@pytest.mark.card
@pytest.mark.parametrize("args,layout", _LAYOUTS)
def test_layout_is_the_first_that_fits(card, args, layout):
    """The kernel's plan (``layout_of``): the first tile-table layout that
    fits in `_TABLES_BYTES`, and the shared memory it takes."""
    groups, widths, dtype = args
    values = [torch.zeros(1000, w, dtype=dtype, device=card) for w in widths]
    plan = ks._plan(values, 1000, groups)
    assert tuple(plan[k] for k in ks._PLAN[:7]) == layout
    stride, positions, warps, pitch = layout[:4]
    elem = ks._ELEM_BYTES[dtype]
    assert positions & (positions - 1) == 0 and stride >= sum(widths) + 1
    assert positions * warps * pitch * elem <= ks._TABLES_BYTES or positions * warps == 1
    assert plan["smem"] == groups * (sum(widths) + 1) * 8 + positions * warps * pitch * elem
    assert plan["blocks"] == 1  # 1000 rows: one tile


@pytest.mark.card
def test_kernel_on_misaligned_and_strided_values(card):
    values, ids = _inputs(7, (8,), 2, F32, n=10_001)
    wide = torch.cat([values[0], values[1]], 1).to(card)
    # rows that start 4 bytes past a 16-byte boundary, and a strided view
    tables, counts = ks.keyed_sums([wide[:, 1:9], wide[:, ::2]], ids.to(card), 7)
    _check(tables, counts, [wide[:, 1:9].cpu(), wide[:, ::2].cpu()], ids, 7, _RTOL[F32])


@pytest.mark.card
def test_kernel_of_no_rows(card):
    before = ks.keyed_sums.launches
    tables, counts = ks.keyed_sums([torch.zeros(0, 8, device=card)],
                                   torch.zeros(0, dtype=torch.int64, device=card), 3)
    assert ks.keyed_sums.launches == before
    assert counts.tolist() == [0, 0, 0] and not tables[0].any()


@pytest.mark.card
def test_kernel_at_the_cell_shape(card):
    """100M rows of 8 float32 values in [0, 1), 16 keys, the values and their
    squares: every mean within 1e-6 of float64, the counts exact."""
    n, width, groups = 100_000_000, 8, 16
    gen = torch.Generator(device=card).manual_seed(2**31 + 12345)
    v = torch.rand(n, width, generator=gen, device=card)
    ids = torch.randint(0, groups, (n,), generator=gen, device=card)
    (s, q), counts = ks.keyed_sums([v, v * v], ids, groups)
    want_s = torch.zeros(groups, width, dtype=F64, device=card)
    want_q = torch.zeros(groups, width, dtype=F64, device=card)
    for lo in range(0, n, 10_000_000):
        x = v[lo:lo + 10_000_000].double()
        want_s.index_add_(0, ids[lo:lo + 10_000_000], x)
        want_q.index_add_(0, ids[lo:lo + 10_000_000], x * x)
    want_counts = torch.bincount(ids, minlength=groups)
    assert torch.equal(counts, want_counts)
    per = counts.double()[:, None]
    for got, want in ((s, want_s), (q, want_q)):
        gap = ((got.double() / per) - want / per).abs() / (want / per).abs()
        assert float(gap.max()) < 1e-6


@pytest.mark.card
def test_segment_plan_takes_the_kernel_once_a_call(card):
    data = _frame(n=200_000)
    df = tft.TensorFrame([tft.Column("k", torch.from_numpy(data["k"]).to(card)),
                          tft.Column("v", torch.from_numpy(data["v"]).to(card))])
    fetches, feed = _fetches(df)
    grouped = tft.group_by(df, "k")
    before = ks.keyed_sums.launches
    for call in range(1, 4):
        out = tft.aggregate(fetches, grouped, feed_dict=feed, device=card)
        assert stats() == {"aggregate.plan.segment": float(call),
                           "aggregate.segment.kernel": float(call),
                           "factorize.kernel": float(call)}
        assert ks.keyed_sums.launches == before + call
    want = _want(data)
    np.testing.assert_array_equal(out.host_values("k"), want["k"])
    for c in ("s", "m", "q", "hi"):
        np.testing.assert_allclose(out.host_values(c), want[c], rtol=2e-6, atol=0)


@pytest.mark.card
def test_float64_values_take_the_kernel(card):
    data = _frame(n=100_000, dtype=np.float64, width=3)
    df = tft.TensorFrame([tft.Column("k", torch.from_numpy(data["k"]).to(card)),
                          tft.Column("v", torch.from_numpy(data["v"]).to(card))])
    fetches, feed = _fetches(df)
    out = tft.aggregate(fetches, tft.group_by(df, "k"), feed_dict=feed, device=card)
    assert stats()["aggregate.segment.kernel"] == 1.0
    want = _want(data)
    for c in ("s", "m", "q", "hi"):
        assert out.host_values(c).dtype == np.float64
        np.testing.assert_allclose(out.host_values(c), want[c], rtol=1e-13, atol=0)


@pytest.mark.card
def test_a_table_past_the_limit_takes_the_plain_version(card):
    # 4097 keys x (1 value + the count) = 8194 accumulators
    data = _frame(n=50_000, width=None, seed=3)
    data["k"] = np.random.default_rng(3).permutation(np.arange(50_000) % 4097)
    df = tft.TensorFrame([tft.Column("k", torch.from_numpy(data["k"]).to(card)),
                          tft.Column("v", torch.from_numpy(data["v"]).to(card))])
    m = dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
    before = ks.keyed_sums.launches
    out = tft.aggregate([m], tft.group_by(df, "k"), feed_dict={"m_input": "v"}, device=card)
    # 4097 keys: past the factorization kernel's capacity too
    assert stats() == {"aggregate.plan.segment": 1.0, "aggregate.segment.torch": 1.0,
                       "factorize.torch": 1.0}
    assert ks.keyed_sums.launches == before
    np.testing.assert_allclose(out.host_values("m"), _want(data)["m"], rtol=1e-6, atol=0)
