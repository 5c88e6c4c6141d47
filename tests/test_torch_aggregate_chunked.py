"""PyTorch port: the aggregate plans and the last runtime knobs, held to the
JAX package on the CPU.

- The four knobs (`aggregate_exact_size_limit`, `aggregate_segment_fast`,
  `executor_cache_entries`, `telemetry_ring_entries`): names, ``TFS_*`` env
  parsing, defaults and minimums equal to `tensorframes_tpu.config`'s; the
  executor's LRU evicts at its bound and the span ring takes its size at a
  reset. The JAX package's `default_num_blocks` and
  `aggregate_buffer_rows`, read nowhere there, are not in the port: setting
  either raises.
- The chunk plan (`aggregate._aggregate_chunked`) against the JAX
  package's with ``aggregate_segment_fast=False`` and many distinct group
  sizes, mirroring `tests/test_verbs.py::TestAggregateChunked`: one call a
  power-of-two chunk size, sums, a size-weighted mean, min/max, integer
  sums, vector cells.
- The exact plan over graphs with `tf.cond` and `tf.while_loop` against the
  JAX package's exact plan: one vmapped call a distinct group size, no
  per-group loop.

Tolerances: keys, integer results, min and max exact; float sums and means
rtol 1e-12 in float64 and 1e-5 in float32 (the chunk partials are summed in
another order than the reference's).
"""

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.runtime.executor import Executor
from tensorframes_tpu_torch.utils import telemetry
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

from _torch_runtime import reset_port

CPU = "cpu"
_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
_CHUNKED = dict(aggregate_exact_size_limit=1, aggregate_segment_fast=False)


@pytest.fixture(autouse=True)
def _isolated():
    reset_port()
    yield
    reset_port()


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------

_KNOBS = [
    # (knob, env var, a well-formed value, a value under the minimum)
    ("aggregate_exact_size_limit", "TFS_AGGREGATE_EXACT_SIZE_LIMIT", "7", "-3"),
    ("executor_cache_entries", "TFS_EXECUTOR_CACHE_ENTRIES", "64", "0"),
    ("telemetry_ring_entries", "TFS_TELEMETRY_RING_ENTRIES", "100", "-1"),
    ("aggregate_segment_fast", "TFS_AGGREGATE_SEGMENT_FAST", "0", None),
]


@pytest.mark.parametrize("knob", [k[0] for k in _KNOBS])
def test_knob_defaults_equal_the_reference(knob):
    assert tconfig.default_value(knob) == jconfig.default_value(knob)
    assert getattr(tconfig.get(), knob) == getattr(jconfig.get(), knob)


@pytest.mark.parametrize("knob,var,good,low", _KNOBS, ids=[k[0] for k in _KNOBS])
def test_knob_env_parsing_equals_the_reference(knob, var, good, low, monkeypatch):
    for raw in [good, "not-a-number", low] if low is not None else [good, "off", "true"]:
        monkeypatch.setenv(var, raw)
        assert getattr(tconfig.Config(), knob) == getattr(jconfig.Config(), knob), raw
    monkeypatch.setenv(var, good)
    want = {"0": False}.get(good, int(good) if good.lstrip("-").isdigit() else good)
    assert getattr(tconfig.Config(), knob) == want
    if low is not None:  # below the minimum: clamped to it, as the reference does
        monkeypatch.setenv(var, low)
        assert getattr(tconfig.Config(), knob) == getattr(jconfig.Config(), knob) >= 0


@pytest.mark.parametrize("knob", ["default_num_blocks", "aggregate_buffer_rows", "default_mesh"])
@pytest.mark.parametrize("how", ["update", "override", "env"])
def test_knobs_dead_in_the_reference_are_not_ported(knob, how, monkeypatch):
    # declared in the JAX package and read nowhere there
    assert knob in {f.name for f in jconfig.dataclasses.fields(jconfig.Config)}
    assert not hasattr(tconfig.get(), knob)
    if how == "env":
        monkeypatch.setenv(f"TFS_{knob.upper()}", "4")
        assert not hasattr(tconfig.Config(), knob)
        return
    with pytest.raises(AttributeError, match=knob):
        if how == "update":
            tft.config.update(**{knob: 4})
        else:
            with tft.config.override(**{knob: 4}):
                pass


def test_all_four_knobs_override_together():
    knobs = dict(
        aggregate_segment_fast=False, aggregate_exact_size_limit=3,
        executor_cache_entries=9, telemetry_ring_entries=11,
    )
    with tft.config.override(**knobs):
        assert {k: getattr(tft.config.get(), k) for k in knobs} == knobs
        assert all(tft.config.is_explicit(k) for k in knobs)
    assert tft.config.get().executor_cache_entries == 512
    assert not any(tft.config.is_explicit(k) for k in knobs)


def test_executor_lru_evicts_at_the_bound():
    ex = Executor()
    df = tft.TensorFrame.from_dict({"x": np.arange(6.0)})
    graphs = [(tdsl.block(df, "x") + float(i)).named("z") for i in range(5)]
    with tft.config.override(executor_cache_entries=3):
        for g in graphs:
            tft.map_blocks(g, df, executor=ex, device=CPU)
        assert len(ex.cache_keys()) == 3 and ex.compile_count == 5
        # the oldest went first: the first graph lowers again
        tft.map_blocks(graphs[0], df, executor=ex, device=CPU)
        assert ex.compile_count == 6 and len(ex.cache_keys()) == 3
    # the bound is read at every insert: a larger one keeps more
    for g in graphs:
        tft.map_blocks(g, df, executor=ex, device=CPU)
    assert len(ex.cache_keys()) == 5


def test_span_ring_takes_its_size_at_a_reset_and_gauges_the_executor():
    with tft.config.override(telemetry_ring_entries=4):
        telemetry.reset()
        df = tft.TensorFrame.from_dict({"x": np.arange(8.0)}, num_blocks=8)
        tft.map_blocks((tdsl.block(df, "x") * 2.0).named("z"), df, device=CPU)
        assert len(telemetry.spans()) == 4 and telemetry.spans_dropped() > 0
    telemetry.reset()
    assert telemetry._ring._ring.maxlen == 8192
    from tensorframes_tpu_torch.runtime.executor import default_executor

    gauges = telemetry.metrics_snapshot()[1]
    assert gauges[("executor_cache_entries", ())] == len(default_executor().cache_keys())


# ---------------------------------------------------------------------------
# the chunk plan
# ---------------------------------------------------------------------------


def _both(data, prog, knobs, keys=("k",), num_blocks=3):
    """The JAX package's and the port's aggregate under ``knobs``; the
    port's plan counters."""
    jdf = tfs.TensorFrame.from_dict(data, num_blocks=num_blocks)
    tdf = tft.TensorFrame.from_dict(data, num_blocks=num_blocks)
    with jconfig.override(**knobs):
        ref = tfs.aggregate(prog(jdsl, jdf), tfs.group_by(jdf, *keys))
    reset_stats()
    with tft.config.override(**knobs):
        out = tft.aggregate(prog(tdsl, tdf), tft.group_by(tdf, *keys), device=CPU)
    return ref, out, stats()


def _compare(ref, out, exact=()):
    assert out.columns == ref.columns
    for c in ref.columns:
        r, o = np.asarray(ref.host_values(c)), out.host_values(c)
        assert (o.shape, o.dtype) == (r.shape, r.dtype), c
        if r.dtype.kind in "biu" or c in exact:
            np.testing.assert_array_equal(o, r, err_msg=c)
        else:
            np.testing.assert_allclose(o, r, rtol=_RTOL[r.dtype], atol=0, err_msg=c)


def _sized(sizes, dtype=np.float64, cols=None, seed=0, shuffle=True):
    rng = np.random.default_rng(seed)
    keys = np.repeat(np.arange(len(sizes), dtype=np.int64) * 3 - 7, sizes)
    if shuffle:
        rng.shuffle(keys)
    shape = (len(keys),) if cols is None else (len(keys), cols)
    if np.issubdtype(dtype, np.integer):
        x = rng.integers(-50, 50, shape).astype(dtype)
    else:
        x = rng.normal(size=shape).astype(dtype)
    return {"k": keys, "x": x}


def _reduce(op, transform=None):
    def prog(d, f):
        xi = d.block(f, "x", tf_name="x_input")
        return getattr(d, f"reduce_{op}")(transform(d, xi) if transform else xi,
                                          axes=[0]).named("x")
    return prog


def _chunk_calls():
    return [s for s in telemetry.spans() if s.name == "aggregate.chunk"]


# all-distinct sizes: 40 groups of 1..40 rows, 6 power-of-two chunk sizes
_DISTINCT = list(range(1, 41))

_CHUNK_CASES = [
    ("sum", None, np.float64, None),
    ("sum", None, np.float32, None),
    ("sum", None, np.float32, 3),
    ("sum", "square", np.float64, None),
    ("mean", None, np.float64, None),
    ("mean", None, np.float32, 3),
    ("mean", "square", np.float64, None),
    ("min", None, np.float32, None),
    ("max", "neg", np.float64, 2),
    ("sum", None, np.int64, None),
    ("max", None, np.int32, None),
    ("min", "square", np.int64, 2),
]


@pytest.mark.parametrize(
    "op,transform,dtype,cols", _CHUNK_CASES,
    ids=[f"{o}-{t}-{np.dtype(d).name}-{c}" for o, t, d, c in _CHUNK_CASES],
)
def test_chunk_plan_matches_the_reference(op, transform, dtype, cols):
    fn = {None: None, "square": lambda d, x: x * x, "neg": lambda d, x: -x}[transform]
    data = _sized(_DISTINCT, dtype, cols)
    telemetry.reset()
    ref, out, counts = _both(data, _reduce(op, fn), dict(aggregate_segment_fast=False))
    assert counts == {"aggregate.plan.chunk": 1.0}
    # one vmapped call a power-of-two chunk size, whatever the distribution
    assert len(_chunk_calls()) == max(_DISTINCT).bit_length()
    _compare(ref, out, exact=("x",) if op in ("min", "max") else ())


def test_chunk_plan_equals_the_exact_plan_and_numpy():
    sizes = [1, 2, 3, 5, 8, 13, 21, 1, 7]
    data = _sized(sizes)
    tdf = tft.TensorFrame.from_dict(data)
    prog = _reduce("sum")
    with tft.config.override(aggregate_segment_fast=False):
        reset_stats()
        exact = tft.aggregate(prog(tdsl, tdf), tft.group_by(tdf, "k"), device=CPU)
        assert stats() == {"aggregate.plan.exact": 1.0}
    reset_stats()
    with tft.config.override(**_CHUNKED):
        chunked = tft.aggregate(prog(tdsl, tdf), tft.group_by(tdf, "k"), device=CPU)
    assert stats() == {"aggregate.plan.chunk": 1.0}
    np.testing.assert_array_equal(chunked.host_values("k"), exact.host_values("k"))
    np.testing.assert_allclose(chunked.host_values("x"), exact.host_values("x"), rtol=1e-12)
    want = [data["x"][data["k"] == k].sum() for k in chunked.host_values("k")]
    np.testing.assert_allclose(chunked.host_values("x"), want, rtol=1e-12)


def test_mean_combines_size_weighted():
    # non-power-of-two sizes give groups of unequal chunks: an unweighted
    # mean of the chunk means would be wrong
    sizes = [3, 5, 6, 7, 1]
    data = _sized(sizes, shuffle=False)
    ref, out, counts = _both(data, _reduce("mean"), _CHUNKED)
    assert counts == {"aggregate.plan.chunk": 1.0}
    _compare(ref, out)
    want = [data["x"][data["k"] == k].mean() for k in out.host_values("k")]
    np.testing.assert_allclose(out.host_values("x"), want, rtol=1e-12)


def test_integer_mean_takes_the_exact_plan():
    data = {"k": np.array([0, 0, 0, 1, 1], np.int64), "x": np.array([0, 1, 5, 7, 2], np.int64)}
    knobs = dict(aggregate_exact_size_limit=0, aggregate_segment_fast=False)
    ref, out, counts = _both(data, _reduce("mean"), knobs, num_blocks=1)
    assert counts == {"aggregate.plan.exact": 1.0}
    _compare(ref, out)
    assert out.host_values("x").tolist() == [2, 4]  # truncated, as TF's Mean


def test_unclassified_graph_takes_the_exact_plan():
    def wrapped(d, f):
        return d.identity(d.reduce_min(d.block(f, "x", tf_name="x_input"), axes=[0])).named("x")

    ref, out, counts = _both(_sized(_DISTINCT), wrapped, _CHUNKED)
    assert counts == {"aggregate.plan.exact": 1.0}
    _compare(ref, out, exact=("x",))


def test_multiple_fetches_and_two_keys_through_the_chunk_plan():
    rng = np.random.default_rng(3)
    n = 400
    data = {
        "a": rng.integers(0, 5, n).astype(np.int64),
        "b": rng.integers(0, 9, n).astype(np.int32),
        "x": rng.normal(size=(n, 2)),
    }

    def prog(d, f):
        s = d.reduce_sum(d.block(f, "x", tf_name="s_input"), axes=[0]).named("s")
        m = d.reduce_max(d.block(f, "x", tf_name="m_input"), axes=[0]).named("m")
        return [s, m]

    jdf, tdf = tfs.TensorFrame.from_dict(data), tft.TensorFrame.from_dict(data)
    feed = {"s_input": "x", "m_input": "x"}
    with jconfig.override(**_CHUNKED):
        ref = tfs.aggregate(prog(jdsl, jdf), tfs.group_by(jdf, "a", "b"), feed_dict=feed)
    reset_stats()
    with tft.config.override(**_CHUNKED):
        out = tft.aggregate(prog(tdsl, tdf), tft.group_by(tdf, "a", "b"), feed_dict=feed,
                            device=CPU)
    assert stats() == {"aggregate.plan.chunk": 1.0}
    _compare(ref, out, exact=("m",))


def test_size_limit_decides_between_exact_and_chunk():
    data = _sized([1, 2, 3, 4, 5, 6])  # 6 distinct sizes
    prog = _reduce("sum")
    for limit, plan in ((6, "exact"), (5, "chunk")):
        knobs = dict(aggregate_exact_size_limit=limit, aggregate_segment_fast=False)
        ref, out, counts = _both(data, prog, knobs)
        assert counts == {f"aggregate.plan.{plan}": 1.0}
        _compare(ref, out)


def test_chunk_plan_of_an_empty_frame():
    data = {"k": np.zeros(0, np.int64), "x": np.zeros(0)}
    ref, out, counts = _both(data, _reduce("sum"), _CHUNKED, num_blocks=1)
    assert counts == {"aggregate.plan.exact": 1.0}  # zero sizes: nothing to chunk
    _compare(ref, out)


# ---------------------------------------------------------------------------
# the exact plan over graphs with control flow: one call a size
# ---------------------------------------------------------------------------

def _tf_bytes(build) -> bytes:
    tf = pytest.importorskip("tensorflow")
    g = tf.Graph()
    with g.as_default():
        build(tf, tf.compat.v1)
    return g.as_graph_def().SerializeToString()


def _cond_graph(tf, tf1):
    x = tf1.placeholder(tf.float64, shape=(None,), name="x_input")
    tf.identity(
        tf.cond(tf.reduce_sum(x) > 0.0, lambda: tf.reduce_sum(x), lambda: tf.reduce_max(x)),
        name="x",
    )


def _while_graph(tf, tf1):
    # halve the group's values until their absolute sum is under 1: a
    # data-dependent trip count a group
    x = tf1.placeholder(tf.float64, shape=(None,), name="x_input")
    out = tf.while_loop(lambda v: tf.reduce_sum(tf.abs(v)) > 1.0, lambda v: v * 0.5, [x])
    tf.identity(tf.reduce_sum(out[0]), name="x")


def _while_counter_graph(tf, tf1):
    # an int32 trip counter and a float carry: the loop's outputs are exact
    x = tf1.placeholder(tf.float64, shape=(None,), name="x_input")
    i, v = tf.while_loop(
        lambda i, v: tf.reduce_max(v) < 50.0, lambda i, v: (i + 1, v * 2.0 + 1.0),
        [tf.constant(0), x],
    )
    tf.identity(tf.cast(i, tf.float64) * 1000.0 + tf.reduce_sum(v), name="x")


def _np_while(v):
    while np.abs(v).sum() > 1.0:
        v = v * 0.5
    return v.sum()


def _np_counter(v):
    i = 0
    while v.max() < 50.0:
        i, v = i + 1, v * 2.0 + 1.0
    return i * 1000.0 + v.sum()


_CF_CASES = {
    "cond": (_cond_graph, lambda v: v.sum() if v.sum() > 0 else v.max()),
    "while": (_while_graph, _np_while),
    "while_counter": (_while_counter_graph, _np_counter),
}


@pytest.mark.parametrize("case", sorted(_CF_CASES))
def test_exact_plan_over_control_flow_runs_one_call_a_size(case):
    build, numpy_fn = _CF_CASES[case]
    data_bytes = _tf_bytes(build)
    sizes = [1, 2, 2, 3, 5, 5, 5, 8, 13]
    data = _sized(sizes, seed=4)
    data["x"] = data["x"] * 4.0
    jdf = tfs.TensorFrame.from_dict(data)
    ref = tfs.aggregate(data_bytes, tfs.group_by(jdf, "k"), fetch_names=["x"])
    tdf = tft.TensorFrame.from_dict(data, num_blocks=2)
    telemetry.reset()
    reset_stats()
    out = tft.aggregate(data_bytes, tft.group_by(tdf, "k"), fetch_names=["x"], device=CPU)
    counts = stats()
    assert counts["aggregate.plan.exact"] == 1.0
    calls = [s for s in telemetry.spans() if s.name == "aggregate.size"]
    assert len(calls) == len(set(sizes))  # no per-group loop
    if case != "cond":
        # one host read a trip of the batched loop, over all groups of a size
        assert counts["control.while.host_syncs"] >= len(set(sizes))
    np.testing.assert_array_equal(out.host_values("k"), np.asarray(ref["k"].values))
    np.testing.assert_allclose(out.host_values("x"), np.asarray(ref["x"].values), rtol=1e-12)
    want = [numpy_fn(data["x"][data["k"] == k]) for k in out.host_values("k")]
    np.testing.assert_allclose(out.host_values("x"), want, rtol=1e-12)
