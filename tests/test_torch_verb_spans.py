"""PyTorch port: every verb call is one ``verb`` span (`utils.profiling.
verb_entry`), the function front end's blocks and the aggregate's key stage
have spans of their own, and the program's spans are `torch.profiler`
ranges while a profiler records, and only then."""

import time

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import CPU, reset_port

ROWS = 12


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _frame():
    return tft.TensorFrame.from_dict(
        {"x": np.arange(ROWS, dtype=np.float32), "k": np.arange(ROWS) % 3}, num_blocks=3
    )


def _pair():
    f32, sc = tft.ScalarType.float32, tft.Shape(())
    x1 = tft.dsl.placeholder(f32, sc, name="x_1")
    x2 = tft.dsl.placeholder(f32, sc, name="x_2")
    return (x1 + x2).named("x")


def _sum(df):
    return tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")


# verb -> (its span's name, a call over the frame)
CALLS = {
    "map_blocks": ("map_blocks", lambda df: tft.map_blocks(
        (tft.block(df, "x") + 3.0).named("z"), df, device=CPU)),
    "map_blocks.fn": ("map_blocks", lambda df: tft.map_blocks(
        lambda x: {"z": x + 3.0}, df, device=CPU)),
    "map_rows": ("map_rows", lambda df: tft.map_rows(
        (tft.row(df, "x") * 2.0).named("z"), df, device=CPU)),
    "map_rows.fn": ("map_rows", lambda df: tft.map_rows(
        lambda x: {"z": x * 2.0}, df, device=CPU)),
    "reduce_blocks": ("reduce_blocks", lambda df: tft.reduce_blocks(_sum(df), df, device=CPU)),
    "reduce_rows": ("reduce_rows", lambda df: tft.reduce_rows(_pair(), df, device=CPU)),
    "aggregate": ("aggregate", lambda df: tft.aggregate(
        _sum(df), tft.group_by(df, "k"), device=CPU)),
    "reduce_blocks_stream": ("reduce_blocks_stream", lambda df: tft.reduce_blocks_stream(
        _sum(df), iter([df, df]), device=CPU)),
}


def _roots():
    return [s for s in ttele.spans() if s.kind == "verb" and s.parent_id is None]


def _verb_seconds(verb):
    hists = ttele.metrics_snapshot()[2]
    return sum(h[3] for (name, labels), h in hists.items()
               if name == "verb_seconds" and dict(labels).get("verb") == verb)


def _descendants(span):
    out, todo = [], [span.span_id]
    while todo:
        sid = todo.pop()
        for s in ttele.spans():
            if s.parent_id == sid:
                out.append(s)
                todo.append(s.span_id)
    return out


@pytest.mark.parametrize("case", sorted(CALLS))
def test_one_root_verb_span_a_call(case):
    verb, call = CALLS[case]
    df = _frame()
    call(df)  # warm: lowerings and first-dispatch counts
    ttele.reset()
    before = ttele.flat_counters()
    call(df)
    roots = _roots()
    assert [s.name for s in roots] == [verb]
    rows = 0 if verb == "reduce_blocks_stream" else ROWS  # a stream has no input frame
    assert roots[0].attrs.get("rows") == (rows or None)
    after = ttele.flat_counters()
    assert after[f"{verb}.calls"] - before.get(f"{verb}.calls", 0) == 1
    assert after.get(f"{verb}.rows", 0) - before.get(f"{verb}.rows", 0) == rows
    assert after[f"{verb}.seconds"] == pytest.approx(roots[0].seconds)
    assert _verb_seconds(verb) == 1


def test_the_profile_reads_the_verb_counters():
    from tensorframes_tpu_torch.runtime import profiler as tprofiler

    df = _frame()
    for _ in range(2):
        CALLS["aggregate"][1](df)
    v = tprofiler.snapshot().verbs["aggregate"]
    assert (v["calls"], v["rows"], v["latency"]["count"]) == (2, 2 * ROWS, 2)
    assert v["seconds"] == pytest.approx(ttele.flat_counters()["aggregate.seconds"])


@pytest.mark.parametrize("case", ["map_blocks.fn", "map_rows.fn"])
def test_function_blocks_are_dispatch_spans_of_the_verb(case):
    verb, call = CALLS[case]
    df = _frame()
    ttele.reset()
    call(df)
    (root,) = _roots()
    blocks = [s for s in ttele.spans() if s.name == f"{verb}.block"]
    assert [(s.kind, s.parent_id, s.attrs["block"], s.attrs["rows"]) for s in blocks] == [
        ("dispatch", root.span_id, i, ROWS // 3) for i in range(3)
    ]
    assert all(root.t0 <= s.t0 <= s.t1 <= root.t1 for s in blocks)


@pytest.mark.parametrize("plan,knobs", [
    ("segment", {}),
    ("exact", dict(aggregate_segment_fast=False)),
    ("chunk", dict(aggregate_segment_fast=False, aggregate_exact_size_limit=0)),
])
def test_aggregate_keys_and_reductions_under_the_verb(plan, knobs):
    df = tft.TensorFrame.from_dict(
        {"x": np.arange(ROWS, dtype=np.float32), "k": np.asarray([0] * 7 + [1] * 3 + [2] * 2)}
    )
    with tconfig.override(**knobs):
        ttele.reset()
        out = tft.aggregate(_sum(df), tft.group_by(df, "k"), device=CPU)
    np.testing.assert_array_equal(out.host_values("x"), [21.0, 24.0, 21.0])
    (root,) = _roots()
    assert root.name == "aggregate"
    under = _descendants(root)
    keys = [s for s in under if s.name == "aggregate.keys"]
    assert [(s.kind, s.parent_id) for s in keys] == [("stage", root.span_id)]
    span = {"segment": "aggregate.segment", "exact": "aggregate.size",
            "chunk": "aggregate.chunk"}[plan]
    sums = [s for s in under if s.kind == "dispatch" and s.name.startswith("aggregate.")]
    assert sums and {s.name for s in sums} == {span}
    assert all(ttele.exec_seconds(s) > 0 for s in keys + sums)


def test_a_stage_span_on_the_cpu_keeps_no_events():
    with ttele.span("stage.cpu", kind="stage", torch_device=torch.device("cpu")):
        pass
    (s,) = [s for s in ttele.spans() if s.name == "stage.cpu"]
    assert s.events is None and ttele.exec_seconds(s) == s.seconds


def _host_ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type().name == "CPU"]


def test_spans_are_profiler_ranges_on_its_clock():
    df = _frame()
    CALLS["aggregate"][1](df)
    CALLS["map_blocks.fn"][1](df)
    from torch.profiler import ProfilerActivity, profile, record_function

    lo = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer.call"):
            CALLS["aggregate"][1](df)
            CALLS["map_blocks.fn"][1](df)
    hi = time.time_ns()
    ranges = _host_ranges(prof)
    (outer,) = [r for r in ranges if r[0] == "outer.call"]
    names = ["aggregate", "aggregate.keys", "aggregate.segment", "map_blocks", "map_blocks.block"]
    for name in names:
        found = [r for r in ranges if r[0] == name]
        assert found, name
        for _, s, t in found:
            assert outer[1] <= s <= t <= outer[2], name
            assert lo <= s <= t <= hi, name
    (verb,) = [r for r in ranges if r[0] == "aggregate"]
    (keys,) = [r for r in ranges if r[0] == "aggregate.keys"]
    assert verb[1] <= keys[1] <= keys[2] <= verb[2]
    assert len([r for r in ranges if r[0] == "map_blocks.block"]) == 3


def test_no_range_without_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    df = _frame()
    for case in ("aggregate", "map_blocks.fn", "map_blocks"):
        CALLS[case][1](df)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        CALLS["aggregate"][1](df)
    assert "aggregate" in entered and "aggregate.keys" in entered


@pytest.mark.parametrize("case", ["aggregate", "map_blocks.fn", "reduce_rows"])
def test_telemetry_off_keeps_no_span_and_the_same_outputs(case):
    _, call = CALLS[case]
    df = _frame()
    on = call(df)
    with tconfig.override(telemetry=False):
        ttele.reset()
        off = call(df)
        assert ttele.spans() == []
    if isinstance(on, torch.Tensor):
        torch.testing.assert_close(off, on, rtol=0, atol=0)
    else:
        for c in on.columns:
            np.testing.assert_array_equal(off.host_values(c), on.host_values(c))
