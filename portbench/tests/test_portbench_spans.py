"""The readers of the program's spans on traced CPU runs of the tiny cells:
``verb_host_ms`` and ``verb_self_ms`` in every cell, ``agg_keys_ms`` and
``agg_sums_ms`` in the aggregate's, and a reader that finds the window's
spans gone raises."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("checkout"))


def _traced(root, workload):
    cell = harness.resolve(root, workload)
    line, _ = harness.run_cell(cell, 2**31 + 11, 0.3, True, torch.device("cpu"),
                               time.perf_counter(), 0.0)
    assert line["correct"], line
    return {k: v["value"] for k, v in line["metrics"].items()}


@pytest.mark.parametrize("workload", ["gpt2.tiny", "meanvar.tiny"])
def test_verb_spans_are_read(root, workload):
    m = _traced(root, workload)
    assert 0.0 <= m["verb_self_ms"] <= m["verb_host_ms"]
    assert m["verb_host_ms"] > 0.0
    if workload == "meanvar.tiny":
        assert m["agg_keys_ms"] > 0.0 and m["agg_sums_ms"] > 0.0
        assert m["agg_keys_ms"] + m["agg_sums_ms"] <= m["verb_host_ms"]
    else:
        assert "agg_keys_ms" not in m and "agg_sums_ms" not in m


@pytest.mark.parametrize("metric", ["verb_host_ms", "verb_self_ms", "agg_keys_ms",
                                    "agg_sums_ms"])
def test_a_reader_raises_when_the_ring_was_emptied(root, metric):
    from tensorframes_tpu_torch.utils import telemetry

    _traced(root, "meanvar.tiny")
    telemetry.reset()
    reader = harness.load_module(root / "portbench" / "metrics" / f"{metric}.py", "metric")
    run = harness.Run(1.0, 0.3, [0.01] * 3, {}, {})
    with pytest.raises(RuntimeError):
        reader.read(run)
