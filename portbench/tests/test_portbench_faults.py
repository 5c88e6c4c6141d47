"""A run on the CPU at a tiny size, the timed path sound and then broken
underneath: ``correct`` comes out true, then false for every fault the
cell can have; and the precision control, put through the cell's own
comparison, comes out not correct."""

import json
import os
import subprocess
import sys

import pytest

from portbench import control
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, workload, fault="", seconds="0.5"):
    env = dict(os.environ, PORTBENCH_TEST_FAULT=fault,
               PYTHONPATH=os.pathsep.join([str(root), str(tiny.REPO)]))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tests._cpu_rank", "--workload", workload,
         "--seed", "3000000019", "--seconds", seconds, "--trace", "0"],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    compared = [ln for ln in out.stderr.strip().splitlines() if ln.startswith("compared ")]
    assert compared and list(line)[-1] == "compared"
    assert compared == out.stderr.strip().splitlines()[-len(compared):]
    return line


@pytest.mark.parametrize("workload,fault", [
    ("gpt2.tiny", ""),
    ("gpt2.tiny", "lm_altered"),
    ("gpt2.tiny", "lm_half_batch"),
    ("meanvar.tiny", ""),
    ("meanvar.tiny", "agg_altered"),
    ("meanvar.tiny", "agg_half_batch"),
    ("meanvar.tiny.r4", ""),
    ("meanvar.tiny.r4", "no_exchange"),
    ("meanvar.tiny.r4", "agg_half_batch"),
    ("meanvar.tiny.r4", "agg_altered"),
])
def test_correct_only_when_the_timed_path_is_sound(root, workload, fault):
    line = _run(root, workload, fault)
    assert line["correct"] is (fault == ""), line["compared"]
    assert line["attempted"] > 0 and line["device"]["count"] == (4 if "r4" in workload else 1)


@pytest.mark.parametrize("workload", ["meanvar.tiny", "meanvar.tiny.r4"])
def test_the_control_fails_the_cells_own_comparison(root, workload):
    import torch

    for rec in control.readings(root, workload, [2**31 + 17, 5], torch.device("cpu")):
        assert rec["correct"] is False, rec
        assert set(rec["compared"]) == {"keys_wrong", "mean_rel_err"}
        assert not rec["compared"]["mean_rel_err"]["ok"]


def test_the_lm_control_goes_through_the_cells_own_comparison(root):
    import torch

    # the CPU has no TF32, so here the control computes float32 and agrees;
    # on the card it fails (test_portbench_card)
    (rec,) = control.readings(root, "gpt2.tiny", [2**31 + 19], torch.device("cpu"))
    assert set(rec["compared"]) == {"logits_max_abs_err"}
    assert rec["compared"]["logits_max_abs_err"]["value"] < 1e-5 and rec["correct"] is True
