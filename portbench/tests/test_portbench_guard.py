"""No process of the benchmark loads JAX or the JAX package."""

import subprocess
import sys
import types

import pytest

from portbench import harness, run
from portbench.tests import tiny


def test_forbidden_names_compare_the_whole_top_level_name():
    mods = ["tensorframes_tpu_torch", "tensorframes_tpu_torch.ops", "jaxtyping", "flaxen",
            "numpy", "portbench.harness"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy"]) == ["jax"]
    assert harness.forbidden_modules(["tensorframes_tpu.api", "jaxlib", "flax.linen"]) == [
        "flax", "jaxlib", "tensorframes_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import importlib, pathlib, sys\n"
        "import tensorframes_tpu_torch, tensorframes_tpu_torch.models\n"
        "import tensorframes_tpu_torch.parallel.multihost\n"
        "from portbench import harness, run, trace, control, sets, yardstick\n"
        "pkg = pathlib.Path(harness.__file__).parent\n"
        "for d in ('drivers', 'metrics'):\n"
        "    for p in sorted((pkg / d).glob('*.py')):\n"
        "        harness.load_module(p, d)\n"
        "import portbench.reference.gpt2, portbench.reference.keyed_meanvar\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tiny.REPO), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_that_finds_jax_loaded_prints_no_result(tmp_path, monkeypatch, capsys):
    root = tiny.make_checkout(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "meanvar.tiny", "--seed", "3", "--seconds", "0.2"],
                  device_type="cpu", root=root)
    out = capsys.readouterr()
    assert rc == 3
    assert out.out.strip() == ""
    assert "jax" in out.err


def test_a_run_without_cuda_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "meanvar.k16", "--seed", "3", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out.strip() == ""
