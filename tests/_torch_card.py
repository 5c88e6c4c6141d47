"""The ``card`` fixture of the port's tests that run on an NVIDIA card.

A test file that uses it imports no JAX, so the card's machine, which has
none, runs it without the repository's conftest (which imports JAX):

    python3 -m pytest tests/test_torch_keyed_sums.py tests/test_torch_factorize_keys.py \\
        tests/test_torch_flash_attention_card.py tests/test_torch_kda_card.py -m card \\
        --noconftest -p no:cacheprovider

Import the fixture into the test module (``from _torch_card import
card``); pytest finds it there.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

__all__ = ["card", "build_logs_afresh"]


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with python3 -m pytest "
                    "tests/test_torch_keyed_sums.py tests/test_torch_factorize_keys.py "
                    "tests/test_torch_flash_attention_card.py tests/test_torch_kda_card.py -m card "
                    "--noconftest")
    return torch.device("cuda", 0)


def build_logs_afresh(names, into) -> dict:
    """nvcc's output (``-Xptxas -v`` included) for each library
    ``csrc/<name>.cu`` of ``names``, built afresh into the directory
    ``into``: a checkout's cached build leaves no log in
    `ops._cuda_build.build_logs`. The process's own `build_logs` are left
    as they were."""
    from tensorframes_tpu_torch.ops import _cuda_build

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_cuda_build, "_BUILD", into)
        mp.setattr(_cuda_build, "build_logs", {})
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(_cuda_build._build, names))
        return {name: _cuda_build.build_logs[name] for name in names}
