import pytest


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with python3 -m pytest "
                    "portbench/tests -m card")
    return torch.device("cuda", 0)
