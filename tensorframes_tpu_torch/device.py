"""Device resolution for every entry point of the port.

Each verb and model takes ``device=``. ``None`` means the CUDA card; a
machine without one raises instead of quietly running on the CPU. The CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "DeviceLike"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a machine without a card
    raises ``RuntimeError`` naming the way to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tensorframes_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' to "
            "run on the CPU"
        )
    return dev
