"""Device health: the /healthz rows.

The reporting half of `tensorframes_tpu/runtime/scheduler.py`.
`health_overview` is the /healthz payload: one row per local device, with
the JAX rows' keys. The devices are the CUDA cards, labelled ``cuda:<index>``
with ``device_kind`` from `torch.cuda.get_device_name`; a machine without a
card reports one ``cpu:0`` row, the device its callers pass
(``device="cpu"``).

Every row's circuit is ``closed``: the failover circuit breaker
(``DeviceHealth``, its cooldown knob and eviction ledger) comes with the
verb-dispatch retry path that feeds it, and block placement across cards
(``plan``, ``resolve``, ``BlockSchedule``) with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["device_label", "health_overview"]


def device_label(dev) -> str:
    """``type:index`` of a `torch.device` (or a device string): the label
    dispatch spans and the materialization cache key on. The CPU is
    ``cpu:0``."""
    d = torch.device(dev)
    return f"{d.type}:{d.index or 0}"


def _local_devices() -> List[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu", 0)]


def _device_kind(d: torch.device) -> str:
    if d.type == "cuda":
        return torch.cuda.get_device_name(d.index or 0)
    return "cpu"


def health_overview() -> List[Dict]:
    """One row per local device: label, kind, circuit state, failures and
    remaining cooldown."""
    return [
        {
            "device": device_label(d),
            "device_kind": _device_kind(d),
            "state": "closed",
            "failures": 0,
            "cooldown_s": 0.0,
            "retry_in_s": 0.0,
        }
        for d in _local_devices()
    ]
