"""Compatibility name: the classified retry lives in `runtime.faults`.

The PyTorch counterpart of `tensorframes_tpu/runtime/retry.py`. The JAX
shim also re-exports the numerics guard, which is not in the port yet.
"""

from __future__ import annotations

from .faults import run_with_retries  # noqa: F401

__all__ = ["run_with_retries"]
