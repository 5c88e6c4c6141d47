"""Compatibility names: the classified retry and the numerics guard live in
`runtime.faults`.

The PyTorch counterpart of `tensorframes_tpu/runtime/retry.py`.
"""

from __future__ import annotations

from .faults import maybe_check_numerics, run_with_retries  # noqa: F401

__all__ = ["run_with_retries", "maybe_check_numerics"]
