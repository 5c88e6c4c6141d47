"""Execution runtime of the PyTorch port."""

from .executor import Executor, default_executor

__all__ = ["Executor", "default_executor"]
