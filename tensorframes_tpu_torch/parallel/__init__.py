"""Parallel layer of the PyTorch port: `ring.full_attention` so far."""

from .ring import full_attention

__all__ = ["full_attention"]
