"""Models of the PyTorch port."""

from .transformer import TransformerLM

__all__ = ["TransformerLM"]
