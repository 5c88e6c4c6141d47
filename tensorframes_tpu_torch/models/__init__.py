"""Models of the PyTorch port."""

from .kmeans import kmeans
from .mlp import MLP
from .transformer import TransformerLM

__all__ = ["MLP", "TransformerLM", "kmeans"]
