"""Models of the PyTorch port."""

from .inception import InceptionLite
from .kmeans import kmeans
from .mlp import MLP
from .transformer import TransformerLM

__all__ = ["InceptionLite", "MLP", "TransformerLM", "kmeans"]
