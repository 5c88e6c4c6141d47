"""Models of the PyTorch port: scoring and training."""

from .inception import InceptionLite
from .kmeans import kmeans
from .mlp import MLP
from .moe import MoEFFN
from .training import init_opt_state, make_train_step
from .transformer import TransformerLM

__all__ = [
    "InceptionLite", "MLP", "MoEFFN", "TransformerLM", "init_opt_state", "kmeans",
    "make_train_step",
]
