"""Models of the PyTorch port: scoring and training."""

from .deepseek_v2 import DeepSeekV2LM
from .inception import InceptionLite
from .kmeans import kmeans
from .mlp import MLP
from .moe import MoEFFN, RoutedExperts
from .training import init_opt_state, make_train_step
from .transformer import TransformerLM

__all__ = [
    "DeepSeekV2LM", "InceptionLite", "MLP", "MoEFFN", "RoutedExperts", "TransformerLM",
    "init_opt_state", "kmeans", "make_train_step",
]
