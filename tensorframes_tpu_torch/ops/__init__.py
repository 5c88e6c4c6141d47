"""Op lowering rules and the hand-written kernels of the PyTorch port."""

from .lowering import GraphLoweringError, build_callable, supported
from .registry import LowerCtx, OpRule, get_rule, register, registered_ops

__all__ = [
    "GraphLoweringError",
    "build_callable",
    "supported",
    "LowerCtx",
    "OpRule",
    "get_rule",
    "register",
    "registered_ops",
]
