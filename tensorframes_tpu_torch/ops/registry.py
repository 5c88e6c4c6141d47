"""Op registry: maps TF op names to torch lowering rules.

The PyTorch counterpart of `tensorframes_tpu/ops/registry.py`. Each
supported GraphDef op has a rule: a function from input values to output
values, run op by op when the lowered callable is called (eager PyTorch).

Static values: several TF ops take *data* inputs that must be known when
the graph is lowered (reshape targets, reduction axes). `Const` nodes
evaluate to host numpy arrays and stay numpy until an op needs them as a
tensor (`LowerCtx.tensor`); `LowerCtx.static` recovers such values and
refuses a value that depends on the feeds (a tensor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..graph.ir import Graph, GraphNode
from ..schema import ScalarType

__all__ = [
    "OpRule",
    "LowerCtx",
    "register",
    "get_rule",
    "GraphLoweringError",
    "registered_ops",
]


class GraphLoweringError(ValueError):
    """Raised when a graph cannot be lowered to torch."""


@dataclass
class OpRule:
    name: str
    # fn(ctx, node, inputs) -> value | tuple of values (multi-output ops)
    fn: Callable[["LowerCtx", GraphNode, List[Any]], Any]


_REGISTRY: Dict[str, OpRule] = {}


def register(*names: str):
    """Decorator: register a lowering rule under one or more TF op names."""

    def deco(fn):
        for n in names:
            _REGISTRY[n] = OpRule(n, fn)
        return fn

    return deco


def get_rule(op: str) -> Optional[OpRule]:
    return _REGISTRY.get(op)


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


class LowerCtx:
    """Per-lowering context: the device tensors live on, the graph being
    lowered (control-flow rules find their bodies in ``graph.subgraphs``),
    static-value recovery, and the host->device cache of the graph's
    constants. ``memo`` lets a rule keep what it builds once per lowering
    (a body's callable) across the calls of the lowered function.

    ``row_axis`` marks a per-row graph lifted to block level
    (`graph.vectorize.lift_to_block_level`): any value may carry a row
    axis its per-row graph does not declare, as under `vmap`, so the
    control-flow rules let a carry or a branch output gain that axis."""

    def __init__(
        self, device: torch.device, graph: Optional["Graph"] = None, row_axis: bool = False
    ):
        self.device = device
        self.graph = graph
        self.row_axis = row_axis
        self.memo: Dict[Any, Any] = {}
        # id(constant numpy array) -> its tensor on `device`; filled only
        # for arrays the lowered callable keeps alive (`pin`), so an id is
        # never reused by another array while its entry exists
        self._pinned: Dict[int, torch.Tensor] = {}

    @property
    def is_meta(self) -> bool:
        """A shape probe: values are never computed, so nothing may be
        read back to the host."""
        return self.device.type == "meta"

    def static(self, value, node: GraphNode, what: str) -> np.ndarray:
        """``value`` as a host numpy array, or a clear error if it is a
        tensor computed from the feeds."""
        if isinstance(value, torch.Tensor):
            raise GraphLoweringError(
                f"op {node.op!r} (node {node.name!r}) requires a constant "
                f"{what}, but it is computed from the feeds; make it a Const"
            )
        return np.asarray(value)

    def static_int_list(self, value, node: GraphNode, what: str) -> List[int]:
        return [int(x) for x in np.atleast_1d(self.static(value, node, what))]

    def pin(self, arr: np.ndarray) -> None:
        """Upload a constant that every call reuses (weights, folded
        subgraphs) once, instead of once per call."""
        self._pinned[id(arr)] = self._upload(arr)

    def tensor(self, value) -> torch.Tensor:
        """``value`` as a tensor on this context's device."""
        if isinstance(value, torch.Tensor):
            return value
        hit = self._pinned.get(id(value))
        return hit if hit is not None else self._upload(np.asarray(value))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        dtype = ScalarType.from_np_dtype(arr.dtype).torch_dtype
        if self.is_meta:  # shape probes: values never matter
            return torch.empty(arr.shape, dtype=dtype, device="meta")
        from ..frame import as_tensor

        # order="C" keeps 0-d arrays 0-d (np.ascontiguousarray would not)
        return as_tensor(np.asarray(arr, order="C"), self.device)
