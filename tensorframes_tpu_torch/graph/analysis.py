"""Graph analysis: input/output classification + shape & dtype inference.

The PyTorch counterpart of `tensorframes_tpu/graph/analysis.py`. The JAX
package runs `jax.eval_shape` over two probe sizes for the unknown dims;
here the same two probes run through the lowered callable on ``meta``
tensors, which carry shapes and dtypes and do no device work. Dims that
stay fixed across the probes are known; dims that follow the probe are
unknown.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.lowering import build_callable
from ..schema import ScalarType, Shape
from .ir import Graph, GraphNode, parse_edge

__all__ = ["NodeSummary", "GraphSummary", "analyze_graph"]

# Probe sizes for unknown dims: distinct, so a dim equal to both probes
# cannot be mistaken for an unknown one.
_PROBES = (3, 5)
_META = torch.device("meta")


@dataclass
class NodeSummary:
    name: str
    is_input: bool
    is_output: bool
    dtype: ScalarType
    shape: Shape  # may contain unknown dims


@dataclass
class GraphSummary:
    inputs: Dict[str, NodeSummary]
    outputs: Dict[str, NodeSummary]


def _placeholder_spec(
    node: GraphNode, overrides: Dict[str, Shape]
) -> Tuple[ScalarType, Shape]:
    dtype = node.dtype_attr
    if dtype is None:
        raise ValueError(f"placeholder {node.name!r} has no dtype attr")
    shape = overrides.get(node.name, node.shape_attr)
    if shape is None:
        raise ValueError(
            f"placeholder {node.name!r} has no shape (attr or column); the "
            "reference requires placeholder shapes too"
        )
    return dtype, shape


_cache: Dict[tuple, GraphSummary] = {}
_cache_lock = threading.Lock()


def analyze_graph(
    graph: Graph,
    fetches: Sequence[str],
    placeholder_shapes: Optional[Dict[str, Shape]] = None,
) -> GraphSummary:
    """Classify inputs/outputs and infer dtypes + partial shapes.

    ``placeholder_shapes`` overrides placeholder shape attrs (the verbs
    inject column block shapes). Memoized on (graph fingerprint, fetches,
    overrides): analysis is pure.
    """
    overrides = dict(placeholder_shapes or {})
    key = (
        graph.fingerprint(),
        tuple(fetches),
        tuple(sorted((k, v.dims) for k, v in overrides.items())),
    )
    with _cache_lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit

    inputs: Dict[str, NodeSummary] = {}
    for ph in graph.placeholders():
        dtype, shape = _placeholder_spec(ph, overrides)
        inputs[ph.name] = NodeSummary(ph.name, True, False, dtype, shape)
    feed_names = list(inputs)
    fetch_list = list(fetches)
    fn = build_callable(graph, fetch_list, feed_names, _META)

    per_probe: List[Tuple[torch.Tensor, ...]] = []
    for probe in _PROBES:
        feeds = [
            torch.empty(
                tuple(probe if d is None else d for d in inputs[n].shape.dims),
                dtype=inputs[n].dtype.torch_dtype,
                device=_META,
            )
            for n in feed_names
        ]
        per_probe.append(fn(*feeds))

    outputs: Dict[str, NodeSummary] = {}
    for f, a, b in zip(fetch_list, per_probe[0], per_probe[1]):
        base = parse_edge(f)[0]
        merged = Shape(tuple(a.shape)).merge(Shape(tuple(b.shape)))
        if merged is None:
            raise ValueError(
                f"fetch {f!r}: output rank depends on the block size"
            )
        dtype = ScalarType.from_torch_dtype(a.dtype)
        outputs[base] = NodeSummary(base, False, True, dtype, merged)

    summary = GraphSummary(inputs=inputs, outputs=outputs)
    with _cache_lock:
        if len(_cache) > 1024:  # bound the memo
            _cache.clear()
        _cache[key] = summary
    return summary
