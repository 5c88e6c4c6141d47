"""Graph -> torch callable lowering.

The PyTorch counterpart of `tensorframes_tpu/ops/lowering.py`.
`build_callable` turns a `Graph` + fetch list into a plain function of the
placeholder tensors that runs every node's rule eagerly on one device.
Constant subgraphs are evaluated once at build time on the CPU, and the
constants the calls need are uploaded to the device once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..graph.ir import Graph, parse_edge
from .registry import GraphLoweringError, LowerCtx, get_rule
from . import standard  # noqa: F401  (populates the registry)
from . import control  # noqa: F401  (_Cond/_While and TensorList rules)

__all__ = ["build_callable", "supported", "GraphLoweringError"]

_PLACEHOLDERS = ("Placeholder", "PlaceholderV2")
_CPU = torch.device("cpu")


def supported(graph: Graph, fetches: Sequence[str]) -> Tuple[bool, str]:
    """Whether every op in the closure of ``fetches`` has a rule:
    ``(True, "")``, or ``(False, reason)`` naming the first op without
    one."""
    for node in graph.toposort(list(fetches)):
        if node.op in _PLACEHOLDERS:
            continue
        if get_rule(node.op) is None:
            return False, f"unsupported op {node.op!r} (node {node.name!r})"
    return True, ""


def _host(out):
    """A rule's output as host numpy (a tuple stays a tuple)."""
    if isinstance(out, tuple):
        return tuple(_host(v) for v in out)
    if isinstance(out, torch.Tensor):
        from ..frame import _to_numpy

        return _to_numpy(out)
    return np.asarray(out)


def build_callable(
    graph: Graph,
    fetches: Sequence[str],
    feed_names: Sequence[str],
    device: torch.device,
    row_axis: bool = False,
) -> Callable[..., Tuple[Any, ...]]:
    """Build ``fn(*feed_tensors) -> tuple(fetch_values)`` running on
    ``device`` (``meta`` for shape probes).

    ``feed_names`` fixes the positional order of placeholder arguments.
    Fetches may use ``name:k`` syntax. ``row_axis`` lowers a per-row graph
    lifted to block level (`LowerCtx.row_axis`).
    """
    order = graph.toposort(list(fetches))
    feed_pos = {name: i for i, name in enumerate(feed_names)}
    for node in order:
        if node.op in _PLACEHOLDERS:
            if node.name not in feed_pos:
                raise GraphLoweringError(
                    f"placeholder {node.name!r} is not fed; feeds: {list(feed_names)}"
                )
        elif get_rule(node.op) is None:
            raise GraphLoweringError(
                f"unsupported op {node.op!r} (node {node.name!r}); the "
                "PyTorch port lowers "
                "tensorframes_tpu_torch.ops.registry.registered_ops()"
            )

    # control-flow rules resolve their body Subgraphs through the ctx
    ctx = LowerCtx(device, graph, row_axis)
    host_ctx = LowerCtx(_CPU, graph, row_axis)

    # Constant subgraphs (no placeholder ancestors) are evaluated ONCE
    # here, on the host, and their numpy results baked into every call:
    # shape arithmetic stays a build-time fact a downstream `ctx.static`
    # can read, and weight chains are not recomputed per call.
    const_env: Dict[Tuple[str, int], Any] = {}
    for node in order:
        if node.op in _PLACEHOLDERS:
            continue
        ins: List[Any] = []
        for edge in node.inputs:
            dep, idx, ctrl = parse_edge(edge)
            if ctrl:
                continue
            if (dep, idx) not in const_env:
                break
            ins.append(const_env[(dep, idx)])
        else:
            out = _host(get_rule(node.op).fn(host_ctx, node, ins))
            for i, v in enumerate(out if isinstance(out, tuple) else (out,)):
                const_env[(node.name, i)] = v
    # upload once the constants a call consumes as tensors (const_env keeps
    # every pinned array alive for the life of the callable)
    used = {parse_edge(f)[:2] for f in fetches}
    for node in order:
        if (node.name, 0) not in const_env:
            used.update(
                (dep, idx)
                for dep, idx, ctrl in map(parse_edge, node.inputs)
                if not ctrl
            )
    for key in used & const_env.keys():
        ctx.pin(const_env[key])

    # the call plan, resolved once: (node, rule, input keys) per computed
    # node, the feed position per placeholder (control edges only order)
    steps: List[Tuple[Any, Any, List[Tuple[str, int]]]] = []
    feed_steps: List[Tuple[Tuple[str, int], int]] = []
    for node in order:
        if (node.name, 0) in const_env:
            continue
        if node.op in _PLACEHOLDERS:
            feed_steps.append(((node.name, 0), feed_pos[node.name]))
            continue
        keys = [(dep, idx) for dep, idx, ctrl in map(parse_edge, node.inputs) if not ctrl]
        steps.append((node, get_rule(node.op).fn, keys))
    fetch_keys = [parse_edge(f)[:2] for f in fetches]

    def fn(*feed_arrays):
        if len(feed_arrays) != len(feed_pos):
            raise ValueError(
                f"expected {len(feed_pos)} feeds {list(feed_names)}, "
                f"got {len(feed_arrays)}"
            )
        env: Dict[Tuple[str, int], Any] = dict(const_env)
        for key, pos in feed_steps:
            env[key] = feed_arrays[pos]
        for node, rule, keys in steps:
            try:
                ins = [env[k] for k in keys]
            except KeyError:
                missing = next(k for k in keys if k not in env)
                raise GraphLoweringError(
                    f"node {node.name!r} consumes output {missing[1]} of "
                    f"{missing[0]!r} which was not produced"
                ) from None
            out = rule(ctx, node, ins)
            if isinstance(out, tuple):
                for i, v in enumerate(out):
                    env[(node.name, i)] = v
            else:
                env[(node.name, 0)] = out
        results = []
        for f, key in zip(fetches, fetch_keys):
            if key not in env:
                raise GraphLoweringError(f"fetch {f!r} was not produced")
            results.append(ctx.tensor(env[key]))
        return tuple(results)

    return fn
