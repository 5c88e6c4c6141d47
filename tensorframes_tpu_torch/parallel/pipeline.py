"""Pipeline parallelism: GPipe-style staged execution over a mesh axis.

The PyTorch counterpart of `tensorframes_tpu/parallel/pipeline.py`. Each
device on the ``stage`` axis holds one stage's parameters; the batch is
split into microbatches that flow through the stages, the activations handed
to the next stage by `collectives.ppermute`. With S stages and M
microbatches the pipeline runs M + S - 1 ticks (the classic bubble).

The JAX function runs every stage at every tick under `shard_map` and keeps
only the results that carry a real microbatch; the port's lockstep loop runs
stage s at tick t only when it holds microbatch t - s, which computes the
same outputs. It is differentiable: autograd flows back through the stages
and the hand-offs.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping

import torch

from . import collectives
from .mesh import Mesh

__all__ = ["pipeline_apply"]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def pipeline_apply(
    stage_fn: Callable,
    stage_params: Any,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "stage",
    num_microbatches: int,
) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over the mesh's ``axis``.

    - ``stage_fn(params, h) -> h``: one stage's computation (the same on
      every stage; heterogeneous behaviour goes in the parameters);
    - ``stage_params``: a tree (dicts, lists, tuples) of tensors whose
      leading axis has the axis size; slice s sits on stage s's device;
    - ``x``: ``(batch, ...)``; ``num_microbatches`` must divide the batch.

    Returns the last stage's outputs for the whole batch, on x's device.
    """
    devices = collectives.axis_devices(mesh, axis)
    n_stage = len(devices)
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} must divide num_microbatches {num_microbatches}"
        )
    for leaf in _leaves(stage_params):
        if leaf.shape[:1] != (n_stage,):
            raise ValueError(
                f"a stage parameter of shape {tuple(leaf.shape)} needs a leading "
                f"axis of the {axis!r} axis size {n_stage}"
            )
    mb = batch // num_microbatches
    params = [_tree_map(lambda p, s=s: p[s].to(devices[s]), stage_params) for s in range(n_stage)]
    micro = [x[j * mb:(j + 1) * mb].to(devices[0]) for j in range(num_microbatches)]
    perm = [(s, s + 1) for s in range(n_stage - 1)]
    buf: List[Any] = [None] * n_stage
    outs = []
    for t in range(num_microbatches + n_stage - 1):
        h_out: List[Any] = [None] * n_stage
        for s in range(n_stage):
            if 0 <= t - s < num_microbatches:  # stage s holds microbatch t - s
                h_out[s] = stage_fn(params[s], micro[t] if s == 0 else buf[s])
        if t >= n_stage - 1:
            outs.append(h_out[-1])
        buf = collectives.ppermute(h_out, perm, devices)
    return torch.cat(outs, dim=0).to(x.device)
