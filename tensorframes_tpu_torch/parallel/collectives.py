"""Collectives over one mesh axis, in lockstep.

The JAX package takes ``ppermute``, ``psum``, ``pmax``, ``all_to_all`` and
``axis_index`` from `jax.lax` inside `shard_map`, where one program runs on
every device of the mesh. The port's mesh (`parallel.mesh.Mesh`) runs in one
process, its shards issued one after another by eager PyTorch, so each
collective here is a lockstep function: it takes the list of per-shard
tensors along one mesh axis, one tensor a device of that axis in axis order,
and returns that list after the collective. A shard's position in the list
is its ``axis_index``.

They are built from ``.to(device)``, sums, maxima and concatenation, so
autograd flows through them and gives JAX's transposes: the gradient of a
tensor copied to every shard comes back summed, that of a `psum` is a
`psum`, that of a `ppermute` the inverse permutation.

`axis_groups` splits a mesh's coordinates into the groups of one or more
named axes (the other axes fixed), so that a step can reduce over
``"model"`` alone or over ``("data", "seq")``.

Several slots of a mesh may name one device (the one-card smoke runs meshes
whose slots are all ``cuda:0``); a move between two such slots is then a
no-op, and nothing here keys state by device. A mesh over several
processes (`parallel.multihost`) is refused (`axis_groups`): there the
same move would drop another process's shard without an error.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .mesh import Mesh

__all__ = [
    "all_to_all",
    "axis_devices",
    "axis_groups",
    "pmax",
    "ppermute",
    "psum",
    "sum_to",
]

Coord = Tuple[int, ...]


def axis_groups(mesh: Mesh, axes: Union[str, Sequence[str]]) -> List[List[Coord]]:
    """The mesh's coordinates grouped over ``axes``: one group for each
    position of the other axes (row-major), each group's coordinates
    row-major over ``axes`` in the order given."""
    mesh.require_one_process("a lockstep collective")
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {a!r}; its axes are {mesh.axis_names}")
    shape = mesh.devices.shape
    inner = [mesh.axis_names.index(a) for a in axes]
    outer = [i for i in range(len(shape)) if i not in inner]
    groups = []
    for o in np.ndindex(*(shape[i] for i in outer)):
        group = []
        for a in np.ndindex(*(shape[i] for i in inner)):
            coord = [0] * len(shape)
            for i, v in zip(outer, o):
                coord[i] = v
            for i, v in zip(inner, a):
                coord[i] = v
            group.append(tuple(coord))
        groups.append(group)
    return groups


def axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along ``axis`` with every other axis at index 0: where a
    function shards over one axis and replicates over the rest, these run
    it."""
    return [mesh.devices[c] for c in axis_groups(mesh, axis)[0]]


def ppermute(
    xs: Sequence[Optional[torch.Tensor]],
    perm: Sequence[Tuple[int, int]],
    devices: Sequence[torch.device],
) -> List[Optional[torch.Tensor]]:
    """``out[dst] = xs[src]`` on ``devices[dst]`` for each ``(src, dst)``
    of ``perm``. A shard that receives nothing, or whose source is None,
    gets None (JAX gives zeros, which no caller of the port reads)."""
    out: List[Optional[torch.Tensor]] = [None] * len(devices)
    for src, dst in perm:
        if xs[src] is not None:
            out[dst] = xs[src].to(devices[dst])
    return out


def sum_to(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards on ``device``, added in shard order."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of all shards, on every shard's device."""
    total = sum_to(xs, xs[0].device)
    return [total.to(x.device) for x in xs]


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise maximum of all shards, on every shard's device."""
    dev = xs[0].device
    top = xs[0]
    for x in xs[1:]:
        top = torch.maximum(top, x.to(dev))
    return [top.to(x.device) for x in xs]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """`jax.lax.all_to_all` with ``tiled=True``: shard i cuts its tensor
    into ``n`` equal blocks along ``split_axis`` and sends block j to shard
    j, which concatenates the blocks it receives, in source order, along
    ``concat_axis``."""
    n = len(xs)
    blocks = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [
        torch.cat([blocks[i][j].to(xs[j].device) for i in range(n)], dim=concat_axis)
        for j in range(n)
    ]
