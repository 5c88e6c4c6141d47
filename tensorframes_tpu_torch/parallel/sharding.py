"""Sharded tensors: a global tensor laid out over a mesh, one shard a device.

The JAX package places a global array on a mesh with
``jax.device_put(x, NamedSharding(mesh, PartitionSpec(...)))`` and gets back
one array whose shards live on the mesh's devices. The port's counterpart is
`Sharded`: the mesh, the `PartitionSpec`, the global shape, and the shard
on each mesh slot. A spec entry names the mesh axis (or a tuple of axes)
that splits that dimension, or None; the axes it leaves out replicate the
shard. ``gather(device)`` puts the global tensor back together.

`shard` cuts a tensor by a spec; `as_sharded` does so unless the tensor is
already laid out that way, so a step may take either the global tensors or
its own sharded output. The distinct blocks of a `Sharded` sit at its
"home" slots (every axis the spec leaves out at index 0); a training step
makes each block one autograd leaf and copies it to every slot that holds
it (`models.training.sgd_sharded`), so autograd sums the gradient over the
replicas as JAX's VMA ``psum`` does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["P", "PartitionSpec", "Sharded", "as_sharded", "shard"]

Coord = Tuple[int, ...]


class PartitionSpec(tuple):
    """``P("data", None)``: per dimension, the mesh axis (or tuple of
    axes) that splits it, or None. Missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharded:
    """A global tensor of ``shape`` laid out over ``mesh`` by ``spec``:
    ``shards[coord]`` is the block on mesh slot ``coord``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, shape, shards: np.ndarray):
        mesh.require_one_process("a sharded tensor")
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.shape = torch.Size(shape)
        self.shards = shards
        used = [a for e in self.spec for a in _entry_axes(e)]
        for a in used:
            if a not in mesh.axis_names:
                raise ValueError(f"spec {self.spec} names axis {a!r}, not in {mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")
        if len(self.spec) > len(self.shape):
            raise ValueError(f"spec {self.spec} is longer than the shape {tuple(self.shape)}")
        self._used = {mesh.axis_names.index(a) for a in used}

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def coords(self) -> Iterator[Coord]:
        return np.ndindex(*self.mesh.devices.shape)

    def home(self, coord: Coord) -> Coord:
        """The slot that holds ``coord``'s block first: the axes the spec
        leaves out set to 0."""
        return tuple(c if i in self._used else 0 for i, c in enumerate(coord))

    def homes(self):
        """The slots of the distinct blocks."""
        return [c for c in self.coords() if self.home(c) == c]

    def block_slices(self, coord: Coord) -> Tuple[slice, ...]:
        """Where ``coord``'s block sits in the global tensor."""
        return _block_slices(self.mesh, self.spec, self.shape, coord)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first
        device)."""
        device = self.mesh.devices.flat[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for h in self.homes():
            out[self.block_slices(h)] = self.shards[h].to(device)
        return out

    @classmethod
    def from_blocks(cls, mesh: Mesh, spec, shape, blocks: Dict[Coord, torch.Tensor]) -> "Sharded":
        """A `Sharded` whose home slots hold ``blocks`` and every other
        slot a copy of its home's block on its own device."""
        out = cls(mesh, spec, shape, np.empty(mesh.devices.shape, dtype=object))
        for c in out.coords():
            out.shards[c] = blocks[out.home(c)].to(mesh.devices[c])
        return out

    def __repr__(self) -> str:
        return f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, mesh={self.mesh})"


def _block_slices(mesh: Mesh, spec, shape, coord: Coord) -> Tuple[slice, ...]:
    sizes = mesh.shape
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        parts, idx = 1, 0
        for a in _entry_axes(entry):
            idx = idx * sizes[a] + coord[mesh.axis_names.index(a)]
            parts *= sizes[a]
        if n % parts:
            raise ValueError(
                f"dimension {dim} of size {n} is not evenly divisible by the "
                f"{parts} shards of spec entry {entry!r}"
            )
        per = n // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def shard(t: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """``t`` cut by ``spec`` onto ``mesh``: each distinct block made
    contiguous once and copied to every slot that holds it."""
    layout = Sharded(mesh, spec, t.shape, None)
    blocks = {h: t[layout.block_slices(h)].contiguous() for h in layout.homes()}
    return Sharded.from_blocks(mesh, spec, t.shape, blocks)


def as_sharded(t: Union[torch.Tensor, Sharded], mesh: Mesh, spec) -> Sharded:
    """``t`` laid out over ``mesh`` by ``spec``: itself when it already is,
    else (a global tensor, or a `Sharded` laid out otherwise) cut anew."""
    spec = PartitionSpec(*spec)
    if isinstance(t, Sharded):
        if t.mesh == mesh and _padded(t.spec, t.ndim) == _padded(spec, t.ndim):
            return t
        t = t.gather()
    return shard(t, mesh, spec)


def _padded(spec, ndim: int) -> Tuple[Optional[object], ...]:
    return tuple(spec) + (None,) * (ndim - len(spec))
