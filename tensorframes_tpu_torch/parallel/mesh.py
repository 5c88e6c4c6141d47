"""Device meshes: the substrate the mesh verbs (`parallel.verbs`) shard over.

The PyTorch counterpart of `tensorframes_tpu/parallel/mesh.py`. A `Mesh` is
an array of `torch.device` with named axes (``data`` is the row axis every
verb shards over, ``model`` the tensor-parallel axis), as `jax.sharding.Mesh`
is an array of JAX devices: ``mesh.devices.size`` is the device count and
``mesh.shape["data"]`` the size of the data axis.

`data_mesh()` takes every visible CUDA card (``torch.cuda.device_count()``)
and raises when there is none: a mesh never falls back to the CPU. The CPU
runs only through an explicit device list, for example
``data_mesh(devices=["cpu"] * 8)``, the CPU tests' stand-in for the JAX
package's 8 virtual CPU devices.

A mesh may span processes (`parallel.multihost.global_data_mesh`): each
slot then records the rank that owns it (``ranks``), and a slot's device
names a device of that rank. Its identity (equality, hashing, the
executor's cache keys) names the rank beside the device, since two
processes' ``cuda:0`` are two slots. Only the data-mesh verbs run over such
a mesh, each process its own slots; the lockstep paths, which move
tensors between slots inside one process, refuse it
(`require_one_process`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["Mesh", "data_mesh", "mesh_2d", "shard_to_mesh"]


class Mesh:
    """Devices in an array whose axes carry names; ``ranks`` (same shape,
    default all 0) names the process that owns each slot."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {arr.ndim} dims needs {arr.ndim} axis names, got {list(axis_names)}"
            )
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.ranks = (
            np.zeros(arr.shape, dtype=np.int64) if ranks is None
            else np.asarray(ranks, dtype=np.int64).reshape(arr.shape)
        )

    @property
    def process_count(self) -> int:
        """The number of processes owning the mesh's slots."""
        return len(set(self.ranks.flat))

    def local_slots(self, rank: int) -> List[int]:
        """The row-major indices of the slots ``rank`` owns."""
        return [i for i, r in enumerate(self.ranks.flat) if r == rank]

    def require_one_process(self, what: str) -> None:
        """Raise when the mesh spans processes: ``what`` moves tensors
        between slots in one process, and another process's slot would
        silently drop its data."""
        if self.process_count > 1:
            raise ValueError(
                f"{what} runs every slot of its mesh in lockstep in one process, "
                f"and this mesh spans {self.process_count} processes; across "
                "processes only the data-mesh verbs run (parallel.multihost)"
            )

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        """The devices in row-major order: shard ``d`` runs on entry ``d``."""
        return list(self.devices.flat)

    def _key(self):
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat),
                tuple(int(r) for r in self.ranks.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        if self.process_count > 1:
            slots = [f"r{r}/{d}" for r, d in zip(self.ranks.flat, self.devices.flat)]
        else:
            slots = [str(d) for d in self.devices.flat]
        return f"Mesh({axes}; {slots})"


def _devices(devices: Sequence[DeviceLike]) -> List[torch.device]:
    return [resolve_device(d) for d in devices]


def _visible_cards() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a mesh takes every visible CUDA card by default, and none is "
            "visible here (torch.cuda.device_count() is 0); pass devices=[...] "
            "to build one, for example devices=['cpu'] * 8 on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def data_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the ``data`` axis (the verbs' default): every visible
    card, or the first ``num_devices`` of them, or exactly ``devices``."""
    if devices is None:
        devices = _visible_cards()
        if num_devices is not None:
            devices = devices[:num_devices]
    else:
        devices = _devices(devices)
    return Mesh(np.asarray(devices, dtype=object), ("data",))


def mesh_2d(data: int, model: int, devices=None) -> Mesh:
    """2-D ``data x model`` mesh (the models' data- and tensor-parallel
    layout)."""
    devices = _visible_cards() if devices is None else _devices(devices)
    if len(devices) < data * model:
        raise ValueError(
            f"need {data * model} devices for a {data}x{model} mesh, have {len(devices)}"
        )
    arr = np.asarray(devices[: data * model], dtype=object)
    return Mesh(arr.reshape(data, model), ("data", "model"))


def shard_to_mesh(mesh: Mesh, t) -> List[torch.Tensor]:
    """Split ``t`` over the mesh's ``data`` axis by its lead dim: one shard
    a device, each on its device. A lead dim that the axis does not divide
    is padded to the next multiple by repeating the last row
    (`shape_policy.pad_lead`); the caller slices the pad rows back off."""
    from ..frame import as_tensor
    from ..shape_policy import pad_lead

    ndata = mesh.shape["data"]
    n = t.shape[0]
    if n % ndata:
        t = pad_lead(t, n, n + (ndata - n % ndata))
    per = t.shape[0] // ndata
    return [
        as_tensor(t[i * per:(i + 1) * per], d)
        for i, d in enumerate(mesh.devices.reshape(ndata, -1)[:, 0])
    ]
