"""Parallel layer of the PyTorch port: device meshes (`mesh`), the mesh
verbs (`verbs`, reached through ``mesh=`` on the five verbs) and
`ring.full_attention`."""

from .mesh import Mesh, data_mesh, mesh_2d, shard_to_mesh
from .ring import full_attention
from . import verbs

__all__ = [
    "Mesh",
    "data_mesh",
    "mesh_2d",
    "shard_to_mesh",
    "verbs",
    "full_attention",
]
