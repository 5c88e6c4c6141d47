"""Parallel layer of the PyTorch port: device meshes (`mesh`), the mesh
verbs (`verbs`, reached through ``mesh=`` on the five verbs), lockstep
collectives over a mesh axis (`collectives`), sharded tensors
(`sharding`), ring attention and the Ulysses all-to-all (`ring`), and the
GPipe pipeline (`pipeline`)."""

from . import collectives, verbs
from .mesh import Mesh, data_mesh, mesh_2d, shard_to_mesh
from .pipeline import pipeline_apply
from .ring import full_attention, ring_attention, ring_attention_reference, seq_all_to_all
from .sharding import P, PartitionSpec, Sharded, shard

__all__ = [
    "Mesh",
    "P",
    "PartitionSpec",
    "Sharded",
    "collectives",
    "data_mesh",
    "full_attention",
    "mesh_2d",
    "pipeline_apply",
    "ring_attention",
    "ring_attention_reference",
    "seq_all_to_all",
    "shard",
    "shard_to_mesh",
    "verbs",
]
