"""Frame and parameter checkpoints (npz).

The PyTorch counterpart of `tensorframes_tpu/utils/checkpoint.py`, in the
same file layouts, so each package reads what the other wrote:

- frames: `save_frame` / `load_frame`, a columnar npz: ``__offsets__``
  (block offsets), ``__columns__`` (names), and per column
  ``dtype::<name>`` with ``dense::<name>`` (the values; a device column is
  copied to the host) or ``ragged::<name>`` (an object array of cells).
  `load_frame` gives host columns, as the io readers do;
- parameters: `save_params` / `load_params`, an npz of the leaves
  ``leaf0, leaf1, ...`` in JAX's flattening order (dict keys sorted, lists
  and tuples in order; `models.training.tree_leaves`) beside a
  ``__treedef__`` entry. `load_params` restores them into the
  structure of ``like``, each tensor on the device of ``like``'s leaf.
  A sharded leaf (`parallel.sharding.Sharded`) is saved gathered, as JAX
  saves a global array, and restored onto ``like``'s mesh and spec, as
  JAX's restore takes ``like``'s shardings. This is the JAX package's npz
  fallback; the card has no Orbax, so there is no directory format.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch

from ..frame import Column, TensorFrame
from ..models.training import tree_leaves
from ..parallel.sharding import Sharded, shard
from ..schema import ScalarType

__all__ = ["save_frame", "load_frame", "save_params", "load_params"]


def _object_vector(cells) -> np.ndarray:
    """A 1-D object array of cells (``np.asarray(..., dtype=object)``
    would stack cells that share a shape into one array)."""
    cells = list(cells)
    out = np.empty(len(cells), dtype=object)
    for i, c in enumerate(cells):
        out[i] = np.asarray(c)
    return out


def save_frame(path: str, frame: TensorFrame) -> None:
    """Serialize a TensorFrame (columns, dtypes and block offsets) to npz."""
    payload: Dict[str, Any] = {
        "__offsets__": np.asarray(frame.offsets, dtype=np.int64),
        "__columns__": np.asarray(frame.columns, dtype=object),
    }
    for name in frame.columns:
        c = frame.column(name)
        payload[f"dtype::{name}"] = np.asarray(c.dtype.value)
        if c.is_dense:
            payload[f"dense::{name}"] = c.host_values()
        else:
            payload[f"ragged::{name}"] = _object_vector(c.rows())
    np.savez(path, **payload)


def load_frame(path: str) -> TensorFrame:
    """The frame `save_frame` wrote, with host columns."""
    with np.load(path, allow_pickle=True) as data:
        offsets = data["__offsets__"].tolist()
        names = data["__columns__"].tolist()
        cols = []
        for name in names:
            dtype = ScalarType(str(data[f"dtype::{name}"]))
            if f"dense::{name}" in data:
                cols.append(Column(name, data[f"dense::{name}"], dtype))
            else:
                cols.append(Column(name, list(data[f"ragged::{name}"]), dtype))
    return TensorFrame(cols, offsets)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, Sharded):
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_params(path: str, params: Any) -> None:
    """Checkpoint a tree of tensors (model parameters, optimizer moments)."""
    leaves = tree_leaves(params)
    # the JAX package's reader counts the leaves as the entries but one
    np.savez(
        path,
        __treedef__=np.asarray(type(params).__name__),
        **{f"leaf{i}": _host(leaf) for i, leaf in enumerate(leaves)},
    )


def _unflatten(like: Any, leaves: Iterator) -> Any:
    """A tree shaped as ``like`` (a `ParameterDict` becomes a dict, a
    `ParameterList` a list), its leaves taken from ``leaves`` in
    `tree_leaves` order, each tensor on the device of ``like``'s leaf and
    each sharded leaf laid out as ``like``'s."""
    if isinstance(like, (Mapping, torch.nn.ParameterDict)):
        values = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: values[k] for k in like}
    if isinstance(like, tuple):
        return tuple(_unflatten(t, leaves) for t in like)
    if isinstance(like, (list, torch.nn.ParameterList)):
        return [_unflatten(t, leaves) for t in like]
    arr = next(leaves)
    if isinstance(like, Sharded):
        return shard(torch.from_numpy(arr), like.mesh, like.spec)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def load_params(path: str, like: Any = None) -> Any:
    """Restore a `save_params` checkpoint (or one the JAX package wrote
    through its npz fallback) into the structure of ``like``."""
    if like is None:
        raise ValueError("npz restore needs `like` for the tree structure")
    with np.load(path, allow_pickle=True) as data:
        leaves = [data[f"leaf{i}"] for i in range(len(data.files) - 1)]
    want = len(tree_leaves(like))
    if len(leaves) != want:
        raise ValueError(f"{path}: {len(leaves)} leaves, `like` has {want}")
    return _unflatten(like, iter(leaves))
