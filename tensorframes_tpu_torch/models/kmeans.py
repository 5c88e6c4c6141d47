"""k-means over TensorFrames.

The PyTorch counterpart of `tensorframes_tpu/models/kmeans.py`, itself the
re-design of the reference's flagship demo (`kmeans_demo.py`): per-block
assignment + `UnsortedSegmentSum` partials inside a trimmed `map_blocks`
with the centres bound, then the Lloyd update on the host. The points may
sit on the device; only the ``(blocks * k, dim + 1)`` partials come back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import api
from ..device import DeviceLike, resolve_device
from ..frame import TensorFrame
from ..graph import builder as dsl
from ..schema import ScalarType, Shape

__all__ = ["kmeans"]


def _assignment_graph(k: int, dim: int, np_dtype, feature_col: str):
    """Trimmed map_blocks graph: block of points -> (k, dim+1) partials,
    one row per centre: [sum of its points, their count]. The centres are
    a bound placeholder, so one lowering serves every iteration."""
    st = ScalarType.from_np_dtype(np.dtype(np_dtype))
    pts = dsl.placeholder(st, Shape((None, dim)), name=feature_col)
    c = dsl.placeholder(st, Shape((k, dim)), name="centers")
    # squared distances via ||p||^2 - 2 p.c + ||c||^2 ; argmin over k
    p2 = dsl.reduce_sum(dsl.square(pts), axes=[1], keep_dims=True)  # (n,1)
    pc = dsl.matmul(pts, c, transpose_b=True)  # (n,k)
    c2 = dsl.reduce_sum(dsl.square(c), axes=[1])  # (k,)
    d = p2 - 2.0 * pc + c2  # broadcast -> (n,k)
    assign32 = dsl.cast(dsl.argmin(d, axis=1), ScalarType.int32)
    # concat [points, 1] so one segment-sum yields sums AND counts
    ones_n = dsl.reduce_sum(pts * 0.0, axes=[1], keep_dims=True) + 1.0  # (n,1)
    aug = dsl.concat([pts, ones_n], axis=1)  # (n, dim+1)
    return dsl.unsorted_segment_sum(aug, assign32, k).named("partial")


def kmeans(
    frame: TensorFrame,
    feature_col: str,
    k: int,
    num_iters: int = 10,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd iterations; returns (centers, counts) as host numpy. The
    initial centres are ``k`` distinct rows drawn by
    ``numpy.random.RandomState(seed)``, as in the JAX model."""
    if num_iters < 1:
        raise ValueError("kmeans needs num_iters >= 1")
    dev = resolve_device(device)
    col = frame.column(feature_col)
    if col.cell_shape.rank != 1:
        raise ValueError("kmeans needs a dense rank-1 feature column")
    n, dim = len(col), col.cell_shape.dims[0]
    picks = np.random.RandomState(seed).choice(n, size=k, replace=False)
    values = col.values
    if isinstance(values, torch.Tensor):
        centers = values[torch.from_numpy(picks).to(values.device)].cpu().numpy()
    else:
        centers = values[picks].copy()
    counts = np.zeros(k)

    partial = _assignment_graph(k, dim, centers.dtype, feature_col)
    for _ in range(num_iters):
        part_frame = api.map_blocks(
            partial, frame, trim=True, bindings={"centers": centers}, device=dev
        )
        parts = part_frame.host_values("partial").reshape(-1, k, dim + 1)
        totals = parts.sum(axis=0)  # (k, dim+1)
        counts = totals[:, -1]
        sums = totals[:, :-1]
        nonempty = counts > 0
        centers = centers.copy()
        centers[nonempty] = sums[nonempty] / counts[nonempty, None]
    return centers, counts
