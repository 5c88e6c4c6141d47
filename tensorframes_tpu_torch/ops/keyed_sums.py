"""Keyed sums: the per-group sums of several row-wise outputs and the group
counts in one pass, the hand-written CUDA kernel and its plain PyTorch
version.

The segment plans of `aggregate` (`aggregate._segment_tables`, the
per-device step of `aggregate._aggregate_segment` and of the mesh plan of
`parallel.verbs.aggregate`) sum every ``sum`` and ``mean`` fetch's
transform output by group id and count the rows of each group.
`keyed_sums` does all of it in one launch of ``csrc/keyed_sums.cu`` on
CUDA tensors (each row's id and values read once, the tables kept in
shared memory, float32 adds bounded to tiles of 4096 rows and carried in
float64). `takes_kernel` says from the device, the dtypes and the table's
size whether the kernel takes a call; `_segment_tables` routes what it
does not take to ``ops.standard.segment_reduce``. `keyed_sums_reference`
is the plain version the kernel is held against. There is no fallback
from the kernel to the plain version. ``keyed_sums.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Sequence, Tuple

import torch

from ._cuda_build import check, load_library
from .standard import segment_reduce

__all__ = ["keyed_sums", "keyed_sums_reference", "takes_kernel", "row_width"]

# element bytes of the dtypes the kernel sums
_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}
# the most outputs one launch takes (csrc/keyed_sums.cu refuses more: kMaxOutputs)
_MAX_OUTPUTS = 8
# the most accumulators of a table, groups x (summed row widths + the count):
# a float64 running table of 64 KB and a tile table of at most 96 KB in one
# block's shared memory (227 KB on Hopper), so at least one block fits an SM
_MAX_SLOTS = 8192
# the shared memory the tile tables may take in one of the layouts that
# share them out (csrc/keyed_sums.cu: layout_of), so that four blocks fit an SM
_TABLES_BYTES = 48 * 1024


def row_width(t: torch.Tensor) -> int:
    """The values a row of ``t`` holds: the product of its cell shape."""
    return math.prod(t.shape[1:])


def takes_kernel(device: torch.device, dtypes: Sequence[torch.dtype], groups: int,
                 widths: Sequence[int]) -> bool:
    """Whether the kernel takes a call: CUDA tensors, 1 to `_MAX_OUTPUTS`
    outputs of one dtype, float32 or float64, each row at least one value,
    and a table of at most `_MAX_SLOTS` accumulators, the count column
    included."""
    return (
        torch.device(device).type == "cuda"
        and 1 <= len(dtypes) <= _MAX_OUTPUTS
        and len(set(dtypes)) == 1
        and dtypes[0] in _ELEM_BYTES
        and groups >= 1
        and min(widths) >= 1
        and groups * (sum(widths) + 1) <= _MAX_SLOTS
    )


def keyed_sums_reference(
    values: Sequence[torch.Tensor], ids: torch.Tensor, groups: int
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version: ``(tables, counts)``, one ``(groups, *cell)``
    table of per-group sums a value tensor (`segment_reduce`'s sum: float
    rows added in chunks of 4096, the chunk sums then added) and the int64
    rows of each group. Ids outside ``[0, groups)`` are dropped."""
    tables = [segment_reduce(v, ids, groups, "sum") for v in values]
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < groups), ids, groups)
    counts = torch.bincount(ids, minlength=groups + 1)[:groups]
    return tables, counts


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc/keyed_sums.cu's C entries: name -> (argtypes, restype)
_ENTRIES = {
    "tfs_keyed_sums_plan": ([_I32, _I64, _I32, _I32, _PTR, _PTR, _I32, _PTR], _I32),
    "tfs_keyed_sums": (
        [_I32, _PTR, _I64, _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _PTR], _I32),
    "tfs_keyed_sums_error_string": ([_I32], ctypes.c_char_p),
}


_PLAN = ("stride", "positions", "warps", "pitch", "spread", "lanes", "shifted", "smem", "blocks")


def _plan(values: Sequence[torch.Tensor], n: int, groups: int,
          tables_bytes: int = _TABLES_BYTES) -> Dict[str, int]:
    """The kernel's plan for ``n`` rows of ``values`` (CUDA tensors of one
    dtype, contiguous) into ``groups`` groups, as ``csrc/keyed_sums.cu``
    makes it: the tile tables' layout (``layout_of``, within
    ``tables_bytes``), its dynamic shared memory and its thread blocks."""
    k = len(values)
    out = (ctypes.c_int * len(_PLAN))()
    lib = load_library("keyed_sums", _ENTRIES)
    with torch.cuda.device(values[0].device):
        rc = lib.tfs_keyed_sums_plan(
            _ELEM_BYTES[values[0].dtype], n, groups, k,
            (ctypes.c_void_p * k)(*[v.data_ptr() for v in values]),
            (ctypes.c_int * k)(*[row_width(v) for v in values]), tables_bytes, out,
        )
    check(rc, "keyed_sums plan", lib.tfs_keyed_sums_error_string)
    return dict(zip(_PLAN, out))


def _launch(values: Sequence[torch.Tensor], ids: torch.Tensor, groups: int,
            tables_bytes: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One launch of the kernel on CUDA tensors `keyed_sums` has checked,
    its tile tables within ``tables_bytes`` of shared memory where one of
    the layouts that share them out fits."""
    dev, dtype, n = ids.device, values[0].dtype, ids.shape[0]
    ids = ids.to(torch.int64).contiguous()
    values = [v.contiguous() for v in values]
    widths = [row_width(v) for v in values]
    tables = [torch.empty((groups,) + tuple(v.shape[1:]), dtype=dtype, device=dev)
              for v in values]
    counts = torch.empty(groups, dtype=torch.int64, device=dev)
    if n == 0:
        for t in tables:
            t.zero_()
        return tables, counts.zero_()
    k, blocks = len(values), _plan(values, n, groups, tables_bytes)["blocks"]
    lib = load_library("keyed_sums", _ENTRIES)
    with torch.cuda.device(dev):
        partials = torch.empty(blocks * groups * (sum(widths) + 1), dtype=torch.float64,
                               device=dev)
        rc = lib.tfs_keyed_sums(
            _ELEM_BYTES[dtype], ids.data_ptr(), n, groups, k,
            (ctypes.c_void_p * k)(*[v.data_ptr() for v in values]),
            (ctypes.c_int * k)(*widths),
            (ctypes.c_void_p * k)(*[t.data_ptr() for t in tables]),
            counts.data_ptr(), partials.data_ptr(), blocks, tables_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "keyed_sums launch", lib.tfs_keyed_sums_error_string)
    keyed_sums.launches += 1
    return tables, counts


def keyed_sums(
    values: Sequence[torch.Tensor], ids: torch.Tensor, groups: int
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(tables, counts)`` from one launch of the kernel: each value
    tensor's ``(groups, *cell)`` per-group sums, in its dtype, and the int64
    rows of each group; rows whose id is outside ``[0, groups)`` are
    dropped. ``values`` share ``ids``' device and row count. Raises
    `ValueError` where `takes_kernel` refuses them (CPU tensors included)."""
    n = ids.shape[0]
    for v in values:
        if v.device != ids.device or v.dim() < 1 or v.shape[0] != n:
            raise ValueError(
                f"keyed_sums: values {tuple(v.shape)} on {v.device} against {n} ids on {ids.device}"
            )
    widths = [row_width(v) for v in values]
    if not takes_kernel(ids.device, [v.dtype for v in values], groups, widths):
        raise ValueError(
            f"keyed_sums: no kernel for {[v.dtype for v in values]} of widths {widths} "
            f"into {groups} groups on {ids.device}"
        )
    return _launch(values, ids, groups, _TABLES_BYTES)


keyed_sums.launches = 0
