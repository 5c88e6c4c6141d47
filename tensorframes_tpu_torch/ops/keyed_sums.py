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
float64). A launch reads value tensors (its sources) and sums outputs,
each a source through an op of `LOAD_OPS` applied as the value loads: by
default one identity output a value tensor (the transform materialised
by the plan), and where the transform is only columns and their squares
the plan passes the columns themselves, each read once, and the squares
never reach device memory (`aggregate._column_loads`). `takes_kernel` says
from the device, the dtypes and the table's size whether the kernel takes
a call, and `takes_launch` the same of a launch's values and outputs;
`_segment_tables` routes what it does not take to
``ops.standard.segment_reduce``. `launch_flops` is what the cost ledger
counts of a launch. `keyed_sums_reference` is the plain
version the kernel is held against (the outputs materialised, then
summed). There is no fallback from the kernel to the plain version.
``keyed_sums.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ._cuda_build import check, load_library
from .standard import segment_reduce

__all__ = ["keyed_sums", "keyed_sums_reference", "takes_kernel", "takes_launch", "launch_flops",
           "row_width", "LOAD_OPS"]

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
# what an output applies to its source's values as they load, and its code
# in csrc/keyed_sums.cu (kIdentity, kSquare); the square rounds as
# torch.square does
LOAD_OPS = {"identity": 0, "square": 1}
_PLAIN_OPS = {"identity": lambda x: x, "square": torch.square}


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


Outputs = Sequence[Tuple[int, str]]


def takes_launch(values: Sequence, groups: int, outputs: Optional[Outputs] = None) -> bool:
    """Whether the kernel takes a launch of ``outputs`` (as `keyed_sums`
    reads them; by default one identity output a value tensor) over
    ``values`` (anything with a device, a dtype and a shape) into
    ``groups`` groups: `takes_kernel` of the outputs' dtypes and widths."""
    read = [values[src] for src, _ in _outputs(values, outputs)]
    return bool(read) and takes_kernel(read[0].device, [v.dtype for v in read], groups,
                                       [row_width(v) for v in read])


def launch_flops(values: Sequence[torch.Tensor], outputs: Optional[Outputs] = None) -> int:
    """The flops of a launch, as the cost ledger counts them: an add an
    output value and a product a squared one (the count column's adds are
    not counted)."""
    return sum(values[src].numel() * (2 if op == "square" else 1)
               for src, op in _outputs(values, outputs))


def _outputs(values: Sequence[torch.Tensor], outputs: Optional[Outputs]) -> List[Tuple[int, str]]:
    """``outputs`` checked against ``values`` (each output reads one of them
    through an op of `LOAD_OPS`, each feeds at least one output), or one
    identity output a value tensor where it is None."""
    if outputs is None:
        return [(i, "identity") for i in range(len(values))]
    outputs = list(outputs)
    if ({src for src, _ in outputs} != set(range(len(values)))
            or any(op not in LOAD_OPS for _, op in outputs)):
        raise ValueError(f"keyed_sums: outputs {outputs} of {len(values)} value tensors")
    return outputs


def keyed_sums_reference(
    values: Sequence[torch.Tensor], ids: torch.Tensor, groups: int,
    outputs: Optional[Outputs] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version: ``(tables, counts)``, one ``(groups, *cell)``
    table of per-group sums an output (`segment_reduce`'s sum: float rows
    added in chunks of 4096, the chunk sums then added; an output's values
    materialised first) and the int64 rows of each group. Ids outside
    ``[0, groups)`` are dropped."""
    tables = [segment_reduce(_PLAIN_OPS[op](values[src]), ids, groups, "sum")
              for src, op in _outputs(values, outputs)]
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < groups), ids, groups)
    counts = torch.bincount(ids, minlength=groups + 1)[:groups]
    return tables, counts


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc/keyed_sums.cu's C entries: name -> (argtypes, restype)
_ENTRIES = {
    "tfs_keyed_sums_plan": (
        [_I32, _I64, _I32, _I32, _PTR, _PTR, _I32, _PTR, _PTR, _I32, _PTR], _I32),
    "tfs_keyed_sums": (
        [_I32, _PTR, _I64, _I32, _I32, _PTR, _PTR, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
         _PTR], _I32),
    "tfs_keyed_sums_error_string": ([_I32], ctypes.c_char_p),
}


_PLAN = ("stride", "positions", "warps", "pitch", "spread", "lanes", "shifted", "smem", "blocks")


def _c_args(values: Sequence[torch.Tensor], outputs: Outputs) -> tuple:
    """The sources and outputs as the C entries take them: the sources'
    count, pointers and row widths, the outputs' count, sources and ops."""
    s, k = len(values), len(outputs)
    return (s, (ctypes.c_void_p * s)(*[v.data_ptr() for v in values]),
            (ctypes.c_int * s)(*[row_width(v) for v in values]), k,
            (ctypes.c_int * k)(*[src for src, _ in outputs]),
            (ctypes.c_int * k)(*[LOAD_OPS[op] for _, op in outputs]))


def _plan(values: Sequence[torch.Tensor], n: int, groups: int,
          tables_bytes: int = _TABLES_BYTES, outputs: Optional[Outputs] = None) -> Dict[str, int]:
    """The kernel's plan for ``n`` rows of ``values`` (CUDA tensors of one
    dtype, contiguous) summed as ``outputs`` into ``groups`` groups, as
    ``csrc/keyed_sums.cu`` makes it: the tile tables' layout
    (``layout_of``, within ``tables_bytes``), its dynamic shared memory and
    its thread blocks."""
    out = (ctypes.c_int * len(_PLAN))()
    lib = load_library("keyed_sums", _ENTRIES)
    with torch.cuda.device(values[0].device):
        rc = lib.tfs_keyed_sums_plan(
            _ELEM_BYTES[values[0].dtype], n, groups, *_c_args(values, _outputs(values, outputs)),
            tables_bytes, out,
        )
    check(rc, "keyed_sums plan", lib.tfs_keyed_sums_error_string)
    return dict(zip(_PLAN, out))


def _launch(values: Sequence[torch.Tensor], ids: torch.Tensor, groups: int,
            outputs: List[Tuple[int, str]],
            tables_bytes: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One launch of the kernel on CUDA tensors `keyed_sums` has checked,
    its tile tables within ``tables_bytes`` of shared memory where one of
    the layouts that share them out fits."""
    dev, dtype, n = ids.device, values[0].dtype, ids.shape[0]
    ids = ids.to(torch.int64).contiguous()
    values = [v.contiguous() for v in values]
    tables = [torch.empty((groups,) + tuple(values[src].shape[1:]), dtype=dtype, device=dev)
              for src, _ in outputs]
    counts = torch.empty(groups, dtype=torch.int64, device=dev)
    if n == 0:
        for t in tables:
            t.zero_()
        return tables, counts.zero_()
    blocks = _plan(values, n, groups, tables_bytes, outputs)["blocks"]
    lib = load_library("keyed_sums", _ENTRIES)
    with torch.cuda.device(dev):
        cols = sum(row_width(values[src]) for src, _ in outputs) + 1
        partials = torch.empty(blocks * groups * cols, dtype=torch.float64, device=dev)
        rc = lib.tfs_keyed_sums(
            _ELEM_BYTES[dtype], ids.data_ptr(), n, groups, *_c_args(values, outputs),
            (ctypes.c_void_p * len(tables))(*[t.data_ptr() for t in tables]),
            counts.data_ptr(), partials.data_ptr(), blocks, tables_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "keyed_sums launch", lib.tfs_keyed_sums_error_string)
    keyed_sums.launches += 1
    return tables, counts


def keyed_sums(
    values: Sequence[torch.Tensor], ids: torch.Tensor, groups: int,
    outputs: Optional[Outputs] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(tables, counts)`` from one launch of the kernel: each output's
    ``(groups, *cell)`` per-group sums, in the values' dtype, and the int64
    rows of each group; rows whose id is outside ``[0, groups)`` are
    dropped. ``outputs`` lists ``(value index, op)`` a table, the op (of
    `LOAD_OPS`) applied to each value as it loads, each value tensor read
    once however many outputs read it; by default one identity output a
    value tensor. ``values`` share ``ids``' device and row count. Raises
    `ValueError` where `takes_kernel` refuses the outputs (CPU tensors
    included)."""
    n = ids.shape[0]
    for v in values:
        if v.device != ids.device or v.dim() < 1 or v.shape[0] != n:
            raise ValueError(
                f"keyed_sums: values {tuple(v.shape)} on {v.device} against {n} ids on {ids.device}"
            )
    outputs = _outputs(values, outputs)
    if not takes_launch(values, groups, outputs):
        raise ValueError(
            f"keyed_sums: no kernel for {[values[src].dtype for src, _ in outputs]} of widths "
            f"{[row_width(values[src]) for src, _ in outputs]} into {groups} groups on "
            f"{ids.device}"
        )
    return _launch(values, ids, groups, outputs, _TABLES_BYTES)


keyed_sums.launches = 0
