"""Key factorization: the sorted distinct values of an integer key tensor and
each row's index into them, the hand-written CUDA kernel and its plain
PyTorch version.

Every aggregate plan's key stage (`frame.factorize_keys`: a key column, and
the combined codes of several) needs ``torch.unique(keys, sorted=True,
return_inverse=True)``. `factorize` computes it for int32 and int64 keys on
a card with ``csrc/factorize_keys.cu``: a distinct pass that gathers the
keys into hash sets in shared memory, one host read of their count, then a
finish that sorts the few distinct keys and a lookup pass that writes each
row's rank; nothing is sorted at row scale. It takes columns of at most
`CAPACITY` distinct keys and returns None past it, having read part of the
keys once. `takes_kernel` says from the device and the dtype whether the
kernel takes a tensor; `factorize_reference` is the plain version (the
``torch.unique`` route) the kernel is held against bit for bit.
``factorize.launches`` counts each pass's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._cuda_build import check, load_library

__all__ = ["factorize", "factorize_reference", "takes_kernel", "CAPACITY", "EMPTY_KEY"]

# element bytes of the key dtypes the kernel takes
_ELEM_BYTES = {torch.int32: 4, torch.int64: 8}
# csrc/factorize_keys.cu: kCapacity (as many keys as the keyed-sums kernel
# takes groups: 4,096 groups of one value and the count fill its 8,192 slots)
CAPACITY = 4096
# csrc/factorize_keys.cu: kEmpty, the empty slot's marker (a key equal to it
# is flagged, never stored)
EMPTY_KEY = -(2**63)


def takes_kernel(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether the kernel takes keys of ``dtype`` on ``device``: int32 and
    int64 on a CUDA card."""
    return torch.device(device).type == "cuda" and dtype in _ELEM_BYTES


def factorize_reference(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(sorted distinct keys, row -> index into them)``,
    ``torch.unique(keys, sorted=True, return_inverse=True)``."""
    return torch.unique(keys, sorted=True, return_inverse=True)


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc/factorize_keys.cu's C entries: name -> (argtypes, restype)
_ENTRIES = {
    "tfs_factorize_constants": ([_PTR], _I32),
    "tfs_factorize_distinct": ([_I32, _PTR, _I64, _PTR, _PTR], _I32),
    "tfs_factorize_lookup": ([_I32, _PTR, _I64, _PTR, _I32, _PTR, _PTR, _PTR], _I32),
    "tfs_factorize_error_string": ([_I32], ctypes.c_char_p),
}
_words = {}  # the kernel's constants, read once from the library


def _library():
    """The library, its constants read and checked against the wrapper's
    on first use."""
    lib = load_library("factorize_keys", _ENTRIES)
    if not _words:
        out = (ctypes.c_longlong * 5)()
        lib.tfs_factorize_constants(out)
        words = dict(zip(("capacity", "slots", "work", "empty", "count"), out))
        if (words["capacity"], words["empty"]) != (CAPACITY, EMPTY_KEY):
            raise RuntimeError(f"factorize_keys: the library's constants {words} differ "
                               f"from the wrapper's ({CAPACITY}, {EMPTY_KEY})")
        _words.update(words)
    return lib


def factorize(keys: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(sorted distinct keys, row -> index into them)`` from the kernel,
    equal bit for bit to `factorize_reference`: the distinct keys in a new
    tensor of their own length and dtype, the int64 indices in ``keys``'
    shape. None where ``keys`` hold more than `CAPACITY` distinct values.
    Raises `ValueError` where `takes_kernel` refuses them (CPU tensors
    included)."""
    if not takes_kernel(keys.device, keys.dtype):
        raise ValueError(f"factorize_keys: no kernel for {keys.dtype} keys on {keys.device}")
    dev, n = keys.device, keys.numel()
    if n == 0:
        return (torch.empty(0, dtype=keys.dtype, device=dev),
                torch.empty(keys.shape, dtype=torch.int64, device=dev))
    flat = keys.reshape(-1).contiguous()
    lib, elem = _library(), _ELEM_BYTES[keys.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        work = torch.empty(_words["work"], dtype=torch.int64, device=dev)
        check(lib.tfs_factorize_distinct(elem, flat.data_ptr(), n, work.data_ptr(), stream),
              "factorize_keys distinct pass", lib.tfs_factorize_error_string)
        factorize.launches["distinct"] += 1
        at = _words["count"]
        count, overflow, marker = work[at:at + 3].tolist()  # the one host read
        d = count + marker
        if overflow or d > CAPACITY:
            return None
        uniq = torch.empty(d, dtype=keys.dtype, device=dev)
        inverse = torch.empty(n, dtype=torch.int64, device=dev)
        check(lib.tfs_factorize_lookup(elem, flat.data_ptr(), n, work.data_ptr(), d,
                                       uniq.data_ptr(), inverse.data_ptr(), stream),
              "factorize_keys lookup pass", lib.tfs_factorize_error_string)
    factorize.launches["lookup"] += 1
    return uniq, inverse.view(keys.shape)


factorize.launches = {"distinct": 0, "lookup": 0}
