"""TensorFrame: a columnar, block-partitioned frame for tensor compute.

The PyTorch counterpart of `tensorframes_tpu/frame.py`. Each column is one
dense array of shape ``(nrows, *cell_shape)``: a host numpy array, or a
`torch.Tensor` on an explicit device once `to_device` (or a verb) put it
there. A frame carries block boundaries (``offsets``); a verb applies its
graph once per block, the reference's Spark partition.

This slice holds dense columns only: ragged and string columns are refused
at construction.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .schema import ColumnInfo, FrameInfo, ScalarType, Shape, UnsupportedTypeError

__all__ = ["TensorFrame", "Column", "as_tensor", "factorize_keys"]

ArrayLike = Union[np.ndarray, torch.Tensor, Sequence]


def as_tensor(values, device: torch.device) -> torch.Tensor:
    """A column block as a tensor on ``device``: host numpy is wrapped
    without a copy and then copied once to the device (no copy at all when
    ``device`` is the CPU); a tensor moves only if it lies elsewhere."""
    if isinstance(values, torch.Tensor):
        return values.to(device)
    arr = np.asarray(values)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy path
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        ScalarType.from_np_dtype(arr.dtype).torch_dtype  # refuses uint32/64
        t = torch.from_numpy(arr)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy().view(ScalarType.bfloat16.np_dtype)
    return t.numpy()


class Column:
    """One dense column: host numpy, or a tensor on a device."""

    def __init__(
        self, name: str, data: ArrayLike, dtype: Optional[ScalarType] = None
    ):
        self.name = name
        self._host: Optional[np.ndarray] = None  # host_values() cache
        if isinstance(data, torch.Tensor):
            self.values = data
            st = ScalarType.from_torch_dtype(data.dtype)
        else:
            arr = np.asarray(data)
            if arr.dtype == object or arr.dtype.kind in ("U", "S"):
                raise UnsupportedTypeError(
                    f"column {name!r}: ragged and string columns are not "
                    "supported by the PyTorch port yet (dense numeric only)"
                )
            if dtype is not None:
                arr = arr.astype(dtype.np_dtype, copy=False)
            self.values = arr
            st = ScalarType.from_np_dtype(arr.dtype)
        if dtype is not None and dtype is not st:
            raise ValueError(
                f"column {name!r}: values are {st.name}, dtype says {dtype.name}"
            )
        self.dtype = st
        self.cell_shape = Shape(tuple(self.values.shape[1:]))

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def info(self) -> ColumnInfo:
        return ColumnInfo(self.name, self.dtype, self.cell_shape)

    @property
    def device(self) -> Optional[torch.device]:
        """The tensor's device, or None for a host numpy column."""
        return self.values.device if isinstance(self.values, torch.Tensor) else None

    def slice(self, start: int, stop: int) -> "Column":
        return Column(self.name, self.values[start:stop])

    def host_values(self) -> np.ndarray:
        """One host numpy array of all cells: THE device->host boundary.
        Verbs keep device columns on the device; this is the one place a
        column crosses to the host. The copy is made once and cached."""
        if isinstance(self.values, np.ndarray):
            return self.values
        if self._host is None:
            self._host = _to_numpy(self.values)
        return self._host


class TensorFrame:
    """Columnar, block-partitioned frame; block i covers rows
    ``offsets[i]:offsets[i+1]``."""

    def __init__(
        self, columns: Sequence[Column], offsets: Optional[Sequence[int]] = None
    ):
        if not columns:
            raise ValueError("a TensorFrame needs at least one column")
        self._cols: Dict[str, Column] = {}
        n = len(columns[0])
        for c in columns:
            if len(c) != n:
                raise ValueError(
                    f"column {c.name!r} has {len(c)} rows, expected {n}"
                )
            if c.name in self._cols:
                raise ValueError(f"duplicate column {c.name!r}")
            self._cols[c.name] = c
        self.nrows = n
        offsets = [0, n] if offsets is None else [int(o) for o in offsets]
        if offsets[0] != 0 or offsets[-1] != n or any(
            a > b for a, b in zip(offsets, offsets[1:])
        ):
            raise ValueError(f"bad block offsets {offsets} for {n} rows")
        self.offsets = offsets

    @classmethod
    def from_dict(
        cls,
        data: Dict[str, ArrayLike],
        num_blocks: Optional[int] = None,
        dtypes: Optional[Dict[str, ScalarType]] = None,
    ) -> "TensorFrame":
        cols = [
            Column(name, values, (dtypes or {}).get(name))
            for name, values in data.items()
        ]
        frame = cls(cols)
        return frame if num_blocks is None else frame.repartition(num_blocks)

    # ---- accessors -----------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    @property
    def info(self) -> FrameInfo:
        return FrameInfo([c.info for c in self._cols.values()])

    def column(self, name: str) -> Column:
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; available: {self.columns}")
        return self._cols[name]

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    @property
    def num_blocks(self) -> int:
        return len(self.offsets) - 1

    def block_sizes(self) -> List[int]:
        return [b - a for a, b in zip(self.offsets, self.offsets[1:])]

    def block(self, i: int) -> "TensorFrame":
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return TensorFrame([c.slice(lo, hi) for c in self._cols.values()])

    def blocks(self) -> Iterable["TensorFrame"]:
        for i in range(self.num_blocks):
            yield self.block(i)

    # ---- restructuring -------------------------------------------------
    def repartition(self, num_blocks: int) -> "TensorFrame":
        """Split into ``num_blocks`` near-equal blocks."""
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        edges = np.linspace(0, self.nrows, num_blocks + 1).astype(int)
        return TensorFrame(list(self._cols.values()), list(edges))

    def select(self, names: Sequence[str]) -> "TensorFrame":
        return TensorFrame([self.column(n) for n in names], self.offsets)

    def analyze(self) -> "TensorFrame":
        """Dense columns already know their cell shapes, so analysis (the
        reference's data scan) leaves them as they are."""
        return TensorFrame(list(self._cols.values()), self.offsets)

    # ---- device placement ----------------------------------------------
    def to_device(self, device: DeviceLike = None) -> "TensorFrame":
        """Every column as a tensor on ``device`` (default: the CUDA card).
        One host->device copy per column; verbs on the result keep their
        outputs there."""
        dev = resolve_device(device)
        cols = [
            Column(c.name, as_tensor(c.values, dev)) for c in self._cols.values()
        ]
        return TensorFrame(cols, self.offsets)

    def host_values(self, name: str) -> np.ndarray:
        """Host numpy array of one column (`Column.host_values`)."""
        return self.column(name).host_values()

    def print_schema(self) -> None:
        print(self.info.explain())

    def __repr__(self) -> str:
        return (
            f"TensorFrame[{self.nrows} rows x {len(self._cols)} cols, "
            f"{self.num_blocks} blocks]({', '.join(map(repr, self.info))})"
        )


def _factorize_one(keys: torch.Tensor):
    """(sorted distinct keys, row -> index into them) of one key tensor.
    NaN is one key, sorted last, as in `np.unique` (`torch.unique` keeps
    every NaN apart)."""
    if keys.dtype.is_floating_point:
        nan = torch.isnan(keys)
        if bool(nan.any()):
            uniq, inv = torch.unique(keys[~nan], sorted=True, return_inverse=True)
            inverse = torch.full(keys.shape, len(uniq), dtype=torch.int64, device=keys.device)
            inverse[~nan] = inv
            return torch.cat([uniq, keys[nan][:1]]), inverse
    return torch.unique(keys, sorted=True, return_inverse=True)


def factorize_keys(key_names: Sequence[str], key_arrays: Sequence[ArrayLike]):
    """Factorize one or more dense scalar key columns into
    ``(key_out: name -> distinct key values per group, inverse: row -> group
    id)``, groups in sorted key order as in the reference.

    Keys are factorized where they lie (a device tensor stays on its
    device; host numpy runs on the CPU). Several keys combine their codes
    mixed-radix into one int64 per row, with the reference's overflow
    check."""
    tensors = []
    for name, arr in zip(key_names, key_arrays):
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
            if arr.dtype == object or arr.dtype.kind in ("U", "S"):
                raise ValueError(
                    f"group key {name!r}: string and object keys are not "
                    "supported by the PyTorch port yet (ROADMAP Queue 1 item 2)"
                )
            arr = torch.from_numpy(arr)
        tensors.append(arr)
    if len(tensors) == 1:
        uniq, inverse = _factorize_one(tensors[0])
        return {key_names[0]: uniq}, inverse
    combo = torch.zeros(len(tensors[0]), dtype=torch.int64, device=tensors[0].device)
    for t in tensors:
        uniq, inv = _factorize_one(t)
        radix = max(len(uniq), 1)
        if len(combo) and int(combo.max()) > (2**62) // radix:
            raise ValueError("aggregate: combined group-key cardinality overflows")
        combo = combo * radix + inv
    _, inverse = torch.unique(combo, sorted=True, return_inverse=True)
    num_groups = int(inverse.max()) + 1 if len(inverse) else 0
    # each group's first row carries its key values
    rows = torch.arange(len(inverse), device=inverse.device)
    first = torch.full((num_groups,), len(inverse), dtype=torch.int64, device=inverse.device)
    first = first.scatter_reduce(0, inverse, rows, "amin", include_self=True)
    return {k: t[first] for k, t in zip(key_names, tensors)}, inverse
