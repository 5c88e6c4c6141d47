"""Schema core: scalar types, tensor shapes with unknown dims, column metadata.

This is the TPU-native re-design of the reference's schema layer
(`Shape.scala`, `ColumnInformation.scala`, `MetadataConstants.scala`,
`DataFrameInfo.scala` in org/tensorframes). Semantics preserved:

- shapes carry ``None`` ("unknown") dims, and a block column always has an
  unknown lead dim (the block size), matching `Shape.scala:16-84`;
- precision comparison ``check_more_precise_than`` follows
  `Shape.scala:54-59`: a shape is at least as precise as another when every
  dim is either equal or the other's dim is unknown;
- shape merging widens mismatched dims to unknown, matching the analyze
  machinery in `ExperimentalOperations.scala:168-178`.

Unlike the reference (which embedded metadata into Spark StructField
metadata under `org.spartf.shape` / `org.sparktf.type`,
`MetadataConstants.scala:19,27`), column metadata here is a first-class
Python object attached to the columnar frame.

The PyTorch port keeps its own copy of `tensorframes_tpu/schema.py` and adds
the `ScalarType` <-> `torch.dtype` map. Types torch cannot compute with are
refused loudly when a column or a graph value would become a tensor:
uint32/uint64 (torch stores them but has almost no kernels for them) and
strings (host-only, never on the device).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ScalarType",
    "Shape",
    "Unknown",
    "ColumnInfo",
    "FrameInfo",
    "UnsupportedTypeError",
]

#: Sentinel for an unknown dimension (the reference uses -1 / Shape.Unknown).
Unknown = None


class UnsupportedTypeError(TypeError):
    """Raised when a dtype outside the supported scalar set is used."""

    # a schema/dtype rejection never succeeds on retry
    tfs_fault_class = "deterministic"


class ScalarType(enum.Enum):
    """Supported cell scalar types.

    The reference supports Double, Float, Int(32), Long, Binary
    (`datatypes.scala:265-267`). TPU-native additions: bool, bfloat16,
    float16, int8, int16, uint8, uint32, uint64 — first-class on TPU and in
    XLA. ``string`` mirrors the reference's Binary column support (host-only:
    strings never land on the accelerator).
    """

    float64 = "float64"
    float32 = "float32"
    bfloat16 = "bfloat16"
    float16 = "float16"
    int64 = "int64"
    int32 = "int32"
    int16 = "int16"
    int8 = "int8"
    uint8 = "uint8"
    uint32 = "uint32"
    uint64 = "uint64"
    bool_ = "bool"
    string = "string"

    # ---- numpy interop -------------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        if self is ScalarType.bfloat16:
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        if self is ScalarType.string:
            return np.dtype(object)
        return np.dtype(self.value)

    @classmethod
    def from_np_dtype(cls, dt) -> "ScalarType":
        dt = np.dtype(dt)
        if dt.kind in ("U", "S", "O"):
            return cls.string
        name = dt.name
        if name == "bfloat16":
            return cls.bfloat16
        if name == "bool":
            return cls.bool_
        try:
            return cls(name)
        except ValueError as e:
            raise UnsupportedTypeError(f"unsupported dtype {dt!r}") from e

    # ---- TF proto DataType interop ------------------------------------
    # Wire-compatible with tensorflow/core/framework/types.proto enum values.
    @property
    def tf_datatype(self) -> int:
        return _SCALAR_TO_TF[self]

    @classmethod
    def from_tf_datatype(cls, value: int) -> "ScalarType":
        # TF marks reference dtypes as value + 100 (DT_*_REF); normalize.
        value = value % 100
        try:
            return _TF_TO_SCALAR[value]
        except KeyError as e:
            raise UnsupportedTypeError(f"unsupported DataType enum {value}") from e

    # ---- torch interop ------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        """The tensor dtype of this scalar type; raises for the types torch
        cannot compute with (uint32/uint64 arithmetic, strings)."""
        try:
            return _SCALAR_TO_TORCH[self]
        except KeyError:
            raise UnsupportedTypeError(
                f"{self.name} columns cannot become torch tensors "
                + (
                    "(strings stay on the host)"
                    if self is ScalarType.string
                    else "(torch has no arithmetic kernels for it)"
                )
            ) from None

    @classmethod
    def from_torch_dtype(cls, dt: torch.dtype) -> "ScalarType":
        try:
            return _TORCH_TO_SCALAR[dt]
        except KeyError:
            raise UnsupportedTypeError(f"unsupported torch dtype {dt}") from None

    @property
    def is_floating(self) -> bool:
        return self in (
            ScalarType.float64,
            ScalarType.float32,
            ScalarType.bfloat16,
            ScalarType.float16,
        )

    @property
    def is_integer(self) -> bool:
        return self in (
            ScalarType.int64,
            ScalarType.int32,
            ScalarType.int16,
            ScalarType.int8,
            ScalarType.uint8,
            ScalarType.uint32,
            ScalarType.uint64,
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ScalarType.{self.name}"


# tensorflow/core/framework/types.proto (public wire contract)
_SCALAR_TO_TF = {
    ScalarType.float32: 1,
    ScalarType.float64: 2,
    ScalarType.int32: 3,
    ScalarType.uint8: 4,
    ScalarType.int16: 5,
    ScalarType.int8: 6,
    ScalarType.string: 7,
    ScalarType.int64: 9,
    ScalarType.bool_: 10,
    ScalarType.bfloat16: 14,
    ScalarType.float16: 19,
    ScalarType.uint32: 22,
    ScalarType.uint64: 23,
}
_TF_TO_SCALAR = {v: k for k, v in _SCALAR_TO_TF.items()}

_SCALAR_TO_TORCH = {
    ScalarType.float64: torch.float64,
    ScalarType.float32: torch.float32,
    ScalarType.bfloat16: torch.bfloat16,
    ScalarType.float16: torch.float16,
    ScalarType.int64: torch.int64,
    ScalarType.int32: torch.int32,
    ScalarType.int16: torch.int16,
    ScalarType.int8: torch.int8,
    ScalarType.uint8: torch.uint8,
    ScalarType.bool_: torch.bool,
}
_TORCH_TO_SCALAR = {v: k for k, v in _SCALAR_TO_TORCH.items()}


@dataclass(frozen=True)
class Shape:
    """A tensor shape whose dims may be unknown (``None``).

    Re-design of `Shape.scala`. Dims are stored as a tuple of
    ``int | None``; ``None`` is an unknown dim (the reference's ``-1``).
    """

    dims: Tuple[Optional[int], ...]

    # ---- constructors --------------------------------------------------
    def __init__(self, dims: Iterable[Optional[int]]):
        norm = []
        for d in dims:
            if d is None or (isinstance(d, (int, np.integer)) and int(d) < 0):
                norm.append(None)
            elif isinstance(d, (int, np.integer)):
                norm.append(int(d))
            else:
                raise TypeError(f"bad dim {d!r}")
        object.__setattr__(self, "dims", tuple(norm))

    @classmethod
    def scalar(cls) -> "Shape":
        return cls(())

    @classmethod
    def of_array(cls, arr: np.ndarray) -> "Shape":
        return cls(arr.shape)

    # ---- structure -----------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def is_scalar(self) -> bool:
        return self.rank == 0

    @property
    def has_unknown(self) -> bool:
        return any(d is None for d in self.dims)

    @property
    def num_elements(self) -> Optional[int]:
        """Element count, or None if any dim is unknown."""
        if self.has_unknown:
            return None
        n = 1
        for d in self.dims:
            n *= d  # type: ignore[operator]
        return n

    def prepend(self, dim: Optional[int]) -> "Shape":
        """`Shape.prepend` — add a lead dim (None = unknown block size)."""
        return Shape((dim,) + self.dims)

    @property
    def tail(self) -> "Shape":
        """`Shape.tail` — drop the lead dim (block shape -> cell shape)."""
        if self.rank == 0:
            raise ValueError("cannot take tail of a scalar shape")
        return Shape(self.dims[1:])

    def drop_inner(self) -> "Shape":
        """`Shape.dropInner` — drop the innermost dim."""
        if self.rank == 0:
            raise ValueError("cannot drop inner dim of a scalar shape")
        return Shape(self.dims[:-1])

    # ---- precision lattice (Shape.scala:54-59) -------------------------
    def check_more_precise_than(self, other: "Shape") -> bool:
        """True iff self is compatible with, and at least as precise as, other.

        Each dim of ``self`` must equal the corresponding dim of ``other``,
        or ``other``'s dim must be unknown. Ranks must match.
        """
        if self.rank != other.rank:
            return False
        for mine, theirs in zip(self.dims, other.dims):
            if theirs is not None and mine != theirs:
                return False
        return True

    def merge(self, other: "Shape") -> Optional["Shape"]:
        """Widening merge used by analyze (`ExperimentalOperations.scala:168-178`).

        Mismatched dims widen to unknown; mismatched ranks return None
        (incompatible — reference raises in that case).
        """
        if self.rank != other.rank:
            return None
        return Shape(
            a if a == b else None for a, b in zip(self.dims, other.dims)
        )

    # ---- concrete-shape helpers ---------------------------------------
    def assert_concrete(self) -> Tuple[int, ...]:
        if self.has_unknown:
            raise ValueError(f"shape {self} still has unknown dims")
        return self.dims  # type: ignore[return-value]

    def __repr__(self) -> str:
        inner = ",".join("?" if d is None else str(d) for d in self.dims)
        return f"[{inner}]"


@dataclass(frozen=True)
class ColumnInfo:
    """Tensor metadata for one frame column.

    Mirrors `ColumnInformation` + `SparkTFColInfo`: a scalar type and the
    *cell* shape (shape of one row's value). The block shape is the cell
    shape with an unknown lead dim prepended (`ColumnInformation`'s shapes
    always carry an Unknown lead — `DebugRowOps.scala:449-451`).
    """

    name: str
    dtype: ScalarType
    cell_shape: Shape

    @property
    def block_shape(self) -> Shape:
        return self.cell_shape.prepend(Unknown)

    def with_name(self, name: str) -> "ColumnInfo":
        return ColumnInfo(name, self.dtype, self.cell_shape)

    def __repr__(self) -> str:
        return f"{self.name}: {self.dtype.name}{self.cell_shape}"


class FrameInfo:
    """All column metadata for a frame (`DataFrameInfo.scala`)."""

    def __init__(self, cols: Sequence[ColumnInfo]):
        self.cols = list(cols)
        self._by_name = {c.name: c for c in self.cols}
        if len(self._by_name) != len(self.cols):
            raise ValueError("duplicate column names")

    def __getitem__(self, name: str) -> ColumnInfo:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self):
        return iter(self.cols)

    def __len__(self) -> int:
        return len(self.cols)

    @property
    def names(self):
        return [c.name for c in self.cols]

    def explain(self) -> str:
        """Pretty-printer matching the spirit of `DataFrameInfo.explain`."""
        lines = [f"root"]
        for c in self.cols:
            lines.append(f" |-- {c.name}: {c.dtype.name} {c.cell_shape}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"FrameInfo({', '.join(map(repr, self.cols))})"
