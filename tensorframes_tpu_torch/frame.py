"""TensorFrame: a columnar, block-partitioned frame for tensor compute.

The PyTorch counterpart of `tensorframes_tpu/frame.py`. A column takes one
of three forms:

- dense host numpy of shape ``(nrows, *cell_shape)``;
- a dense `torch.Tensor` on an explicit device, once `to_device` (or a
  verb) put it there;
- ragged or string cells, kept on the host: a list of per-row numpy cells
  whose shapes vary (the rank is known, the dims are not until `analyze`),
  or, for scalar strings, one object vector of the row values.

A frame carries block boundaries (``offsets``); a verb applies its graph
once per block, the reference's Spark partition. Ragged and string cells
never go to the device. pandas and pyarrow are imported inside the methods
that need them, never when this module loads.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .schema import ColumnInfo, FrameInfo, ScalarType, Shape, Unknown
from .utils.profiling import count as _count

__all__ = ["TensorFrame", "Column", "as_tensor", "factorize_keys"]

ArrayLike = Union[np.ndarray, torch.Tensor, Sequence]


def as_tensor(values, device: torch.device) -> torch.Tensor:
    """A column block as a tensor on ``device``: host numpy is wrapped
    without a copy and then copied once to the device (no copy at all when
    ``device`` is the CPU); a tensor moves only if it lies elsewhere."""
    if isinstance(values, torch.Tensor):
        if _on(values.device, device):
            return values  # already there: skip the per-block `.to` call
        return values.to(device)
    arr = np.asarray(values)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy path
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        ScalarType.from_np_dtype(arr.dtype).torch_dtype  # refuses uint32/64, strings
        t = torch.from_numpy(arr)
    return t.to(device)


def _on(have: torch.device, want: torch.device) -> bool:
    """Whether a tensor on ``have`` already lies on ``want`` (a CUDA device
    without an index is the current one)."""
    if have == want:
        return True
    if have.type == want.type == "cpu":
        return True  # torch.device("cpu", i) (a test's device slot) is the CPU
    if have.type != want.type or want.index is not None:
        return False
    return want.type == "cpu" or have.index == _cuda_device()


def _cuda_device() -> int:
    """The current CUDA device's index (`torch.cuda.current_device` without
    its per-call initialisation check, once CUDA is up)."""
    try:
        return torch._C._cuda_getDevice()
    except AttributeError:
        return torch.cuda.current_device()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy().view(ScalarType.bfloat16.np_dtype)
    return t.numpy()


def _is_string_array(arr: np.ndarray) -> bool:
    return arr.dtype.kind in ("U", "S", "O")


def _string_vector(data, n: int) -> Optional[np.ndarray]:
    """The object vector of a string column's row values when every cell is
    a scalar (str, bytes or another non-container value), else None."""
    if isinstance(data, np.ndarray) and data.dtype == object and data.ndim == 1:
        vec = data.copy()
    else:
        vec = np.fromiter(data, dtype=object, count=n)
    types = set(map(type, vec))
    if any(issubclass(t, (list, tuple)) for t in types):
        return None
    if any(issubclass(t, np.ndarray) for t in types):
        if any(np.ndim(x) for x in vec):
            return None
        vec = np.fromiter((np.asarray(x)[()] for x in vec), dtype=object, count=n)
    return vec


class Column:
    """One column: dense (host numpy or a device tensor), or ragged /
    string cells on the host (``ragged`` is not None)."""

    def __init__(
        self, name: str, data: ArrayLike, dtype: Optional[ScalarType] = None
    ):
        self.name = name
        self._host: Optional[np.ndarray] = None  # host_values() cache
        self.ragged: Optional[Union[List[np.ndarray], np.ndarray]] = None
        if isinstance(data, torch.Tensor):
            self._init_dense(data, ScalarType.from_torch_dtype(data.dtype), dtype)
            return
        if isinstance(data, np.ndarray) and data.dtype != object:
            if data.dtype.kind in ("U", "S") or dtype is None:
                self._init_dense(data, ScalarType.from_np_dtype(data.dtype), dtype)
            else:
                arr = data.astype(dtype.np_dtype, copy=False)
                self._init_dense(arr, ScalarType.from_np_dtype(arr.dtype), dtype)
            return
        # Bulk path: one np.asarray over a list/tuple beats a per-cell
        # conversion of every row, and always copies, so the frame never
        # aliases caller memory (a pandas Series would share its buffer;
        # it takes the per-cell path below, as a generator does).
        if isinstance(data, (list, tuple)) and data and dtype is not ScalarType.string:
            try:
                bulk = np.asarray(data)
            except (ValueError, TypeError):  # ragged rows, mixed objects
                bulk = None
            if bulk is not None and not _is_string_array(bulk):
                target = dtype or ScalarType.from_np_dtype(bulk.dtype)
                arr = bulk.astype(target.np_dtype, copy=False)
                self._init_dense(arr, target, None)
                return
        self._init_cells(data, dtype)

    @classmethod
    def _from_cells(cls, name: str, cells: List[np.ndarray], rank: int) -> "Column":
        """A ragged column of a verb's per-row outputs: cells that share one
        dtype and rank and differ in shape, taken without a per-cell copy."""
        c = cls.__new__(cls)
        c.name, c._host, c.values, c.ragged = name, None, None, cells
        c.dtype = ScalarType.from_np_dtype(cells[0].dtype)
        c.cell_shape = Shape((Unknown,) * rank)
        return c

    def _init_dense(self, values, st: ScalarType, dtype: Optional[ScalarType]) -> None:
        if dtype is not None and dtype is not st:
            raise ValueError(
                f"column {self.name!r}: values are {st.name}, dtype says {dtype.name}"
            )
        self.values = values
        self.dtype = st
        self.cell_shape = Shape(tuple(values.shape[1:]))

    def _init_cells(self, data, dtype: Optional[ScalarType]) -> None:
        """The per-cell path: string detection, the rank check, and
        densification of uniform cells."""
        if not isinstance(data, (list, tuple, np.ndarray)):
            data = list(data)  # a generator is consumed once
        n = len(data)
        if dtype is None:
            if n == 0:
                raise ValueError(f"empty ragged column {self.name!r} needs a dtype")
            if _is_string_array(np.asarray(data[0])):
                dtype = ScalarType.string
        self.values = None  # type: ignore[assignment]
        if dtype is ScalarType.string:
            self.dtype = ScalarType.string
            vec = _string_vector(data, n)
            if vec is not None:
                self.ragged, self.cell_shape = vec, Shape(())
                return
        cells = [np.asarray(x) for x in data]
        if dtype is None:
            dtype = ScalarType.from_np_dtype(np.result_type(*{c.dtype for c in cells}))
        self.dtype = dtype
        if dtype is not ScalarType.string:
            cells = [c.astype(dtype.np_dtype) for c in cells]
        rank = cells[0].ndim if cells else 0
        if any(c.ndim != rank for c in cells):
            raise ValueError(f"column {self.name!r}: rows disagree on rank")
        self.ragged = cells
        # without a scan only the rank is known (`ColumnInformation.scala:94-111`)
        self.cell_shape = Shape((Unknown,) * rank)
        self._try_densify()

    def _try_densify(self) -> None:
        """Promote a ragged column whose cells all share one shape to dense."""
        if self.ragged is None or self.dtype is ScalarType.string or not len(self.ragged):
            return
        s0 = self.ragged[0].shape
        if all(c.shape == s0 for c in self.ragged):
            values = np.stack(self.ragged) if s0 else np.asarray(
                [c[()] for c in self.ragged], dtype=self.dtype.np_dtype
            )
            self.values = values.astype(self.dtype.np_dtype)
            self.cell_shape = Shape(s0)
            self.ragged = None

    # ------------------------------------------------------------------
    @property
    def is_dense(self) -> bool:
        return self.ragged is None

    def __len__(self) -> int:
        return int(self.values.shape[0]) if self.is_dense else len(self.ragged)

    @property
    def info(self) -> ColumnInfo:
        return ColumnInfo(self.name, self.dtype, self.cell_shape)

    @property
    def device(self) -> Optional[torch.device]:
        """The tensor's device, or None for a host column (numpy, ragged or
        string cells)."""
        return self.values.device if isinstance(self.values, torch.Tensor) else None

    def _is_string_vector(self) -> bool:
        return isinstance(self.ragged, np.ndarray)

    def slice(self, start: int, stop: int) -> "Column":
        if self.is_dense:
            return Column(self.name, self.values[start:stop])
        if self._is_string_vector():
            part = self.with_info(self.info)
            part.ragged = self.ragged[start:stop]
            return part
        return Column(self.name, self.ragged[start:stop], self.dtype)

    def row(self, i: int):
        if self.is_dense:
            return self.values[i]
        if self._is_string_vector():
            return np.asarray(self.ragged[i])
        return self.ragged[i]

    def rows(self) -> Iterable:
        if self.is_dense:
            return iter(self.values)
        if self._is_string_vector():
            return (np.asarray(x) for x in self.ragged)
        return iter(self.ragged)

    def host_rows(self) -> Iterable:
        """`rows` with a device column copied to the host once first."""
        return iter(self.host_values()) if self.is_dense else self.rows()

    def host_values(self) -> np.ndarray:
        """One host numpy array of all cells: THE device->host boundary.
        Verbs keep device columns on the device; this is the one place a
        column crosses to the host. The copy of a device column is made
        once, cached, and counted (``host_sync``). A scalar string column
        gives its object vector of row values."""
        if self.is_dense:
            if isinstance(self.values, np.ndarray):
                return self.values
            if self._host is None:
                _count("host_sync")
                self._host = _to_numpy(self.values)
            return self._host
        if not self._is_string_vector():
            raise ValueError(f"column {self.name!r} is ragged; no single host array")
        return self.ragged

    def analyzed_cell_shape(self) -> Shape:
        """Scan all cells and merge shapes with unknown-widening
        (`ExperimentalOperations.scala:140-178`)."""
        if self.is_dense or self._is_string_vector():
            return self.cell_shape
        merged: Optional[Shape] = None
        for s in dict.fromkeys(c.shape for c in self.ragged):
            shape = Shape(s)
            if merged is None:
                merged = shape
                continue
            m = merged.merge(shape)
            if m is None:
                raise ValueError(
                    f"column {self.name!r}: rows disagree on rank ({merged} vs {shape})"
                )
            merged = m
        return merged if merged is not None else self.cell_shape

    def with_info(self, info: ColumnInfo) -> "Column":
        c = Column.__new__(Column)
        c.name = info.name
        c.values = self.values
        c.ragged = self.ragged
        c.dtype = info.dtype
        c.cell_shape = info.cell_shape
        c._host = self._host  # same buffer, so the host cache carries over
        return c


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

    # ---- constructors --------------------------------------------------
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

    @classmethod
    def from_pandas(cls, pdf, num_blocks: Optional[int] = None) -> "TensorFrame":
        data = {}
        for name in pdf.columns:
            series = pdf[name]
            data[name] = list(series) if series.dtype == object else series.to_numpy()
        return cls.from_dict(data, num_blocks=num_blocks)

    @classmethod
    def from_arrow(cls, table, num_blocks: Optional[int] = None) -> "TensorFrame":
        """Build from a pyarrow Table: primitive columns become dense,
        fixed-size-list columns dense vectors, list columns ragged, string
        columns host string cells."""
        import pyarrow as pa

        data: Dict[str, ArrayLike] = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            if pa.types.is_fixed_size_list(col.type):
                flat = col.values.to_numpy(zero_copy_only=False)
                data[name] = flat.reshape(-1, col.type.list_size)
            elif pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
                data[name] = [np.asarray(x) for x in col.to_pylist()]
            else:
                data[name] = col.to_numpy(zero_copy_only=False)
        return cls.from_dict(data, num_blocks=num_blocks)

    @classmethod
    def from_rows(
        cls, rows: Sequence[Dict[str, ArrayLike]], num_blocks: Optional[int] = None
    ) -> "TensorFrame":
        if not rows:
            raise ValueError("from_rows needs at least one row")
        names = list(rows[0].keys())
        return cls.from_dict({n: [r[n] for r in rows] for n in names}, num_blocks=num_blocks)

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

    def with_columns(self, cols: Sequence[Column]) -> "TensorFrame":
        merged = dict(self._cols)
        for c in cols:
            merged[c.name] = c
        return TensorFrame(list(merged.values()), self.offsets)

    def pad_ragged(self, col_name: str, length_col: Optional[str] = None) -> "TensorFrame":
        """A ragged rank-1 column as a zero-padded dense column plus an
        int32 length column (``<col>_len`` by default): the masked-execution
        bridge for block-level ops over variable-length rows. One numpy
        pass: the lengths, then one scatter of every value into a zero
        buffer."""
        c = self.column(col_name)
        if c.is_dense:
            return self
        if c.cell_shape.rank != 1:
            raise ValueError("pad_ragged supports rank-1 ragged columns")
        cells = c.ragged
        lens = np.fromiter((x.size for x in cells), dtype=np.int32, count=len(cells))
        out = np.zeros((len(cells), int(lens.max())), dtype=cells[0].dtype)
        row = np.repeat(np.arange(len(cells)), lens)
        starts = np.cumsum(lens, dtype=np.int64) - lens
        pos = np.arange(len(row), dtype=np.int64) - np.repeat(starts, lens)
        out[row, pos] = np.concatenate(cells)
        return self.with_columns(
            [Column(col_name, out, c.dtype), Column(length_col or f"{col_name}_len", lens)]
        )

    # ---- schema ops (analyze / append_shape) ---------------------------
    def analyze(self) -> "TensorFrame":
        """Scan the data and refine every column's cell shape
        (`ExperimentalOperations.scala:39-51`): ragged columns merge their
        cells' shapes, widening the dims that differ to unknown."""
        cols = [
            c.with_info(ColumnInfo(c.name, c.dtype, c.analyzed_cell_shape()))
            for c in self._cols.values()
        ]
        return TensorFrame(cols, self.offsets)

    def append_shape(self, name: str, cell_shape: Shape) -> "TensorFrame":
        """Attach a cell shape by hand (`ExperimentalOperations.scala:53-68`)."""
        c = self.column(name)
        info = ColumnInfo(name, c.dtype, cell_shape)
        cols = [c.with_info(info) if n == name else col for n, col in self._cols.items()]
        return TensorFrame(cols, self.offsets)

    # ---- device placement ----------------------------------------------
    def to_device(self, device: DeviceLike = None) -> "TensorFrame":
        """Dense numeric columns as tensors on ``device`` (default: the
        CUDA card), one host->device copy each; ragged and string columns
        stay on the host. Verbs on the result keep their outputs there."""
        dev = resolve_device(device)
        cols = []
        for c in self._cols.values():
            if c.is_dense and c.dtype is not ScalarType.string:
                moved = Column(c.name, as_tensor(c.values, dev))
                moved.cell_shape = c.cell_shape
                cols.append(moved)
            else:
                cols.append(c)
        return TensorFrame(cols, self.offsets)

    def to_global(self, mesh=None, columns=None) -> "GlobalFrame":  # noqa: F821
        """This frame's dense columns sharded over a data mesh (default:
        every healthy card), one shard tensor a card: see
        `tensorframes_tpu_torch.globalframe`. Verbs on the result run on
        the shards and keep their outputs there."""
        from .globalframe import GlobalFrame

        return GlobalFrame.from_frame(self, mesh=mesh, columns=columns)

    # ---- lazy plans ----------------------------------------------------
    def lazy(self, device: DeviceLike = None) -> "LazyFrame":  # noqa: F821
        """Wrap this frame into a `LazyFrame`: later graph-based
        ``map_blocks`` calls defer and fuse into one callable per block,
        run at the first terminal action (`collect` / `host_values` / any
        reduce or aggregate / `.force()`) on ``device`` (default: the CUDA
        card). See `tensorframes_tpu_torch.lazy`."""
        from .lazy import LazyFrame

        return LazyFrame(self, device=device)

    # ---- export --------------------------------------------------------
    def host_values(self, name: str) -> np.ndarray:
        """Host numpy array of one column (`Column.host_values`)."""
        return self.column(name).host_values()

    def to_host(self) -> "TensorFrame":
        """Every device column as host numpy (one cached copy each): the
        inverse of `to_device`."""
        cols = []
        for c in self._cols.values():
            if c.device is not None:
                host = Column(c.name, c.host_values())
                host.cell_shape = c.cell_shape
                cols.append(host)
            else:
                cols.append(c)
        return TensorFrame(cols, self.offsets)

    def to_arrow(self):
        """Export to a pyarrow Table (dense vectors as fixed-size lists,
        ragged and higher-rank cells as lists)."""
        import pyarrow as pa

        arrays = {}
        for name, c in self._cols.items():
            if c.is_dense and c.cell_shape.is_scalar:
                arrays[name] = pa.array(c.host_values())
            elif c.is_dense and c.cell_shape.rank == 1:
                vals = c.host_values()
                arrays[name] = pa.FixedSizeListArray.from_arrays(
                    pa.array(vals.ravel()), vals.shape[1]
                )
            else:
                arrays[name] = pa.array([np.asarray(r).tolist() for r in c.host_rows()])
        return pa.table(arrays)

    def to_pandas(self):
        import pandas as pd

        data = {}
        for c in self._cols.values():
            if c.is_dense and c.cell_shape.is_scalar:
                data[c.name] = c.host_values()
            else:
                data[c.name] = [np.asarray(r).tolist() for r in c.host_rows()]
        return pd.DataFrame(data)

    def collect(self) -> List[Dict[str, np.ndarray]]:
        """Every row as a dict of its cells; each device column crosses to
        the host once (`Column.host_values`)."""
        names = self.columns
        return [
            dict(zip(names, vals))
            for vals in zip(*[self._cols[n].host_rows() for n in names])
        ]

    def print_schema(self) -> None:
        print(self.info.explain())

    def __repr__(self) -> str:
        return (
            f"TensorFrame[{self.nrows} rows x {len(self._cols)} cols, "
            f"{self.num_blocks} blocks]({', '.join(map(repr, self.info))})"
        )


# ---------------------------------------------------------------------------
# group keys
# ---------------------------------------------------------------------------


def _unique(keys: torch.Tensor):
    """``torch.unique(keys, sorted=True, return_inverse=True)``: the
    factorization kernel for int32 and int64 keys on a card while they hold
    at most its capacity of distinct keys (`ops.factorize_keys`), else
    ``torch.unique``. On a card the route is counted, ``factorize.kernel``
    or ``factorize.torch``."""
    from .ops import factorize_keys as _fk  # at the top it would cycle through ops.lowering

    if _fk.takes_kernel(keys.device, keys.dtype):
        got = _fk.factorize(keys)
        if got is not None:
            _count("factorize.kernel")
            return got
    if keys.device.type == "cuda":
        _count("factorize.torch")
    return _fk.factorize_reference(keys)


def _factorize_one(keys: torch.Tensor):
    """(sorted distinct keys, row -> index into them) of one key tensor.
    NaN is one key, sorted last, as in `np.unique` (`torch.unique` keeps
    every NaN apart)."""
    if keys.dtype.is_floating_point:
        nan = torch.isnan(keys)
        if bool(nan.any()):
            uniq, inv = _unique(keys[~nan])
            inverse = torch.full(keys.shape, len(uniq), dtype=torch.int64, device=keys.device)
            inverse[~nan] = inv
            return torch.cat([uniq, keys[nan][:1]]), inverse
    return _unique(keys)


def _is_na(x) -> bool:
    return x is None or (isinstance(x, (float, np.floating)) and x != x)


def _sorted_keys(keys: List) -> List:
    """Distinct keys in pandas' sorted order: a plain sort, or, for keys
    that do not compare (strings beside numbers), the non-strings sorted
    first and then the strings, as `pandas.core.sorting` does."""
    try:
        return sorted(keys)
    except TypeError:
        strs = [k for k in keys if isinstance(k, str)]
        return sorted(k for k in keys if not isinstance(k, str)) + sorted(strs)


def _factorize_objects(arr: np.ndarray):
    """(sorted distinct keys, int64 codes) of a host string or object key
    array, as ``pandas.factorize(sort=True, use_na_sentinel=False)`` gives
    them: None and NaN are one key, NaN, sorted last. pandas does it when it
    imports; otherwise one dict pass over the rows and a sort of the
    distinct keys give the same codes and the same key order."""
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        codes, uniq = pd.factorize(arr, sort=True, use_na_sentinel=False)
        return np.asarray(uniq), codes.astype(np.int64)
    first: Dict = {}
    codes = np.fromiter(
        (first.setdefault(x, len(first)) for x in arr.tolist()), dtype=np.int64, count=len(arr)
    )
    seen = list(first)
    na = [k for k in seen if _is_na(k)]
    order = _sorted_keys([k for k in seen if not _is_na(k)])
    rank = {k: r for r, k in enumerate(order)}
    remap = np.array([len(order) if _is_na(k) else rank[k] for k in seen], dtype=np.int64)
    uniq = order + [np.nan] * bool(na)
    out = np.empty(len(uniq), dtype=object)
    out[:] = uniq
    if arr.dtype.kind in ("U", "S"):
        out = out.astype(arr.dtype)
    return out, remap[codes]


def factorize_keys(
    key_names: Sequence[str],
    key_arrays: Sequence[ArrayLike],
    device: Optional[torch.device] = None,
):
    """Factorize one or more scalar key columns into ``(key_out: name ->
    distinct key values per group, inverse: row -> group id)``, groups in
    sorted key order as in the reference (`DebugRowOps.scala:554-599`).

    Numeric keys are factorized where they lie (a device tensor stays on
    its device; host numpy runs on the CPU), integer keys on a card by the
    factorization kernel where it takes them (`_unique`). String and object keys
    factorize on the host (`_factorize_objects`); their codes go to
    ``device`` (default: the first tensor key's device, else the CPU) once,
    and their distinct values stay a host array. Several keys combine their
    codes mixed-radix into one int64 per row, with the reference's overflow
    check."""
    if device is None:
        device = next(
            (a.device for a in key_arrays if isinstance(a, torch.Tensor)), torch.device("cpu")
        )
    per_key = []  # (distinct keys, codes, the key values: a tensor or host strings)
    for arr in key_arrays:
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
            if _is_string_array(arr):
                uniq, codes = _factorize_objects(arr)
                per_key.append((uniq, torch.from_numpy(codes).to(device), arr))
                continue
            arr = torch.from_numpy(arr)
        per_key.append((*_factorize_one(arr), arr))
    if len(per_key) == 1:
        return {key_names[0]: per_key[0][0]}, per_key[0][1]
    combo = torch.zeros(len(per_key[0][1]), dtype=torch.int64, device=per_key[0][1].device)
    for uniq, inv, _ in per_key:
        radix = max(len(uniq), 1)
        if len(combo) and int(combo.max()) > (2**62) // radix:
            raise ValueError("aggregate: combined group-key cardinality overflows")
        combo = combo * radix + inv.to(combo.device)
    _, inverse = _unique(combo)
    num_groups = int(inverse.max()) + 1 if len(inverse) else 0
    # each group's first row carries its key values
    rows = torch.arange(len(inverse), device=inverse.device)
    first = torch.full((num_groups,), len(inverse), dtype=torch.int64, device=inverse.device)
    first = first.scatter_reduce(0, inverse, rows, "amin", include_self=True)
    first_host = first.cpu().numpy() if any(
        isinstance(v, np.ndarray) for _, _, v in per_key
    ) else None
    key_out = {
        name: v[first_host] if isinstance(v, np.ndarray) else v[first]
        for name, (_, _, v) in zip(key_names, per_key)
    }
    return key_out, inverse
