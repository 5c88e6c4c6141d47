"""Builder DSL: author graphs without TensorFlow, mirroring the reference's
Scala DSL (`dsl/package.scala`, `dsl/Operation.scala`, `dsl/DslImpl.scala`).

Nodes are built lazily ("freeze" semantics, `Operation.scala:86-104`): a
`Tensor` handle records op/parents/attrs; names are assigned at `build()`
time — requested names win, anonymous nodes get TF-style ``op_N`` counters
scoped by `scope()` (the reference's `Paths`, made re-entrant and
thread-safe here via contextvars — the original is documented
thread-UNSAFE, `dsl/Paths.scala:10-12`).

The PyTorch port keeps its own copy of `tensorframes_tpu/graph/builder.py`,
exported as `tensorframes_tpu_torch.dsl`: both packages emit the same
GraphDef bytes for the same DSL program.

The DSL emits the same TF-compatible NodeDefs as the import path, so DSL
graphs export to GraphDef wire bytes byte-for-byte comparably to graphs a
real TF would build (the reference asserts exactly this in its
`ExtractNodes` golden tests, `dsl/ExtractNodes.scala:14-77`).
"""

from __future__ import annotations

import contextvars
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

#: build() memo: fetch-id tuple -> (weakrefs for liveness check, result)
_build_memo: Dict[tuple, tuple] = {}  # pure memo keyed by live fetch ids (weakref-guarded)

from ..proto.graphdef import AttrValue, TensorProto
from ..schema import ScalarType, Shape
from .ir import Graph, GraphNode

__all__ = [
    "Tensor",
    "scope",
    "placeholder",
    "constant",
    "zeros",
    "ones",
    "fill",
    "identity",
    "add",
    "sub",
    "mul",
    "div",
    "matmul",
    "square",
    "sqrt",
    "reduce_sum",
    "reduce_min",
    "reduce_max",
    "reduce_mean",
    "cast",
    "reshape",
    "expand_dims",
    "concat",
    "argmin",
    "argmax",
    "unsorted_segment_sum",
    "relu",
    "softmax",
    "sigmoid",
    "tanh",
    "build",
    "block",
    "row",
]

_scope_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "tfs_dsl_scope", default=()
)


@contextmanager
def scope(name: str):
    """Name scope, like `dsl.scope` / TF name scopes (`Paths.scala:13-56`)."""
    tok = _scope_stack.set(_scope_stack.get() + (name,))
    try:
        yield
    finally:
        _scope_stack.reset(tok)


class Tensor:
    """Handle to one output of an unfrozen DSL node."""

    def __init__(
        self,
        op: str,
        parents: Sequence["Tensor"],
        attrs: Dict[str, AttrValue],
        dtype: ScalarType,
        requested_name: Optional[str] = None,
        idx: int = 0,
        source: Optional["Tensor"] = None,
    ):
        self.op = op
        self.parents = list(parents)
        self.attrs = dict(attrs)
        self.dtype = dtype
        self.requested_name = requested_name
        self.scope_path = _scope_stack.get()
        self.idx = idx
        self.source = source  # for multi-output handles: the defining node
        # (consumer Tensor, suffix): name this node "<consumer>/<suffix>"
        # at build time — how TF scopes helper constants under the op
        # that owns them (e.g. Sum's "reduction_indices")
        self.name_relative = None
        # anonymous-name counter base when it differs from the op type
        # (TF names anonymous AddV2 nodes "Add", RealDiv "div", ...)
        self.name_base = None

    # -- naming ----------------------------------------------------------
    def named(self, name: str) -> "Tensor":
        """Request an explicit node name (`Operation.named`)."""
        self.requested_name = name
        # renaming is the one post-construction mutation Tensors allow;
        # drop memoized builds so the new name is picked up
        _build_memo.clear()
        return self

    # -- operators (implicit constant conversion, dsl/Implicits.scala) ---
    def _coerce(self, other) -> "Tensor":
        if isinstance(other, Tensor):
            return other
        return constant(np.asarray(other, dtype=self.dtype.np_dtype))

    def __add__(self, other):
        return add(self, self._coerce(other))

    def __radd__(self, other):
        return add(self._coerce(other), self)

    def __sub__(self, other):
        return sub(self, self._coerce(other))

    def __rsub__(self, other):
        return sub(self._coerce(other), self)

    def __mul__(self, other):
        return mul(self, self._coerce(other))

    def __rmul__(self, other):
        return mul(self._coerce(other), self)

    def __truediv__(self, other):
        return div(self, self._coerce(other))

    def __rtruediv__(self, other):
        return div(self._coerce(other), self)

    def __neg__(self):
        return _nary("Neg", [self])

    def __repr__(self) -> str:
        nm = self.requested_name or "?"
        return f"<dsl.Tensor {self.op} {nm} {self.dtype.name}>"


# ---------------------------------------------------------------------------
# node factories
# ---------------------------------------------------------------------------


def _same_dtype(a: Tensor, b: Tensor, op: str) -> ScalarType:
    if a.dtype is not b.dtype:
        raise ValueError(
            f"{op}: dtype mismatch {a.dtype.name} vs {b.dtype.name} "
            "(TF graphs do not promote dtypes; cast explicitly)"
        )
    return a.dtype


def placeholder(
    dtype: ScalarType, shape: Shape, name: Optional[str] = None
) -> Tensor:
    attrs = {
        "dtype": AttrValue.of_type(dtype),
        "shape": AttrValue.of_shape(shape),
    }
    return Tensor("Placeholder", [], attrs, dtype, requested_name=name)


def constant(
    value, dtype: Optional[ScalarType] = None, name: Optional[str] = None
) -> Tensor:
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(dtype.np_dtype)
    elif arr.dtype == np.float64:
        pass  # keep doubles as doubles, like the Scala DSL
    st = ScalarType.from_np_dtype(arr.dtype)
    attrs = {
        "dtype": AttrValue.of_type(st),
        "value": AttrValue.of_tensor(TensorProto.from_numpy(arr)),
    }
    return Tensor("Const", [], attrs, st, requested_name=name)


def zeros(shape, dtype: ScalarType = ScalarType.float64) -> Tensor:
    t = constant(np.zeros(shape, dtype=dtype.np_dtype))
    t.name_base = "zeros"  # TF's anonymous-name base for tf.zeros
    return t


def ones(shape, dtype: ScalarType = ScalarType.float64) -> Tensor:
    t = constant(np.ones(shape, dtype=dtype.np_dtype))
    t.name_base = "ones"
    return t


def fill(shape, value, dtype: Optional[ScalarType] = None) -> Tensor:
    # A real Fill node (dims/value Const children scoped under it), the
    # wire shape TF emits — not a constant-folded Const
    dims = constant(np.asarray(shape, dtype=np.int32))
    val = constant(value, dtype=dtype)
    t = _nary(
        "Fill",
        [dims, val],
        val.dtype,
        {"index_type": AttrValue.of_type(ScalarType.int32)},
    )
    dims.name_relative = (t, "dims")
    val.name_relative = (t, "value")
    return t


def _nary(
    op: str,
    parents: List[Tensor],
    dtype: Optional[ScalarType] = None,
    extra_attrs: Optional[Dict[str, AttrValue]] = None,
    name: Optional[str] = None,
) -> Tensor:
    dt = dtype or parents[0].dtype
    attrs = {"T": AttrValue.of_type(dt)}
    attrs.update(extra_attrs or {})
    return Tensor(op, parents, attrs, dt, requested_name=name)


def identity(x: Tensor, name: Optional[str] = None) -> Tensor:
    return _nary("Identity", [x], name=name)


def add(a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
    # AddV2: what modern TF emits for `tf.add` — the golden structural
    # suite pins our export to the installed TF's wire format (the
    # import path still accepts legacy "Add" from reference fixtures)
    t = _nary("AddV2", [a, b], _same_dtype(a, b, "add"), name=name)
    t.name_base = "Add"  # TF's anonymous-name base for add
    return t


def sub(a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
    return _nary("Sub", [a, b], _same_dtype(a, b, "sub"), name=name)


def mul(a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
    return _nary("Mul", [a, b], _same_dtype(a, b, "mul"), name=name)


def div(a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
    # Modern TF's `tf.div` emits RealDiv for floats (true division) and
    # keeps integer Div truncation; match its wire format per dtype so
    # the golden structural suite holds across the dtype matrix.
    dt = _same_dtype(a, b, "div")
    op = "RealDiv" if dt.is_floating else "Div"
    t = _nary(op, [a, b], dt, name=name)
    if op == "RealDiv":
        t.name_base = "div"  # TF's anonymous-name base for tf.div
    return t


def matmul(a: Tensor, b: Tensor, transpose_a=False, transpose_b=False) -> Tensor:
    extra = {
        "transpose_a": AttrValue.of_bool(transpose_a),
        "transpose_b": AttrValue.of_bool(transpose_b),
        # modern TF stamps gradient-precision flags on every MatMul
        "grad_a": AttrValue.of_bool(False),
        "grad_b": AttrValue.of_bool(False),
    }
    return _nary("MatMul", [a, b], _same_dtype(a, b, "matmul"), extra)


def square(x: Tensor) -> Tensor:
    return _nary("Square", [x])


def sqrt(x: Tensor) -> Tensor:
    return _nary("Sqrt", [x])


def relu(x: Tensor) -> Tensor:
    return _nary("Relu", [x])


def softmax(x: Tensor) -> Tensor:
    return _nary("Softmax", [x])


def sigmoid(x: Tensor) -> Tensor:
    return _nary("Sigmoid", [x])


def tanh(x: Tensor) -> Tensor:
    return _nary("Tanh", [x])


def cast(x: Tensor, dtype: ScalarType) -> Tensor:
    attrs = {
        "SrcT": AttrValue.of_type(x.dtype),
        "DstT": AttrValue.of_type(dtype),
    }
    return Tensor("Cast", [x], attrs, dtype)


def reshape(x: Tensor, shape: Sequence[int]) -> Tensor:
    shp = constant(np.asarray(shape, dtype=np.int32))
    t = _nary(
        "Reshape", [x, shp],
        extra_attrs={"Tshape": AttrValue.of_type(ScalarType.int32)},
    )
    shp.name_relative = (t, "shape")
    return t


def expand_dims(x: Tensor, axis: int) -> Tensor:
    dim = constant(np.int32(axis))
    t = _nary(
        "ExpandDims", [x, dim],
        extra_attrs={"Tdim": AttrValue.of_type(ScalarType.int32)},
    )
    dim.name_relative = (t, "dim")
    return t


def concat(xs: Sequence[Tensor], axis: int) -> Tensor:
    dt = xs[0].dtype
    for x in xs[1:]:
        if x.dtype is not dt:
            raise ValueError(
                f"concat: inputs disagree on dtype ({dt.name} vs "
                f"{x.dtype.name}); cast first"
            )
    ax = constant(np.int32(axis))
    t = _nary(
        "ConcatV2", list(xs) + [ax], dt,
        {
            "N": AttrValue.of_int(len(xs)),
            "Tidx": AttrValue.of_type(ScalarType.int32),
        },
    )
    t.name_base = "concat"  # TF's anonymous-name base for tf.concat
    ax.name_relative = (t, "axis")
    return t


def _reducer(
    op: str, x: Tensor, axes: Optional[Sequence[int]], keep_dims: bool
) -> Tensor:
    """Reduction with a `reduction_indices` Const child, matching
    `DslImpl.build_reducer` (`DslImpl.scala:175-188`)."""
    if axes is None:
        axes = []
    idx = constant(np.asarray(list(axes), dtype=np.int32))
    extra = {
        "keep_dims": AttrValue.of_bool(keep_dims),
        "Tidx": AttrValue.of_type(ScalarType.int32),
    }
    t = _nary(op, [x, idx], x.dtype, extra)
    # TF scopes the axis constant under the reduce node's (final) name
    idx.name_relative = (t, "reduction_indices")
    return t


def reduce_sum(x: Tensor, axes=None, keep_dims=False, name=None) -> Tensor:
    return _reducer("Sum", x, axes, keep_dims).named(name) if name else _reducer(
        "Sum", x, axes, keep_dims
    )


def reduce_min(x: Tensor, axes=None, keep_dims=False) -> Tensor:
    return _reducer("Min", x, axes, keep_dims)


def reduce_max(x: Tensor, axes=None, keep_dims=False) -> Tensor:
    return _reducer("Max", x, axes, keep_dims)


def reduce_mean(x: Tensor, axes=None, keep_dims=False) -> Tensor:
    return _reducer("Mean", x, axes, keep_dims)


def _arg_reducer(op: str, x: Tensor, axis: int) -> Tensor:
    """ArgMin/ArgMax with TF's `dimension` const child + index attrs."""
    dim = constant(np.int32(axis))
    t = _nary(
        op, [x, dim], x.dtype,
        {
            "Tidx": AttrValue.of_type(ScalarType.int32),
            "output_type": AttrValue.of_type(ScalarType.int64),
        },
    )
    t.dtype = ScalarType.int64
    dim.name_relative = (t, "dimension")
    return t


def argmin(x: Tensor, axis: int = 0) -> Tensor:
    return _arg_reducer("ArgMin", x, axis)


def argmax(x: Tensor, axis: int = 0) -> Tensor:
    return _arg_reducer("ArgMax", x, axis)


def unsorted_segment_sum(data: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    n = constant(np.int32(num_segments))
    return _nary(
        "UnsortedSegmentSum", [data, ids, n], data.dtype,
        {"Tindices": AttrValue.of_type(ids.dtype)},
    )


# ---------------------------------------------------------------------------
# frame integration (dsl.block / dsl.row, `dsl/package.scala:92-112`)
# ---------------------------------------------------------------------------


def block(frame, col_name: str, tf_name: Optional[str] = None) -> Tensor:
    """Placeholder matching a column's *block* (unknown lead dim), named
    after the column (`extractPlaceholder`, `DslImpl.scala:90-107`)."""
    info = frame.info[col_name]
    return placeholder(
        info.dtype, info.block_shape, name=tf_name or col_name
    )


def row(frame, col_name: str, tf_name: Optional[str] = None) -> Tensor:
    """Placeholder matching a single row's cell of a column."""
    info = frame.info[col_name]
    return placeholder(info.dtype, info.cell_shape, name=tf_name or col_name)


# ---------------------------------------------------------------------------
# freeze: Tensor closure -> Graph
# ---------------------------------------------------------------------------


def build(fetches: Union[Tensor, Sequence[Tensor]]) -> (Graph, List[str]):
    """Freeze the transitive closure of ``fetches`` into a `Graph`.

    Returns (graph, fetch_names). Name assignment: requested names win;
    anonymous nodes get ``<scope>/<op_lower>_<k>`` counters
    (`Paths.scala:40-55`, `DslImpl.buildGraph`).
    """
    if isinstance(fetches, Tensor):
        fetches = [fetches]
    # Memoize per fetch-tuple identity: verbs rebuild the graph on every
    # call otherwise (re-serializing it dominated chained-verb dispatch).
    # Tensors are immutable once created, so identity is a sound key.
    memo_key = tuple(id(f) for f in fetches)
    cached = _build_memo.get(memo_key)
    if cached is not None and all(
        a() is b for a, b in zip(cached[0], fetches)
    ):
        return cached[1]
    order: List[Tensor] = []
    seen: Dict[int, bool] = {}

    def visit(t: Tensor):
        root = t.source or t
        if id(root) in seen:
            return
        seen[id(root)] = True
        for p in root.parents:
            visit(p)
        order.append(root)

    for f in fetches:
        visit(f)

    counters: Dict[str, int] = {}
    names: Dict[int, str] = {}
    used = set()
    for t in order:
        if t.name_relative is not None:
            continue  # named after its consumer in the second pass
        if t.requested_name:
            name = "/".join(t.scope_path + (t.requested_name,))
        else:
            base = "/".join(t.scope_path + (t.name_base or t.op,))
            k = counters.get(base, 0)
            name = base if k == 0 else f"{base}_{k}"
            counters[base] = k + 1
            while name in used:
                k = counters[base]
                name = f"{base}_{k}"
                counters[base] = k + 1
        if name in used:
            raise ValueError(f"duplicate node name {name!r} in DSL graph")
        used.add(name)
        names[id(t)] = name
    for t in order:
        if t.name_relative is None:
            continue
        consumer, suffix = t.name_relative
        root = consumer.source or consumer
        name = f"{names[id(root)]}/{suffix}"
        if name in used:
            raise ValueError(f"duplicate node name {name!r} in DSL graph")
        used.add(name)
        names[id(t)] = name

    g = Graph()
    for t in order:
        edges = []
        for p in t.parents:
            root = p.source or p
            e = names[id(root)]
            if p.idx:
                e = f"{e}:{p.idx}"
            edges.append(e)
        g.add(GraphNode(names[id(t)], t.op, edges, dict(t.attrs)))

    fetch_names = []
    for f in fetches:
        root = f.source or f
        n = names[id(root)]
        fetch_names.append(f"{n}:{f.idx}" if f.idx else n)
    if len(_build_memo) > 256:  # bound the memo
        _build_memo.clear()
    _build_memo[memo_key] = (
        [weakref.ref(f) for f in fetches],
        (g, fetch_names),
    )
    return g, fetch_names
