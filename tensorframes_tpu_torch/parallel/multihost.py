"""Multi-process execution: one process a card, a mesh over all of them,
each process feeding its own rows.

The PyTorch counterpart of `tensorframes_tpu/parallel/multihost.py`, on
`torch.distributed`. It stands in for the reference's multi-executor Spark
cluster: every process holds its own rows, and one reduce, map or keyed
aggregate spans the whole job.

    from tensorframes_tpu_torch.parallel import multihost as mh
    mh.initialize_distributed()            # torchrun's environment, NCCL
    mesh = mh.global_data_mesh()           # every process's card
    df = mh.host_local_frame_to_global(local_frame, mesh)
    tft.reduce_blocks(s, df, mesh=mesh)    # every process gets the total

A `SpanningFrame` holds this process's rows, one shard a local mesh slot,
and knows the global row count and each shard's global offset (a global
`jax.Array`'s ``addressable_shards``). The data-mesh verbs take it with
its mesh (``mesh=``): each process runs its own slots through the verbs'
one block loop (`api._place` -> `local_place`); `reduce_blocks` and
`reduce_rows` then all-gather the per-shard partials in global shard order
(`gather_partials`) and every process combines them, so every process
returns the same value; `map_blocks` and `map_rows` return the outputs as
a `SpanningFrame`. What the JAX package does elsewhere, the port does
too: a verb without ``mesh=`` raises `ValueError`, and a keyed
`aggregate`, `host_values` or `to_pandas` over rows of other processes
raise `RuntimeError` (use `aggregate_global` on the per-process frame).

Device tensors travel over the process group's own backend: NCCL on the
card, gloo on the CPU (``initialize_distributed(device="cpu")``, what the
tests use). Host metadata (row counts, shape codes, string key codes,
mesh labels) travels over a gloo group made beside an NCCL group. Retries
(`runtime.faults`) wrap local work only: a collective is never re-entered
on one rank while the others have moved on.
"""

from __future__ import annotations

import datetime
import inspect
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..frame import Column, TensorFrame, as_tensor
from ..schema import ScalarType, Shape
from .mesh import Mesh, _devices

__all__ = [
    "initialize_distributed",
    "global_data_mesh",
    "host_local_frame_to_global",
    "analyze_global",
    "aggregate_global",
    "SpanningFrame",
    "Shard",
]

# the gloo group host metadata travels over when the default group is
# NCCL (None: the default group, which is gloo)
_meta_group = None


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 600.0,
) -> None:
    """Join the job's process group. Without arguments it reads torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``). Idempotent, and a no-op in a
    single-process run with no coordinator anywhere.

    ``device=None`` is NCCL on the card ``cuda:LOCAL_RANK`` (set current
    before the group starts; one rank a card), and raises without a card;
    ``device="cpu"`` is gloo. Collectives that wait longer than
    ``timeout_s`` for a lost peer fail instead of hanging. A failure
    re-raises whenever the caller asked for more than one process."""
    global _meta_group
    if dist.is_initialized():
        return
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if addr is None:
        if world > 1:
            raise ValueError(
                f"initialize_distributed: {world} processes need a coordinator "
                "address (coordinator_address= or MASTER_ADDR / MASTER_PORT)"
            )
        return  # one process, nothing to join
    explicit = coordinator_address is not None or world > 1
    try:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "initialize_distributed: device=None is NCCL on this rank's "
                    "card, and torch.cuda.is_available() is False here; pass "
                    "device='cpu' for gloo"
                )
            local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            backend = "nccl"
        elif torch.device(device).type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"initialize_distributed: device={device!r} is neither None nor 'cpu'")
        timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=world, rank=rank, timeout=timeout
        )
        _meta_group = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
    except Exception:
        if explicit:
            raise


def process_count() -> int:
    """Processes in the job (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _allgather_object(obj) -> List:
    out: List = [None] * process_count()
    dist.all_gather_object(out, obj, group=_meta_group)
    return out


def _allgather_host(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (one shape and dtype everywhere), stacked in
    rank order, over the metadata group."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=_meta_group)
    return torch.stack(out).numpy()


def _gather_padded_host(arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Every process's rows of ``arr`` (row counts ``lens``, cells alike),
    padded to the largest count for the gather and cut back, in rank
    order."""
    pad = np.zeros((int(lens.max()) - arr.shape[0],) + arr.shape[1:], arr.dtype)
    g = _allgather_host(np.concatenate([arr, pad]))
    return np.concatenate([g[p, : lens[p]] for p in range(len(lens))])


def _gather_padded(t: torch.Tensor, lens: Sequence[int]) -> torch.Tensor:
    """Every process's rows of device tensor ``t`` (row counts ``lens``,
    cells alike), over the default group's backend, in rank order on
    ``t``'s device. The rows travel as bytes, so every dtype moves
    (gloo has no uint32)."""
    cell = tuple(t.shape[1:])
    row_bytes = int(np.prod(cell, dtype=np.int64)) * t.element_size()
    buf = torch.zeros(int(max(lens)) * row_bytes, dtype=torch.uint8, device=t.device)
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    buf[: flat.numel()] = flat
    out = [torch.empty_like(buf) for _ in lens]
    dist.all_gather(out, buf)
    return torch.cat([
        o[: n * row_bytes].view(t.dtype).reshape((n,) + cell) for o, n in zip(out, lens)
    ])


# ---------------------------------------------------------------------------
# the global mesh and frame
# ---------------------------------------------------------------------------


def global_data_mesh(axes: Sequence[str] = ("data",), devices=None) -> Mesh:
    """A 1-D mesh over every process's slots, process-major (the order of
    `jax.devices()`), each slot recording the rank that owns it. This
    process's slots are its card by default, or ``devices`` (for example
    ``["cpu"] * 2``, the CPU tests' two slots a process)."""
    if len(axes) != 1:
        raise ValueError("use parallel.mesh_2d for multi-axis meshes")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "global_data_mesh takes this process's card by default, and "
                "none is visible here; pass devices=[...], for example ['cpu'] * 2"
            )
        local = [torch.device("cuda", torch.cuda.current_device())]
    else:
        local = _devices(devices)
    if process_count() == 1:
        return Mesh(np.asarray(local, dtype=object), tuple(axes))
    labels = _allgather_object([str(d) for d in local])
    devs = [torch.device(lab) for labs in labels for lab in labs]
    ranks = [r for r, labs in enumerate(labels) for _ in labs]
    return Mesh(np.asarray(devs, dtype=object), tuple(axes), ranks=ranks)


class Shard(NamedTuple):
    """One shard of a `SpanningFrame` column that this process holds: its
    global rows and its values on its slot's device."""

    index: slice
    data: torch.Tensor


class SpanningFrame:
    """A frame whose rows lie in several processes: ``local`` holds this
    process's rows (one block a local mesh slot), ``nrows`` counts every
    process's, and this process's first row is global row
    ``row_offset``. Build it with `host_local_frame_to_global`; the verbs
    take it with ``mesh=`` its mesh."""

    _spanning = True  # what `api._spanning_in_out` looks for

    def __init__(self, local: TensorFrame, mesh: Mesh, nrows: int, row_offset: int):
        self.local = local
        self.mesh = mesh
        self.nrows = int(nrows)
        self.row_offset = int(row_offset)
        self.slots = mesh.local_slots(process_index())
        if local.num_blocks != len(self.slots):
            raise ValueError(
                f"{local.num_blocks} local blocks for {len(self.slots)} local mesh slots"
            )
        local._span_mesh = mesh  # `local_place` runs only such a frame over the mesh

    @property
    def columns(self) -> List[str]:
        return self.local.columns

    @property
    def info(self):
        return self.local.info

    def shards(self, name: str) -> List[Shard]:
        """Column ``name``'s shards in this process, one a local slot, in
        global order."""
        vals = self.local.column(name).values
        off = self.local.offsets
        devs = self.mesh.device_list()
        return [
            Shard(slice(self.row_offset + off[j], self.row_offset + off[j + 1]),
                  as_tensor(vals[off[j]:off[j + 1]], devs[s]))
            for j, s in enumerate(self.slots)
        ]

    def _all_local(self, what: str) -> TensorFrame:
        if self.mesh.process_count > 1:
            raise RuntimeError(
                f"{what}: the frame's rows span {self.mesh.process_count} processes, "
                "and this process holds only its own; read them with shards(name), "
                "or aggregate per process with parallel.multihost.aggregate_global"
            )
        return self.local

    def column(self, name: str) -> Column:
        return self._all_local("column").column(name)

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    def host_values(self, name: str) -> np.ndarray:
        return self._all_local("host_values").host_values(name)

    def to_pandas(self):
        return self._all_local("to_pandas").to_pandas()

    def __repr__(self) -> str:
        return (
            f"SpanningFrame[{self.nrows} rows x {len(self.columns)} cols, rows "
            f"[{self.row_offset}:{self.row_offset + self.local.nrows}) here, {self.mesh!r}]"
        )


def host_local_frame_to_global(frame: TensorFrame, mesh: Mesh) -> SpanningFrame:
    """Assemble a global frame from every process's rows: process p's rows
    follow those of processes 0..p-1, split evenly over p's mesh slots and
    placed on the first of them (the counterpart of
    `jax.make_array_from_process_local_data`). Every column must be dense
    and numeric; as in the JAX package, the local slots must divide the
    row count, and every process must pass the same row count and schema
    (the JAX package builds disagreeing global shapes then and fails at
    the first collective)."""
    for name in frame.columns:
        c = frame.column(name)
        if not c.is_dense or c.dtype is ScalarType.string:
            raise ValueError(f"multi-host frames need dense numeric columns ({name!r})")
    rank = process_index()
    slots = mesh.local_slots(rank)
    if not slots:
        raise ValueError(f"the mesh has no slot of process {rank}: {mesh!r}")
    n, k = frame.nrows, len(slots)
    if n % k:
        raise ValueError(
            f"process {rank} passes {n} rows, which its {k} mesh slots do not divide evenly"
        )
    if process_count() > 1:
        schema = (n, [(c, frame.info[c].dtype.name, frame.info[c].cell_shape.dims)
                      for c in frame.columns])
        every = _allgather_object(schema)
        if any(s != every[0] for s in every):
            raise ValueError(
                "every process must pass the same row count and columns to "
                f"host_local_frame_to_global; they passed {[(s[0], len(s[1])) for s in every]} "
                "(rows, columns) by rank"
            )
    dev = mesh.device_list()[slots[0]]
    cols = []
    for name in frame.columns:
        c = frame.column(name)
        nc = Column(name, as_tensor(c.values, dev))
        nc.cell_shape = c.cell_shape
        cols.append(nc)
    per = n // k
    local = TensorFrame(cols, [j * per for j in range(k + 1)])
    return SpanningFrame(local, mesh, n * mesh.process_count, n * rank)


# ---------------------------------------------------------------------------
# the verbs over a SpanningFrame (api._spanning_in_out, api._place)
# ---------------------------------------------------------------------------


def run_verb(verb, fetches, frame: SpanningFrame, args, kwargs):
    """``verb`` (the decorated verb below `api._spanning_in_out`) over
    ``frame``: without ``mesh=`` only when every row is here (else the JAX
    package's `ValueError`), with ``mesh=`` the frame's mesh over this
    process's rows, eagerly; a frame out is a `SpanningFrame`."""
    from ..lazy import _LAZY_MODE

    bound = inspect.signature(verb).bind(fetches, frame, *args, **kwargs)
    mesh = bound.arguments.get("mesh")
    name = verb.__name__
    if mesh is None and frame.mesh.process_count > 1:
        raise ValueError(
            f"{name}: the frame's rows span {frame.mesh.process_count} processes; "
            "pass mesh= (the mesh it was built over)"
        )
    if mesh is not None and mesh != frame.mesh:
        raise ValueError(f"{name}: the frame lies on {frame.mesh!r}, not on mesh={mesh!r}")
    bound.arguments["frame"] = frame.local
    tok = _LAZY_MODE.set(False)  # over other processes' rows a verb runs eagerly
    try:
        out = verb(*bound.args, **bound.kwargs)
    finally:
        _LAZY_MODE.reset(tok)
    if mesh is None or not isinstance(out, TensorFrame):
        return out
    return _respan(out, frame, trimmed=bool(bound.arguments.get("trim")))


def _respan(out: TensorFrame, frame: SpanningFrame, trimmed: bool) -> SpanningFrame:
    """A map's local outputs as a `SpanningFrame` over ``frame``'s mesh:
    one block a local slot (a slot whose input shard was empty ran
    nothing and holds no rows); a trimmed map's global row count and
    offset come from every process's output row count."""
    off = frame.local.offsets
    k = len(off) - 1
    if out.num_blocks == k:
        offsets = list(out.offsets)
    else:
        sizes = [0] * k
        live = [j for j in range(k) if off[j + 1] > off[j]]
        for j, a, b in zip(live, out.offsets, out.offsets[1:]):
            sizes[j] = b - a
        offsets = [int(x) for x in np.cumsum([0] + sizes)]
    local = TensorFrame([out.column(c) for c in out.columns], offsets)
    if not trimmed:
        return SpanningFrame(local, frame.mesh, frame.nrows, frame.row_offset)
    counts = [out.nrows] * frame.mesh.process_count
    if process_count() > 1:
        counts = _allgather_host(np.asarray([out.nrows], np.int64))[:, 0].tolist()
    rank = process_index()
    return SpanningFrame(local, frame.mesh, sum(counts), sum(counts[:rank]))


def local_place(frame: TensorFrame, mesh: Mesh):
    """`api._Place` of a mesh over several processes: this process's
    slots, slot s running block j of the frame's local rows (a
    `SpanningFrame.local`), empty shards skipped; results converge on the
    first local slot."""
    from ..api import _Place

    if getattr(frame, "_span_mesh", None) != mesh:
        raise ValueError(
            f"a mesh over {mesh.process_count} processes runs the verbs over a frame "
            "from parallel.multihost.host_local_frame_to_global(frame, mesh)"
        )
    slots = mesh.local_slots(process_index())
    devs = mesh.device_list()
    off = frame.offsets
    items = [(s, off[j], off[j + 1]) for j, s in enumerate(slots) if off[j + 1] > off[j]]
    return _Place(items, devs[slots[0]], mesh=mesh, devs=devs)


def gather_partials(partials: List[tuple], mesh: Mesh, anchor: torch.device,
                    outputs) -> List[tuple]:
    """Every process's per-shard partials (tuples of one tensor a fetch,
    each on ``anchor``), in global shard order: rank-major, each rank's in
    slot order. Every process gets the same list.

    ``outputs`` are the fetches' analyzed outputs (`graph.analysis`
    summaries, alike on every rank). When their shapes are known, the
    partials travel in ONE all-gather of a buffer of one size on every
    rank: its partial count, then each fetch's partials padded to the
    most slots a rank holds (the JAX package's all-gather inside the mesh
    program needs no more). A dim the analysis left unknown costs a
    descriptor gather over the metadata group first."""
    like = [(tuple(o.shape.dims), o.dtype.torch_dtype) for o in outputs]
    if any(d is None for shape, _ in like for d in shape):
        every = _allgather_object(
            [(tuple(t.shape), t.dtype) for t in partials[0]] if partials else None)
        like = next((d for d in every if d is not None), None)
        if like is None:
            return []  # no process reduced a row
    for p in partials:
        for t, (shape, dtype) in zip(p, like):
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise RuntimeError(
                    f"a partial of shape {tuple(t.shape)} {t.dtype}, where every "
                    f"process sends {shape} {dtype}"
                )
    kmax = max(len(mesh.local_slots(r)) for r in set(mesh.ranks.flat))
    # each fetch's rows, its block 8-byte aligned so every dtype views back
    sizes = [int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dt).element_size()
             for shape, dt in like]
    spans = [-(-kmax * n // 8) * 8 for n in sizes]
    buf = torch.zeros(8 + sum(spans), dtype=torch.uint8, device=anchor)
    buf[:8] = torch.tensor([len(partials)], dtype=torch.int64).view(torch.uint8)
    off = 8
    for j, span in enumerate(spans):
        if partials:
            flat = torch.stack([as_tensor(p[j], anchor) for p in partials]).reshape(-1)
            flat = flat.view(torch.uint8)
            buf[off:off + flat.numel()] = flat
        off += span
    out = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(out, buf)
    counts = torch.stack([o[:8] for o in out]).view(torch.int64).reshape(-1).tolist()
    cols, off = [], 8
    for (shape, dtype), n, span in zip(like, sizes, spans):
        cols.append(torch.cat([
            o[off:off + k * n].view(dtype).reshape((k,) + shape) for o, k in zip(out, counts)
        ]))
        off += span
    return [tuple(c[i] for c in cols) for i in range(sum(counts))]


def spanning_grouped(grouped, verb: str):
    """A `GroupedFrame` over a `SpanningFrame`: over its local frame when
    every row is here, else the JAX package's `RuntimeError`."""
    from ..api import GroupedFrame

    return GroupedFrame(grouped.frame._all_local(verb), grouped.keys)


# ---------------------------------------------------------------------------
# analyze_global and aggregate_global
# ---------------------------------------------------------------------------


def analyze_global(frame):
    """Distributed `analyze`: every process scans its own rows, then the
    per-column cell shapes merge across processes, widening the dims that
    differ to unknown (the reference's cluster-wide scan,
    `ExperimentalOperations.scala:89-132`). ``frame`` is this process's
    frame (a `SpanningFrame`'s local rows are scanned). Ranks are agreed
    first; shapes travel as fixed-width int64 rows (rank, then dims, -1
    for unknown, -2 for padding); a rank that differs across processes
    raises."""
    if isinstance(frame, SpanningFrame):
        out = analyze_global(frame.local)
        return SpanningFrame(
            TensorFrame([out.column(c) for c in out.columns], frame.local.offsets),
            frame.mesh, frame.nrows, frame.row_offset,
        )
    analyzed = frame.analyze()
    infos = [analyzed.info[name] for name in analyzed.columns]
    max_rank = max((i.cell_shape.rank for i in infos), default=0)
    multi = process_count() > 1
    if multi:
        max_rank = int(_allgather_host(np.asarray([max_rank], np.int64)).max())
    enc = np.full((len(infos), max_rank + 1), -2, dtype=np.int64)
    for r, info in enumerate(infos):
        enc[r, 0] = info.cell_shape.rank
        for j, d in enumerate(info.cell_shape.dims):
            enc[r, 1 + j] = -1 if d is None else d
    all_enc = _allgather_host(enc) if multi else enc[None]
    out = analyzed
    for r, info in enumerate(infos):
        merged = None
        for p in range(all_enc.shape[0]):
            rank = int(all_enc[p, r, 0])
            shape = Shape([None if int(d) == -1 else int(d) for d in all_enc[p, r, 1:1 + rank]])
            if merged is None:
                merged = shape
                continue
            m = merged.merge(shape)
            if m is None:
                raise ValueError(
                    f"analyze_global: column {info.name!r} has rank {merged.rank} on "
                    f"some hosts and {shape.rank} on others (incompatible, like the "
                    "reference's analyze rank check)"
                )
            merged = m
        out = out.append_shape(info.name, merged)
    return out


def _string_codes(values) -> np.ndarray:
    """A host string or bytes key column as UCS4 code points, one row a
    key, padded to the widest key of any process. Bytes decode first:
    ``str(b"abc")`` would be the repr ``"b'abc'"``."""

    def cell(x):
        return x.decode("utf-8", "surrogateescape") if isinstance(x, bytes) else str(x)

    sarr = np.array([cell(x) for x in values], dtype="<U1") if len(values) == 0 \
        else np.array([cell(x) for x in values])
    w = max(1, sarr.dtype.itemsize // 4)
    wmax = int(_allgather_host(np.asarray([w], np.int64)).max())
    sarr = sarr.astype(f"<U{wmax}")
    if not len(sarr):
        return np.zeros((0, wmax), np.uint32)
    return sarr.view(np.uint32).reshape(len(sarr), wmax)


def aggregate_global(fetches, grouped, feed_dict=None, fetch_names=None, executor=None,
                     device=None):
    """Distributed keyed aggregation over every process's rows.

    Every process aggregates its own rows (`api.aggregate` on ``device``,
    default the card), the small keyed partial tables all-gather across
    processes, and the partials combine again per key by each fetch's
    monoid (`aggregate._monoid_combine`), weighted by group size for a
    mean: the rows never move, only keys x cell-sized partials (the
    reference's partial-aggregation shuffle, `DebugRowOps.scala:554-599`).
    Partial tables are padded to the largest row count for the gather and
    cut back by their true lengths; a string or bytes key travels as a
    fixed-width UCS4 code matrix (as int32: gloo has no uint32). Every
    fetch must classify (Sum / Min / Max / Prod, float Mean over a
    row-wise transform), else `ValueError`."""
    from .. import api as _api
    from ..aggregate import _chunk_combiners, _factorized, _keyed_output, _monoid_combine
    from ..frame import factorize_keys
    from ..graph.analysis import analyze_graph
    from ..graph.ir import base_name

    if getattr(grouped.frame, "_spanning", False):
        grouped = spanning_grouped(grouped, "aggregate_global")
    frame = grouped.frame
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    overrides = _api._ph_overrides(graph, frame, feed_dict, True, {})
    summary = analyze_graph(graph, fetch_list, placeholder_shapes=overrides)
    combiners = _chunk_combiners(graph, fetch_list, summary)
    if combiners is None:
        raise ValueError(
            "aggregate_global needs Reduce(rowwise(placeholder), axis=0) "
            "fetches (Sum/Min/Max/Prod, float Mean); rewrite the graph or "
            "aggregate host-locally"
        )
    bases = sorted(base_name(f) for f in fetch_list)
    local = _api.aggregate(graph, grouped, feed_dict, fetch_names=fetch_list,
                           executor=executor, device=device)
    if process_count() == 1:
        return local
    key_cols = list(grouped.keys)
    dev = local.column(bases[0]).values.device
    lens = _allgather_host(np.asarray([local.nrows], np.int64))[:, 0]
    gathered: Dict[str, object] = {}
    for k in key_cols:
        col = local.column(k)
        if col.dtype is ScalarType.string:
            codes = _gather_padded_host(_string_codes(col.host_values()).view(np.int32), lens)
            wmax = codes.shape[1]
            keys = np.ascontiguousarray(codes).view(np.uint32).view(f"<U{wmax}").ravel()
            gathered[k] = keys.astype(object)
        else:
            gathered[k] = _gather_padded(as_tensor(col.values, dev), lens)
    for b in bases:
        gathered[b] = _gather_padded(as_tensor(local.column(b).values, dev), lens)
    weights = None
    if "mean" in combiners.values():
        _, inverse, num_groups = _factorized(grouped, dev)
        counts = torch.bincount(inverse, minlength=num_groups).to(torch.int64)
        weights = _gather_padded(counts, lens).to(torch.float64)
    key_out, inverse = factorize_keys(key_cols, [gathered[k] for k in key_cols], dev)
    num_groups = len(next(iter(key_out.values())))
    results = {
        b: _monoid_combine(gathered[b], inverse, num_groups, combiners[b], weights)
        for b in bases
    }
    return _keyed_output(key_out, results, bases)
