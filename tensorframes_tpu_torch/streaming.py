"""Out-of-core streaming reduce.

The PyTorch counterpart of `tensorframes_tpu/streaming.py`.
`reduce_blocks_stream` folds an iterator of frames with background
prefetch and bounded-memory tree-folding — what makes the BASELINE north
star (a 1B-row vector reduce) run in bounded host and device memory.
`api.py` re-exports it.

The stream is one stage graph (`ingest.pipeline.pipelined`): the source
(a Python iterator of frames, or the discovery and parallel-decode stages
of a `stream_dataset`), then the H2D transfer stage, then the consumer,
which reduces each chunk on the card while the next chunk is produced and
copied. The transfer stage (`_TransferStage`) runs on a pipeline thread:
it copies each chunk's dense columns through a ring of reusable pinned
staging buffers on its own CUDA stream and records an event; the
consumer's stream waits on that event before the reduce reads the chunk,
and `Tensor.record_stream` keeps the caching allocator from handing the
chunk's memory out again while the consumer's stream still reads it.

Chunks may be `LazyFrame`s (a pending map chain over each chunk): the
transfer stage stages the chunk's BASE frame, and the per-chunk reduce
fuses the pending chain with the reduce (`LazyFrame.reduce_blocks`).

Placement (as the JAX package's): ``device=`` pins one device; ``mesh=``
reduces each chunk over the mesh (no transfer stage: the mesh owns its
placement); otherwise the block scheduler's devices (``devices=``, or two
or more cards under ``config.block_scheduler``) take the chunks in turn,
chunk i on device i mod n: the transfer stage (one per device) and the
consumer each count chunks and agree by the chunk's ordinal, so chunk i's
copy lands where chunk i reduces, while chunk i-1 computes on another
card. Partials converge on the first device. Under ``"global"`` a chunk of
at least ``config.global_frame_min_rows`` rows is sharded over the global
mesh in the transfer stage and reduced once a shard (`globalframe`); the
stream asks once, on its first sharded chunk, whether the graph can run
there, and an ineligible stream stands the global path down and rotates.
The global path's partials fold eagerly into two alternating slots (the
double-buffered accumulator): the fold of chunk k runs while chunk k+1's
shards copy, and at most two partial tables are live.
"""

from __future__ import annotations

from contextlib import nullcontext as _nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import api as _api  # late-bound: api imports this module at its end
from .device import DeviceLike, resolve_device
from .frame import Column, TensorFrame, _to_numpy, as_tensor
from .graph.analysis import analyze_graph
from .graph.ir import base_name as _base
from .aggregate import _chunk_combiners
from .runtime.deadline import deadline_entry as _deadline_entry
from .runtime.executor import Executor
from .schema import ScalarType
from .utils import telemetry as _telemetry
from .utils.profiling import count as record_count

__all__ = ["reduce_blocks_stream"]

# Pinned staging slots of the transfer stage. A slot is busy from the
# host copy of chunk k into it until the DMA out of it lands; one copy
# stream runs the DMAs in order, so two slots already let the host copy of
# chunk k+1 run under the DMA of chunk k — the pipeline's live-chunk bound
# (W + 2d + 4) would only add pinned memory that waits on the same stream.
_STAGING_SLOTS = 2

# tree-fold cadence of fold_every="auto" (the JAX package's)
_AUTO_FOLD_EVERY = 64


def _spill_partial_to_host(part: Dict, chunk: int) -> Dict:
    """D2H-spill one partial table to host numpy through the one
    accounting path every stream spill shares: a ``host_sync`` span and
    counter and the ``d2h_bytes`` histogram. Host partials pass through
    untouched."""
    if not any(isinstance(v, torch.Tensor) for v in part.values()):
        return part
    with _telemetry.span(
        "reduce_blocks_stream.spill", kind="host_sync", chunk=chunk,
    ):
        spilled = {
            k: _to_numpy(v) if isinstance(v, torch.Tensor) else v
            for k, v in part.items()
        }
    record_count("host_sync")
    if _telemetry.enabled():
        _telemetry.histogram_observe(
            "d2h_bytes", float(sum(v.nbytes for v in spilled.values())),
        )
    return spilled


class _Staged:
    """A chunk whose columns the transfer stage copied to the card, the
    event recorded on the copy stream after the copies, and the
    `LazyFrame` whose base it is, if any."""

    __slots__ = ("frame", "event", "lazy", "stage")

    def __init__(self, frame: TensorFrame, event, lazy=None, stage=None):
        self.frame = frame
        self.event = event
        self.lazy = lazy
        self.stage = stage  # the `_TransferStage` whose `receive` takes it


class _PinnedSlot:
    """One staging slot: a pinned host buffer per column name, grown when
    a chunk needs more, and the event of the last DMA out of it."""

    __slots__ = ("buffers", "event")

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event = None

    def view(self, name: str, like: torch.Tensor) -> torch.Tensor:
        nbytes = like.numel() * like.element_size()
        buf = self.buffers.get(name)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.buffers[name] = buf
        return buf[:nbytes].view(like.dtype).view(like.shape)


class _TransferStage:
    """The H2D transfer stage of a stream, called on a pipeline thread
    (or inline, with ``config.ingest_pipeline`` off).

    On a CUDA device each dense numeric host column is copied into a
    pinned staging slot, then to the card with ``non_blocking=True`` on
    the stage's own stream; a slot is written again only after the event
    of its previous DMA completed. The consumer calls `receive`, which
    makes its current stream wait for the copy before the reduce reads the
    chunk. On the CPU the stage wraps the host columns as tensors.

    A chunk whose transfer raises stays on the host (the reduce then
    copies it synchronously), as in the JAX package: logged once, counted
    per chunk as ``fallback_counter`` (`LazyFrame.force`'s plan-prep stage
    passes its own name).

    A `LazyFrame` chunk stages its base frame; `receive` hands back the
    same pending plan over the staged base."""

    def __init__(
        self,
        device: torch.device,
        fallback_counter: str = "reduce_blocks_stream.transfer_fallback",
    ):
        self.fallback_counter = fallback_counter
        self.cuda = device.type == "cuda"
        if self.cuda and device.index is None:
            # tensors report "cuda:<index>": compare against the same
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._stream = None  # made on first use, on the stage's thread
        self._slots = [_PinnedSlot() for _ in range(_STAGING_SLOTS)]
        self._next = 0
        self._warned = False

    def __call__(self, f):
        from .lazy import LazyFrame

        if isinstance(f, LazyFrame):
            staged = self(f._base)
            if isinstance(staged, _Staged):
                return _Staged(staged.frame, staged.event, f, self)
            return f._with_base(staged)
        if not isinstance(f, TensorFrame) or f.nrows == 0:
            return f  # pandas chunks convert in the reduce; empty ones skip
        try:
            return self._stage(f) if self.cuda else f.to_device(self.device)
        except Exception as e:
            if not self._warned:
                self._warned = True
                from .utils.log import get_logger

                get_logger("streaming").warning(
                    "prefetch device-transfer stage disabled for this chunk "
                    "(%s: %s); it will transfer synchronously inside its "
                    "reduce dispatch",
                    type(e).__name__, e,
                )
            record_count(self.fallback_counter)
            return f

    def _stage(self, f: TensorFrame):
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            slot = self._slots[self._next % len(self._slots)]
            self._next += 1
            if slot.event is not None:
                slot.event.synchronize()  # its previous DMA has landed
            cols, copied = [], 0
            try:
                with torch.cuda.stream(self._stream):
                    for name in f.columns:
                        c = f.column(name)
                        if (
                            not c.is_dense
                            or c.dtype is ScalarType.string
                            or c.device == self.device
                        ):
                            cols.append(c)
                            continue
                        src = as_tensor(c.values, torch.device("cpu")).contiguous()
                        host = slot.view(name, src)
                        host.copy_(src)
                        dev_t = torch.empty_like(host, device=self.device)
                        dev_t.copy_(host, non_blocking=True)
                        copied += host.numel() * host.element_size()
                        moved = Column(name, dev_t)
                        moved.cell_shape = c.cell_shape
                        cols.append(moved)
            finally:
                if copied:
                    # also after a failed later column: the slot is not
                    # rewritten before the DMAs already issued land
                    event = torch.cuda.Event()
                    event.record(self._stream)
                    slot.event = event
            if not copied:
                return f
        if _telemetry.enabled():
            _telemetry.histogram_observe("h2d_bytes", float(copied))
        return _Staged(TensorFrame(cols, f.offsets), event, stage=self)

    def receive(self, item):
        """The consumer's side: the chunk, safe to read on the consumer's
        current stream."""
        if not isinstance(item, _Staged):
            return item
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(item.event)
        for name in item.frame.columns:
            values = item.frame.column(name).values
            if isinstance(values, torch.Tensor) and values.device == self.device:
                values.record_stream(cur)
        if item.lazy is not None:
            return item.lazy._with_base(item.frame)
        return item.frame

    def close(self) -> None:
        """Wait for the copies already issued: no DMA outlives the
        stream's staging buffers."""
        if self._stream is not None:
            self._stream.synchronize()


@_deadline_entry("reduce_blocks_stream")
@torch.no_grad()
def reduce_blocks_stream(
    fetches,
    frames,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    executor: Optional[Executor] = None,
    fold_every="auto",
    device: DeviceLike = None,
    checkpoint=None,
    checkpoint_every: Optional[int] = None,
    resume: str = "auto",
    mesh=None,
    devices=None,
):
    """Out-of-core reduce: fold an ITERATOR of frames (chunks too large to
    hold at once). Chunk N+1 is produced and copied to ``device`` (default:
    the CUDA card) by background pipeline threads while chunk N reduces
    there; partials combine with the same graph. Returns one tensor for
    one fetch, a dict of tensors for several, on ``device``.

    The partial table is tree-folded every ``fold_every`` chunks, so
    memory is bounded by O(fold_every) partials however long the stream.
    Combining partials through the same graph assumes the reduce is
    ASSOCIATIVE over blocks, so ``fold_every="auto"`` tree-folds (every
    64 chunks) ONLY when every fetch is a sum/min/max/prod monoid reduce
    consuming its placeholder DIRECTLY; Mean, transform-then-reduce
    (``Sum(x*x)``) and unclassifiable graphs keep every partial for one
    final combine, spilling all but the newest partial to the host
    (counted as ``host_sync`` plus ``d2h_bytes``). Pass an int to force a
    cadence, or ``None`` to force the single final combine. Empty chunks
    are skipped; a stream with no rows raises `ValueError`.

    Durable streams (``checkpoint=``, `runtime.checkpoint`): give a path
    and the stream atomically commits its progress — a versioned manifest
    plus the live partial table — after every ``checkpoint_every`` folded
    chunks (default ``config.stream_checkpoint_every``), on clean
    `DeadlineExceeded` / `Cancelled` exits, and at completion. A new call
    resumes from the committed watermark: an unstarted `stream_dataset`
    skips committed chunks at the task-metadata level (never re-decoded),
    a plain iterator pulls and drops them. Drift in any manifest field is
    refused (``resume="ignore"`` starts afresh). Only classifiable monoid
    reduces are eligible.
    """
    from . import config as _cfg
    from . import globalframe as _gf
    from .runtime import scheduler as _rs

    _api._check_mesh_args("reduce_blocks_stream", mesh, device, devices)
    graph, fetch_list = _api._as_graph(fetches, fetch_names)
    auto_fold = fold_every == "auto"
    if auto_fold:
        fold_every = None  # resolved from the first chunk's analysis below
    if fold_every is not None:
        fold_every = max(2, int(fold_every))
    # placement: a pinned device, a mesh, a rotation over the scheduler's
    # devices, or the global mesh (its rotation parked until it stands down)
    rotation = gmesh = parked = None
    if mesh is not None:
        dev = mesh.device_list()[0]
    elif device is not None:
        dev = resolve_device(device)
    else:
        rotation = _rs.resolve(devices=devices)
        if rotation is not None and devices is None and len(rotation) < 2:
            rotation = None  # one device: nothing to rotate
        if devices is None and _rs.global_mode():
            try:
                gmesh = _gf.resolve_global_mesh()
            except Exception:
                gmesh = None
            if gmesh is not None:
                parked, rotation = rotation, None
        dev = (
            rotation[0] if rotation else gmesh.device_list()[0] if gmesh is not None
            else resolve_device(None)
        )
    # global path's off switch (the transfer stage runs on a pipeline
    # thread: a plain-list cell is the shared flag) and its one check
    gmesh_off = [gmesh is None]
    gmesh_checked = [False]

    def _combine(parts: List[Dict]) -> Dict:
        # partials stack on the first device (rotated ones move there; no
        # host round-trip between fold generations); host partials join
        stacked = TensorFrame.from_dict(
            {b: _api._stack_parts([p[b] for p in parts], dev) for b in parts[0]}
        )
        with _gf._suppress_route():
            r = _api.reduce_blocks(
                graph, stacked, None, fetch_names=fetch_list,
                executor=executor, device=dev,
            )
        record_count("reduce_blocks_stream.fold")
        return r if isinstance(r, dict) else {_base(fetch_list[0]): r}

    # Compose ONE stage graph for the whole ingest path. A plain iterator
    # of frames keeps the producer -> transfer shape; an unstarted
    # `IngestStream` contributes its discovery source and parallel-decode
    # stage, so discovery, decode, H2D transfer and compute all overlap
    # under one shared buffering budget.
    from .ingest.dataset import IngestStream
    from .ingest.pipeline import PipeStage, pipelined

    composable = isinstance(frames, IngestStream) and not frames.started

    ckpt = None
    watermark = 0
    restored: List[Dict] = []
    ds_tasks = None
    if checkpoint is not None:
        from .runtime.checkpoint import StreamCheckpointer

        ds_fp = None
        if composable:
            # the dataset fingerprint AND the resume skip both work at the
            # task-METADATA level: the task list reads only file footers
            ds_tasks = frames.dataset.task_list()
            ds_fp = frames.dataset.fingerprint(ds_tasks)
        ckpt = StreamCheckpointer(
            checkpoint, graph, [_base(f) for f in fetch_list],
            checkpoint_every, resume, ds_fp,
        )
        ckpt.entry_gate()
        watermark, restored = ckpt.try_resume()

    if composable:
        # resume skips committed chunks at the task level: they are never
        # decoded again (the decode-stage counter proves it)
        source, pipe_stages = frames.source_and_stages(
            tasks=ds_tasks, skip=watermark
        )
        pipe_depth = frames.depth
    else:
        # plain iterator — or an IngestStream someone already pulled from,
        # whose running pipeline must be consumed, not rebuilt
        source, pipe_stages, pipe_depth = frames, [], None
        if watermark:
            # no metadata level: committed chunks are pulled (the producer
            # pays their synthesis) but never transferred or dispatched
            source = iter(frames)
            for _ in range(watermark):
                try:
                    next(source)
                except StopIteration:
                    break
    stages: Dict = {}

    def stage_for(d):
        if d not in stages:
            stages[d] = _TransferStage(d)
        return stages[d]

    # chunk ordinals of the transfer stage and of the consumer: chunk i's
    # device is i mod n on both sides (a resume continues the count)
    stage_idx = [watermark]
    consume_idx = [watermark]

    def chunk_device(counter):
        i = counter[0]
        counter[0] += 1
        return rotation[i % len(rotation)] if rotation else dev

    def transfer(f):
        d = chunk_device(stage_idx)  # every chunk advances the ordinal
        if (
            not gmesh_off[0] and isinstance(f, TensorFrame)
            and f.nrows >= max(1, _cfg.get().global_frame_min_rows)
        ):
            try:
                return _gf.GlobalFrame.from_frame(f, mesh=gmesh)
            except Exception as e:
                gmesh_off[0] = True
                from .utils.log import get_logger

                get_logger("streaming").warning(
                    "global sharded transfer disabled for this stream "
                    "(%s: %s); chunks fall back to the per-block path",
                    type(e).__name__, e,
                )
        return stage_for(d)(f)

    if mesh is None:
        pipe_stages.append(PipeStage("transfer-stage", transfer))

    from .runtime.deadline import Cancelled, DeadlineExceeded

    partials: List[Dict] = list(restored)
    # double-buffered accumulator of the global path: two slots, each an
    # independent chain of eager folds
    dbuf: List[Optional[Dict]] = [None, None]
    dbuf_n = [0]
    dbuf_ok = [True]
    # `ordinal` counts source chunks FULLY consumed (committed ones
    # included): the candidate watermark. Empty chunks advance it.
    ordinal = watermark
    try:
        for item in pipelined(
            source, pipe_stages, depth=pipe_depth, ordinal_base=watermark
        ):
            f = item.stage.receive(item) if isinstance(item, _Staged) else item
            if gmesh_off[0] and parked is not None:
                # the global path stood down: rotation resumes as under
                # "auto"
                rotation, parked = parked, None
            chunk_dev = chunk_device(consume_idx) if mesh is None else dev
            nrows = len(f) if _api._is_pandas(f) else getattr(f, "nrows", None)
            if nrows == 0:
                # an empty chunk contributes the reduction identity:
                # nothing (a reduce_min partial over 0 rows would poison
                # the combine). Classification waits for rows.
                ordinal += 1
                continue
            if isinstance(f, _gf.GlobalFrame):
                if not gmesh_checked[0]:
                    # the graph is fixed for the stream's lifetime: decide
                    # once whether it runs on the shards
                    gmesh_checked[0] = True
                    if not _gf.stream_reduce_eligible(graph, fetch_list, f, feed_dict, executor):
                        gmesh_off[0] = True
                        _gf._note_fallback("unclassified-reduce")
                        from .utils.log import get_logger

                        get_logger("streaming").warning(
                            "global sharded transfer disabled for this "
                            "stream: the reduce graph has no monoid "
                            "structure to combine shard partials by; chunks "
                            "take the per-block path"
                        )
                if gmesh_off[0]:
                    # sharded before the switch flipped
                    f = f.to_frame()
            if auto_fold or (ckpt is not None and ckpt.monoids is None):
                # classify once, on the first chunk: ONE analysis serves
                # the fold class and the checkpoint eligibility gate
                comb_any = None
                try:
                    ov = _api._ph_overrides(graph, f, feed_dict, True, {})
                    s = analyze_graph(graph, fetch_list, placeholder_shapes=ov)
                    comb_any = _chunk_combiners(graph, fetch_list, s)
                    if auto_fold:
                        # require_direct: partials recombine through the
                        # same graph, so an interposed transform would be
                        # re-applied at every fold
                        comb = _chunk_combiners(
                            graph, fetch_list, s, require_direct=True
                        )
                        if comb is not None and "mean" not in comb.values():
                            fold_every = _AUTO_FOLD_EVERY
                except Exception:
                    pass  # conservative: no folding when classification fails
                auto_fold = False
                if ckpt is not None:
                    ckpt.on_first_chunk(comb_any, fold_every)
            if isinstance(f, _gf.GlobalFrame):
                where = {}
            elif mesh is not None:
                where = {"mesh": mesh}
            elif rotation:
                # the chunk reduces where its transfer put it
                where = {"devices": [chunk_dev]}
            else:
                where = {"device": dev}
            with _telemetry.span(
                "reduce_blocks_stream.chunk", kind="verb", rows=int(nrows or 0)
            ), (_gf._suppress_route() if gmesh_off[0] else _nullcontext()):
                r = _api.reduce_blocks(
                    graph, f, feed_dict, fetch_names=fetch_list,
                    executor=executor, **where,
                )
            record_count("reduce_blocks_stream.chunks")
            part = r if isinstance(r, dict) else {_base(fetch_list[0]): r}
            if (
                dbuf_ok[0] and not gmesh_off[0] and ckpt is None
                and fold_every is not None and _cfg.get().plan_pipeline
            ):
                # the global path's double buffer: fold into slot k % 2
                slot = dbuf_n[0] % 2
                dbuf_n[0] += 1
                if dbuf[slot] is None:
                    dbuf[slot] = part
                else:
                    try:
                        with _telemetry.span(
                            "reduce_blocks_stream.fold", kind="stage", slot=slot
                        ):
                            dbuf[slot] = _combine([dbuf[slot], part])
                        _gf._note_stream_fold()
                    except Exception:
                        # a fold failed (device pressure): both operands
                        # spill to the host, the tree-fold list takes over
                        dbuf_ok[0] = False
                        partials.extend(
                            _spill_partial_to_host(p, ordinal) for p in (dbuf[slot], part)
                        )
                        dbuf[slot] = None
                ordinal += 1
                continue
            partials.append(part)
            # the chunk's contribution is IN `partials`: (ordinal,
            # partials) is committable even if the fold below is cut off
            ordinal += 1
            if fold_every is not None and len(partials) >= fold_every:
                with _telemetry.span("reduce_blocks_stream.fold", kind="stage"):
                    partials = [_combine(partials)]
            elif fold_every is None and len(partials) > 1:
                # no tree-fold will drain this list: spill the PREVIOUS
                # partial to the host so an unfoldable stream costs
                # O(#chunks) host memory, not device memory; the newest
                # stays on the device, so this dispatch still overlaps
                partials[-2] = _spill_partial_to_host(
                    partials[-2], len(partials) - 2
                )
            if ckpt is not None:
                ckpt.note_chunk_folded(ordinal, partials)
        # the double buffer's slots join the final combine
        partials.extend(d for d in dbuf if d is not None)
        if not partials:
            raise ValueError(
                "reduce_blocks_stream over an empty iterator (or every "
                "chunk had zero rows)"
            )
        if len(partials) == 1:
            out = partials[0]
        else:
            with _telemetry.span("reduce_blocks_stream.fold", kind="stage"):
                out = _combine(partials)
    except (DeadlineExceeded, Cancelled) as e:
        # clean cooperative exits commit the progress so far
        if ckpt is not None:
            ckpt.on_interrupt(e, ordinal, partials)
        raise
    finally:
        for st in stages.values():
            st.close()
    if ckpt is not None:
        # completion commit: an identical re-run resumes to a no-op
        ckpt.finalize(ordinal, partials)
    if len(fetch_list) == 1:
        return _as_result(out[_base(fetch_list[0])], dev)
    return {k: _as_result(v, dev) for k, v in out.items()}


def _as_result(v, dev: torch.device) -> torch.Tensor:
    """A restored partial is host numpy; results are tensors on ``dev``."""
    return v if isinstance(v, torch.Tensor) else as_tensor(np.asarray(v), dev)
