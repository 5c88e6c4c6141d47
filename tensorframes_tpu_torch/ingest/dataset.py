"""Multi-file shard discovery + parallel decode for the ingest engine.

A copy of `tensorframes_tpu/ingest/dataset.py`, row-group predicate
pushdown included: `Dataset.decode` takes the relational plan's pushed-down
column set and predicate (`graph.plan.Pred`).

A dataset is an ordered list of SHARDS (Parquet or Arrow IPC files —
a directory, a glob, an explicit list, or any mix), each shard an
ordered list of CHUNKS (groups of row groups / record batches). Shard
discovery is deterministic: user-given order is preserved, and every
directory/glob expansion is sorted lexicographically, so two runs over
the same dataset see the same chunk ordinals — which is what makes the
checkpoint watermark, fault injection and measurements reproducible.

Decode is per-chunk and self-contained: each `ChunkTask` re-opens its
shard, reads exactly its groups and closes the handle (try/finally, so
workers never leak descriptors), which is what makes the decode stage
embarrassingly parallel — `IngestStream` runs it on a small thread
pool (``config.ingest_decode_workers``) with in-order delivery through
the `pipeline` reorder buffer. pyarrow releases the GIL inside
Parquet/IPC decode, so the pool gives real core parallelism.

`stream_dataset` is the user entry point; `io.stream_parquet` /
`io.stream_arrow_ipc` route multi-path arguments here.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .pipeline import PipeStage, pipelined

__all__ = [
    "ChunkTask",
    "Dataset",
    "IngestStream",
    "discover_shards",
    "stream_dataset",
]

PathLike = Union[str, "os.PathLike[str]"]

_PARQUET_EXTS = (".parquet", ".pq")
_IPC_EXTS = (".arrow", ".feather", ".ipc", ".arrows")
_FORMATS = ("auto", "parquet", "ipc")


def _format_of(path: str, fmt: str) -> str:
    if fmt != "auto":
        return fmt
    ext = os.path.splitext(path)[1].lower()
    if ext in _PARQUET_EXTS:
        return "parquet"
    if ext in _IPC_EXTS:
        return "ipc"
    raise ValueError(
        f"cannot infer shard format from {path!r} (extension {ext!r}); "
        "pass format='parquet' or format='ipc'"
    )


def discover_shards(
    paths: Union[PathLike, Sequence[PathLike]], format: str = "auto"
) -> List[Tuple[str, str]]:
    """Resolve ``paths`` into the dataset's deterministic shard list
    ``[(path, format), ...]``.

    Each entry may be a file, a directory (every file with a known
    Parquet/IPC extension inside, non-recursive), or a glob pattern;
    a sequence mixes freely. User-given order is preserved; every
    expansion is sorted lexicographically. Unreadable/missing inputs
    and an empty result are loud errors — a dataset that silently
    resolved to zero shards would "succeed" with the reduction of
    nothing."""
    if format not in _FORMATS:
        raise ValueError(
            f"format={format!r} is not one of 'auto' | 'parquet' | 'ipc'"
        )
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    shards: List[Tuple[str, str]] = []
    for entry in paths:
        p = os.fspath(entry)
        if os.path.isdir(p):
            exts = _PARQUET_EXTS + _IPC_EXTS
            names = sorted(
                n for n in os.listdir(p)
                if os.path.splitext(n)[1].lower() in exts
            )
            if not names:
                raise ValueError(
                    f"directory {p!r} contains no Parquet/IPC shards"
                )
            shards.extend(
                (os.path.join(p, n), _format_of(n, format)) for n in names
            )
        elif _glob.has_magic(p):
            matches = sorted(_glob.glob(p))
            if not matches:
                raise ValueError(f"glob {p!r} matched no shards")
            shards.extend((m, _format_of(m, format)) for m in matches)
        else:
            if not os.path.exists(p):
                raise FileNotFoundError(f"shard {p!r} does not exist")
            shards.append((p, _format_of(p, format)))
    if not shards:
        raise ValueError("dataset resolved to zero shards")
    return shards


@dataclass(frozen=True)
class ChunkTask:
    """One decodable unit: ``groups`` row-group / record-batch indices
    of one shard file. Cheap to hold (no data), so discovery can run
    ahead of decode through a deeper task queue."""

    shard: str
    format: str
    groups: Tuple[int, ...]
    shard_index: int
    rows: int = field(default=-1)  # from metadata; -1 = unknown


def _group_stats(md, group: int, cols: Sequence[str]):
    """(min, max) per predicate column from one parquet row group's
    footer statistics, or None when any needed column lacks stats (the
    group must then be decoded — pruning is strictly conservative)."""
    try:
        rg = md.row_group(group)
        by_name = {}
        for ci in range(rg.num_columns):
            c = rg.column(ci)
            by_name[c.path_in_schema] = c
        stats = {}
        for name in cols:
            c = by_name.get(name)
            if c is None or c.statistics is None:
                return None
            st = c.statistics
            if not st.has_min_max:
                return None
            stats[name] = (st.min, st.max)
        return stats
    except Exception:
        return None


def _chunk_context(task) -> dict:
    """Stamped onto any exception escaping the decode stage (see
    `pipeline._stamp`): failures name the shard file, not just the
    chunk ordinal."""
    return {"tfs_shard_path": getattr(task, "shard", None)}


class Dataset:
    """The resolved shard list plus the chunking policy.

    ``tasks()`` enumerates `ChunkTask`s in deterministic stream order
    (shards in discovery order, groups ascending, ``chunk_groups``
    groups per task) reading only file METADATA — the discovery stage
    of the pipeline. ``decode(task)`` turns one task into a
    `TensorFrame` — the parallel-decode stage. Shards with zero row
    groups / record batches yield no tasks (an empty shard contributes
    the reduction identity: nothing)."""

    def __init__(
        self,
        paths: Union[PathLike, Sequence[PathLike]],
        format: str = "auto",
        chunk_groups: int = 1,
    ):
        if chunk_groups < 1:
            raise ValueError("chunk_groups must be >= 1")
        self.shards = discover_shards(paths, format=format)
        self.chunk_groups = int(chunk_groups)

    # -- discovery stage -----------------------------------------------
    def _shard_groups(self, path: str, fmt: str):
        """(group count, per-group row counts or None) from file
        METADATA only — discovery must never decode data (the decode
        pool would just re-read it, and a serial full read here is
        exactly the bottleneck the pipeline exists to remove). Parquet
        footers carry row counts; the IPC footer exposes only the batch
        count cheaply, so IPC tasks report ``rows=-1`` (unknown)."""
        if fmt == "parquet":
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(path)
            try:
                md = pf.metadata
                return md.num_row_groups, [
                    md.row_group(i).num_rows
                    for i in range(md.num_row_groups)
                ]
            finally:
                pf.close()
        import pyarrow as pa

        source = pa.OSFile(path, "rb")
        try:
            reader = pa.ipc.open_file(source)
            return reader.num_record_batches, None
        finally:
            source.close()

    def tasks(self) -> Iterator[ChunkTask]:
        path = None
        try:
            for si, (path, fmt) in enumerate(self.shards):
                n_groups, group_rows = self._shard_groups(path, fmt)
                for start in range(0, n_groups, self.chunk_groups):
                    idx = tuple(
                        range(start, min(start + self.chunk_groups, n_groups))
                    )
                    yield ChunkTask(
                        shard=path,
                        format=fmt,
                        groups=idx,
                        shard_index=si,
                        rows=(
                            sum(group_rows[i] for i in idx)
                            if group_rows is not None else -1
                        ),
                    )
        except GeneratorExit:
            raise
        except Exception as e:
            # discovery failures name the shard (the producer stage has
            # no per-stage context hook — it stamps chunk index only)
            if path is not None and getattr(e, "tfs_shard_path", None) is None:
                try:
                    e.tfs_shard_path = path
                except Exception:
                    pass  # __slots__ errors refuse stamps; e still raises
            raise

    def task_list(self) -> List[ChunkTask]:
        """`tasks()` materialized — still METADATA-only (file footers,
        never chunk data). The checkpoint layer uses the list twice:
        once for the dataset fingerprint, once to skip committed
        chunks on resume without re-decoding them."""
        return list(self.tasks())

    def fingerprint(self, tasks: Optional[List[ChunkTask]] = None) -> str:
        """Deterministic digest of the dataset's METADATA identity:
        shard paths + formats + on-disk sizes, the chunking policy,
        and every task's (shard, groups, row-count) tuple. This is
        what the durable-stream manifest records — a resumed stream
        whose dataset gained/lost/resized a shard (or whose row
        groups moved) refuses loudly instead of folding drifted
        chunks onto committed partials. Same-size same-row-count
        content rewrites are beyond a metadata fingerprint; keep
        checkpoints next to immutable datasets."""
        if tasks is None:
            tasks = self.task_list()
        shards = []
        for path, fmt in self.shards:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            shards.append([os.path.abspath(path), fmt, size])
        blob = json.dumps(
            {
                "chunk_groups": self.chunk_groups,
                "shards": shards,
                "tasks": [
                    [t.shard, t.format, list(t.groups), t.rows]
                    for t in tasks
                ],
            },
            sort_keys=True,
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- decode stage --------------------------------------------------
    def decode(self, task: ChunkTask, columns=None, predicate=None):
        """One chunk -> one `TensorFrame`; opens and CLOSES the shard
        (try/finally) so a pool of decode workers never accumulates
        handles, and an abandoned stream leaks nothing.

        ``columns`` / ``predicate`` are the plan optimizer's pushdown
        surface (`graph.optimizer`): the column set narrows the read to
        the selected + predicate columns, and the predicate prunes whole
        parquet row groups from footer (min, max) stats BEFORE decode —
        skipped rows count into ``plan_pushdown_rows_skipped`` — then
        masks the survivors at the arrow boundary, so fewer rows are
        decoded, not more rows masked. Unknown requested columns are
        dropped here (the plan's select/map stages raise the precise
        schema error); every decoded row counts into
        ``ingest_rows_decoded``."""
        from ..frame import TensorFrame
        from ..utils import telemetry as _tele

        pred_cols = sorted(predicate.columns()) if predicate is not None else []
        if task.format == "parquet":
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(task.shard)
            try:
                md = pf.metadata
                groups = list(task.groups)
                if predicate is not None:
                    kept, skipped_rows = [], 0
                    for g in groups:
                        stats = _group_stats(md, g, pred_cols)
                        if stats is not None and not predicate.may_match(stats):
                            skipped_rows += md.row_group(g).num_rows
                        else:
                            kept.append(g)
                    if skipped_rows:
                        from ..graph import plan as _plan

                        _plan.note_pushdown_rows(skipped_rows)
                    groups = kept
                schema_names = pf.schema_arrow.names
                read_cols = None
                if columns is not None:
                    read_cols = [
                        c
                        for c in dict.fromkeys(list(columns) + pred_cols)
                        if c in schema_names
                    ]
                if not groups:
                    table = pf.schema_arrow.empty_table()
                    if read_cols is not None:
                        table = table.select(read_cols)
                else:
                    table = pf.read_row_groups(groups, columns=read_cols)
            finally:
                pf.close()
        else:
            import pyarrow as pa

            source = pa.OSFile(task.shard, "rb")
            try:
                reader = pa.ipc.open_file(source)
                batches = [reader.get_batch(i) for i in task.groups]
                table = pa.Table.from_batches(batches, schema=reader.schema)
            finally:
                source.close()
            if columns is not None:
                table = table.select([
                    c
                    for c in dict.fromkeys(list(columns) + pred_cols)
                    if c in table.column_names
                ])
        if predicate is not None and table.num_rows:
            import pyarrow as pa

            mask = predicate.mask(
                lambda n: table.column(n).to_numpy(zero_copy_only=False)
            )
            table = table.filter(pa.array(np.asarray(mask, dtype=bool)))
        if columns is not None:
            table = table.select([c for c in columns if c in table.column_names])
        _tele.counter_inc("ingest_rows_decoded", float(table.num_rows))
        return TensorFrame.from_arrow(table)


def _auto_decode_workers() -> int:
    from .. import config as _config

    w = int(getattr(_config.get(), "ingest_decode_workers", 0) or 0)
    if w > 0:
        return w
    return max(1, min(4, os.cpu_count() or 1))


class IngestStream:
    """A ONE-SHOT iterator of frames backed by the stage-graph
    pipeline: discovery (producer) -> parallel decode (pool). What
    `stream_dataset` returns.

    Iterator semantics match the single-file `io.stream_*` generators
    exactly — ``next()`` works, ``close()`` releases the pipeline (and
    every open shard handle) deterministically, exhaustion is final —
    so the multi-path and single-path readers are interchangeable.
    `reduce_blocks_stream` recognizes an UNSTARTED instance and
    COMPOSES its H2D transfer stage into the same graph
    (`source_and_stages`), so discovery, decode, transfer, compute and
    combine all overlap under one shared buffering budget instead of
    two chained pipelines; a partially-consumed instance degrades to a
    plain chunk iterator."""

    def __init__(
        self,
        dataset: Dataset,
        decode_workers: Optional[int] = None,
        depth: Optional[int] = None,
    ):
        self.dataset = dataset
        self.decode_workers = (
            _auto_decode_workers() if decode_workers is None
            else max(1, int(decode_workers))
        )
        self.depth = depth
        self._active = None  # the running pipeline generator, once started

    def source_and_stages(self, tasks=None, skip: int = 0):
        """(source iterator, [decode stage]) — the pipeline prefix a
        consumer composes further stages onto. ``tasks`` reuses an
        already-materialized `task_list()`; ``skip`` drops the first N
        tasks at the METADATA level (the durable-stream resume path:
        committed chunks are never re-decoded)."""
        decode = PipeStage(
            "decode",
            self.dataset.decode,
            workers=self.decode_workers,
            context=_chunk_context,
            cheap_input=True,  # tasks are descriptors, not chunks
        )
        if skip:
            if tasks is None:
                tasks = self.dataset.task_list()
            source = iter(tasks[int(skip):])
        elif tasks is not None:
            source = iter(tasks)
        else:
            source = self.dataset.tasks()
        return source, [decode]

    @property
    def started(self) -> bool:
        return self._active is not None

    def _pipeline(self):
        if self._active is None:
            source, stages = self.source_and_stages()
            self._active = pipelined(source, stages, depth=self.depth)
        return self._active

    def __iter__(self):
        return self._pipeline()

    def __next__(self):
        return next(self._pipeline())

    def close(self) -> None:
        """Cancel the pipeline and release every buffered chunk and
        open shard handle (a no-op if never started)."""
        if self._active is not None:
            self._active.close()


def stream_dataset(
    paths: Union[PathLike, Sequence[PathLike]],
    format: str = "auto",
    chunk_groups: int = 1,
    decode_workers: Optional[int] = None,
    depth: Optional[int] = None,
) -> IngestStream:
    """Stream a multi-file dataset as frames through the pipelined
    ingest engine: deterministic shard discovery -> parallel decode
    (``decode_workers`` threads, default ``config.
    ingest_decode_workers`` or min(4, cores)) -> in-order delivery,
    all bounded by the shared buffering budget (``depth`` /
    ``config.stream_prefetch_depth``).

    ``paths`` may be a file, directory, glob, or a sequence mixing
    them; ``format`` pins 'parquet' / 'ipc' when extensions cannot
    (``auto``). ``chunk_groups`` row groups / record batches form one
    streamed frame. Feed the result to `reduce_blocks_stream` — the
    H2D transfer stage composes into the same stage graph — or iterate
    it directly."""
    return IngestStream(
        Dataset(paths, format=format, chunk_groups=chunk_groups),
        decode_workers=decode_workers,
        depth=depth,
    )
