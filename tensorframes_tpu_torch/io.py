"""Arrow IPC and Parquet files in and out.

The PyTorch counterpart of `tensorframes_tpu/io.py`. A block is one Arrow
record batch or one Parquet row group, so the block structure survives a
round trip (empty blocks too, in Arrow IPC; Parquet has no empty row
groups). Decoding stays on the host: a frame read here holds host columns,
and moving it to the card is the caller's step (`TensorFrame.to_device`,
or the transfer stage of `reduce_blocks_stream`). pyarrow is imported
inside each function.

A list of paths, a directory or a glob given to `stream_arrow_ipc` /
`stream_parquet` is a multi-file dataset: it streams through the pipelined
ingest engine (`stream_dataset`, `ingest.dataset`). The whole-file readers
and the writers take one file.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Iterator, List, Optional

from .frame import TensorFrame

__all__ = [
    "write_arrow_ipc",
    "read_arrow_ipc",
    "stream_arrow_ipc",
    "frame_to_ipc_bytes",
    "frame_from_ipc_bytes",
    "write_parquet",
    "read_parquet",
    "stream_parquet",
    "stream_dataset",
]

def _is_multi_path(path) -> bool:
    """A list/tuple, a directory, or a glob pattern routes to the
    multi-file dataset pipeline; a single file keeps the lightweight
    one-handle reader."""
    if not isinstance(path, (str, os.PathLike)):
        return True
    p = os.fspath(path)
    return os.path.isdir(p) or _glob.has_magic(p)


def _single_path(path) -> str:
    """``path`` as one file name for the whole-file readers and the
    writers; a list, a directory or a glob raises."""
    if _is_multi_path(path):
        raise ValueError(
            f"{path!r} is a multi-file dataset (a list of paths, a directory "
            "or a glob): stream it with stream_arrow_ipc / stream_parquet / "
            "stream_dataset; this function takes one file"
        )
    return os.fspath(path)


def _record_batches(frame: TensorFrame):
    """One record batch per block of the frame's Arrow table, zero-row
    batches for empty blocks."""
    import pyarrow as pa

    table = frame.to_arrow()
    for lo, hi in zip(frame.offsets, frame.offsets[1:]):
        yield pa.RecordBatch.from_struct_array(
            table.slice(lo, hi - lo).to_struct_array().combine_chunks()
        )


def _frame_with_offsets(table, row_counts: List[int], num_blocks: Optional[int]) -> TensorFrame:
    """``num_blocks`` repartitions; otherwise the file's own chunks (record
    batches or row groups) become the blocks when they hold every row."""
    if num_blocks is not None:
        return TensorFrame.from_arrow(table, num_blocks=num_blocks)
    frame = TensorFrame.from_arrow(table)
    offsets = [0]
    for n in row_counts:
        offsets.append(offsets[-1] + n)
    if offsets[-1] == frame.nrows and len(offsets) > 2:
        frame.offsets = offsets
    return frame


def write_arrow_ipc(frame: TensorFrame, path) -> None:
    """Write a frame to an Arrow IPC (Feather v2) file, one record batch
    per block."""
    import pyarrow as pa

    schema = frame.to_arrow().schema
    with pa.OSFile(_single_path(path), "wb") as sink:
        with pa.ipc.new_file(sink, schema) as writer:
            for batch in _record_batches(frame):
                writer.write_batch(batch)


def read_arrow_ipc(path, num_blocks: Optional[int] = None) -> TensorFrame:
    """Read a whole Arrow IPC file into one host frame (record batches
    become blocks unless ``num_blocks`` repartitions)."""
    import pyarrow as pa

    with pa.OSFile(_single_path(path), "rb") as source:
        reader = pa.ipc.open_file(source)
        batches = [reader.get_batch(i) for i in range(reader.num_record_batches)]
        table = pa.Table.from_batches(batches, schema=reader.schema)
    return _frame_with_offsets(table, [b.num_rows for b in batches], num_blocks)


def stream_arrow_ipc(path, batches_per_frame: int = 1) -> Iterator[TensorFrame]:
    """Yield one host frame per ``batches_per_frame`` record batches, so
    host memory stays bounded whatever the file's size. The file closes
    when the stream ends, fails or is closed.

    A directory, a glob or a sequence of paths is a multi-file dataset,
    routed through the pipelined ingest engine (`stream_dataset`)."""
    if _is_multi_path(path):
        return stream_dataset(path, format="ipc", chunk_groups=batches_per_frame)
    path = os.fspath(path)
    if batches_per_frame < 1:
        raise ValueError("batches_per_frame must be >= 1")
    return _stream_arrow_ipc(path, batches_per_frame)


def _stream_arrow_ipc(path: str, batches_per_frame: int) -> Iterator[TensorFrame]:
    import pyarrow as pa

    source = pa.OSFile(path, "rb")
    try:
        reader = pa.ipc.open_file(source)
        n = reader.num_record_batches
        for start in range(0, n, batches_per_frame):
            group = [reader.get_batch(i) for i in range(start, min(start + batches_per_frame, n))]
            yield TensorFrame.from_arrow(pa.Table.from_batches(group))
    finally:
        source.close()


def frame_to_ipc_bytes(frame: TensorFrame) -> bytes:
    """A frame as Arrow IPC stream bytes, one record batch per block."""
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, frame.to_arrow().schema) as writer:
        for batch in _record_batches(frame):
            writer.write_batch(batch)
    return sink.getvalue().to_pybytes()


def frame_from_ipc_bytes(data: bytes) -> TensorFrame:
    """The frame of `frame_to_ipc_bytes` output (record batches become
    blocks when they hold every row). Empty input raises."""
    import pyarrow as pa

    if not data:
        raise ValueError(
            "frame_from_ipc_bytes: empty byte string (expected an Arrow IPC stream)"
        )
    with pa.ipc.open_stream(pa.BufferReader(data)) as reader:
        batches = list(reader)
        schema = reader.schema
    table = pa.Table.from_batches(batches, schema=schema)
    return _frame_with_offsets(table, [b.num_rows for b in batches], None)


def write_parquet(frame: TensorFrame, path) -> None:
    """Write a frame as Parquet, one row group per non-empty block (Parquet
    has no empty row groups). Each group is pinned to its block's row
    count, which pyarrow would otherwise split at its default group
    size."""
    import pyarrow.parquet as pq

    table = frame.to_arrow()
    writer = pq.ParquetWriter(_single_path(path), table.schema)
    try:
        for lo, hi in zip(frame.offsets, frame.offsets[1:]):
            if hi > lo:
                writer.write_table(table.slice(lo, hi - lo), row_group_size=hi - lo)
    finally:
        writer.close()


def read_parquet(path, num_blocks: Optional[int] = None) -> TensorFrame:
    """Read a whole Parquet file into one host frame (row groups become
    blocks unless ``num_blocks`` repartitions)."""
    import pyarrow.parquet as pq

    with pq.ParquetFile(_single_path(path)) as pf:
        table = pf.read()
        meta = pf.metadata
        group_rows = [meta.row_group(i).num_rows for i in range(meta.num_row_groups)]
    return _frame_with_offsets(table, group_rows, num_blocks)


def stream_parquet(path, row_groups_per_frame: int = 1) -> Iterator[TensorFrame]:
    """Yield one host frame per ``row_groups_per_frame`` row groups, the
    Parquet twin of `stream_arrow_ipc` (multi-file datasets included)."""
    if _is_multi_path(path):
        return stream_dataset(
            path, format="parquet", chunk_groups=row_groups_per_frame
        )
    path = os.fspath(path)
    if row_groups_per_frame < 1:
        raise ValueError("row_groups_per_frame must be >= 1")
    return _stream_parquet(path, row_groups_per_frame)


def _stream_parquet(path: str, row_groups_per_frame: int) -> Iterator[TensorFrame]:
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    try:
        n = pf.num_row_groups
        for start in range(0, n, row_groups_per_frame):
            idx = list(range(start, min(start + row_groups_per_frame, n)))
            yield TensorFrame.from_arrow(pf.read_row_groups(idx))
    finally:
        pf.close()


def stream_dataset(paths, format: str = "auto", chunk_groups: int = 1,
                   decode_workers: Optional[int] = None,
                   depth: Optional[int] = None):
    """Stream a MULTI-FILE dataset (directory / glob / explicit list of
    Parquet or Arrow IPC shards) as host frames through the pipelined
    ingest engine: deterministic shard discovery -> parallel decode
    (``decode_workers`` threads) -> in-order delivery under the shared
    buffering budget. Feed to `reduce_blocks_stream`, which composes its
    H2D transfer stage into the same stage graph. See
    `ingest.dataset.stream_dataset`."""
    from .ingest.dataset import stream_dataset as _sd

    return _sd(
        paths, format=format, chunk_groups=chunk_groups,
        decode_workers=decode_workers, depth=depth,
    )
