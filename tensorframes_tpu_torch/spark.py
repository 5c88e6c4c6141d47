"""Spark adapter: Spark DataFrame in, result out, one call.

The PyTorch counterpart of `tensorframes_tpu/spark.py`. The reference's
entire user surface was Spark DataFrames — implicit `df.mapBlocks(...)`
enrichment (`dsl/Implicits.scala:25-116`) and a Py4J builder the Python
API drove (`impl/PythonInterface.scala:26-84`). Here Spark is an INGEST
substrate: executors dump their partitions as Arrow IPC files on shared
storage via `mapInArrow`, and this host reads those files and runs the
port's verbs on the card (``device=``, default ``cuda``; ``mesh=``
shards the rows over a mesh, as on the verbs):

    import tensorframes_tpu_torch.spark as tfspark
    total = tfspark.reduce_blocks(graph, spark_df, ingest_dir="/mnt/x")
    scored = tfspark.map_blocks(graph, spark_df, fetch_names=["probs"])
    per_key = tfspark.aggregate(graph, spark_df, keys=["k"])

Only `ingest` touches the pyspark API (one `mapInArrow` + `collect` of
file paths, nothing else), and pyarrow is imported inside the functions
that use it, so this module imports without pyspark or pyarrow.

"""

from __future__ import annotations

import os
import shutil
import tempfile
import uuid
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from . import api as _api
from . import io as _io
from .frame import TensorFrame

__all__ = [
    "IngestResult",
    "ingest",
    "map_blocks",
    "map_rows",
    "reduce_blocks",
    "reduce_rows",
    "aggregate",
]


class IngestResult(NamedTuple):
    """One ingest call's partition files plus the per-call directory
    that owns them (removed wholesale after the verb unless
    ``keep_ingest=True``)."""

    paths: List[str]
    directory: str


def _partition_dumper(ingest_dir: str):
    """The function shipped to Spark executors via ``mapInArrow``: write
    this partition's record batches as ONE Arrow IPC file in
    ``ingest_dir`` (shared storage), yield its path back to the driver.
    Pure pyarrow — independently testable without pyspark."""

    def dump(batch_iter):
        import pyarrow as pa

        batches = list(batch_iter)
        if not batches:
            return
        path = os.path.join(ingest_dir, f"part-{uuid.uuid4().hex}.arrow")
        with pa.OSFile(path, "wb") as sink:
            with pa.ipc.new_file(sink, batches[0].schema) as writer:
                for b in batches:
                    writer.write_batch(b)
        yield pa.RecordBatch.from_pydict({"path": [path]})

    return dump


def ingest(spark_df, ingest_dir: Optional[str] = None) -> IngestResult:
    """Dump every partition of ``spark_df`` to Arrow IPC files inside a
    fresh PER-CALL subdirectory of ``ingest_dir`` (or of the system temp
    dir). ``ingest_dir`` must be storage both the executors and this host
    can reach (the temp-dir default is correct only in `local[*]` mode,
    where executors share the driver's filesystem).

    The per-call subdirectory is the cleanup unit: a failed ingest removes
    it — including partitions that finished dumping before another
    executor died — and the verbs remove it after the result is
    computed."""
    if ingest_dir is not None:
        os.makedirs(ingest_dir, exist_ok=True)
    call_dir = tempfile.mkdtemp(prefix="tfs-spark-ingest-", dir=ingest_dir)
    try:
        rows = spark_df.mapInArrow(
            _partition_dumper(call_dir), "path string"
        ).collect()
    except Exception:
        shutil.rmtree(call_dir, ignore_errors=True)
        raise
    return IngestResult([r.path for r in rows], call_dir)


def _stream_paths(paths: Sequence[str]) -> Iterator[TensorFrame]:
    # one frame per FILE = one block per Spark partition (the reference's
    # partition==block model). Arrow batches inside a file are only the
    # executor's write granularity
    # (spark.sql.execution.arrow.maxRecordsPerBatch), never a block
    # boundary.
    for p in paths:
        yield _io.read_arrow_ipc(p, num_blocks=1)


def _cleanup(result: IngestResult, keep: bool) -> None:
    if not keep:
        shutil.rmtree(result.directory, ignore_errors=True)


def reduce_blocks(
    fetches,
    spark_df,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    ingest_dir: Optional[str] = None,
    keep_ingest: bool = False,
    mesh=None,
    **kw,
):
    """`reduce_blocks` over a Spark DataFrame: partitions stream from the
    ingest dir and fold on the card in bounded host memory
    (`reduce_blocks_stream`), replacing the reference's driver-funneled
    `RDD.reduce` (`DebugRowOps.scala:530-533`)."""
    ing = ingest(spark_df, ingest_dir)
    try:
        return _api.reduce_blocks_stream(
            fetches, _stream_paths(ing.paths), feed_dict,
            fetch_names=fetch_names, mesh=mesh, **kw,
        )
    finally:
        _cleanup(ing, keep_ingest)


def _collected_frame(paths: Sequence[str]) -> TensorFrame:
    frames = list(_stream_paths(paths))
    if not frames:
        raise ValueError("spark ingest produced no rows")
    if len(frames) == 1:
        return frames[0]
    cols = {}
    for name in frames[0].columns:
        parts = [f.column(name) for f in frames]
        if all(c.is_dense for c in parts) and (
            len({c.values.shape[1:] for c in parts}) == 1
        ):
            cols[name] = np.concatenate([np.asarray(c.values) for c in parts])
        elif not any(c.cell_shape.rank for c in parts):
            # scalar string/object columns (group keys from Spark arrive
            # as Arrow strings): one assembled host vector
            cols[name] = np.concatenate(
                [np.asarray(c.host_values()) for c in parts]
            )
        else:
            # ragged rows (variable-length Arrow lists, or cell shapes
            # differing across partitions): keep per-row cells — the
            # verbs' ragged paths handle them like the reference's
            # variable-length map_rows (`TFDataOps.scala:90-103`)
            cols[name] = [np.asarray(r) for c in parts for r in c.rows()]
    out = TensorFrame.from_dict(cols)
    # one block per ingested file — the Spark partition boundaries
    offsets = [0]
    for f in frames:
        offsets.append(offsets[-1] + f.nrows)
    return TensorFrame([out.column(n) for n in out.columns], offsets)


def map_blocks(
    fetches,
    spark_df,
    feed_dict: Optional[Dict[str, str]] = None,
    trim: bool = False,
    fetch_names: Optional[Sequence[str]] = None,
    ingest_dir: Optional[str] = None,
    keep_ingest: bool = False,
    mesh=None,
    **kw,
) -> TensorFrame:
    """`map_blocks` over a Spark DataFrame; each ingested partition is one
    block (the reference's partition==block model,
    `DebugRowOps.scala:384-398`). Returns the scored TensorFrame, its
    outputs on the verb's device."""
    ing = ingest(spark_df, ingest_dir)
    try:
        return _api.map_blocks(
            fetches, _collected_frame(ing.paths), feed_dict, trim=trim,
            fetch_names=fetch_names, mesh=mesh, **kw,
        )
    finally:
        _cleanup(ing, keep_ingest)


def map_rows(
    fetches,
    spark_df,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    ingest_dir: Optional[str] = None,
    keep_ingest: bool = False,
    **kw,
) -> TensorFrame:
    """`map_rows` over a Spark DataFrame."""
    ing = ingest(spark_df, ingest_dir)
    try:
        return _api.map_rows(
            fetches, _collected_frame(ing.paths), feed_dict,
            fetch_names=fetch_names, **kw,
        )
    finally:
        _cleanup(ing, keep_ingest)


def reduce_rows(
    fetches,
    spark_df,
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    ingest_dir: Optional[str] = None,
    keep_ingest: bool = False,
    mesh=None,
    **kw,
):
    """`reduce_rows` over a Spark DataFrame."""
    ing = ingest(spark_df, ingest_dir)
    try:
        return _api.reduce_rows(
            fetches, _collected_frame(ing.paths), feed_dict,
            fetch_names=fetch_names, mesh=mesh, **kw,
        )
    finally:
        _cleanup(ing, keep_ingest)


def aggregate(
    fetches,
    spark_df,
    keys: Sequence[str],
    feed_dict: Optional[Dict[str, str]] = None,
    fetch_names: Optional[Sequence[str]] = None,
    ingest_dir: Optional[str] = None,
    keep_ingest: bool = False,
    mesh=None,
    **kw,
) -> TensorFrame:
    """`aggregate` over a Spark DataFrame grouped by ``keys`` — the
    `df.groupBy(k).agg(tf_output)` surface (`Implicits.scala:105-116`,
    `DebugRowOps.scala:554-599`) without the UDAF buffering machinery:
    the keyed segment plans run on the card after ingest."""
    if not keys:
        raise ValueError("aggregate needs at least one key column")
    ing = ingest(spark_df, ingest_dir)
    try:
        frame = _collected_frame(ing.paths)
        return _api.aggregate(
            fetches, _api.group_by(frame, *keys), feed_dict,
            fetch_names=fetch_names, mesh=mesh, **kw,
        )
    finally:
        _cleanup(ing, keep_ingest)
