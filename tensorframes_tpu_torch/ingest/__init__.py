"""Pipelined out-of-core ingest engine.

The PyTorch counterpart of `tensorframes_tpu/ingest/`:

- `pipeline` — the generic stage-graph runtime: N concurrently
  executing stages over bounded queues, out-of-order parallel workers
  with in-order delivery, per-stage telemetry, classified fault
  retries, deterministic cancellation.
- `dataset` — multi-file shard discovery (directory / glob / explicit
  list of Parquet or Arrow IPC files, deterministic shard order) and
  the parallel-decode stage that turns row groups / record batches
  into host frames.

`streaming.reduce_blocks_stream` and the multi-path `io.stream_*` readers
run on top; `stream_dataset` is the user-facing entry point.
"""

from .pipeline import (  # noqa: F401
    PipeStage,
    pipelined,
    set_stage_fault_injector,
)
from .dataset import (  # noqa: F401
    ChunkTask,
    Dataset,
    IngestStream,
    discover_shards,
    stream_dataset,
)

__all__ = [
    "ChunkTask",
    "Dataset",
    "IngestStream",
    "PipeStage",
    "discover_shards",
    "pipelined",
    "set_stage_fault_injector",
    "stream_dataset",
]
