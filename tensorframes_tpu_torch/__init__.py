"""tensorframes_tpu_torch: the PyTorch / CUDA port of tensorframes_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module names and its user surface: a graph (builder DSL,
GraphDef bytes, or a plain function) is matched to the columns of a
block-partitioned `TensorFrame` and run per block by the five verbs
``map_blocks``, ``map_rows``, ``reduce_blocks``, ``reduce_rows`` and
``aggregate`` (over ``group_by``). Every verb and model runs on the CUDA
card unless the caller passes ``device="cpu"``.

The port imports torch and numpy, never jax nor the JAX package. It keeps
its own copies of the framework-free modules it needs (schema, proto,
graph IR and builder, control-flow functionalization, variable freezing,
the Inception scoring graph). Imported GraphDefs are functionalized and
frozen as the JAX package does, so TF control flow and variables run.
Columns may be dense, ragged or strings; ragged and string cells stay on
the host. pandas and pyarrow (for `TensorFrame.from_pandas`/`from_arrow`
and `io`) are imported only where they are used, so the package loads
without them.

`reduce_blocks_stream` folds an iterator of frames (or a multi-file
`stream_dataset`) chunk by chunk, with host I/O, the host-to-card copy and
the reduce overlapped; `map_blocks`, `map_rows`, `reduce_blocks` and the
stream take ``timeout_s=`` (`deadline_scope` for a whole chain), and a
stream may be made durable with ``checkpoint=``. `config` holds the knobs.

Lazy plans: ``df.lazy()`` or ``with tft.lazy():`` defers graph
``map_blocks`` calls into one fused callable per block (`LazyFrame`), and
``tft.scan(dir).filter(tft.col("x") > c)...group_by(...).agg(...)`` builds a
relational plan (`RelationalFrame`) that the cost-based optimizer rewrites
(predicate pushdown into Parquet row groups, column pruning, map fusion)
before it runs. `tensorframes_tpu_torch.spark` runs the verbs over a Spark
DataFrame through one Arrow IPC file per partition; it imports without
pyspark and pyarrow.

Models (`models`) score and train: `MLP` and `TransformerLM` take SGD
steps (`train_step`) or any `torch.optim` optimizer (`make_train_step`),
`MoEFFN` is the expert FFN, and `utils.checkpoint` saves frames and
parameters in the JAX package's npz layouts. The verbs run under
`torch.no_grad()`, so their outputs can feed training.

Serving (`serving`): ``tft.serving.register(name, fetches, schema,
device=...)`` makes a program an endpoint, ``tft.serving.serve(port=0)``
mounts it on the process HTTP server (which also serves /metrics, /healthz
and /trace), and ``ServingClient(url).run(...)`` calls it over Arrow IPC;
concurrent requests to a row-local endpoint coalesce into one dispatch.
The flight recorder (`runtime.blackbox`, ``tft.incidents()``) keeps a
bundle per typed fault. Setting ``TFS_TELEMETRY_PORT`` starts the HTTP
server at import.

Runtime services: the cost ledger (`runtime.costmodel`) counts every cached
program's flops and bytes on the meta device at its first dispatch and its
executions at every dispatch; ``tft.diagnostics()`` joins it with the
dispatch spans (CUDA event time on the card) into achieved-vs-peak rates
per program, with memory, OOM forensics and the fault ledger;
``tft.explain_analyze(lazy_frame)`` runs a plan and reports the same per
stage. The verbs retry transient errors and split blocks that ran out of
memory (`runtime.faults`). ``tft.profile.snapshot()`` captures a
`WorkloadProfile` (save / load / merge / diff, in the JAX package's
schema), and ``tft.autotune()`` recommends and applies knob changes from
one; ``config.autotune`` runs that loop in the background.

Meshes: every verb takes ``mesh=`` (`parallel.data_mesh()` holds every
visible card, ``data_mesh(devices=["cpu"] * 8)`` runs the shards on the
CPU); the rows shard across the mesh's devices (`parallel.verbs`).

Float32 matrix products run in full float32: TF32 is turned off here for
cuBLAS and cuDNN, because the parity bars against the JAX package assume
it.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import config  # noqa: E402
from . import ingest  # noqa: E402
from . import io  # noqa: E402
from . import serving  # noqa: E402
from .api import (  # noqa: E402
    GroupedFrame,
    aggregate,
    analyze,
    append_shape,
    block,
    block_to_row,
    explain,
    explain_detailed,
    group_by,
    map_blocks,
    map_rows,
    print_schema,
    reduce_blocks,
    reduce_blocks_stream,
    reduce_rows,
    row,
    scan,
)
from .frame import Column, TensorFrame  # noqa: E402
from .graph import Graph, ShapeHints  # noqa: E402
from .graph import builder as dsl  # noqa: E402
from .graph.plan import col  # noqa: E402
from .globalframe import GlobalFrame  # noqa: E402
from .lazy import LazyFrame, RelationalFrame, explain_analyze, lazy  # noqa: E402
from .models import InceptionLite  # noqa: E402
from .io import stream_dataset  # noqa: E402
from .runtime import Executor  # noqa: E402
from .runtime.checkpoint import CheckpointError  # noqa: E402
from .runtime.deadline import (  # noqa: E402
    Cancelled,
    DeadlineExceeded,
    OverloadError,
    deadline_scope,
)
from .runtime.blackbox import incidents  # noqa: E402
from .runtime import profiler as profile  # noqa: E402
from .runtime import autotune as _autotune_mod  # noqa: E402
from .runtime.autotune import autotune  # noqa: E402
from .schema import ColumnInfo, FrameInfo, ScalarType, Shape, Unknown  # noqa: E402
from .utils import telemetry  # noqa: E402
from .utils.telemetry import diagnostics  # noqa: E402

# the telemetry HTTP endpoint starts here only when config.telemetry_port
# (TFS_TELEMETRY_PORT) is set
telemetry.maybe_serve()
# the background autotuner starts here only when config.autotune
# (TFS_AUTOTUNE) is on
_autotune_mod.maybe_start()

__version__ = "0.1.0"

__all__ = [
    "Cancelled",
    "CheckpointError",
    "Column",
    "ColumnInfo",
    "DeadlineExceeded",
    "Executor",
    "FrameInfo",
    "GlobalFrame",
    "GroupedFrame",
    "Graph",
    "InceptionLite",
    "LazyFrame",
    "OverloadError",
    "RelationalFrame",
    "ScalarType",
    "Shape",
    "ShapeHints",
    "TensorFrame",
    "Unknown",
    "aggregate",
    "analyze",
    "append_shape",
    "autotune",
    "block",
    "block_to_row",
    "col",
    "config",
    "deadline_scope",
    "diagnostics",
    "dsl",
    "explain",
    "explain_analyze",
    "explain_detailed",
    "group_by",
    "incidents",
    "ingest",
    "io",
    "lazy",
    "map_blocks",
    "map_rows",
    "print_schema",
    "profile",
    "reduce_blocks",
    "reduce_blocks_stream",
    "reduce_rows",
    "row",
    "scan",
    "serving",
    "stream_dataset",
    "telemetry",
]
