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
)
from .frame import Column, TensorFrame  # noqa: E402
from .graph import Graph  # noqa: E402
from .graph import builder as dsl  # noqa: E402
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
from .schema import ColumnInfo, FrameInfo, ScalarType, Shape, Unknown  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Cancelled",
    "CheckpointError",
    "Column",
    "ColumnInfo",
    "DeadlineExceeded",
    "Executor",
    "FrameInfo",
    "GroupedFrame",
    "Graph",
    "InceptionLite",
    "OverloadError",
    "ScalarType",
    "Shape",
    "TensorFrame",
    "Unknown",
    "aggregate",
    "analyze",
    "append_shape",
    "block",
    "block_to_row",
    "config",
    "deadline_scope",
    "dsl",
    "explain",
    "explain_detailed",
    "group_by",
    "ingest",
    "io",
    "map_blocks",
    "map_rows",
    "print_schema",
    "reduce_blocks",
    "reduce_blocks_stream",
    "reduce_rows",
    "row",
    "stream_dataset",
]
