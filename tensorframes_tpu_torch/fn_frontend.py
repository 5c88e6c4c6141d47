"""Plain-function front end: `map_blocks` over a Python function.

The PyTorch counterpart of `tensorframes_tpu/fn_frontend.py::_map_blocks_fn`.
The function's parameter names pick the columns; it is called once per
block with that block's columns as tensors on the verb's device and must
return a dict of named output tensors, whose names become column names.
Where the JAX package traces and jits the function, the port calls it
eagerly: a model's own kernels (the flash-attention kernel of
`models.TransformerLM`) launch inside the call.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List

import numpy as np
import torch

from .frame import Column, TensorFrame, as_tensor


def _fn_feed_columns(fn: Callable, frame: TensorFrame) -> List[str]:
    params = [
        p.name
        for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    ]
    missing = [p for p in params if p not in frame.info]
    if missing:
        raise ValueError(
            f"function front-end: parameters {missing} have no matching "
            f"columns (columns: {frame.columns})"
        )
    return params


def _fn_outputs_to_dict(res, what: str) -> Dict[str, torch.Tensor]:
    if not isinstance(res, dict):
        raise ValueError(
            f"{what}: a function graph must return a dict of named output "
            "arrays (output names become column names)"
        )
    if not res:
        raise ValueError(
            f"{what}: the function graph returned an empty dict; it must "
            "return at least one named output array"
        )
    return res


def _map_blocks_fn(
    fn: Callable, frame: TensorFrame, trim: bool, device: torch.device
) -> TensorFrame:
    from . import api as _api

    params = _fn_feed_columns(fn, frame)
    acc: Dict[str, List[torch.Tensor]] = {}
    out_sizes: List[int] = []
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            out_sizes.append(0)
            continue
        feeds = [as_tensor(frame.column(p).values[lo:hi], device) for p in params]
        outs = _fn_outputs_to_dict(fn(*feeds), "map_blocks")
        out_sizes.append(_api._block_rows(outs, hi - lo, trim))
        for name, o in outs.items():
            acc.setdefault(name, []).append(o)
    if not acc:
        raise ValueError(
            "map_blocks: every block is empty, so the function never ran and "
            "its output names are unknown"
        )
    out_cols = [Column(n, _api._concat(parts)) for n, parts in acc.items()]
    offsets = list(np.cumsum([0] + out_sizes)) if trim else frame.offsets
    return _api._output_frame(
        frame, out_cols, append_input=not trim, offsets=offsets
    )
