"""Plain-function front end: `map_blocks` and `map_rows` over a Python
function.

The PyTorch counterpart of `tensorframes_tpu/fn_frontend.py`
(`_map_blocks_fn`, and `_map_rows_fn` for dense columns). The function's
parameter names pick the columns, or a binding of the same name; it must
return a dict of named output tensors, whose names become column names.
`map_blocks` calls it once per block with that block's columns as tensors
on the verb's device; `map_rows` calls it once per block under
`torch.func.vmap`, so it sees one row's cells (bound parameters stay whole,
``in_dims=None``). Where the JAX package traces and jits the function, the
port calls it eagerly: a model's own kernels (the flash-attention kernel
of `models.TransformerLM`) launch inside the call.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .frame import Column, TensorFrame


def _fn_feed_columns(
    fn: Callable, frame: TensorFrame, bindings: Dict
) -> List[str]:
    params = [
        p.name
        for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    ]
    missing = [p for p in params if p not in frame.info and p not in bindings]
    if missing:
        raise ValueError(
            f"function front-end: parameters {missing} have no matching "
            f"columns (columns: {frame.columns})"
        )
    unknown = sorted(set(bindings) - set(params))
    if unknown:
        raise ValueError(
            f"bindings {unknown} do not match any function parameter "
            f"(parameters: {params})"
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


def _identity(params: List[str]) -> Dict[str, str]:
    """Parameter -> column: a parameter reads the column of its name."""
    return {p: p for p in params}


def _never_ran(what: str) -> ValueError:
    return ValueError(
        f"{what}: every block is empty, so the function never ran and its "
        "output names are unknown"
    )


def _map_blocks_fn(
    fn: Callable,
    frame: TensorFrame,
    trim: bool,
    device: torch.device,
    bindings: Optional[Dict] = None,
) -> TensorFrame:
    from . import api as _api

    bindings = bindings or {}
    params = _fn_feed_columns(fn, frame, bindings)
    bound = _api._bound_tensors(bindings, device)
    acc: Dict[str, List[torch.Tensor]] = {}
    out_sizes: List[int] = []
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            out_sizes.append(0)
            continue
        feeds = _api._feeds(frame, _identity(params), params, lo, hi, device, bound)
        outs = _fn_outputs_to_dict(fn(*feeds), "map_blocks")
        out_sizes.append(_api._block_rows(outs, hi - lo, trim))
        for name, o in outs.items():
            acc.setdefault(name, []).append(o)
    if not acc:
        raise _never_ran("map_blocks")
    out_cols = [Column(n, _api._concat(parts)) for n, parts in acc.items()]
    offsets = list(np.cumsum([0] + out_sizes)) if trim else frame.offsets
    return _api._output_frame(
        frame, out_cols, append_input=not trim, offsets=offsets
    )


def _map_rows_fn(
    fn: Callable,
    frame: TensorFrame,
    device: torch.device,
    bindings: Optional[Dict] = None,
) -> TensorFrame:
    """`map_rows` of a function of row cells (dense columns): one vmapped
    call per block; output names come from the returned dict."""
    from . import api as _api

    bindings = bindings or {}
    params = _fn_feed_columns(fn, frame, bindings)
    if bindings and all(p in bindings for p in params):
        raise ValueError(
            "map_rows: every parameter is bound, so nothing varies per "
            "row; use map_blocks (or call the function directly)"
        )
    vfn = torch.func.vmap(
        lambda *cells: _fn_outputs_to_dict(fn(*cells), "map_rows"),
        in_dims=tuple(None if p in bindings else 0 for p in params),
    )
    bound = _api._bound_tensors(bindings, device)
    acc: Dict[str, List[torch.Tensor]] = {}
    for bi in range(frame.num_blocks):
        lo, hi = frame.offsets[bi], frame.offsets[bi + 1]
        if lo == hi:
            continue
        feeds = _api._feeds(frame, _identity(params), params, lo, hi, device, bound)
        for name, o in vfn(*feeds).items():
            acc.setdefault(name, []).append(o)
    if not acc:
        raise _never_ran("map_rows")
    out_cols = [Column(n, _api._concat(parts)) for n, parts in acc.items()]
    return _api._output_frame(frame, out_cols, append_input=True)
