"""Program cost ledger: always-on per-program cost and memory accounting.

The PyTorch counterpart of `tensorframes_tpu/runtime/costmodel.py`, with the
JAX module's entry points, keys and knobs. JAX reads the compiler's modeled
cost (``lowered.cost_analysis()``); eager PyTorch has no compiler, so the
port counts the ATen ops itself:

- **Capture on the meta device.** The first dispatch of each (cached
  program, input shape signature) replays the program's callable, built
  for ``torch.device("meta")``, on meta tensors of the dispatched shapes,
  under a `TorchDispatchMode` that sees every ATen op (`capture`). The
  replay launches nothing, allocates nothing and never synchronises. A
  program whose graph holds `_Cond`/`_While` (its work depends on the
  data: the meta replay runs both branches and one loop trip), and one
  whose replay raises, stays at honest ``None``, as a failed JAX capture
  does.
- **The counting conventions**, XLA's where they can be, so the port's
  flops equal the JAX ledger's on matmul and elementwise programs:

  - flops: 2·M·N·K for ``mm`` / ``bmm`` (plus M·N for the add of
    ``addmm`` / ``baddbmm``), 2·M·N for ``mv``, 2·N for ``dot``,
    `torch.utils.flop_counter`'s formula for convolutions; one per output
    element for elementwise arithmetic (comparisons and selects included);
    input elements minus output elements for a reduction (N−1 for a full
    sum), plus one per output element for a mean; softmax as XLA counts
    ``jax.nn.softmax`` (max-reduce, a max against -inf, subtract, exp,
    sum-reduce, divide: 4N − R flops for R rows of N/R). Transcendentals
    (``exp``, ``log``, ``tanh``, ``sigmoid``, ``sqrt``, ``rsqrt``, ``pow``,
    ``sin``, ``cos``, ``erf``, ...) are counted apart, not as flops. Data
    movement (copies and dtype conversions, concatenation, gathers,
    scatters, padding, fills) is 0 flops.
  - bytes: operand bytes plus result bytes of every ATen op that is not a
    view, summed over the program. This is XLA's per-op sum over the
    unoptimised module, except that XLA materialises scalar broadcasts:
    0-d operands and results (scalar constants) count 0 bytes here, so
    ``x * 3.0`` over f32[1000] is 8,000 bytes (XLA: 16,004). View ops
    (``view``, ``expand``, ``permute``, ``slice``, ...) count nothing.
  - temp bytes (``config.cost_ledger_memory``): the high-water mark of
    live intermediate bytes during the meta replay (weak references on the
    replay's results), minus the output bytes.

- **Count at dispatch time.** Every call of a cached program bumps its
  (kind, shape) entry's execution count — one locked update of the cell
  the executor keeps from the capture (`count`) — so the issued totals are
  exact. The verb contextvar attributes a
  per-verb high-water mark of dispatch footprint.
- **Join with spans** (`roofline`, `residuals`): achieved FLOP/s and HBM
  bytes/s over the dispatch spans' execute seconds — CUDA event time on
  the card (`utils.telemetry.exec_seconds`), host time on the CPU — against
  the card's peaks (`device_peaks`).
- **Memory overview** (`memory_overview`): one row per visible CUDA device
  from ``torch.cuda.memory_stats``; registered as labeled gauges and
  embedded in OOM forensic snapshots (`runtime.faults`).

Everything here is observability: capture and counting never break a
dispatch, so every entry point is exception-guarded.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import config as _config
from ..utils import telemetry as _tele

__all__ = [
    "DEVICE_PEAKS",
    "enabled",
    "signature",
    "count_program",
    "capture",
    "count",
    "note_exec",
    "program_costs",
    "program_shapes",
    "program_footprint",
    "verb_peaks",
    "device_peaks",
    "memory_overview",
    "roofline",
    "residuals",
    "modeled_recompute_s",
    "planner_throughput",
    "reset",
]


def enabled() -> bool:
    """Cost-ledger master switch (``config.cost_ledger`` /
    ``TFS_COST_LEDGER``), independent of the telemetry span switch."""
    return bool(_config._config.cost_ledger)


# ---------------------------------------------------------------------------
# device peaks
# ---------------------------------------------------------------------------

# Datasheet peaks by `torch.cuda.get_device_name()`. The JAX key name
# ``matmul_flops_s`` is kept; on the H100 it holds the float32 rate OUTSIDE
# the tensor cores (67 TFLOP/s), the rate the port computes at: TF32 is off
# and the dtypes come from the graph.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "matmul_flops_s": 67e12},
}


def device_peaks(device=None) -> Dict[str, Optional[float]]:
    """Datasheet peaks of ``device`` (default: CUDA device 0, or the CPU
    when there is no card): ``{"device_kind", "hbm_bytes_s",
    "matmul_flops_s"}``, with honest ``None`` for a kind not in the table
    (the CPU included), so fractions render as "peak unknown"."""
    kind = None
    try:
        dev = torch.device(device) if device is not None else None
        if dev is None:
            dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    except Exception:
        pass  # no live backend: peaks honestly read as unknown
    row = DEVICE_PEAKS.get(kind or "", {})
    return {
        "device_kind": kind,
        "hbm_bytes_s": row.get("hbm_bytes_s"),
        "matmul_flops_s": row.get("matmul_flops_s"),
    }


# ---------------------------------------------------------------------------
# counting ATen ops on the meta device
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
    "pow", "sqrt", "rsqrt", "tanh", "sin", "cos", "tan", "asin", "acos",
    "atan", "atan2", "sinh", "cosh", "asinh", "acosh", "atanh", "erf",
    "erfc", "erfinv", "lgamma", "digamma",
}
_REDUCTIONS = {
    "sum", "prod", "amax", "amin", "max", "min", "argmax", "argmin", "any",
    "all", "nansum", "logsumexp", "var", "std", "var_mean", "std_mean",
    "norm", "linalg_vector_norm", "count_nonzero", "aminmax", "cumsum",
    "cumprod",
}
# ops that move or create data without arithmetic: 0 flops, bytes counted
_DATA_MOVEMENT = {
    "clone", "copy", "_to_copy", "cat", "stack", "index", "index_select",
    "gather", "scatter", "scatter_add", "scatter_reduce", "index_put",
    "index_add", "index_copy", "constant_pad_nd", "flip", "roll", "repeat",
    "masked_select", "nonzero", "sort", "topk", "argsort", "embedding",
    "_unsafe_index", "fill", "zero", "full", "full_like", "zeros",
    "zeros_like", "ones", "ones_like", "empty", "empty_like",
    "empty_strided", "new_empty", "new_zeros", "new_ones", "new_full",
    "arange", "scalar_tensor", "lift_fresh_copy", "_local_scalar_dense",
    "unique", "_unique2", "unique_consecutive", "bincount", "tril", "triu",
    "searchsorted", "bucketize", "one_hot", "_pin_memory", "resize",
    "set_", "detach_", "pad", "reflection_pad2d",
    "replication_pad2d", "diag_embed", "im2col", "col2im", "narrow_copy",
    "slice_scatter", "select_scatter", "diagonal_scatter", "as_strided_scatter",
    "split_with_sizes_copy", "expand_copy", "permute_copy", "view_copy",
}


# views the schema does not mark as aliasing
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh"}


def _name(func) -> str:
    n = func.overloadpacket.__name__
    return n[:-1] if n.endswith("_") and not n.endswith("__") else n


def _numel(t) -> int:
    return int(t.numel()) if isinstance(t, torch.Tensor) else 0


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        out = []
        for o in obj:
            out.extend(_tensors(o))
        return out
    return []


def _bytes(ts) -> int:
    """Bytes of tensors that hold more than a scalar (0-d tensors count 0:
    a scalar operand is broadcast, not streamed)."""
    return sum(
        t.numel() * t.element_size() for t in ts if t.dim() > 0
    )


def _op_cost(func, args, kwargs, out) -> Tuple[float, float, int]:
    """(flops, transcendentals, bytes) of one ATen op, by the module
    docstring's conventions."""
    name = _name(func)
    if func.is_view or name in _VIEWS:
        return 0.0, 0.0, 0
    ins = _tensors(list(args) + list(kwargs.values()))
    outs = _tensors(out)
    nbytes = _bytes(ins) + _bytes(outs)
    out_n = sum(t.numel() for t in outs)
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
        return 2.0 * a.numel() * b.shape[-1], 0.0, nbytes
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
        return 2.0 * a.numel() * b.shape[-1] + out_n, 0.0, nbytes
    if name == "mv":
        return 2.0 * args[0].numel(), 0.0, nbytes
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel(), 0.0, nbytes
    if name in ("convolution", "_convolution", "cudnn_convolution"):
        from torch.utils.flop_counter import flop_registry

        f = flop_registry.get(func.overloadpacket)
        return (float(f(*args, **kwargs, out_val=out)) if f else 0.0), 0.0, nbytes
    if name in ("_softmax", "_log_softmax"):
        # jax.nn's: max-reduce (n - r), a max against -inf (r), subtract
        # (n), exp, sum-reduce (n - r), divide or subtract (n); the log of
        # log_softmax is r transcendentals
        n = args[0].numel()
        dim = args[1] % max(1, args[0].dim())
        r = n // max(1, args[0].shape[dim]) if args[0].dim() else 1
        t = float(n) if name == "_softmax" else float(n + r)
        return 4.0 * n - r, t, nbytes
    if name in _REDUCTIONS:
        in_n = ins[0].numel() if ins else 0
        return float(max(0, in_n - out_n)), 0.0, nbytes
    if name == "mean":
        in_n = ins[0].numel() if ins else 0
        return float(max(0, in_n - out_n) + out_n), 0.0, nbytes
    if name in _TRANSCENDENTAL:
        return 0.0, float(out_n), nbytes
    if name in _DATA_MOVEMENT or not ins:
        return 0.0, 0.0, nbytes
    return float(out_n), 0.0, nbytes


class _CostMode(TorchDispatchMode):
    """Sums `_op_cost` over every ATen op it sees; with ``track_memory``
    also the high-water mark of live result bytes."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0
        self.track = track_memory
        self.live = 0
        self.peak = 0

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f, t, b = _op_cost(func, args, kwargs, out)
        self.flops += f
        self.transcendentals += t
        self.bytes += b
        if self.track and not func.is_view:
            for o in _tensors(out):
                n = o.numel() * o.element_size()
                self.live += n
                weakref.finalize(o, self._freed, n)
            self.peak = max(self.peak, self.live)
        return out


def count_program(fn: Callable, args) -> Dict[str, Optional[float]]:
    """Count one call of ``fn`` — a callable built for the meta device —
    on meta tensors shaped like ``args`` (non-tensor arguments pass
    through). Returns ``{"flops", "transcendentals", "bytes_accessed",
    "temp_bytes"}``; raises what the replay raises."""
    meta_args = [
        torch.empty(a.shape, dtype=a.dtype, device="meta")
        if isinstance(a, torch.Tensor) else a
        for a in args
    ]
    track = bool(_config.get().cost_ledger_memory)
    mode = _CostMode(track_memory=track)
    with mode:
        out = fn(*meta_args)
    out_bytes = _bytes(_tensors(out))
    del out
    return {
        "flops": mode.flops,
        "transcendentals": mode.transcendentals,
        "bytes_accessed": float(mode.bytes),
        "temp_bytes": float(max(0, mode.peak - out_bytes)) if track else None,
    }


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

_lock = threading.Lock()
# fingerprint -> {"kinds": set, "shapes": {(kind, sig): entry}, "evicted"}
_programs: Dict[str, Dict] = {}
# bounds: the ledger is always on in long-lived services; past the
# per-program shape cap the oldest entry folds into "evicted", past the
# program cap the oldest program is dropped
_MAX_SHAPES_PER_PROGRAM = 64
_MAX_PROGRAMS = 1024
# verb name -> {"bytes", "program", "rows"}
_verb_peaks: Dict[str, Dict] = {}
def signature(args) -> Tuple:
    """The input shape signature of one dispatch: (shape, dtype) of each
    tensor argument."""
    return tuple([(a.shape, a.dtype) for a in args if isinstance(a, torch.Tensor)])


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _lead_rows(ts) -> Optional[int]:
    for t in ts:
        if t.dim():
            return int(t.shape[0])
    return None


def _entry(fp: str, kind: str, sig: Tuple) -> Dict:
    """The (program, kind, shape) ledger cell — caller holds _lock."""
    prog = _programs.get(fp)
    if prog is None:
        while len(_programs) >= _MAX_PROGRAMS:
            for gone in _programs.pop(next(iter(_programs)))["shapes"].values():
                gone["gone"] = True
        prog = {
            "kinds": set(), "shapes": {},
            "evicted": {"execs": 0, "flops": 0.0, "bytes": 0.0},
        }
        _programs[fp] = prog
    prog["kinds"].add(kind)
    ent = prog["shapes"].get((kind, sig))
    if ent is None:
        while len(prog["shapes"]) >= _MAX_SHAPES_PER_PROGRAM:
            old = prog["shapes"].pop(next(iter(prog["shapes"])))
            old["gone"] = True
            ev = prog["evicted"]
            ev["execs"] += old["execs"]
            if old["flops"] is not None:
                ev["flops"] += old["flops"] * max(1, old["execs"])
            if old["bytes_accessed"] is not None:
                ev["bytes"] += old["bytes_accessed"] * max(1, old["execs"])
        ent = {
            "flops": None, "transcendentals": None, "bytes_accessed": None,
            "arg_bytes": None, "out_bytes": None, "temp_bytes": None,
            "execs": 0, "capture_s": 0.0, "phase": None, "rows": None,
            "peaked": set(),  # verbs whose peak has seen this footprint
        }
        prog["shapes"][(kind, sig)] = ent
    return ent


def capture(key: Tuple, meta_fn: Optional[Callable], args, phase: str = "meta") -> Optional[Dict]:
    """Record the modeled cost of one (program, shape) at its first
    dispatch: ``meta_fn`` (the program built for the meta device, or None
    when it cannot be replayed) is counted on meta tensors shaped like
    ``args`` (`count_program`). Returns the ledger cell, which `count`
    takes at every later dispatch of the shape. Never raises: a failed
    replay leaves the cell at honest None."""
    if not enabled():
        return None
    fp, kind = str(key[1]), str(key[0])
    t0 = time.perf_counter()
    cost = None
    if meta_fn is not None:
        try:
            cost = count_program(meta_fn, args)
        except Exception:
            cost = None  # the ledger degrades to unknown
    try:
        ts = _tensors(list(args))
        sig = signature(args)
        dt = time.perf_counter() - t0
        with _lock:
            ent = _entry(fp, kind, sig)
            if cost is not None:
                ent["flops"] = cost["flops"]
                ent["transcendentals"] = cost["transcendentals"]
                ent["bytes_accessed"] = cost["bytes_accessed"]
                if cost["temp_bytes"] is not None:
                    ent["temp_bytes"] = cost["temp_bytes"]
                    ent["peaked"].clear()  # the footprint grew: compare anew
            ent["arg_bytes"] = _nbytes(ts)
            ent["rows"] = _lead_rows(ts)
            ent["capture_s"] += dt
            ent["phase"] = ent["phase"] or phase
        return ent
    except Exception:
        return None  # the ledger never breaks a dispatch


def count(ent: Dict, key: Tuple, args, out, sig: Tuple) -> None:
    """Count one execution against the ledger cell ``ent`` that `capture`
    returned for this (program, shape): one locked update, plus the
    per-verb footprint high-water mark (the byte counts are read at the
    cell's first execution; a cell's footprint is fixed then, so each verb
    compares it once). A cell the ledger has since evicted is looked up
    anew. Never raises."""
    try:
        verb = _tele.current_verb()
        with _lock:
            if "gone" in ent:
                ent = _entry(str(key[1]), str(key[0]), sig)
            ent["execs"] += 1
            if ent["out_bytes"] is None:
                ins = _tensors(list(args))
                ent["out_bytes"] = _nbytes(_tensors(out))
                if ent["arg_bytes"] is None:
                    ent["arg_bytes"] = _nbytes(ins)
                if ent["rows"] is None:
                    ent["rows"] = _lead_rows(ins)
            if verb:
                _note_peak(ent, verb, str(key[1]))
    except Exception:
        pass  # exec accounting never breaks the dispatch it counts


def _note_peak(ent: Dict, verb: str, fp: str) -> None:
    """Raise ``verb``'s footprint high-water mark to cell ``ent``'s, once
    per (cell, verb): a cell's footprint is fixed once its byte counts
    are read. Caller holds _lock."""
    if verb in ent["peaked"]:
        return
    ent["peaked"].add(verb)
    footprint = ent["arg_bytes"] + ent["out_bytes"] + (ent["temp_bytes"] or 0)
    peak = _verb_peaks.get(verb)
    if peak is None or footprint > peak["bytes"]:
        _verb_peaks[verb] = {"bytes": footprint, "program": fp, "rows": ent["rows"]}


def _count_run(run, verb: Optional[str]) -> None:
    """Fold the execution counts a `telemetry.dispatch_run` deferred
    (``run.ledger``: one (cell, key, signature) per dispatch whose cell
    already knew its byte counts) under one lock, with the per-verb
    high-water marks of ``verb`` as `count` keeps them."""
    with _lock:
        for ent, key, sig in run.ledger:
            if "gone" in ent:
                ent = _entry(str(key[1]), str(key[0]), sig)
            ent["execs"] += 1
            # a cell made anew here reads its bytes at its next `count`
            if verb and ent["out_bytes"] is not None:
                _note_peak(ent, verb, str(key[1]))


_tele.on_run_end(_count_run)


def note_exec(key: Tuple, args, out, verb: Optional[str] = None,
              sig: Optional[Tuple] = None, flops: Optional[float] = None) -> None:
    """Count one execution of a cached program against its (kind, shape)
    cell and update the per-verb footprint high-water mark: one locked
    dict update (the byte counts are read at a cell's first execution).
    ``flops``: the cost of a launch no meta replay counts (a hand-written
    kernel's), set on a cell that has none at its first execution: these
    flops, no transcendentals, and its operands' and results' bytes.
    Never raises."""
    if not enabled():
        return
    try:
        fp, kind = str(key[1]), str(key[0])
        if sig is None:
            sig = signature(args)
        if verb is None:
            verb = _tele.current_verb()
        with _lock:
            ent = _entry(fp, kind, sig)
            ent["execs"] += 1
            if ent["out_bytes"] is None or ent["arg_bytes"] is None:
                ins = _tensors(list(args))
                if ent["arg_bytes"] is None:
                    ent["arg_bytes"] = _nbytes(ins)
                if ent["out_bytes"] is None:
                    ent["out_bytes"] = _nbytes(_tensors(out))
                if ent["rows"] is None:
                    ent["rows"] = _lead_rows(ins)
            if flops is not None and ent["flops"] is None:
                ent["flops"], ent["transcendentals"] = float(flops), 0.0
                ent["bytes_accessed"] = float(ent["arg_bytes"] + ent["out_bytes"])
                ent["phase"] = ent["phase"] or "modeled"
            if verb:
                footprint = ent["arg_bytes"] + ent["out_bytes"] + (ent["temp_bytes"] or 0)
                peak = _verb_peaks.get(verb)
                if peak is None or footprint > peak["bytes"]:
                    _verb_peaks[verb] = {
                        "bytes": footprint, "program": fp, "rows": ent["rows"],
                    }
    except Exception:
        pass  # exec accounting never breaks the dispatch it counts


def program_costs() -> Dict[str, Dict]:
    """Ledger snapshot per program fingerprint: ``{fp: {kinds, shapes,
    execs, total_flops, total_bytes_accessed, footprint_bytes,
    flops_per_exec, bytes_per_exec, temp_known, capture_s}}``. Totals are
    Σ over shape entries of (per-shape cost × its exec count); the
    per-exec columns report the largest captured shape; ``None`` means no
    shape of the program was costed."""
    with _lock:
        progs = {
            fp: {
                "kinds": set(p["kinds"]),
                "shapes": {k: dict(v) for k, v in p["shapes"].items()},
                "evicted": dict(p["evicted"]),
            }
            for fp, p in _programs.items()
        }
    out: Dict[str, Dict] = {}
    for fp, p in progs.items():
        ev = p["evicted"]
        total_flops = float(ev["flops"])
        total_ba = float(ev["bytes"])
        flops_known = ev["flops"] > 0
        ba_known = ev["bytes"] > 0
        execs = ev["execs"]
        footprint = 0
        temp_known = False
        capture_s = 0.0
        per_exec_flops = per_exec_ba = None
        for (_kind, _sig), ent in p["shapes"].items():
            execs += ent["execs"]
            capture_s += ent["capture_s"]
            if ent["flops"] is not None:
                flops_known = True
                total_flops += ent["flops"] * max(1, ent["execs"])
                if per_exec_flops is None or ent["flops"] > per_exec_flops:
                    per_exec_flops = ent["flops"]
            if ent["bytes_accessed"] is not None:
                ba_known = True
                total_ba += ent["bytes_accessed"] * max(1, ent["execs"])
                if per_exec_ba is None or ent["bytes_accessed"] > per_exec_ba:
                    per_exec_ba = ent["bytes_accessed"]
            if ent["temp_bytes"] is not None:
                temp_known = True
            fp_bytes = (
                (ent["arg_bytes"] or 0)
                + (ent["out_bytes"] or 0)
                + (ent["temp_bytes"] or 0)
            )
            footprint = max(footprint, fp_bytes)
        out[fp] = {
            "kinds": sorted(p["kinds"]),
            "shapes": len(p["shapes"]),
            "execs": execs,
            "total_flops": total_flops if flops_known else None,
            "total_bytes_accessed": total_ba if ba_known else None,
            "flops_per_exec": per_exec_flops,
            "bytes_per_exec": per_exec_ba,
            "footprint_bytes": footprint or None,
            "temp_known": temp_known,
            "capture_s": capture_s,
        }
    return out


def modeled_recompute_s(fp: str) -> Optional[float]:
    """Predicted seconds to recompute ONE execution of program ``fp``: the
    per-exec modeled cost (largest captured shape) over the fitted
    effective throughput of `residuals()`. ``None`` without a costed shape
    or without a fit (no dispatch spans yet)."""
    if not enabled():
        return None
    costs = program_costs().get(fp)
    if costs is None:
        return None
    try:
        fit = residuals()["fit"]
    except Exception:
        return None
    pred = None
    if costs["bytes_per_exec"] is not None and fit.get("bytes_per_s"):
        pred = costs["bytes_per_exec"] / fit["bytes_per_s"]
    elif costs["flops_per_exec"] is not None and fit.get("flops_per_s"):
        pred = costs["flops_per_exec"] / fit["flops_per_s"]
    return pred


def program_shapes() -> Dict[str, List[Dict]]:
    """Per-(program, kind, shape) ledger detail: one row per shape entry
    with its lead row count, exec count and modeled costs."""
    with _lock:
        return {
            fp: [
                {
                    "kind": kind,
                    "rows": ent["rows"],
                    "execs": ent["execs"],
                    "flops": ent["flops"],
                    "bytes_accessed": ent["bytes_accessed"],
                    "arg_bytes": ent["arg_bytes"],
                    "out_bytes": ent["out_bytes"],
                    "temp_bytes": ent["temp_bytes"],
                    "phase": ent["phase"],
                }
                for (kind, _sig_), ent in p["shapes"].items()
            ]
            for fp, p in _programs.items()
        }


def program_footprint(fp: str) -> Optional[Dict]:
    """The modeled footprint of one program fingerprint (for OOM
    forensics): max over its shapes of argument + output (+ temp) bytes,
    plus per-exec flops/bytes. None when the program never reached the
    ledger."""
    costs = program_costs().get(str(fp))
    if costs is None:
        return None
    return {
        "footprint_bytes": costs["footprint_bytes"],
        "flops_per_exec": costs["flops_per_exec"],
        "bytes_per_exec": costs["bytes_per_exec"],
        "temp_known": costs["temp_known"],
        "shapes": costs["shapes"],
    }


def verb_peaks() -> Dict[str, Dict]:
    """Per-verb high-water marks of dispatch footprint (argument + output +
    known temp bytes of the largest single dispatch the verb issued)."""
    with _lock:
        return {k: dict(v) for k, v in _verb_peaks.items()}


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------


def memory_overview() -> List[Dict]:
    """One row per visible CUDA device, labelled ``cuda:N``, from
    ``torch.cuda.memory_stats``: ``live_buffer_bytes`` =
    ``allocated_bytes.all.current``, ``live_buffers`` =
    ``active.all.current``, ``bytes_in_use`` = ``memory_allocated``,
    ``peak_bytes_in_use`` = ``max_memory_allocated``. A device whose CUDA
    context was never created reads zeros (asking would create one). No
    card (the CPU): an empty list — torch keeps no allocator statistics
    for host memory."""
    try:
        if not torch.cuda.is_available():
            return []
        n = torch.cuda.device_count()
        live = torch.cuda.is_initialized()
    except Exception:
        return []
    rows = []
    for i in range(n):
        row = {
            "device": f"cuda:{i}",
            "device_kind": None,
            "live_buffer_bytes": 0,
            "live_buffers": 0,
            "bytes_in_use": 0,
            "peak_bytes_in_use": 0,
        }
        if live:
            try:
                ms = torch.cuda.memory_stats(i)
                row["device_kind"] = torch.cuda.get_device_name(i)
                row["live_buffer_bytes"] = int(ms.get("allocated_bytes.all.current", 0))
                row["live_buffers"] = int(ms.get("active.all.current", 0))
                row["bytes_in_use"] = int(torch.cuda.memory_allocated(i))
                row["peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(i))
            except Exception:
                pass  # a lost context: report the zero row
        rows.append(row)
    return rows


def _register_gauges() -> None:
    """Labeled device-memory gauges, evaluated only at export time."""
    def _col(key: str) -> Callable[[], Dict[str, float]]:
        return lambda: {
            r["device"]: float(r[key])
            for r in memory_overview()
            if r[key] is not None
        }

    _tele.gauge_register_multi("live_buffer_bytes", "device", _col("live_buffer_bytes"))
    _tele.gauge_register_multi("device_bytes_in_use", "device", _col("bytes_in_use"))
    _tele.gauge_register_multi("device_peak_bytes", "device", _col("peak_bytes_in_use"))


# ---------------------------------------------------------------------------
# the roofline join (ledger x span attribution)
# ---------------------------------------------------------------------------


def roofline(by_program: Dict[str, Dict]) -> List[Dict]:
    """Join the ledger with the span ring's per-program execute
    attribution (`telemetry.span_aggregates()["by_program"]`): one row per
    fingerprint with modeled totals and achieved FLOP/s + HBM bytes/s over
    the attributed execute seconds (CUDA event time on the card), as
    fractions of the card's peaks (None when the peak or the cost is
    unknown)."""
    peaks = device_peaks()
    costs = program_costs()
    rows: List[Dict] = []
    for fp in sorted(set(costs) | set(by_program)):
        c = costs.get(fp)
        p = by_program.get(fp, {})
        exec_s = float(p.get("execute_s", 0.0))
        row = {
            "program": fp,
            "execs": c["execs"] if c else 0,
            "shapes": c["shapes"] if c else 0,
            "flops_per_exec": c["flops_per_exec"] if c else None,
            "bytes_per_exec": c["bytes_per_exec"] if c else None,
            "total_flops": c["total_flops"] if c else None,
            "total_bytes_accessed": c["total_bytes_accessed"] if c else None,
            "footprint_bytes": c["footprint_bytes"] if c else None,
            "temp_known": c["temp_known"] if c else False,
            "execute_s": exec_s,
            "dispatches": int(p.get("dispatches", 0)),
            "achieved_flops_s": None,
            "achieved_hbm_bytes_s": None,
            "flops_frac_of_peak": None,
            "hbm_frac_of_peak": None,
        }
        # the span window's dispatch count over the span window's execute
        # seconds; per-dispatch cost is the ledger's cumulative average
        disp = int(p.get("dispatches", 0))
        if c and exec_s > 0 and c["execs"] and disp:
            if c["total_flops"] is not None:
                avg = c["total_flops"] / c["execs"]
                row["achieved_flops_s"] = avg * disp / exec_s
                if peaks["matmul_flops_s"]:
                    row["flops_frac_of_peak"] = (
                        row["achieved_flops_s"] / peaks["matmul_flops_s"]
                    )
            if c["total_bytes_accessed"] is not None:
                avg = c["total_bytes_accessed"] / c["execs"]
                row["achieved_hbm_bytes_s"] = avg * disp / exec_s
                if peaks["hbm_bytes_s"]:
                    row["hbm_frac_of_peak"] = (
                        row["achieved_hbm_bytes_s"] / peaks["hbm_bytes_s"]
                    )
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# cost-model accuracy: modeled vs span-achieved residuals
# ---------------------------------------------------------------------------


def residuals(span_list=None) -> Dict:
    """How wrong is the cost model, per (program x dispatched shape)?

    Joins the span ring's per-dispatch execute seconds (grouped by program
    fingerprint and dispatched lead rows) with the ledger's modeled cost
    of that shape, and scores each group against a time predicted from a
    per-process effective throughput fitted over every joined group (Σ
    modeled bytes / Σ achieved seconds, and the flops analogue). So
    ``residual_ratio`` = 1 means the program sits where the model ranks it
    among its peers. Where the card's peaks are known each group also
    carries the absolute roofline time (``modeled_peak_s``) and its ratio.
    Returns ``{"warn_ratio", "fit", "by_class", "groups", "programs"}``;
    programs whose ratio exceeds ``config.cost_residual_warn_ratio`` are
    ``flagged``."""
    ss = _tele.spans() if span_list is None else span_list
    groups: Dict[Tuple[str, Optional[int]], Dict] = {}
    for s in ss:
        if s.kind != "dispatch":
            continue
        prog = s.attrs.get("program")
        if not prog:
            continue
        rows = s.attrs.get("rows")
        bucket = s.attrs.get("bucket")
        lead = bucket if bucket is not None else rows
        lead = int(lead) if lead is not None else None
        g = groups.setdefault(
            (str(prog), lead),
            {"seconds": 0.0, "host_seconds": 0.0, "dispatches": 0, "rows": 0.0},
        )
        sec = _tele.exec_seconds(s)
        g["seconds"] += sec
        if "device_s" not in s.attrs:
            g["host_seconds"] += sec
        g["dispatches"] += 1
        g["rows"] += float(rows or 0)
        g.setdefault("op_class", _op_class(s.name))
    # a program's build spans (its lowering, the ledger's meta capture) run
    # on the host inside its first dispatch window: they are subtracted from
    # its host-timed dispatch seconds, in proportion across its shape
    # groups, floored at 1% of the window. CUDA event time excludes them.
    compile_s: Dict[str, float] = {}
    for s in ss:
        if s.kind == "compile":
            prog = s.attrs.get("program")
            if prog:
                compile_s[str(prog)] = compile_s.get(str(prog), 0.0) + s.seconds
    prog_host_s: Dict[str, float] = {}
    for (fp, _lead), g in groups.items():
        prog_host_s[fp] = prog_host_s.get(fp, 0.0) + g["host_seconds"]
    for (fp, _lead), g in groups.items():
        cs = compile_s.get(fp, 0.0)
        tot = prog_host_s.get(fp, 0.0)
        if cs > 0 and tot > 0 and g["host_seconds"] > 0:
            g["compile_s_excluded"] = cs * (g["host_seconds"] / tot)
            g["seconds"] -= g["host_seconds"]
            g["seconds"] += max(
                0.01 * g["host_seconds"], g["host_seconds"] - g["compile_s_excluded"]
            )
    shapes = program_shapes()

    def _modeled(fp: str, lead: Optional[int]) -> Tuple:
        ents = shapes.get(fp) or []
        match = [e for e in ents if e["rows"] == lead]
        if not match and len(ents) == 1:
            match = ents
        if not match:
            return None, None
        e = max(match, key=lambda e: e["execs"])
        by = e["bytes_accessed"]
        if by is None and e["arg_bytes"] is not None:
            by = e["arg_bytes"] + (e["out_bytes"] or 0)
        return e["flops"], by

    joined = []
    for (fp, lead), g in groups.items():
        flops, by = _modeled(fp, lead)
        joined.append(
            {
                "program": fp,
                "rows": lead,
                "op_class": g.get("op_class", "map"),
                "dispatches": g["dispatches"],
                "achieved_s": g["seconds"],
                "compile_s_excluded": g.get("compile_s_excluded", 0.0),
                "modeled_flops": flops,
                "modeled_bytes": by,
            }
        )
    fit_b_num = fit_b_den = fit_f_num = fit_f_den = 0.0
    cls_fit: Dict[str, Dict[str, float]] = {}
    for r in joined:
        if r["achieved_s"] <= 0:
            continue
        c = cls_fit.setdefault(
            r["op_class"],
            {"b_num": 0.0, "b_den": 0.0, "f_num": 0.0, "f_den": 0.0, "groups": 0},
        )
        c["groups"] += 1
        if r["modeled_bytes"] is not None:
            fit_b_num += r["modeled_bytes"] * r["dispatches"]
            fit_b_den += r["achieved_s"]
            c["b_num"] += r["modeled_bytes"] * r["dispatches"]
            c["b_den"] += r["achieved_s"]
        if r["modeled_flops"] is not None:
            fit_f_num += r["modeled_flops"] * r["dispatches"]
            fit_f_den += r["achieved_s"]
            c["f_num"] += r["modeled_flops"] * r["dispatches"]
            c["f_den"] += r["achieved_s"]
    eff_bytes = fit_b_num / fit_b_den if fit_b_den > 0 else None
    eff_flops = fit_f_num / fit_f_den if fit_f_den > 0 else None
    by_class = {
        cls: {
            "bytes_per_s": c["b_num"] / c["b_den"] if c["b_den"] > 0 else None,
            "flops_per_s": c["f_num"] / c["f_den"] if c["f_den"] > 0 else None,
            "groups": c["groups"],
        }
        for cls, c in cls_fit.items()
    }
    peaks = device_peaks()
    warn = float(_config.get().cost_residual_warn_ratio or 0.0)
    per_prog: Dict[str, Dict] = {}
    for r in joined:
        pred = None
        # the bytes model first (dataframe verbs are bandwidth-shaped)
        if r["modeled_bytes"] is not None and eff_bytes:
            pred = r["modeled_bytes"] / eff_bytes
        elif r["modeled_flops"] is not None and eff_flops:
            pred = r["modeled_flops"] / eff_flops
        r["predicted_s_per_exec"] = pred
        ach = r["achieved_s"] / r["dispatches"] if r["dispatches"] else None
        r["achieved_s_per_exec"] = ach
        r["residual_ratio"] = (
            ach / pred if (pred and ach is not None and pred > 0) else None
        )
        peak_s = None
        if r["modeled_flops"] is not None and peaks["matmul_flops_s"]:
            peak_s = r["modeled_flops"] / peaks["matmul_flops_s"]
        if r["modeled_bytes"] is not None and peaks["hbm_bytes_s"]:
            hb = r["modeled_bytes"] / peaks["hbm_bytes_s"]
            peak_s = hb if peak_s is None else max(peak_s, hb)
        r["modeled_peak_s"] = peak_s
        r["peak_ratio"] = ach / peak_s if (peak_s and ach is not None) else None
        p = per_prog.setdefault(
            r["program"],
            {"achieved_s": 0.0, "predicted_s": 0.0, "dispatches": 0,
             "worst_group_ratio": None},
        )
        p["dispatches"] += r["dispatches"]
        if pred is not None:
            p["achieved_s"] += r["achieved_s"]
            p["predicted_s"] += pred * r["dispatches"]
            rr = r["residual_ratio"]
            if rr is not None and (
                p["worst_group_ratio"] is None
                or abs(_log2(rr)) > abs(_log2(p["worst_group_ratio"]))
            ):
                p["worst_group_ratio"] = rr
    for p in per_prog.values():
        ratio = p["achieved_s"] / p["predicted_s"] if p["predicted_s"] > 0 else None
        p["residual_ratio"] = ratio
        p["flagged"] = bool(
            warn > 0 and ratio is not None and (ratio > warn or ratio < 1.0 / warn)
        )
    return {
        "warn_ratio": warn,
        "fit": {
            "bytes_per_s": eff_bytes,
            "flops_per_s": eff_flops,
            "groups": len(joined),
        },
        "by_class": by_class,
        "groups": sorted(joined, key=lambda r: (r["program"], r["rows"] or 0)),
        "programs": per_prog,
    }


def _op_class(span_name: str) -> str:
    """map / reduce / relational bucket of a dispatch span."""
    n = span_name or ""
    if n.startswith("plan."):
        return "relational"
    if "reduce" in n or "aggregate" in n:
        return "reduce"
    return "map"


def planner_throughput(op_class: str) -> Optional[float]:
    """Residuals-corrected effective bytes/second of one op class (``map``
    / ``reduce`` / ``relational``): the class fit when that class has
    dispatched, else the process-wide fit, else None (the optimizer then
    uses its cold-start default)."""
    try:
        res = residuals()
    except Exception:
        return None
    ent = (res.get("by_class") or {}).get(op_class)
    if ent and ent.get("bytes_per_s"):
        return float(ent["bytes_per_s"])
    v = (res.get("fit") or {}).get("bytes_per_s")
    return float(v) if v else None


def _log2(x: float) -> float:
    import math

    return math.log2(x) if x > 0 else 0.0


def _register_residual_gauge() -> None:
    """``costmodel_residual{program=}``: the per-program residual ratio,
    evaluated only at export."""
    def _residual() -> Dict[str, float]:
        return {
            fp: float(p["residual_ratio"])
            for fp, p in residuals()["programs"].items()
            if p.get("residual_ratio") is not None
        }

    _tele.gauge_register_multi("costmodel_residual", "program", _residual)


def reset() -> None:
    """Clear the ledger and the verb peaks (test isolation)."""
    with _lock:
        for prog in _programs.values():
            for ent in prog["shapes"].values():
                ent["gone"] = True
        _programs.clear()
        _verb_peaks.clear()


_register_gauges()
_register_residual_gauge()
