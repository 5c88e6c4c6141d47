"""Executor inspection.

The PyTorch counterpart of `executor_stats` in
`tensorframes_tpu/utils/inspection.py`. `explain_hlo` and `cost_analysis`
read XLA's HLO and are not in the port: the cost ledger
(`runtime.costmodel`) counts every cached program's flops and bytes
instead.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["executor_stats"]


def executor_stats(executor=None) -> Dict[str, int]:
    """Cache observability for an executor (the process default when none
    is given): ``compile_count`` (distinct lowered callables),
    ``cache_hits`` / ``cache_misses`` (per `Executor.cached` lookup),
    ``cache_entries`` (live LRU size) and ``jit_shape_compiles`` — the JAX
    name kept for the sum over live programs of their distinct dispatched
    input shape signatures (eager PyTorch compiles nothing per shape, but a
    shape churn still shows here). An executor that cannot count them
    reports 0 with ``jit_shape_compiles_estimated: True``. Plus the
    process-wide fault ledger with the OOM forensic snapshots
    (``faults``) and the admission controller's state (``admission``)."""
    from ..runtime import deadline as _deadline
    from ..runtime import faults as _faults
    from ..runtime.executor import default_executor

    ex = executor if executor is not None else default_executor()
    out = {
        "compile_count": int(getattr(ex, "compile_count", 0)),
        "cache_hits": int(getattr(ex, "cache_hits", 0)),
        "cache_misses": int(getattr(ex, "cache_misses", 0)),
        "cache_entries": len(getattr(ex, "_cache", ())),
    }
    per_prog = getattr(ex, "program_shape_compiles", None)
    if callable(per_prog):
        out["jit_shape_compiles"] = int(sum(per_prog().values()))
    else:
        out["jit_shape_compiles"] = 0
        out["jit_shape_compiles_estimated"] = True
    fl = dict(_faults.ledger_snapshot())
    fl["forensics"] = _faults.forensics_snapshot()
    out["faults"] = fl
    out["admission"] = _deadline.controller().snapshot()
    return out
