"""Utilities of the PyTorch port: plan counters and profiler traces,
telemetry and diagnostics, frame and parameter checkpoints.

The checkpoint and telemetry names load on first use (PEP 562): the frame
module imports `utils.profiling`, and the checkpoint module imports the
frame module.
"""

from .profiling import annotate, record, reset_stats, stats, trace

__all__ = [
    "load_frame",
    "load_params",
    "save_frame",
    "save_params",
    "annotate",
    "record",
    "reset_stats",
    "stats",
    "trace",
    "telemetry",
    "diagnostics",
    "export_chrome_trace",
    "export_prometheus",
]

_LAZY = {
    "load_frame": "checkpoint",
    "load_params": "checkpoint",
    "save_frame": "checkpoint",
    "save_params": "checkpoint",
    "diagnostics": "telemetry",
    "export_chrome_trace": "telemetry",
    "export_prometheus": "telemetry",
}


def __getattr__(name):
    import importlib

    if name == "telemetry":
        return importlib.import_module(".telemetry", __name__)
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
