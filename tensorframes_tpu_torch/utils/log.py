"""Logging bootstrap, a copy of `tensorframes_tpu/utils/log.py`.

One logger hierarchy under ``tensorframes_tpu_torch``; level from the
``TFS_LOG_LEVEL`` env var (DEBUG/INFO/WARNING/ERROR, default WARNING).
"""

from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "initialize_logging"]

_ROOT = "tensorframes_tpu_torch"
_initialized = False


def initialize_logging(level: str | None = None) -> None:
    """Configure the package's root logger once (idempotent)."""
    global _initialized
    root = logging.getLogger(_ROOT)
    lvl = (level or os.environ.get("TFS_LOG_LEVEL", "WARNING")).upper()
    root.setLevel(getattr(logging, lvl, logging.WARNING))
    if not _initialized:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        root.addHandler(handler)
        root.propagate = False
        _initialized = True


def get_logger(name: str) -> logging.Logger:
    initialize_logging()
    return logging.getLogger(f"{_ROOT}.{name}")
