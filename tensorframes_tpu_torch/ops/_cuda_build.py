"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``tensorframes_tpu_torch/_build/`` (named by a hash of the source, the
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds) and loaded with `ctypes`. A failed build raises; there is no
fallback. `load_library` declares a library's C entries from one table as
it loads it, and `check` turns an entry's nonzero return code into a
`RuntimeError` carrying the library's own error string. `_build` and
`_BUILD` are the tests' seam: the ``card`` tests build afresh into a
directory of their own to read ptxas' report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["load_library", "check", "build_logs", "build_all"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the log
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc's output of the build


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def _build(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = _BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if out.exists():
        build_logs.setdefault(name, "(cached build)")
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load_library(name: str,
                 entries: Optional[Dict[str, Tuple[Sequence[Any], Any]]] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    each C entry of ``entries`` (entry name -> (argtypes, restype))
    declared as it is loaded, once a process."""
    lib = _libs.get(name)  # set only once its entries are declared
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for entry, (argtypes, restype) in (entries or {}).items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = list(argtypes), restype
            _libs[name] = lib
        return lib


def check(rc: int, what: str, error_string) -> None:
    """Raise `RuntimeError` for an entry's nonzero return code ``rc`` (a
    ``cudaError_t``), with the text of the library's entry
    ``error_string``."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: {error_string(rc).decode()} (cudaError {rc})")


def build_all() -> Dict[str, Path]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` process each: name
    -> the library's path. Each is loaded, its entries declared, at its
    wrapper's first call."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in _CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(_build, names)))
