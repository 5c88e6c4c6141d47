"""PyTorch port: the one seam between the kernel wrappers and their
libraries (`ops._cuda_build.load_library` and `check`).

On the CPU: each wrapper's table of C entries (`_ENTRIES`) against the
``extern "C"`` declarations of its ``csrc/`` sources, argument by argument;
the entries declared once a process; a nonzero return code raised with the
library's own error string. The libraries themselves build and run on the
card only (the ``card`` tests of the kernels' own files).
"""

import ctypes
import re
from pathlib import Path

import pytest

from tensorframes_tpu_torch.ops import _cuda_build
from tensorframes_tpu_torch.ops import factorize_keys, flash_attention, kda, keyed_sums

_CSRC = Path(_cuda_build.__file__).resolve().parent.parent / "csrc"


def _c_entries(*files):
    """name -> ([argument ctypes], return ctype) of every ``extern "C"``
    function in ``files`` (a macro's ``##SUFFIX`` left in its name): any
    pointer is ``c_void_p``."""
    scalars = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    out = {}
    for f in files:
        text = (_CSRC / f).read_text().replace("\\\n", " ")
        for ret, name, args in re.findall(
                r'extern "C" (const char\s*\*|int) (tfs_[\w#]+)\(([^)]*)\)', text):
            types = []
            for arg in filter(None, (a.strip() for a in args.split(","))):
                types.append(ctypes.c_void_p if "*" in arg else scalars[arg.rsplit(" ", 1)[0]])
            out[name] = (types, ctypes.c_char_p if "*" in ret else ctypes.c_int)
    return out


_TABLES = [
    ("keyed_sums", keyed_sums._ENTRIES, _c_entries("keyed_sums.cu")),
    ("factorize_keys", factorize_keys._ENTRIES, _c_entries("factorize_keys.cu")),
    ("kda", kda._ENTRIES, _c_entries("kda.cu")),
] + [
    (f"flash_attention_{sfx}", flash_attention._ENTRIES[sfx],
     {name.replace("##SUFFIX", sfx): decl
      for name, decl in _c_entries("flash_attention.cuh").items()})
    for sfx, _ in flash_attention._BUILDS.values()
]


@pytest.mark.parametrize("table,declared", [t[1:] for t in _TABLES], ids=[t[0] for t in _TABLES])
def test_entry_table_matches_the_c_declarations(table, declared):
    assert table, "no entries"
    for name, (argtypes, restype) in table.items():
        assert name in declared, f"{name} is declared in no source"
        assert (list(argtypes), restype) == declared[name], name


class _FakeEntry:
    argtypes = restype = None


def test_entries_are_declared_once_a_process(monkeypatch, tmp_path):
    lib = type("Lib", (), {"tfs_a": _FakeEntry(), "tfs_b": _FakeEntry()})()
    loads = []
    monkeypatch.setattr(_cuda_build, "_build", lambda name: loads.append(name) or tmp_path)
    monkeypatch.setattr(_cuda_build.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(_cuda_build, "_libs", {})
    table = {"tfs_a": ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
             "tfs_b": ([ctypes.c_int], ctypes.c_char_p)}
    assert _cuda_build.load_library("fake", table) is lib
    assert lib.tfs_a.argtypes == [ctypes.c_int, ctypes.c_void_p] and lib.tfs_a.restype is ctypes.c_int
    assert lib.tfs_b.argtypes == [ctypes.c_int] and lib.tfs_b.restype is ctypes.c_char_p
    lib.tfs_a.argtypes = None  # a second call finds the library and declares nothing
    assert _cuda_build.load_library("fake", table) is lib
    assert lib.tfs_a.argtypes is None
    assert loads == ["fake"] and _cuda_build._libs == {"fake": lib}


def test_check_raises_with_the_librarys_error_string():
    said = []

    def error_string(rc):
        said.append(rc)
        return b"an illegal memory access was encountered"

    _cuda_build.check(0, "keyed_sums launch", error_string)
    assert said == []
    with pytest.raises(RuntimeError) as e:
        _cuda_build.check(700, "keyed_sums launch", error_string)
    assert str(e.value) == ("keyed_sums launch failed: an illegal memory access was "
                            "encountered (cudaError 700)")
