"""Native (C++) host components, loaded through ctypes: the SDPA tokenizer
(``sdpa_parse.cpp``, with the pure-Python parser of
``models/reader_sdpa.py`` as its fallback) and the slab-allocated B&B node
store (``frontier.cpp``, loaded by ``frontier.py``, with a pure-Python
heap of the same pop order as its fallback).

The SDPA loader is a copy of the JAX package's ``native/__init__.py``
(its ``get_lib`` is ``get_sdpa_lib`` here); only the library's place
differs: ``g++`` builds each source at first use into
``build/scipsdp_tpu_torch/native/<hash>/`` beside the package (the hash
covers the source), through a temporary file, so processes that build at
once never load a partial library.  Importing the package builds
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_SRC_PATH = Path(__file__).resolve().parent / "sdpa_parse.cpp"
_lib = None
_tried = False


def library_path(src: Path, name: str) -> Path:
    """Where the source ``src`` is built as ``name`` (keyed by the
    source)."""
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return (Path(__file__).resolve().parent.parent.parent / "build"
            / "scipsdp_tpu_torch" / "native" / key / name)


def build_library(src: Path, name: str) -> Optional[Path]:
    """The built library of ``src``, building it first if it is not
    there; None when ``g++`` fails."""
    lib_path = library_path(src, name)
    if lib_path.is_file():
        return lib_path
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib_path


def get_sdpa_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native parser, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib_path = build_library(_SRC_PATH, "libsdpaparse.so")
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lp = ctypes.POINTER(ctypes.c_long)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.sdpa_count.restype = ctypes.c_int
        lib.sdpa_count.argtypes = [ctypes.c_char_p, lp, lp, lp, lp, lp]
        lib.sdpa_fill.restype = ctypes.c_int
        lib.sdpa_fill.argtypes = [ctypes.c_char_p, lp, dp, lp, lp, lp, lp,
                                  dp, lp, lp]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def parse_sdpa_native(path: str):
    """Tokenize a plain (non-gz) .dat-s file natively.

    Returns (blocksizes, obj, var, block, row, col, val, intidx, rank1idx)
    as numpy arrays (raw 1-based indices, unvalidated), or None when the
    native library is unavailable or rejects the file.
    """
    import numpy as np

    lib = get_sdpa_lib()
    if lib is None or path.endswith(".gz"):
        return None
    c_long = ctypes.c_long
    nv, nb, ne, ni, nr = (c_long(0) for _ in range(5))
    rc = lib.sdpa_count(path.encode(), ctypes.byref(nv), ctypes.byref(nb),
                        ctypes.byref(ne), ctypes.byref(ni), ctypes.byref(nr))
    if rc != 0 or nv.value < 0 or nb.value < 0:
        return None
    bs = np.zeros(nb.value, np.int64)
    obj = np.zeros(nv.value, np.float64)
    var = np.zeros(ne.value, np.int64)
    blk = np.zeros(ne.value, np.int64)
    row = np.zeros(ne.value, np.int64)
    col = np.zeros(ne.value, np.int64)
    val = np.zeros(ne.value, np.float64)
    ii = np.zeros(ni.value, np.int64)
    rr = np.zeros(nr.value, np.int64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.sdpa_fill(path.encode(), ptr(bs, c_long), ptr(obj, ctypes.c_double),
                       ptr(var, c_long), ptr(blk, c_long), ptr(row, c_long),
                       ptr(col, c_long), ptr(val, ctypes.c_double),
                       ptr(ii, c_long), ptr(rr, c_long))
    if rc != 0:
        return None
    return bs, obj, var, blk, row, col, val, ii, rr
