"""Native runtime pieces: ctypes loader for the C++ tokenizer/hasher.

The shared library is built once on demand with g++ (-O3, no external
dependencies) and cached next to the source; every caller must tolerate
`lib() is None` and fall back to the pure-Python implementation — the
native path is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "tokenize_hash.cc"
_SO = _HERE / "_tokenize_hash.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    try:
        result = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(_SO)],
            capture_output=True,
            timeout=120,
        )
        return result.returncode == 0
    except Exception:
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL | None:
    try:
        if lib.th_abi_version() != 1:
            return None
    except Exception:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.th_count_tokens.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64, i64p]
    lib.th_count_tokens.restype = None
    lib.th_hash_tokens.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int32, i32p, f32p, i32p,
    ]
    lib.th_hash_tokens.restype = None
    return lib


def lib() -> ctypes.CDLL | None:
    """The loaded native library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("C99VDB_NO_NATIVE"):
            return None
        if not _SO.exists() and not _build():
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(_SO)))
        except OSError:
            _lib = None
        return _lib
