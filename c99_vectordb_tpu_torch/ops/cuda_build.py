"""Build and load the port's hand-written CUDA sources (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, keyed by a hash of the source and of the shared headers
(csrc/*.cuh), into `_build/`, and
loaded with ctypes. Nothing is built at import: the first launch of a
kernel (or an explicit `build`) compiles it, and a missing nvcc or a
failed build raises there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); "
            "it is needed to build the port's CUDA kernels"
        )
    return found


def source_path(name: str) -> Path:
    """csrc/<name>.cu"""
    return CSRC / f"{name}.cu"


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared headers a source may include
        h.update(header.read_bytes())
    for d in defines:
        h.update(b"\0" + d.encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def ptxas_log(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The `-Xptxas -v` report written beside the library by `build`."""
    path = library_path(name, defines)
    return path.with_name(path.stem + ".ptxas.txt")


def build(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, float]:
    """Compile csrc/<name>.cu if its library (keyed by the source and the
    preprocessor `defines`, each "NAME=VALUE", used only by diagnostic
    builds) is missing. Returns (library path, seconds spent compiling;
    0.0 when cached). Raises if nvcc is missing or the build fails. Builds
    may run in parallel threads (each runs its own nvcc)."""
    out = library_path(name, defines)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    src = source_path(name)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *(f"-D{d}" for d in defines),
        "-o", str(tmp), str(src),
    ]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {src.name} (exit {res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    ptxas_log(name, defines).write_text(res.stderr)
    tmp.replace(out)
    return out, seconds


def load(name: str, abi_symbol: str, abi_version: int, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process, check its
    ABI version, and set each exported function's (argtypes, restype)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            if getattr(lib, abi_symbol)() != abi_version:
                raise RuntimeError(f"{path.name}: unexpected ABI version")
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
    return lib
