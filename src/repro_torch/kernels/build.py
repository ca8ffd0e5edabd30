"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled at
first use into ``build/kernels/lib<name>-<hash>.so`` under the repository
root, for ``sm_90a`` (Hopper). The hash covers the sources and the flags,
so an edited kernel is rebuilt and a stale library is never loaded. A
build writes to a temporary name and renames it into place, so processes
that build at once do not read a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_loaded: dict[str, tuple[ctypes.CDLL, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name in _loaded:
            return _loaded[name][0]
        src = CSRC / f"{name}.cu"
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.glob("*.cu*")):
            h.update(f.name.encode() + f.read_bytes())
        lib_path = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
        log_path = lib_path.with_suffix(".log")
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            r = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
            log_path.write_text(r.stdout + r.stderr)
            os.replace(tmp, lib_path)
        log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = (lib, log)
        return lib


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (the ``-Xptxas -v`` register and
    shared-memory report), after ``load(name)``."""
    return _loaded[name][1]
