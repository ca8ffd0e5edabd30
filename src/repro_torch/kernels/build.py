"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled at
first use into ``build/kernels/lib<name>-<hash>.so`` under the repository
root, for ``sm_90a`` (Hopper); ``load_all`` builds several sources at
once, one ``nvcc`` process each. The hash covers the sources and the flags,
so an edited kernel is rebuilt and a stale library is never loaded. A
build writes to a temporary name and renames it into place, so processes
that build at once do not read a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

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


def _lib_paths(names) -> dict[str, Path]:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    return {name: BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
            for name in names}


def load_all(names: list[str]) -> list[ctypes.CDLL]:
    """The shared libraries built from ``csrc/<name>.cu`` for each name,
    the missing ones built at once, one ``nvcc`` process a source."""
    with _lock:
        paths = _lib_paths(n for n in names if n not in _loaded)
        builds = []
        for name, lib_path in paths.items():
            if lib_path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src = CSRC / f"{name}.cu"
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            builds.append((src, proc, tmp, lib_path))
        failed = []
        for src, proc, tmp, lib_path in builds:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{out}")
                continue
            lib_path.with_suffix(".log").write_text(out)
            os.replace(tmp, lib_path)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, lib_path in paths.items():
            log_path = lib_path.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            _loaded[name] = (ctypes.CDLL(str(lib_path)), log)
        return [_loaded[name][0] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    return load_all([name])[0]


def cu_constant(name: str, constant: str) -> int:
    """The value of ``constexpr int <constant> = <value>;`` in
    ``csrc/<name>.cu``: a tile size the Python side shares with a kernel."""
    src = (CSRC / f"{name}.cu").read_text()
    return int(re.search(rf"constexpr int {constant} = (\d+);", src).group(1))


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (the ``-Xptxas -v`` register and
    shared-memory report), after ``load(name)``."""
    return _loaded[name][1]


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Grad mode is on and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def forbid_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where ``needs_grad(*tensors)``. A kernel writes its output
    through a raw pointer that autograd cannot see, so such a call would
    hand back an output with no gradient, and a backward would give the
    inputs none without a word. ``kernels/ops.py`` takes the kernels the
    model runs through an ``autograd.Function``, whose forward runs with
    grad mode off."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel's output would "
            f"have none; call it through repro_torch.kernels.ops (an "
            f"autograd.Function) or under torch.no_grad()")
