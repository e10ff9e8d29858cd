"""Build-at-first-use for the port's CUDA kernels.

Each kernel is a ``.cu`` file with a plain ``extern "C"`` launch function.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root (git-ignored) and loaded
with ``ctypes``.  The library's file name carries a hash of its sources and
flags, so an edited source always rebuilds and a stale library is never
loaded.  Nothing is compiled or loaded at import: only :func:`load` does,
and only on a host that launches the kernel.

This is a module and not a kernel package: kernel packages are the
directories beside it with an ``ops.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "load"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the library for these sources lives (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library ``name``.

    Raises ``RuntimeError`` with the compiler's output when ``nvcc`` fails.
    Concurrent builds are safe: each compiles to its own temporary file
    and renames it into place.
    """
    lib_path = library_path(name, sources)
    if not lib_path.is_file():
        nvcc = _nvcc()
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
