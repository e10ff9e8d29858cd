"""Public wrapper for the CUDA Pareto-filter kernel.

On a CUDA tensor :func:`pareto_filter` launches the hand-written kernel
(``csrc/pareto_filter.cu``, built at first use) on the current stream and
raises if the build or the launch fails.  On a CPU tensor it runs the plain
PyTorch version (``ref.py``), because the host has no kernel to launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .._build import load
from .ref import pareto_mask_ref

__all__ = ["pareto_filter", "pareto_mask_ref", "LAUNCHES", "SOURCES"]

SOURCES = (Path(__file__).resolve().parent / "csrc" / "pareto_filter.cu",)
MAX_K = 8

# Kernel launches made by this process (CUDA tensors only).
LAUNCHES = 0


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process
    (hashing the sources on every call would cost more than the kernel)."""
    fn = load("pareto_filter", SOURCES).pareto_filter_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pareto_filter(F: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean non-dominated mask of (n, k ≤ 8) minimization objectives.

    ``F`` is cast to float32 before comparing.  ``valid`` (n,) bool
    defaults to the rows whose entries are all finite.
    """
    global LAUNCHES
    if F.dim() != 2 or not 1 <= F.shape[1] <= MAX_K:
        raise ValueError(f"F must be (n, k) with 1 <= k <= {MAX_K}, got "
                         f"{tuple(F.shape)}")
    if not F.is_floating_point():
        raise TypeError(f"F must be floating point, got {F.dtype}")
    n, k = F.shape
    if valid is None:
        valid = torch.isfinite(F).all(-1)
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({n},) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != F.device:
        raise ValueError(f"F on {F.device} but valid on {valid.device}")
    if F.device.type == "cpu":
        return pareto_mask_ref(F, valid)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    F32 = F.to(torch.float32).contiguous()
    v8 = valid.contiguous().view(torch.uint8)
    out = torch.empty(n, dtype=torch.bool, device=F.device)
    if n == 0:
        return out
    launch = _launch_fn()
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = launch(F32.data_ptr(), v8.data_ptr(), out.data_ptr(), n, k,
                     stream)
    if err != 0:
        raise RuntimeError(f"pareto_filter launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
