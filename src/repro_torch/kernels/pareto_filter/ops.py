"""Public wrappers for the CUDA Pareto-filter kernel.

One kernel (``csrc/pareto_filter.cu``, built at first use) filters S
independent segments in one launch.  :func:`pareto_filter_segments` takes
the (S, n, k) stack; :func:`pareto_filter` is one (n, k) mask, the same
kernel with S = 1.  On a CUDA tensor each launches the kernel on the
current stream and raises if the build or the launch fails.  On a CPU
tensor each runs the plain PyTorch version (``ref.py``), because the host
has no kernel to launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .._build import load
from .ref import pareto_mask_ref, pareto_masks_ref

__all__ = ["pareto_filter", "pareto_filter_segments", "pareto_mask_ref",
           "pareto_masks_ref", "LAUNCHES", "SOURCES"]

SOURCES = (Path(__file__).resolve().parent / "csrc" / "pareto_filter.cu",)
MAX_K = 8

# Kernel launches made by this process (CUDA tensors only), one per call
# whatever the number of segments.
LAUNCHES = 0


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process
    (hashing the sources on every call would cost more than the kernel)."""
    fn = load("pareto_filter", SOURCES).pareto_filter_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_objectives(F: torch.Tensor, dims: int, shape: str) -> None:
    if F.dim() != dims or not 1 <= F.shape[-1] <= MAX_K:
        raise ValueError(f"F must be {shape} with 1 <= k <= {MAX_K}, got "
                         f"{tuple(F.shape)}")
    if not F.is_floating_point():
        raise TypeError(f"F must be floating point, got {F.dtype}")


def pareto_filter_segments(F: torch.Tensor,
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(S, n) boolean non-dominated masks of S independent (n, k ≤ 8)
    minimization segments, in one launch.

    ``F`` is cast to float32 before comparing.  ``valid`` (S, n) bool
    defaults to the rows whose entries are all finite.  A row is compared
    only with the rows of its own segment, so ragged segments are padded
    with invalid rows.
    """
    global LAUNCHES
    _check_objectives(F, 3, "(S, n, k)")
    S, n, k = F.shape
    if valid is None:
        valid = torch.isfinite(F).all(-1)
    if valid.shape != (S, n) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({S}, {n}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != F.device:
        raise ValueError(f"F on {F.device} but valid on {valid.device}")
    if F.device.type == "cpu":
        return pareto_masks_ref(F, valid)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    F32 = F.to(torch.float32).contiguous()
    v8 = valid.contiguous().view(torch.uint8)
    out = torch.empty((S, n), dtype=torch.bool, device=F.device)
    if S * n == 0:
        return out
    launch = _launch_fn()
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = launch(F32.data_ptr(), v8.data_ptr(), out.data_ptr(), S, n, k,
                     stream)
    if err != 0:
        raise RuntimeError(f"pareto_filter launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def pareto_filter(F: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean non-dominated mask of (n, k ≤ 8) minimization objectives:
    :func:`pareto_filter_segments` of one segment."""
    _check_objectives(F, 2, "(n, k)")
    n = F.shape[0]
    if valid is not None and (valid.shape != (n,)
                              or valid.dtype != torch.bool):
        raise ValueError(f"valid must be ({n},) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    return pareto_filter_segments(
        F[None], None if valid is None else valid[None])[0]
