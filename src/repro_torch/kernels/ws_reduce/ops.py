"""Public wrapper for the CUDA weighted-sum bank-reduction kernel.

On a CUDA tensor :func:`ws_reduce` launches the hand-written kernel
(``csrc/ws_reduce.cu``, built at first use) on the current stream and
raises if the build or the launch fails.  The kernel reads float32 or
float64 banks and weights as they are and does the cast and the
``nan_to_num`` itself, so the wrapper issues no PyTorch op before the
launch but the output's allocation.  On a CPU tensor it runs the plain
PyTorch version (``ref.py``) after the same cast and ``nan_to_num``,
because the host has no kernel to launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from .._build import load
from .ref import ws_reduce_ref

__all__ = ["ws_reduce", "ws_reduce_ref", "LAUNCHES", "SOURCES"]

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ws_reduce.cu",)
MAX_K = 8
# Element types the kernel reads directly (F and W share one); others are
# cast to float32.
_TYPE_CODES = {torch.float32: 0, torch.float64: 1}

# Kernel launches made by this process (CUDA tensors only).
LAUNCHES = 0


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process."""
    fn = load("ws_reduce", SOURCES).ws_reduce_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ws_reduce(F: torch.Tensor, W: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, B, k ≤ 8) banks × (nw, k) weights → (vals, idx), each (nw, m).

    ``vals`` is the least float32 score ``W[w] · F[i, b]`` over ``b`` and
    ``idx`` (int32) its first index.  Like the reference wrapper, ``F`` is
    cast to float32 and passed through ``nan_to_num(posinf=1e30)`` first
    (on the card inside the kernel), so a +inf (padded) slot never wins
    over a finite one and a bank of padding alone returns index 0.
    """
    global LAUNCHES
    if F.dim() != 3 or not 1 <= F.shape[2] <= MAX_K or F.shape[1] == 0:
        raise ValueError(f"F must be (m, B >= 1, k) with 1 <= k <= {MAX_K}, "
                         f"got {tuple(F.shape)}")
    m, B, k = F.shape
    if W.dim() != 2 or W.shape[1] != k or W.shape[0] == 0:
        raise ValueError(f"W must be (nw >= 1, {k}), got {tuple(W.shape)}")
    if not (F.is_floating_point() and W.is_floating_point()):
        raise TypeError(f"F and W must be floating point, got {F.dtype} "
                        f"and {W.dtype}")
    if W.device != F.device:
        raise ValueError(f"F on {F.device} but W on {W.device}")
    nw = W.shape[0]
    if F.device.type == "cpu":
        return ws_reduce_ref(
            torch.nan_to_num(F.to(torch.float32), posinf=1e30),
            W.to(torch.float32))
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    if F.dtype not in _TYPE_CODES:
        F = F.to(torch.float32)
    if W.dtype != F.dtype:
        # Exact for float32 -> float64; float64 -> float32 rounds as the
        # kernel would.
        W = W.to(F.dtype)
    if not F.is_contiguous():
        F = F.contiguous()
    if not W.is_contiguous():
        W = W.contiguous()
    vals = torch.empty((nw, m), dtype=torch.float32, device=F.device)
    idx = torch.empty((nw, m), dtype=torch.int32, device=F.device)
    if m == 0:
        return vals, idx
    launch = _launch_fn()
    with torch.cuda.device(F.device):
        err = launch(F.data_ptr(), W.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), m, B, k, nw, _TYPE_CODES[F.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ws_reduce launch failed: CUDA error {err}")
    LAUNCHES += 1
    return vals, idx
