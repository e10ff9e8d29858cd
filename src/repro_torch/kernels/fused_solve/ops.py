"""Public wrapper for the fused HMOOC2 aggregation kernel.

:func:`fused_ws_front` takes and returns numpy, like the reference's.  On
the card it launches the hand-written kernel (``csrc/fused_solve.cu``,
built at first use) and then the ``pareto_filter`` kernel over every
(candidate, weight) point, both on the current stream, and raises if a
build or a launch fails.  On the host (``device="cpu"``) it runs the plain
PyTorch version (``ref.py``), because the host has no kernel to launch.

Nothing is padded: the kernel takes any N and m, so the reference's
power-of-two buckets (which bounded its jit's compiled shapes) have no
counterpart.  The reference's padded candidates (+inf banks, never valid)
and padded subQs (zero banks, adding zero to every sum) never changed its
result, so the unpadded outputs are the same.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ...device import resolve_device
from .._build import load
from ..pareto_filter.ops import pareto_filter
from .ref import fused_ws_front_ref

__all__ = ["fused_ws_front", "fused_ws_front_ref", "LAUNCHES", "SOURCES"]

SOURCES = (Path(__file__).resolve().parent / "csrc" / "fused_solve.cu",)
MAX_K = 8

# Kernel launches made by this process (CUDA only; the pareto_filter launch
# that follows each one counts in that kernel's own LAUNCHES).
LAUNCHES = 0


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process."""
    fn = load("fused_solve", SOURCES).fused_ws_front_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_ws_front(Fn: np.ndarray, F_bank: np.ndarray, W: np.ndarray, *,
                   device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, m, B, k) normalized scores + raw banks + (nw, k) weights →
    (jj (N, nw, m) picks, P_all (N, nw, k) objective sums, keep (N, nw)).

    ``keep`` composes validity, the per-candidate dominance mask over the
    weight picks, and the global Pareto filter across all candidates —
    ``P_all[keep]`` is the query-level front, already globally filtered.
    Scores and the global filter compare in float32 (``Fn`` is cast and
    passed through ``nan_to_num(posinf=1e30)``, as the reference's
    ``ws_reduce`` does); the sums and the per-candidate mask keep float64.
    ``device`` (``None`` = the CUDA card) is where the work runs.
    """
    global LAUNCHES
    device = resolve_device(device)
    Fb = np.ascontiguousarray(F_bank, np.float64)
    if Fb.ndim != 4 or min(Fb.shape) == 0 or Fb.shape[3] > MAX_K:
        raise ValueError(f"F_bank must be (N, m, B, k <= {MAX_K}) and "
                         f"nonempty, got {Fb.shape}")
    N, m, B, k = Fb.shape
    if np.shape(Fn) != Fb.shape:
        raise ValueError(f"Fn {np.shape(Fn)} and F_bank {Fb.shape} differ")
    W32 = np.ascontiguousarray(W, np.float32)
    if W32.ndim != 2 or W32.shape[1] != k or W32.shape[0] == 0:
        raise ValueError(f"W must be (nw >= 1, {k}), got {W32.shape}")
    nw = W32.shape[0]
    Fn32 = np.nan_to_num(np.asarray(Fn, np.float32), posinf=1e30)
    Fn_t, Fb_t, W_t = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in (Fn32, Fb, W32))
    if device.type == "cpu":
        jj, P_all, keep = fused_ws_front_ref(Fn_t, Fb_t, W_t)
        return jj.numpy(), P_all.numpy(), keep.numpy()
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    jj = torch.empty((N, nw, m), dtype=torch.int32, device=device)
    P_all = torch.empty((N, nw, k), dtype=torch.float64, device=device)
    P32 = torch.empty((N, nw, k), dtype=torch.float32, device=device)
    valid = torch.empty((N, nw), dtype=torch.bool, device=device)
    launch = _launch_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(Fn_t.data_ptr(), Fb_t.data_ptr(), W_t.data_ptr(),
                     jj.data_ptr(), P_all.data_ptr(), P32.data_ptr(),
                     valid.data_ptr(), N, m, B, k, nw, stream)
    if err != 0:
        raise RuntimeError(f"fused_ws_front launch failed: CUDA error {err}")
    LAUNCHES += 1
    keep = pareto_filter(P32.view(N * nw, k), valid.view(N * nw))
    return (jj.cpu().numpy(), P_all.cpu().numpy(),
            keep.view(N, nw).cpu().numpy())
