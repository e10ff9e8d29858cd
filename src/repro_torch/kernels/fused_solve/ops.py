"""Public wrapper for the fused HMOOC2 aggregation kernel.

:func:`fused_ws_front` takes tensors (or numpy arrays) and returns tensors
on the device it ran on; it never synchronises, so the caller decides when
to read the results back.  On the card one ctypes call enqueues the
hand-written kernel (``csrc/fused_solve.cu``, built at first use) and the
``pareto_filter`` kernel over every (candidate, weight) point, both on the
current stream, and the wrapper raises if a build or a launch fails.  With
``Fn=None`` the kernel normalises the bank itself, so a caller that stages
its bank on the card once pays one copy in and one copy back.  On the host
(``device="cpu"``) it runs the plain PyTorch version (``ref.py``), because
the host has no kernel to launch.

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
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .._build import load
from ..pareto_filter import ops as pareto_ops
from .ref import fused_ws_front_ref, hmooc2_scores_ref

__all__ = ["fused_ws_front", "fused_ws_front_ref", "hmooc2_scores_ref",
           "LAUNCHES", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
# The global filter's kernel is compiled into this library, so one C call
# enqueues both launches.
SOURCES = (_CSRC / "fused_solve.cu",
           _CSRC.parents[1] / "pareto_filter" / "csrc" / "pareto_filter.cu")
MAX_K = 8

# Kernel launches made by this process (CUDA only; the pareto_filter launch
# that follows each one counts in that kernel's own LAUNCHES).
LAUNCHES = 0


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process."""
    fn = load("fused_solve", SOURCES).fused_ws_front_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _as(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array-like) as a contiguous ``dtype`` tensor on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    # repro_torch: allow[TH002] a blocking copy only for numpy inputs; the HMOOC2 aggregation hands K3 the bank and weights already staged on the card (one pinned copy), so its K3 call copies nothing here
    return x.to(device=device, dtype=dtype).contiguous()


def fused_ws_front(Fn: Optional[torch.Tensor], F_bank: torch.Tensor,
                   W: torch.Tensor, *, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, m, B, k) scores (or ``None``) + raw banks + (nw, k) weights →
    (jj (N, nw, m) int32 picks, P_all (N, nw, k) float64 objective sums,
    keep (N, nw) bool), tensors on ``device``.

    ``keep`` composes validity, the per-candidate dominance mask over the
    weight picks, and the global Pareto filter across all candidates —
    ``P_all[keep]`` is the query-level front, already globally filtered.
    ``Fn=None`` scores the bank normalised per candidate and objective, as
    the HMOOC2 solver does (``ref.hmooc2_scores_ref``).  Scores and the
    global filter compare in float32 (a given ``Fn`` is cast and passed
    through ``nan_to_num(posinf=1e30)``, as the reference's ``ws_reduce``
    does); the sums and the per-candidate mask keep float64.  Inputs may
    be tensors anywhere or numpy arrays; ``device`` (``None`` = the CUDA
    card) is where the work runs.
    """
    global LAUNCHES
    device = resolve_device(device)
    Fb = _as(F_bank, torch.float64, device)
    if Fb.dim() != 4 or Fb.numel() == 0 or Fb.shape[3] > MAX_K:
        raise ValueError(f"F_bank must be (N, m, B, k <= {MAX_K}) and "
                         f"nonempty, got {tuple(Fb.shape)}")
    N, m, B, k = Fb.shape
    if Fn is not None:
        Fn = _as(Fn, torch.float32, device)
        if Fn.shape != Fb.shape:
            raise ValueError(f"Fn {tuple(Fn.shape)} and F_bank "
                             f"{tuple(Fb.shape)} differ")
    W = _as(W, torch.float64, device)
    if W.dim() != 2 or W.shape[1] != k or W.shape[0] == 0:
        raise ValueError(f"W must be (nw >= 1, {k}), got {tuple(W.shape)}")
    nw = W.shape[0]
    if device.type == "cpu":
        return fused_ws_front_ref(Fn, Fb, W)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    jj = torch.empty((N, nw, m), dtype=torch.int32, device=device)
    P_all = torch.empty((N, nw, k), dtype=torch.float64, device=device)
    P32 = torch.empty((N, nw, k), dtype=torch.float32, device=device)
    valid = torch.empty((N, nw), dtype=torch.bool, device=device)
    keep = torch.empty((N, nw), dtype=torch.bool, device=device)
    launch = _launch_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(None if Fn is None else Fn.data_ptr(), Fb.data_ptr(),
                     W.data_ptr(), jj.data_ptr(), P_all.data_ptr(),
                     P32.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                     N, m, B, k, nw, stream)
    if err != 0:
        raise RuntimeError(f"fused_ws_front launch failed: CUDA error {err}")
    LAUNCHES += 1
    pareto_ops.LAUNCHES += 1
    return jj, P_all, keep
