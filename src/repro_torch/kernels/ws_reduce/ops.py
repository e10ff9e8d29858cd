"""Public wrappers for the CUDA weighted-sum kernels.

On a CUDA tensor :func:`ws_reduce` launches the hand-written bank-reduction
kernel (``csrc/ws_reduce.cu``, built at first use) on the current stream
and raises if the build or the launch fails.  The kernel reads float32 or
float64 banks and weights as they are and does the cast and the
``nan_to_num`` itself, so the wrapper issues no PyTorch op before the
launch but the output's allocation.  On a CPU tensor it runs the plain
PyTorch version (``ref.py``) after the same cast and ``nan_to_num``,
because the host has no kernel to launch.

:func:`runtime_pick` makes a runtime round's weighted picks: one C call
enqueues ``csrc/runtime_pick.cu``'s two kernels (a block a set, then a
block a weight group), which prefilter, normalise and pick every candidate
set of the round on the card.  It takes and returns device tensors and
never synchronises.  Both sources build into one library.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import load
from .ref import runtime_pick_ref, ws_reduce_ref

__all__ = ["ws_reduce", "ws_reduce_ref", "runtime_pick", "runtime_pick_ref",
           "LAUNCHES", "RUNTIME_PICK_LAUNCHES", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "ws_reduce.cu", _CSRC / "runtime_pick.cu")
MAX_K = 8
# Element types the kernel reads directly (F and W share one); others are
# cast to float32.
_TYPE_CODES = {torch.float32: 0, torch.float64: 1}

# Kernel launches made by this process (CUDA tensors only): ws_reduce's
# and runtime_pick's.
LAUNCHES = 0
RUNTIME_PICK_LAUNCHES = 0


@functools.cache
def _launch_fn():
    """ws_reduce's C launch function, built and loaded once per process."""
    fn = load("ws_reduce", SOURCES).ws_reduce_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _pick_fn():
    """runtime_pick's C launch function, from the same library."""
    fn = load("ws_reduce", SOURCES).runtime_pick_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
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


def _scratch_bytes(R: int, k: int, total: int) -> int:
    """Device scratch of one runtime_pick call (runtime_pick.cu's
    ``scratch_bytes``)."""
    return total * (40 * k + 1) + 24 * R


def _clamp(n: int) -> int:
    return max(-(1 << 63), min(int(n), (1 << 63) - 1))


def runtime_pick(F: torch.Tensor, offsets: torch.Tensor, gid: torch.Tensor,
                 W: torch.Tensor, *, kernel_min_n: int, ws_min_scores: int,
                 max_n: Optional[int] = None) -> torch.Tensor:
    """A runtime round's weighted picks → (R + G,) int32 on F's device.

    ``F`` (total, k <= 8) float64 holds the round's R nonempty candidate
    sets one after another, set r in rows ``offsets[r]:offsets[r + 1]``
    (``offsets``: (R + 1,) int32 from 0 to total); ``gid`` (R,) int32
    names each set's weight group, a row of ``W`` (G, k) float64.  The
    result holds each set's picked row (-1 where a padding slot of its
    group's bank won) and then each group's route: 1 float32, 0 float64
    below ``ws_min_scores``, 2 float64 for a float32 tie.  Sets of at
    least ``kernel_min_n`` rows are prefiltered to their non-dominated
    rows (``runtime_pick_ref`` states the whole function).  ``max_n``, the
    largest set's row count (``total`` if not given), sizes the kernel's
    staging buffer.

    On the card one C call enqueues both kernels on the current stream;
    nothing is read back.  On the host it runs the plain version.
    """
    global RUNTIME_PICK_LAUNCHES
    if F.dim() != 2 or not 1 <= F.shape[1] <= MAX_K \
            or F.dtype != torch.float64:
        raise ValueError(f"F must be (total, k <= {MAX_K}) float64, got "
                         f"{tuple(F.shape)} {F.dtype}")
    total, k = F.shape
    R = gid.numel()
    if gid.dim() != 1 or R == 0 or offsets.shape != (R + 1,) \
            or offsets.dtype != torch.int32 or gid.dtype != torch.int32:
        raise ValueError(f"offsets must be (R + 1,) and gid (R >= 1,) int32, "
                         f"got {tuple(offsets.shape)} {offsets.dtype} and "
                         f"{tuple(gid.shape)} {gid.dtype}")
    if W.dim() != 2 or W.shape[0] == 0 or W.shape[1] != k \
            or W.dtype != torch.float64:
        raise ValueError(f"W must be (G >= 1, {k}) float64, got "
                         f"{tuple(W.shape)} {W.dtype}")
    if len({t.device for t in (F, offsets, gid, W)}) != 1:
        raise ValueError("F, offsets, gid and W must lie on one device")
    G = W.shape[0]
    if F.device.type == "cpu":
        off = offsets.tolist()
        if off[0] != 0 or off[-1] != total \
                or any(b <= a for a, b in zip(off, off[1:])):
            raise ValueError("offsets must rise from 0 to total, every set "
                             "nonempty")
        return runtime_pick_ref(F, offsets, gid, W, kernel_min_n,
                                ws_min_scores)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    F, offsets, gid, W = (t.contiguous() for t in (F, offsets, gid, W))
    head = -(-4 * (R + G) // 8) * 8
    scratch = _scratch_bytes(R, k, total)
    buf = torch.empty(head + scratch, dtype=torch.uint8, device=F.device)
    out = buf[:4 * (R + G)].view(torch.int32)
    launch = _pick_fn()
    # Switching devices costs as much as the checks above; most calls are
    # on the current one.
    guard = (contextlib.nullcontext()
             if F.device.index == torch.cuda.current_device()
             else torch.cuda.device(F.device))
    with guard:
        err = launch(F.data_ptr(), offsets.data_ptr(), gid.data_ptr(),
                     W.data_ptr(), out.data_ptr(), buf.data_ptr() + head,
                     scratch, R, G, k, total,
                     total if max_n is None else int(max_n),
                     _clamp(kernel_min_n), _clamp(ws_min_scores),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"runtime_pick launch failed: CUDA error {err}")
    RUNTIME_PICK_LAUNCHES += 1
    return out
