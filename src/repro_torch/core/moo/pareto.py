"""Pareto-set primitives used throughout HMOOC.

All objective arrays are *minimization* problems of shape ``(n, k)``.
Padded / invalid entries are handled through explicit validity masks.

Two implementations of dominance filtering are provided:

* :func:`pareto_mask_np` — plain numpy in float64, host-side.
* ``repro_torch.kernels.pareto_filter`` — the CUDA kernel with the same
  semantics, comparing in float32 (imported lazily in
  :func:`_pareto_mask_kernel`).

:func:`pareto_mask_fast` routes between them.  Also includes Kung's
O(n log n) algorithm for k=2 (host-side oracle) and hypervolume
computation used by the benchmarks.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device

__all__ = [
    "pareto_mask_np",
    "pareto_mask_fast",
    "kung_2d_np",
    "filter_dominated_np",
    "hypervolume_2d",
    "hypervolume",
]

# Row count at or above which dominance masks route to the kernel.  None =
# resolve from the env var / device per call (tests monkeypatch this
# directly).
_KERNEL_MIN_N = None


def _default_kernel_min_n(device: torch.device) -> int:
    # Read per call, never cached: REPRO_PARETO_KERNEL_MIN_N flipped after
    # import (tests, operators re-tuning a live process) must take effect.
    # On the card every nonempty mask goes to the kernel until the H100's
    # own crossover is measured; on the host the float64 numpy path stays
    # the default (the CPU wrapper would only run the plain version).
    return int(os.environ.get(
        "REPRO_PARETO_KERNEL_MIN_N",
        "0" if device.type == "cuda" else str(1 << 30)))


# ---------------------------------------------------------------------------
# numpy implementations (host-side, dynamic shapes)
# ---------------------------------------------------------------------------

def pareto_mask_np(F: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Numpy dominance mask; O(n log n) sweep for k=2, O(n² k) otherwise."""
    F = np.asarray(F, dtype=np.float64)
    n = F.shape[0]
    if valid is None:
        valid = np.isfinite(F).all(-1)
    else:
        valid = np.asarray(valid, bool) & np.isfinite(F).all(-1)
    if n == 0:
        return valid
    if F.shape[1] == 2 and n > 64:
        return _pareto_mask_2d_np(F, valid)
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    dom = ((le & lt) & valid[:, None]).any(0)
    return valid & ~dom


def _pareto_mask_2d_np(F: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """O(n log n) two-objective dominance mask (duplicate optima survive)."""
    n = F.shape[0]
    mask = np.zeros(n, bool)
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return mask
    order = idx[np.lexsort((F[idx, 1], F[idx, 0]))]
    f0 = F[order, 0]
    f1 = F[order, 1]
    # Group by distinct f0; group minimum of f1 (within-group dominance).
    new_grp = np.empty(order.size, bool)
    new_grp[0] = True
    new_grp[1:] = f0[1:] != f0[:-1]
    grp = np.cumsum(new_grp) - 1
    n_grp = grp[-1] + 1
    grp_min = np.full(n_grp, np.inf)
    np.minimum.at(grp_min, grp, f1)
    # Running strict-prefix min of f1 over earlier (strictly smaller f0) groups.
    prev_best = np.empty(n_grp)
    prev_best[0] = np.inf
    if n_grp > 1:
        prev_best[1:] = np.minimum.accumulate(grp_min)[:-1]
    keep = (f1 == grp_min[grp]) & (f1 < prev_best[grp])
    mask[order[keep]] = True
    return mask


def pareto_mask_fast(F: np.ndarray, valid: Optional[np.ndarray] = None, *,
                     device=None) -> np.ndarray:
    """Dominance mask dispatcher: the CUDA kernel on the card, numpy below
    the routing threshold.

    Same semantics as :func:`pareto_mask_np`.  ``device`` (``None`` = the
    CUDA card) decides where the kernel route runs and the default
    threshold: 0 on ``cuda`` (every nonempty mask), ``1 << 30`` on ``cpu``
    (the float64 numpy path); ``REPRO_PARETO_KERNEL_MIN_N`` overrides both.
    Rows are bucket-padded to a power of two before the kernel.  The kernel
    compares in float32; the numpy route keeps float64.

    Routing is tie-tolerant: when any objective column holds values that
    are distinct in float64 but collide after the kernel's float32 cast,
    the dominance relation itself would change under the cast (a strictly
    dominated point can tie its dominator and survive), so such inputs
    take the float64 numpy path regardless of size.  This keeps the mask a
    pure function of the input values rather than of the route the batch
    happened to take.
    """
    device = resolve_device(device)
    F = np.asarray(F, np.float64)
    n = F.shape[0]
    thr = _KERNEL_MIN_N if _KERNEL_MIN_N is not None \
        else _default_kernel_min_n(device)
    if n < thr or n == 0:
        return pareto_mask_np(F, valid)
    if _f32_tie_hazard(F):
        return pareto_mask_np(F, valid)
    return _pareto_mask_kernel(F, valid, device)


def _f32_tie_hazard(F: np.ndarray) -> bool:
    """True if float64-distinct values in some column tie as float32."""
    for j in range(F.shape[1]):
        col = F[:, j]
        u = np.unique(col[np.isfinite(col)])
        if np.unique(u.astype(np.float32)).size < u.size:
            return True
    return False


def _pareto_mask_kernel(F: np.ndarray, valid: Optional[np.ndarray],
                        device: torch.device) -> np.ndarray:
    from ...kernels.pareto_filter import pareto_filter  # lazy: kernel layer
    n, k = F.shape
    if valid is None:
        v = np.isfinite(F).all(-1)
    else:
        v = np.asarray(valid, bool) & np.isfinite(F).all(-1)
    bucket = max(128, 1 << int(np.ceil(np.log2(max(n, 2)))))
    Fp = np.full((bucket, k), np.inf, np.float32)
    Fp[:n] = np.where(np.isfinite(F), F, np.inf)
    vp = np.zeros(bucket, bool)
    vp[:n] = v
    mask = pareto_filter(torch.from_numpy(Fp).to(device),
                         torch.from_numpy(vp).to(device))
    return mask[:n].cpu().numpy()


def kung_2d_np(F: np.ndarray) -> np.ndarray:
    """Kung's O(n log n) Pareto mask for k=2 minimization (numpy, oracle)."""
    F = np.asarray(F, dtype=np.float64)
    n = F.shape[0]
    mask = np.zeros(n, bool)
    finite = np.isfinite(F).all(-1)
    idx = np.nonzero(finite)[0]
    if idx.size == 0:
        return mask
    # sort by (f0 asc, f1 asc); sweep keeping running min of f1
    order = idx[np.lexsort((F[idx, 1], F[idx, 0]))]
    best = np.inf
    for i in order:
        if F[i, 1] < best:
            mask[i] = True
            best = F[i, 1]
    # Equal points: the sweep keeps the first of duplicates only, which is a
    # valid Pareto subset; mark exact duplicates of kept points as optimal too.
    kept = F[mask]
    for i in idx:
        if not mask[i] and kept.size and (kept == F[i]).all(-1).any():
            mask[i] = True
    return mask


def filter_dominated_np(
    F: np.ndarray, payload: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Return the non-dominated subset of F (and aligned payload rows)."""
    m = pareto_mask_np(F)
    if payload is None:
        return F[m], None
    return F[m], payload[m]


# ---------------------------------------------------------------------------
# Hypervolume (benchmark metric; paper's HV)
# ---------------------------------------------------------------------------

def hypervolume_2d(F: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-objective hypervolume dominated by F w.r.t. reference point.

    Points not dominating ``ref`` contribute nothing.
    """
    F = np.asarray(F, np.float64)
    ref = np.asarray(ref, np.float64)
    if F.size == 0:
        return 0.0
    F = F[np.isfinite(F).all(-1)]
    F = F[(F < ref).all(-1)]
    if F.shape[0] == 0:
        return 0.0
    m = pareto_mask_np(F)
    P = np.unique(F[m], axis=0)  # sorted by f0 asc then f1 asc
    hv = 0.0
    prev_f1 = ref[1]
    for f0, f1 in P:
        if f1 < prev_f1:
            hv += (ref[0] - f0) * (prev_f1 - f1)
            prev_f1 = f1
    return float(hv)


def hypervolume(F: np.ndarray, ref: np.ndarray, n_mc: int = 200_000, seed: int = 0) -> float:
    """Hypervolume for k objectives: exact for k=2, Monte-Carlo otherwise."""
    F = np.asarray(F, np.float64)
    ref = np.asarray(ref, np.float64)
    if F.shape[-1] == 2:
        return hypervolume_2d(F, ref)
    F = F[np.isfinite(F).all(-1)]
    F = F[(F < ref).all(-1)]
    if F.shape[0] == 0:
        return 0.0
    lo = F.min(0)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, ref, size=(n_mc, F.shape[1]))
    dominated = np.zeros(n_mc, bool)
    for f in F:
        dominated |= (pts >= f).all(-1)
    box = np.prod(ref - lo)
    return float(box * dominated.mean())
