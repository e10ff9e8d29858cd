"""Pareto-set primitives used throughout HMOOC.

All objective arrays are *minimization* problems of shape ``(n, k)``.
Padded / invalid entries are handled through explicit validity masks.

Three implementations of dominance filtering are provided:

* :func:`pareto_mask` — chunked O(n² k) tensor function, O(n · chunk)
  memory, computed on the tensor's own device in its own dtype.
* :func:`pareto_mask_np` — plain numpy in float64, host-side.
* ``repro_torch.kernels.pareto_filter`` — the CUDA kernel with the same
  semantics, comparing in float32 (imported lazily in
  :func:`_pareto_masks_kernel`).

:func:`pareto_mask_fast` routes one mask between them and
:func:`pareto_masks_fast` a batch of independent banks, whose kernel route
is one launch.  Also includes Kung's
O(n log n) algorithm for k=2 (host-side oracle) and hypervolume
computation used by the benchmarks.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import tracing
from ...device import resolve_device

__all__ = [
    "pareto_mask",
    "pareto_mask_np",
    "pareto_mask_fast",
    "pareto_masks_fast",
    "kung_2d_np",
    "filter_dominated_np",
    "compact_bank",
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
# Tensor implementations (on the tensor's device)
# ---------------------------------------------------------------------------

def _dominated_by_block(Fj: torch.Tensor, F: torch.Tensor,
                        vj: torch.Tensor) -> torch.Tensor:
    """(n,) bool: row i of ``F`` is dominated by some valid row of the
    block ``Fj`` (c, k), that is F[j] <= F[i] in all objectives and < in
    one."""
    le = (Fj[:, None, :] <= F[None, :, :]).all(-1)   # (c, n)
    lt = (Fj[:, None, :] < F[None, :, :]).any(-1)    # (c, n)
    return ((le & lt) & vj[:, None]).any(0)


def pareto_mask(F: torch.Tensor, valid: Optional[torch.Tensor] = None,
                chunk: int = 256) -> torch.Tensor:
    """Boolean mask of Pareto-optimal (non-dominated) rows of ``F``.

    Args:
      F: (n, k) objective values, minimization.  Rows holding a non-finite
        value are never optimal.
      valid: optional (n,) bool; invalid rows are neither optimal nor
        dominate.
      chunk: dominators are taken ``chunk`` rows at a time, so memory is
        O(n * chunk).

    Computed where ``F`` lies, in its dtype, with no host synchronisation.
    """
    F = torch.as_tensor(F)
    ok = torch.isfinite(F).all(-1)
    if valid is not None:
        ok = ok & torch.as_tensor(valid, dtype=torch.bool, device=F.device)
    dom = torch.zeros(F.shape[0], dtype=torch.bool, device=F.device)
    for lo in range(0, F.shape[0], chunk):
        dom |= _dominated_by_block(F[lo:lo + chunk], F, ok[lo:lo + chunk])
    return ok & ~dom


def compact_bank(F: torch.Tensor, mask: torch.Tensor, p: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather up to ``p`` masked rows of ``F`` to the front, padding with
    +inf.

    Returns (Fout (p, k), valid (p,), idx (p,)) where idx are source row
    indices (arbitrary for padded slots): the masked rows first, in index
    order, then the others.  If more than ``p`` rows are masked the
    surplus is dropped in index order; with ``p`` above n every output
    holds n rows, as slicing does.
    """
    F = torch.as_tensor(F)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=F.device)
    # A stable sort of a bool tensor is not supported everywhere; its
    # uint8 view sorts the same.
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:p]
    take_valid = mask[idx]
    rows = F[idx]
    Fout = torch.where(take_valid[:, None], rows,
                       torch.full_like(rows, float("inf")))
    return Fout, take_valid, idx


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
    return pareto_masks_fast(
        [F], None if valid is None else [valid], device=device)[0]


def pareto_masks_fast(Fs: Sequence[np.ndarray],
                      valid: Optional[Sequence[Optional[np.ndarray]]] = None,
                      *, device=None) -> List[np.ndarray]:
    """Dominance masks of independent banks, the kernel route in one launch.

    Element for element equal to ``[pareto_mask_fast(F, v, device=device)
    for F, v in zip(Fs, valid)]``: routing stays per bank.  A bank below
    the threshold, empty, or flagged by the float32 tie check takes the
    float64 numpy path; the rest are padded with invalid rows to one
    power-of-two bucket (at least 128 rows), copied to the card in one
    transfer, filtered by one kernel launch and copied back once.  The
    per-bank host work (validity, padding, tie check) runs over the stack.
    Every bank holds (n_b, k) objectives with one k.
    """
    tr = tracing.TRACE
    if tr is not None:
        sp = tr.open("pareto_masks")
    device = resolve_device(device)
    Fs = [np.asarray(F, np.float64) for F in Fs]
    if valid is None:
        valid = [None] * len(Fs)
    elif len(valid) != len(Fs):
        raise ValueError(f"got {len(valid)} validity masks for {len(Fs)} "
                         "banks")
    thr = _KERNEL_MIN_N if _KERNEL_MIN_N is not None \
        else _default_kernel_min_n(device)
    out: List[Optional[np.ndarray]] = [None] * len(Fs)
    big = []
    for b, F in enumerate(Fs):
        if F.shape[0] >= max(thr, 1):
            big.append(b)
        else:
            out[b] = pareto_mask_np(F, valid[b])
    if big:
        ks = {Fs[b].shape[1] for b in big}
        if len(ks) != 1:
            raise ValueError(f"banks hold different objective counts {ks}")
        k = ks.pop()
        sizes = np.array([Fs[b].shape[0] for b in big])
        cat = np.concatenate([Fs[b] for b in big])
        finite = np.isfinite(cat)
        v = finite.all(-1)
        if any(valid[b] is not None for b in big):
            v &= np.concatenate([np.ones(n, bool) if valid[b] is None
                                 else np.asarray(valid[b], bool)
                                 for b, n in zip(big, sizes)])
        cat[~finite] = np.inf
        # Bank b fills the first sizes[b] rows of its segment; a boolean
        # mask assigns them in the concatenation's order, one row (viewed
        # as a single k-float item) at a time.
        slots = np.arange(_bucket(sizes.max())) < sizes[:, None]
        X = np.full(slots.shape + (k,), np.inf)
        row = np.dtype((np.void, 8 * k))
        X.view(row)[..., 0][slots] = cat.view(row)[:, 0]
        vp = np.zeros(slots.shape, bool)
        vp[slots] = v
        hazard = _f32_tie_hazards(X)
        for i in np.nonzero(hazard)[0]:
            out[big[i]] = pareto_mask_np(Fs[big[i]], valid[big[i]])
        on_kernel = np.nonzero(~hazard)[0]
        if on_kernel.size:
            nb = _bucket(sizes[on_kernel].max())
            masks = _pareto_masks_kernel(X[on_kernel, :nb],
                                         vp[on_kernel, :nb], device)
            for i, mask in zip(on_kernel, masks):
                out[big[i]] = mask[:sizes[i]]
    if tr is not None:
        tr.close(sp, banks=len(Fs))
    return out


def _bucket(n: int) -> int:
    """Rows a kernel stack is padded to: a power of two, at least 128."""
    return max(128, 1 << int(np.ceil(np.log2(max(n, 2)))))


def _f32_tie_hazards(X: np.ndarray) -> np.ndarray:
    """(S,) bool over an (S, n, k) stack: True where some column of a
    segment holds finite values that are distinct in float64 but tie as
    float32.  Rounding to float32 is monotone, so such a pair exists iff
    two neighbours of the sorted column do."""
    Xs = np.sort(np.where(np.isfinite(X), X, np.inf), axis=1)
    a, b = Xs[:, :-1], Xs[:, 1:]
    with np.errstate(over="ignore"):
        tie = np.isfinite(b) & (a != b) \
            & (a.astype(np.float32) == b.astype(np.float32))
    return tie.any(axis=(1, 2))


def _f32_tie_hazard(F: np.ndarray) -> bool:
    """True if float64-distinct values in some column tie as float32."""
    return bool(_f32_tie_hazards(np.asarray(F, np.float64)[None])[0])


def _f32_tie_hazard_tensor(F: torch.Tensor) -> torch.Tensor:
    """:func:`_f32_tie_hazard` of an (n, k) float64 tensor, computed where
    it lies (each column sorted by ``torch.sort``), as a 0-d bool tensor:
    reading it is the caller's one synchronisation."""
    X = torch.where(torch.isfinite(F), F, torch.full_like(F, float("inf")))
    Xs = torch.sort(X, dim=0).values
    a, b = Xs[:-1], Xs[1:]
    return (torch.isfinite(b) & (a != b)
            & (a.to(torch.float32) == b.to(torch.float32))).any()


def _pareto_masks_kernel(X: np.ndarray, v: np.ndarray, device: torch.device
                         ) -> np.ndarray:
    """(S, bucket) masks of the padded float64 stack ``X`` (S, bucket, k)
    under validity ``v``: F (cast to float32) and ``v`` share one staging
    buffer, pinned when bound for the card, so one copy moves both."""
    from ...kernels.pareto_filter import pareto_filter_segments  # lazy
    S, bucket, k = X.shape
    nF = S * bucket * k * 4
    buf = torch.empty(nF + S * bucket, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:nF].view(np.float32).reshape(X.shape)[...] = X
    host[nF:].view(np.bool_).reshape(v.shape)[...] = v
    buf = buf.to(device, non_blocking=True)
    F32 = buf[:nF].view(torch.float32).view(S, bucket, k)
    valid = buf[nF:].view(torch.bool).view(S, bucket)
    # repro_torch: allow[TH002] K1's callers' one sync a call (PERF.md §3): the launch's masks read back
    return pareto_filter_segments(F32, valid).cpu().numpy()


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
