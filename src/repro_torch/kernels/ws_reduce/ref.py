"""Plain PyTorch versions of the weighted-sum bank-reduction kernel and of
the runtime round's pick (``csrc/runtime_pick.cu``)."""
from __future__ import annotations

from typing import List, Tuple

import torch

from ...core.moo.pareto import _f32_tie_hazard_tensor

__all__ = ["ws_reduce_ref", "ws_scores", "runtime_pick_ref",
           "kept_normalised"]

# Objective value of a padding slot in a runtime pick's bank.
PAD = 1e18


def ws_scores(W: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """float32 scores ``W[w] · F[..., b, :]`` → (nw, *F.shape[:-1]).

    The k terms are multiplied and added one at a time, left to right, in
    float32 — the kernel's order, so both round alike.
    """
    W = W.to(torch.float32)
    F = F.to(torch.float32)
    lead = (W.shape[0],) + (1,) * (F.dim() - 1)
    s = W[:, 0].reshape(lead) * F[..., 0]
    for c in range(1, F.shape[-1]):
        s = s + W[:, c].reshape(lead) * F[..., c]
    return s


def ws_reduce_ref(F: torch.Tensor, W: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(weight, bank) weighted argmin over solution banks.

    F: (m, B, k) objective banks (minimization).  W: (nw, k) weights.
    Returns (vals (nw, m) float32, idx (nw, m) int32): the least score and
    its first index (ties go to the lowest index, as ``jnp.argmin``).
    """
    vals, idx = torch.min(ws_scores(W, F), dim=-1)
    return vals, idx.to(torch.int32)


def _first_argmin(s: torch.Tensor) -> int:
    """First index of the least value of a 1-D tensor, a NaN counting as
    the least (``np.argmin``'s rule, and the kernels')."""
    nan = torch.isnan(s)
    hit = nan if bool(nan.any()) else s == s.min()
    return int(hit.nonzero()[0, 0])


def _dominance_mask(X: torch.Tensor) -> torch.Tensor:
    """Rows of (n, k) ``X`` that no finite row dominates, in X's type; a
    row with a non-finite entry neither dominates nor survives."""
    valid = torch.isfinite(X).all(-1)
    le = (X[:, None, :] <= X[None, :, :]).all(-1)      # [j, i]: X_j <= X_i
    lt = (X[:, None, :] < X[None, :, :]).any(-1)
    return valid & ~((le & lt) & valid[:, None]).any(0)


def _numpy_sum(P: torch.Tensor) -> torch.Tensor:
    """``P.sum(-1)`` in numpy's order for k <= 8 terms: left to right below
    8, pairwise at 8."""
    if P.shape[-1] == 8:
        c = [P[..., q] for q in range(8)]
        return ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5])
                                                  + (c[6] + c[7]))
    s = P[..., 0]
    for q in range(1, P.shape[-1]):
        s = s + P[..., q]
    return s


def kept_normalised(X: torch.Tensor, kernel_min_n: int
                    ) -> Tuple[List[int], torch.Tensor]:
    """One candidate set's kept rows and their float64 normalisation: the
    rows no finite row dominates when (n, k) ``X`` has at least
    ``kernel_min_n`` rows, else all, and all when that keeps none; then
    ``(X[kept] - lo) / span`` with numpy's min and max over every row
    (NaN propagates) and span 1 where hi <= lo."""
    keep = torch.arange(X.shape[0], device=X.device)
    if X.shape[0] >= kernel_min_n:
        mask = _dominance_mask(X)
        if bool(mask.any()):
            keep = mask.nonzero()[:, 0]
    lo, hi = X.amin(0), X.amax(0)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(lo))
    return keep.tolist(), (X[keep] - lo) / span


def runtime_pick_ref(F: torch.Tensor, offsets: torch.Tensor,
                     gid: torch.Tensor, W: torch.Tensor, kernel_min_n: int,
                     ws_min_scores: int) -> torch.Tensor:
    """A runtime round's weighted picks, as ``runtime_pick.cu`` makes them.

    ``F`` (total, k) float64 holds the round's R sets one after another,
    set r in rows ``offsets[r]:offsets[r + 1]``; ``gid`` (R,) names each
    set's weight group, whose weights are the rows of ``W`` (G, k).
    Returns (R + G,) int32 on F's device: each set's picked row (-1 if a
    padding slot of its group's bank won), then each group's route (1
    float32, 0 float64 below ``ws_min_scores``, 2 float64 for a float32
    tie).

    Per set: the rows no finite row dominates (float64 compares) when the
    set has at least ``kernel_min_n`` rows, else all, and all when that
    keeps none; min-max normalised over every row in float64.  Per group:
    the kept rows padded with ``PAD`` to the group's longest, and scored in
    float32 as ``ws_reduce`` scores them when R_g · B_g >=
    ``ws_min_scores`` and no column ties in float32, else in float64 in
    numpy's order; the first least score wins.
    """
    F = F.to(torch.float64)
    W = W.to(torch.float64)
    off = [int(x) for x in offsets.tolist()]
    gids = [int(x) for x in gid.tolist()]
    R, (G, k) = len(gids), W.shape
    out = torch.full((R + G,), -1, dtype=torch.int32)
    out[R:] = 0
    kept, Fn = [], []
    for r in range(R):
        keep, fn = kept_normalised(F[off[r]:off[r + 1]], kernel_min_n)
        kept.append(keep)
        Fn.append(fn)
    for g in range(G):
        members = [r for r in range(R) if gids[r] == g]
        if not members:
            continue
        B = max(len(kept[r]) for r in members)
        Fb = torch.full((len(members), B, k), PAD, dtype=torch.float64,
                        device=F.device)
        for i, r in enumerate(members):
            Fb[i, :len(kept[r])] = Fn[r]
        route = 0
        if len(members) * B >= ws_min_scores:
            route = 2 if bool(_f32_tie_hazard_tensor(Fb.reshape(-1, k))) \
                else 1
        if route == 1:
            s = ws_scores(W[g:g + 1], torch.nan_to_num(
                Fb.to(torch.float32), posinf=1e30))[0]
        else:
            s = _numpy_sum(Fb * W[g])
        for i, r in enumerate(members):
            j = _first_argmin(s[i])
            out[r] = kept[r][j] if j < len(kept[r]) else -1
        out[R + g] = route
    return out.to(F.device)
