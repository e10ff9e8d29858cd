"""Plain reference of the solver's decisions: the dominance mask, the WUN
pick and a runtime round's weighted pick, all in float64 NumPy."""
from __future__ import annotations

import numpy as np


def pareto_mask(F: np.ndarray) -> np.ndarray:
    """Rows of ``F`` (n, k) that no finite row dominates (<= in every
    objective, < in one); a row holding a non-finite value is never
    optimal."""
    F = np.asarray(F, np.float64)
    ok = np.isfinite(F).all(-1)
    if F.shape[0] == 0:
        return ok
    X = np.where(ok[:, None], F, 0.0)
    le = (X[:, None, :] <= X[None, :, :]).all(-1)
    lt = (X[:, None, :] < X[None, :, :]).any(-1)
    dom = (le & lt & ok[:, None]).any(0)
    return ok & ~dom


def wun_pick(front: np.ndarray, weights) -> int:
    """Weighted utopia-nearest point of a front: objectives min-max
    normalised over the finite rows, the least weighted distance to the
    origin, the first of ties."""
    F = np.asarray(front, np.float64)
    w = np.asarray(weights, np.float64)
    finite = np.isfinite(F).all(-1)
    lo, hi = F[finite].min(0), F[finite].max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    dist = np.sqrt(((w * (F - lo) / span) ** 2).sum(-1))
    return int(np.argmin(np.where(finite, dist, np.inf)))


def pick_scores(F: np.ndarray, w: np.ndarray) -> np.ndarray:
    """A candidate set's weighted scores: every row min-max normalised over
    the set, then summed under the weights.  A dominated row never scores
    below its dominator under positive weights, so the least score is the
    weighted pick."""
    F = np.asarray(F, np.float64)
    lo, hi = F.min(0), F.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    return ((F - lo) / span * np.asarray(w, np.float64)).sum(-1)


def pick_gap(F: np.ndarray, w: np.ndarray, j: int) -> float:
    """How far row ``j``'s score lies above the set's least score."""
    s = pick_scores(F, w)
    return float(s[j] - s.min())


def pick_bf16(F: np.ndarray, w: np.ndarray) -> int:
    """The control's pick: the normalised values and weights rounded to
    bfloat16 and the scores summed in bfloat16."""
    import torch
    F = np.asarray(F, np.float64)
    lo, hi = F.min(0), F.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    Fn = torch.from_numpy((F - lo) / span).to(torch.bfloat16)
    wb = torch.from_numpy(np.asarray(w, np.float64)).to(torch.bfloat16)
    return int(torch.argmin((Fn * wb).sum(-1)))
