"""Weighted Utopia Nearest (WUN) recommendation (paper §3.3.2, [40]).

Given a Pareto front and a user preference weight vector, normalize each
objective to [0, 1] over the front (utopia = per-objective min, nadir = max),
then return the point minimizing the weighted Euclidean distance to the
utopia point.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["wun_select"]


def wun_select(F: np.ndarray, weights: np.ndarray) -> Tuple[int, np.ndarray]:
    """Pick one Pareto point.

    Args:
      F: (n, k) Pareto-front objective values (minimization).
      weights: (k,) nonnegative preference weights (sum need not be 1).

    Returns:
      (index, objective row) of the recommended solution.
    """
    F = np.asarray(F, np.float64)
    w = np.asarray(weights, np.float64)
    if F.ndim != 2 or F.shape[0] == 0:
        raise ValueError("empty Pareto front")
    finite = np.isfinite(F).all(-1)
    if not finite.any():
        raise ValueError("no finite Pareto points")
    lo = F[finite].min(0)
    hi = F[finite].max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    Fn = (F - lo) / span  # utopia at the origin
    dist = np.sqrt(((w * Fn) ** 2).sum(-1))
    dist = np.where(finite, dist, np.inf)
    i = int(np.argmin(dist))
    return i, F[i]
