"""K-means clustering of θc candidates (HMOOC subQ-tuning, Algorithm 1 line 2).

Small, deterministic, dependency-free implementation.  Operates in the unit
hypercube, k-means++ seeding, fixed iteration count (jit-friendly shape-wise
but run host-side: candidate counts are a few hundred at most).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["KMeans", "kmeans_fit"]


@dataclasses.dataclass
class KMeans:
    centers: np.ndarray  # (C, d)

    def assign(self, X: np.ndarray) -> np.ndarray:
        """(n, d) -> (n,) nearest-center labels."""
        d2 = ((X[:, None, :] - self.centers[None, :, :]) ** 2).sum(-1)
        return np.argmin(d2, axis=1)


def _kmeanspp_init(X: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((X[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), axis=1)
        tot = d2.sum()
        if tot <= 0:
            centers.append(X[rng.integers(n)])
            continue
        probs = d2 / tot
        centers.append(X[rng.choice(n, p=probs)])
    return np.array(centers)


def kmeans_fit(
    X: np.ndarray, k: int, rng: np.random.Generator, iters: int = 25
) -> Tuple[KMeans, np.ndarray]:
    """Fit k-means; returns (model, labels).  k is clipped to n distinct rows."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    k = int(min(k, n))
    centers = _kmeanspp_init(X, k, rng)
    labels = np.zeros(n, int)
    for _ in range(iters):
        d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_labels = np.argmin(d2, axis=1)
        if (new_labels == labels).all() and _ > 0:
            break
        labels = new_labels
        for c in range(k):
            m = labels == c
            if m.any():
                centers[c] = X[m].mean(0)
    return KMeans(centers=centers), labels
