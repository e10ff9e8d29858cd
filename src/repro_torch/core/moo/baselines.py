"""Baseline MOO solvers the paper compares against (§6.2).

* :func:`solve_ws`   — MO-WS: weighted sum over a random sample bank
  (10k samples, 11 evenly spaced weight pairs), the strongest query-level
  baseline in the paper's prior work [40].
* :func:`solve_evo`  — Evo: NSGA-II (population 100, 500 evaluations).
* :func:`solve_pf`   — Progressive Frontier [40]: recursive middle-point
  probing of constrained single-objective subproblems.
* :func:`solve_so_fw`— SO-FW: single-objective scalarization with *fixed*
  weights (returns exactly one configuration) — the common practical
  approach the paper shows is poorly adaptive.

All solvers minimize ``query_eval : (n, D) unit-cube rows -> (n, k)`` and
return (front, configs, solve_time, n_evals).  They are host numpy, like the
reference's, and draw the same numbers from the same seed; a model-backed
``query_eval`` (``StageObjectives.query_eval_fine`` / ``query_eval_coarse``)
sends each evaluation through ``PerfModel.predict`` on the model's device.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

from .pareto import pareto_mask_np

__all__ = ["solve_ws", "solve_evo", "solve_pf", "solve_so_fw"]

QueryEval = Callable[[np.ndarray], np.ndarray]


def _lhs(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.random((n, d))) / n
    return u


def _normalize(F: np.ndarray) -> np.ndarray:
    lo = F.min(0)
    hi = F.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    return (F - lo) / span


# ---------------------------------------------------------------------------
# MO-WS
# ---------------------------------------------------------------------------

def solve_ws(query_eval: QueryEval, dims: int, *, n_samples: int = 10000,
             n_weights: int = 11, seed: int = 0,
             batch: int = 4096) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Weighted Sum: k-1 simplex of evenly spaced weights over a sample bank.

    Each weight vector yields one SO problem solved by exhaustive evaluation
    of the shared sample bank; the union of per-weight optima is returned
    (each is Pareto optimal, but coverage may collapse — paper Fig. 4).
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    U = _lhs(rng, n_samples, dims)
    F = np.concatenate([query_eval(U[i:i + batch])
                        for i in range(0, n_samples, batch)], 0)
    Fn = _normalize(F)
    ws = np.linspace(0, 1, n_weights)
    picks = []
    for w in ws:
        picks.append(int(np.argmin(w * Fn[:, 0] + (1 - w) * Fn[:, 1])))
    picks = sorted(set(picks))
    Fp = F[picks]
    mask = pareto_mask_np(Fp)
    keep = np.nonzero(mask)[0]
    dt = time.perf_counter() - t0
    return Fp[keep], U[picks][keep], dt, n_samples


# ---------------------------------------------------------------------------
# Evo: NSGA-II
# ---------------------------------------------------------------------------

def _nd_sort(F: np.ndarray) -> np.ndarray:
    """Non-dominated rank per row (0 = first front)."""
    n = F.shape[0]
    rank = np.zeros(n, int)
    remaining = np.arange(n)
    r = 0
    while remaining.size:
        mask = pareto_mask_np(F[remaining])
        front = remaining[mask]
        rank[front] = r
        remaining = remaining[~mask]
        r += 1
    return rank


def _crowding(F: np.ndarray) -> np.ndarray:
    n, k = F.shape
    d = np.zeros(n)
    for j in range(k):
        order = np.argsort(F[:, j])
        span = F[order[-1], j] - F[order[0], j]
        d[order[0]] = d[order[-1]] = np.inf
        if span <= 0 or n < 3:
            continue
        d[order[1:-1]] += (F[order[2:], j] - F[order[:-2], j]) / span
    return d


def solve_evo(query_eval: QueryEval, dims: int, *, pop: int = 100,
              n_evals: int = 500, seed: int = 0,
              eta_c: float = 15.0, eta_m: float = 20.0
              ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """NSGA-II with SBX crossover + polynomial mutation."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    P = _lhs(rng, pop, dims)
    FP = query_eval(P)
    used = pop

    while used < n_evals:
        rank = _nd_sort(FP)
        crowd = _crowding(FP)

        def tourney() -> int:
            a, b = rng.integers(0, P.shape[0], 2)
            if rank[a] != rank[b]:
                return a if rank[a] < rank[b] else b
            return a if crowd[a] > crowd[b] else b

        n_child = min(pop, n_evals - used)
        children = np.empty((n_child, dims))
        for c in range(0, n_child, 2):
            p1, p2 = P[tourney()], P[tourney()]
            # SBX
            u = rng.random(dims)
            beta = np.where(u <= 0.5, (2 * u) ** (1 / (eta_c + 1)),
                            (1 / (2 * (1 - u))) ** (1 / (eta_c + 1)))
            c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
            c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
            # polynomial mutation (prob 1/d per gene)
            for child in (c1, c2):
                mm = rng.random(dims) < (1.0 / dims)
                if mm.any():
                    u2 = rng.random(mm.sum())
                    delta = np.where(
                        u2 < 0.5, (2 * u2) ** (1 / (eta_m + 1)) - 1,
                        1 - (2 * (1 - u2)) ** (1 / (eta_m + 1)))
                    child[mm] = child[mm] + delta
            children[c] = np.clip(c1, 0, 1)
            if c + 1 < n_child:
                children[c + 1] = np.clip(c2, 0, 1)
        FC = query_eval(children)
        used += n_child
        # Environmental selection on the union.
        P = np.concatenate([P, children], 0)
        FP = np.concatenate([FP, FC], 0)
        rank = _nd_sort(FP)
        crowd = _crowding(FP)
        order = np.lexsort((-crowd, rank))
        P, FP = P[order[:pop]], FP[order[:pop]]

    mask = pareto_mask_np(FP)
    dt = time.perf_counter() - t0
    return FP[mask], P[mask], dt, used


# ---------------------------------------------------------------------------
# Progressive Frontier (UDAO [40])
# ---------------------------------------------------------------------------

def _constrained_min(query_eval: QueryEval, dims: int, obj: int,
                     ub: np.ndarray, rng: np.random.Generator,
                     n_probe: int = 512,
                     bank: Optional[Tuple[np.ndarray, np.ndarray]] = None
                     ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
    """min f_obj subject to F <= ub, by sampling + local refinement."""
    U = _lhs(rng, n_probe, dims)
    F = query_eval(U)
    if bank is not None:
        U = np.concatenate([U, bank[0]], 0)
        F = np.concatenate([F, bank[1]], 0)
    ok = (F <= ub[None, :]).all(-1)
    if not ok.any():
        return None, None, n_probe
    i = int(np.argmin(np.where(ok, F[:, obj], np.inf)))
    # Local refinement around the incumbent.
    best_u, best_f = U[i], F[i]
    local = np.clip(best_u[None, :] +
                    rng.normal(0, 0.05, (64, dims)), 0, 1)
    FL = query_eval(local)
    okl = (FL <= ub[None, :]).all(-1)
    if okl.any():
        j = int(np.argmin(np.where(okl, FL[:, obj], np.inf)))
        if FL[j, obj] < best_f[obj]:
            best_u, best_f = local[j], FL[j]
    return best_u, best_f, n_probe + 64


def solve_pf(query_eval: QueryEval, dims: int, *, n_points: int = 9,
             seed: int = 0, n_probe: int = 512
             ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Progressive Frontier: recursive middle-point constrained probes (k=2)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    evals = 0
    # Utopia/nadir probes: unconstrained minima of each objective.
    big = np.array([np.inf, np.inf])
    sols = []
    bank_u = _lhs(rng, n_probe, dims)
    bank_f = query_eval(bank_u)
    evals += n_probe
    bank = (bank_u, bank_f)
    for obj in (0, 1):
        u, f, ne = _constrained_min(query_eval, dims, obj, big, rng,
                                    n_probe, bank)
        evals += ne
        if u is not None:
            sols.append((u, f))
    rects = []
    if len(sols) == 2:
        rects.append((sols[0][1], sols[1][1]))
    while len(sols) < n_points and rects:
        # Pop the rectangle with the largest area.
        areas = [abs((b[0] - a[0]) * (b[1] - a[1])) for a, b in rects]
        ridx = int(np.argmax(areas))
        fa, fb = rects.pop(ridx)
        mid = 0.5 * (np.asarray(fa) + np.asarray(fb))
        ub = np.array([max(fa[0], fb[0]), mid[1]])
        u, f, ne = _constrained_min(query_eval, dims, 0, ub, rng,
                                    n_probe // 2, bank)
        evals += ne
        if u is None:
            continue
        sols.append((u, f))
        rects.append((fa, f))
        rects.append((f, fb))
    F = np.stack([f for _, f in sols])
    U = np.stack([u for u, _ in sols])
    mask = pareto_mask_np(F)
    dt = time.perf_counter() - t0
    return F[mask], U[mask], dt, evals


# ---------------------------------------------------------------------------
# SO-FW
# ---------------------------------------------------------------------------

def solve_so_fw(query_eval: QueryEval, dims: int, weights: np.ndarray, *,
                n_samples: int = 3000, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Fixed-weight scalarization returning a single configuration."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    U = _lhs(rng, n_samples, dims)
    F = query_eval(U)
    Fn = _normalize(F)
    w = np.asarray(weights, np.float64)
    i = int(np.argmin((Fn * w[None, :]).sum(-1)))
    dt = time.perf_counter() - t0
    return F[i:i + 1], U[i:i + 1], dt, n_samples
