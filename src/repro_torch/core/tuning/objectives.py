"""Objective adapters: build stage/query evaluators for the MOO solvers.

Two backends expose the same interface:

* **model** — the trained subQ :class:`PerfModel` (the production path;
  sub-second solving via cached GTN embeddings + batched regressor);
* **oracle** — the analytic simulator evaluated on *CBO-estimated* inputs
  (what a perfect compile-time model would believe), used by algorithm
  benchmarks and tests to isolate MOO behavior from model error.

Objectives (minimization), matching the paper's latency/cloud-cost pair:
  f1 = analytical latency (s)      — Σ over subQs at the query level
  f2 = cloud cost ($)              — latency·(core+mem rates) + IO·io rate

Both are *sums* over subQs for fixed θc, which is what licenses HMOOC's
list-structured DAG aggregation (paper §5.1.2).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ... import tracing
from ...queryengine.plan import Query
from ...queryengine.simulator import CostModel, DEFAULT_COST, simulate_subq
from ...queryengine.trace import _alpha_stats
from ..models.perf_model import PerfModel, make_nondecision
from .spark_space import theta_c_space, theta_p_space, theta_s_space

__all__ = ["StageObjectives", "resource_rate", "QueryObjective",
           "fused_stage_eval", "StageRequest"]


def resource_rate(tc_raw: np.ndarray, cost: CostModel = DEFAULT_COST
                  ) -> np.ndarray:
    """$(per second) of the allocated cluster for raw θc rows."""
    k1, k2, k3 = tc_raw[:, 0], tc_raw[:, 1], tc_raw[:, 2]
    return (k1 * k3 * cost.price_core_h + k2 * k3 * cost.price_mem_gb_h) \
        / 3600.0


# The leading θc columns resource_rate reads.
_RATE_COLS = 3


def _dollars(pred: np.ndarray, rate: np.ndarray, cost: CostModel
             ) -> np.ndarray:
    """(n, 2) [latency, io] predictions and the rows' :func:`resource_rate`
    → (n, 2) [latency, cost]."""
    lat, io = pred[:, 0], pred[:, 1]
    return np.stack([lat, lat * rate + io * cost.price_io_gb], -1)


class StageObjectives:
    """stage_eval factory for one query (model- or oracle-backed)."""

    def __init__(self, query: Query, *, model: Optional[PerfModel] = None,
                 cost: CostModel = DEFAULT_COST):
        self.query = query
        self.model = model
        self.cost = cost
        self.cs = theta_c_space()
        self.ps = theta_p_space()
        self.ss = theta_s_space()
        self.d_c = self.cs.dim
        self.d_ps = self.ps.dim + self.ss.dim
        self.m = query.n_subqs
        if model is not None:
            # One batched GTN dispatch covers all subQs (a cache no-op when
            # the serving layer already prefetched the whole micro-batch).
            model.embed_many([(query, i) for i in range(self.m)])
            self._embs = [model.embed(query, i) for i in range(self.m)]
            self._nond = [make_nondecision(_alpha_stats(
                sq.est_input_rows, sq.est_input_bytes))
                for sq in query.subqs]

    # -- unit→raw helpers ----------------------------------------------------
    def snap_c(self, U: np.ndarray) -> np.ndarray:
        return self.cs.snap_unit(U)

    def snap_ps(self, U: np.ndarray) -> np.ndarray:
        out = U.copy()
        out[..., :self.ps.dim] = self.ps.snap_unit(U[..., :self.ps.dim])
        out[..., self.ps.dim:] = self.ss.snap_unit(U[..., self.ps.dim:])
        return out

    def split_raw(self, Tc: np.ndarray, Tps: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        tc = self.cs.to_raw(Tc)
        tp = self.ps.to_raw(Tps[..., :self.ps.dim])
        ts = self.ss.to_raw(Tps[..., self.ps.dim:])
        return tc, tp, ts

    # -- evaluators ------------------------------------------------------------
    def stage_eval(self, i: int, Tc: np.ndarray, Tps: np.ndarray
                   ) -> np.ndarray:
        """(n, d_c) ⊕ (n, d_ps) unit rows → (n, 2) [latency, cost]."""
        tc_raw, tp_raw, ts_raw = self.split_raw(Tc, Tps)
        if self.model is not None:
            theta = self.theta_rows(Tc, Tps)
            pred = self.model.predict(self._embs[i], theta, self._nond[i])
            lat, io = pred[:, 0], pred[:, 1]
        else:
            sim = simulate_subq(self.query.subqs[i], tc_raw, tp_raw, ts_raw,
                                cost=self.cost, aqe=True,
                                use_est_inputs=True)
            lat, io = sim.ana_latency, sim.io_gb
        dollars = lat * resource_rate(tc_raw, self.cost) \
            + io * self.cost.price_io_gb
        return np.stack([lat, dollars], -1)

    def theta_rows(self, Tc: np.ndarray, Tps: np.ndarray) -> np.ndarray:
        """Regressor θ layout for unit rows: [θc ⊕ θp ⊕ θs], float32."""
        return np.concatenate(
            [Tc, Tps[..., :self.ps.dim], Tps[..., self.ps.dim:]],
            -1).astype(np.float32)

    # -- flat query-level evaluators for the baselines -------------------------
    def query_eval_fine(self) -> Tuple[Callable[[np.ndarray], np.ndarray], int]:
        """Fine-grained flat space: θc ⊕ m × (θp ⊕ θs); D = d_c + m·d_ps."""
        D = self.d_c + self.m * self.d_ps

        def ev(U: np.ndarray) -> np.ndarray:
            n = U.shape[0]
            Tc = U[:, :self.d_c]
            total = np.zeros((n, 2))
            for i in range(self.m):
                lo = self.d_c + i * self.d_ps
                total += self.stage_eval(i, Tc, U[:, lo:lo + self.d_ps])
            return total
        return ev, D

    def query_eval_coarse(self) -> Tuple[Callable[[np.ndarray], np.ndarray], int]:
        """Query-level control: one shared θp ⊕ θs; D = d_c + d_ps."""
        D = self.d_c + self.d_ps

        def ev(U: np.ndarray) -> np.ndarray:
            n = U.shape[0]
            Tc = U[:, :self.d_c]
            Tps = U[:, self.d_c:]
            total = np.zeros((n, 2))
            for i in range(self.m):
                total += self.stage_eval(i, Tc, Tps)
            return total
        return ev, D


QueryObjective = Callable[[np.ndarray], np.ndarray]

# One stage-evaluation request: (objectives, subQ index, θc rows, θp⊕θs rows).
StageRequest = Tuple["StageObjectives", int, np.ndarray, np.ndarray]


def fused_stage_eval(items: Sequence[StageRequest]) -> List[np.ndarray]:
    """Evaluate many stage requests — across subQs *and* queries — at once.

    The model-backed path sends each distinct input once, for one
    bucket-padded :meth:`PerfModel.predict_rows` call in its fused form:
    each request's embedding and nondecision row, each distinct θ block,
    and an (n, 2) int32 map of every scored row to its (request, θ row);
    the regressor rows are built on the device.  A request whose ``Tc`` and
    ``Tps`` are the previous request's arrays (``is``; a plan's banks-phase
    requests, one a subQ) reuses that request's θ block.  Of the raw values
    only the three θc columns :func:`resource_rate` reads (k1 cores, k2
    memory, k3 instances) are converted, once a distinct θ block, and the
    float64 latency→dollars arithmetic runs over all rows at once when
    every request shares one :class:`CostModel` (per request otherwise).
    Per-request outputs are identical to calling ``obj.stage_eval(i, Tc,
    Tps)`` one by one: row j of a padded batch equals row j of the
    per-request call, and the unit→raw and cost arithmetic are element-wise.
    All requests must share one model (the serving layer batches per
    service); the oracle backend (``model is None``) falls back to
    per-request evaluation, which is already one vectorized simulator call
    each.
    """
    if not items:
        return []
    model = items[0][0].model
    if model is None:
        return [obj.stage_eval(i, Tc, Tps) for obj, i, Tc, Tps in items]
    if any(it[0].model is not model for it in items):
        raise ValueError("fused_stage_eval requires one shared model")
    tr = tracing.TRACE
    if tr is not None:
        sp = tr.open("stage_eval")
        sp_part = tr.open("stage_eval.assemble")
    obj0, i0 = items[0][0], items[0][1]
    d_c = obj0.d_c
    R = len(items)
    lengths = np.fromiter((it[2].shape[0] for it in items), np.int64, R)
    bounds = np.zeros(R + 1, np.int64)
    np.cumsum(lengths, out=bounds[1:])
    total = int(bounds[-1])
    emb = np.empty((R, obj0._embs[i0].shape[0]), np.float32)
    nond = np.empty((R, obj0._nond[i0].shape[0]), np.float32)
    # First θ row of each request's block, and the distinct blocks.
    first = np.empty(R, np.int64)
    blocks: List[Tuple[np.ndarray, np.ndarray, int]] = []
    prev = (None, None)
    n_theta = 0
    for k, (obj, i, Tc, Tps) in enumerate(items):
        emb[k] = obj._embs[i]
        nond[k] = obj._nond[i]
        if Tc is not prev[0] or Tps is not prev[1]:
            blocks.append((Tc, Tps, n_theta))
            n_theta += Tc.shape[0]
            prev = (Tc, Tps)
        first[k] = blocks[-1][2]
    theta = np.empty((n_theta, d_c + obj0.d_ps), np.float32)
    tc_unit = np.empty((n_theta, _RATE_COLS), np.float64)
    for Tc, Tps, a in blocks:
        b = a + Tc.shape[0]
        theta[a:b, :d_c] = Tc
        theta[a:b, d_c:] = Tps
        tc_unit[a:b] = Tc[:, :_RATE_COLS]
    tc_raw = np.empty_like(tc_unit)
    for j, p in enumerate(obj0.cs.params[:_RATE_COLS]):
        tc_raw[:, j] = p.to_raw(tc_unit[:, j])
    # Row r of request k scores θ row first[k] + (r - bounds[k]).
    rows = np.empty((total, 2), np.int32, order="F")
    rows[:, 0] = np.repeat(np.arange(R, dtype=np.int32), lengths)
    rows[:, 1] = np.arange(total) - np.repeat(bounds[:-1] - first, lengths)
    if tr is not None:
        tr.close(sp_part, rows=total)
    pred = model.predict_rows(emb, rows, nond, theta)
    if tr is not None:
        sp_part = tr.open("stage_eval.dollars")
    cost = obj0.cost
    if all(it[0].cost is cost for it in items):
        F = _dollars(pred, resource_rate(tc_raw, cost)[rows[:, 1]], cost)
        out = [F[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    else:
        out = []
        for k, (obj, _, Tc, _) in enumerate(items):
            a, b = bounds[k], bounds[k + 1]
            rate = resource_rate(tc_raw[first[k]:first[k] + Tc.shape[0]],
                                 obj.cost)
            out.append(_dollars(pred[a:b], rate, obj.cost))
    if tr is not None:
        tr.close(sp_part)
        tr.close(sp, requests=len(items))
    return out
