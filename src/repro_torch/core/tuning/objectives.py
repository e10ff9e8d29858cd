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

    The model-backed path concatenates every request's regressor rows
    (per-row embedding ⊕ θ ⊕ nondecision) into a single bucket-padded
    :meth:`PerfModel.predict_rows` dispatch, then finishes the float64
    latency→dollars arithmetic per request.  Per-request outputs are
    identical to calling ``obj.stage_eval(i, Tc, Tps)`` one by one: row j of
    a padded batch equals row j of the per-request call, and the cost
    arithmetic is element-wise.  All requests must share one model (the
    serving layer batches per service); the oracle backend (``model is
    None``) falls back to per-request evaluation, which is already one
    vectorized simulator call each.
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
    thetas, metas = [], []
    for obj, i, Tc, Tps in items:
        tc_raw, _, _ = obj.split_raw(Tc, Tps)
        theta = obj.theta_rows(Tc, Tps)
        thetas.append(theta)
        metas.append((obj, i, theta.shape[0], tc_raw))
    total = sum(n for _, _, n, _ in metas)
    emb0 = items[0][0]._embs[items[0][1]]
    nond0 = items[0][0]._nond[items[0][1]]
    # Per-row emb/nond are broadcast straight into the dispatch buffers —
    # no per-request np.repeat intermediates on the host.
    emb_all = np.empty((total, emb0.shape[0]), np.float32)
    nond_all = np.empty((total, nond0.shape[0]), np.float32)
    off = 0
    for obj, i, n, _ in metas:
        emb_all[off:off + n] = obj._embs[i]
        nond_all[off:off + n] = obj._nond[i]
        off += n
    theta_all = np.concatenate(thetas, 0)
    if tr is not None:
        tr.close(sp_part, rows=total)
    pred = model.predict_rows(emb_all, theta_all, nond_all)
    if tr is not None:
        sp_part = tr.open("stage_eval.dollars")
    out: List[np.ndarray] = []
    off = 0
    for obj, _, n, tc_raw in metas:
        p = pred[off:off + n]
        off += n
        lat, io = p[:, 0], p[:, 1]
        dollars = lat * resource_rate(tc_raw, obj.cost) \
            + io * obj.cost.price_io_gb
        out.append(np.stack([lat, dollars], -1))
    if tr is not None:
        tr.close(sp_part)
        tr.close(sp, requests=len(items))
    return out
