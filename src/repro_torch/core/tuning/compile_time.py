"""Compile-time optimization: HMOOC solve + WUN recommendation (paper §5.1).

Produces the optimal Spark context θc*, the fine-grained per-subQ θp/θs the
runtime optimizer is seeded with, and the aggregated submission copies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from ...queryengine.plan import Query
from ...queryengine.simulator import CostModel, DEFAULT_COST
from ..models.perf_model import PerfModel
from ..moo.hmooc import EffectiveSet, HMOOCConfig, HMOOCResult, hmooc_solve
from ..moo.wun import wun_select
from .aggregation import aggregate_submission_theta
from .objectives import StageObjectives, fused_stage_eval

__all__ = ["CompileTimeResult", "compile_time_optimize",
           "default_theta_result", "finish_result"]


@dataclasses.dataclass
class CompileTimeResult:
    # Pareto front (model/believed objective space) + chosen point.
    front: np.ndarray             # (q, 2)
    choice: int                   # WUN index into the front
    # Raw-space configuration of the chosen point.
    theta_c: np.ndarray           # (8,)
    theta_p_sub: np.ndarray       # (m, 9) fine-grained
    theta_s_sub: np.ndarray       # (m, 2)
    theta_p0: np.ndarray          # (9,) aggregated submission copy
    theta_s0: np.ndarray          # (2,)
    solve_time: float
    n_evals: int

    @property
    def chosen_objectives(self) -> np.ndarray:
        return self.front[self.choice]


def compile_time_optimize(
    query: Query,
    *,
    model: Optional[PerfModel] = None,
    weights: Tuple[float, float] = (0.9, 0.1),
    cfg: HMOOCConfig = HMOOCConfig(),
    cost: CostModel = DEFAULT_COST,
    cache=None,
    effective_set: Optional[EffectiveSet] = None,
    device=None,
) -> CompileTimeResult:
    """Solve the fine-grained compile-time MOO and pick a WUN recommendation.

    ``model=None`` uses the oracle (simulator-on-estimates) objective — used
    by algorithm studies; pass the trained subQ model for the paper pipeline.

    ``cache`` is an optional effective-set cache (duck-typed, see
    ``repro_torch.serve.EffectiveSetCache``): ``cache.lookup(query, cfg, model,
    cost)`` returns Algorithm 1 artifacts to reuse (or None) and
    ``cache.store(query, cfg, eset, model, cost)`` records them after a
    solve.  A lookup hit on an identical query skips Algorithm 1 entirely
    and is bit-identical to a cold solve.

    ``effective_set`` forces reuse of the given Algorithm 1 artifacts
    directly (no cache consulted, nothing stored): the degraded serving
    path uses it to reuse a template's banks across parametric variants —
    approximate unless the query matches the one the banks were computed
    from — without ever triggering a fresh Algorithm 1 bank build.

    ``device`` (``None`` = the CUDA card) is where the dominance filters
    run; the model runs on its own device.
    """
    if effective_set is not None and cache is not None:
        raise ValueError("pass cache or effective_set, not both")
    t0 = time.perf_counter()
    obj = StageObjectives(query, model=model, cost=cost)
    if effective_set is not None:
        eset = effective_set
    else:
        eset = cache.lookup(query, cfg, model, cost) if cache is not None \
            else None
    res: HMOOCResult = hmooc_solve(
        obj.stage_eval, obj.m, obj.d_c, obj.d_ps, cfg,
        snap_c=obj.snap_c, snap_ps=obj.snap_ps, effective_set=eset,
        device=device)
    # Don't re-store after a bank-reuse solve: the stored fingerprint must
    # stay that of the query the banks were actually computed from, else an
    # approximate cross-variant reuse would later be served as an exact hit.
    if (cache is not None and res.effective_set is not None
            and not res.extras.get("reused_banks")):
        cache.store(query, cfg, res.effective_set, model, cost)
    return finish_result(query, obj, res, weights, t0)


def finish_result(query: Query, obj: StageObjectives, res: HMOOCResult,
                  weights: Tuple[float, float], t0: float
                  ) -> CompileTimeResult:
    """WUN selection + raw-space extraction after an HMOOC solve.

    Shared by :func:`compile_time_optimize` and the serving layer's batched
    solve loop, so both finish a solve with identical arithmetic.
    """
    if res.front.shape[0] == 0:
        raise RuntimeError(f"HMOOC produced no solutions for {query.qid}")
    choice, _ = wun_select(res.front, np.asarray(weights))

    tc_u = res.theta_c[choice]
    tps_u = res.theta_ps[choice]              # (m, d_ps)
    tc_raw, tp_raw, ts_raw = obj.split_raw(
        tc_u[None, :], tps_u)
    theta_p0, theta_s0 = aggregate_submission_theta(query, tp_raw, ts_raw)
    dt = time.perf_counter() - t0
    return CompileTimeResult(
        front=res.front, choice=choice, theta_c=tc_raw[0],
        theta_p_sub=tp_raw, theta_s_sub=ts_raw,
        theta_p0=theta_p0, theta_s0=theta_s0,
        solve_time=dt, n_evals=res.n_evals)


def default_theta_result(
    query: Query,
    *,
    model: Optional[PerfModel] = None,
    cost: CostModel = DEFAULT_COST,
) -> CompileTimeResult:
    """Spark-default configuration as a :class:`CompileTimeResult` — no MOO.

    The last-resort degraded serving path: when a tenant's solve budget is
    already unmeetable and not even cached Algorithm 1 artifacts exist for
    the query's template, the server admits the query under the paper's
    "default configuration" (Spark 3.5.0 documentation defaults, Table 6)
    instead of queueing it into a blown budget.  Cost is one stage-model
    evaluation per subQ (to report believed objectives) — no sampling,
    no clustering, no banks, no DAG aggregation.
    """
    t0 = time.perf_counter()
    obj = StageObjectives(query, model=model, cost=cost)
    tc_u = obj.cs.default_unit()[None, :]                       # (1, d_c)
    tps_u = np.tile(np.concatenate([obj.ps.default_unit(),
                                    obj.ss.default_unit()]),
                    (obj.m, 1))                                 # (m, d_ps)
    # One batched dispatch across all subQs (the oracle backend keeps the
    # exact per-subQ evaluation); the sum stays a left-to-right
    # accumulation so the reduction order matches the historical loop.
    evals = fused_stage_eval(
        [(obj, i, tc_u, tps_u[i:i + 1]) for i in range(obj.m)])
    front = np.zeros((1, 2), np.float64)
    for F in evals:
        front[0] += F[0]
    tc_raw, tp_raw, ts_raw = obj.split_raw(tc_u, tps_u)
    theta_p0, theta_s0 = aggregate_submission_theta(query, tp_raw, ts_raw)
    return CompileTimeResult(
        front=front, choice=0, theta_c=tc_raw[0],
        theta_p_sub=tp_raw, theta_s_sub=ts_raw,
        theta_p0=theta_p0, theta_s0=theta_s0,
        solve_time=time.perf_counter() - t0, n_evals=query.n_subqs)
