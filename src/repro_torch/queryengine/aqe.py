"""Adaptive Query Execution loop with runtime parameter optimization.

Reproduces the paper's runtime side (§5.2): stages execute in topological
order; each stage completion collapses the logical plan (L̄QP) and exposes
*true* statistics; the runtime optimizer is invoked — unless pruned — to
re-tune θp for the collapsed plan and θs for each newly created query stage.
Spark holds a single live copy of θp/θs, so fine-grained control emerges from
*when* each stage is planned: a stage's effective θp is the copy in effect at
its planning event.

Join-algorithm convertibility is enforced: AQE can upgrade SMJ→SHJ→BHJ from
runtime statistics but can never demote a planned broadcast — the submission
copy therefore carries risk that runtime tuning cannot undo (paper Fig. 3(b)).

Request pruning (§5.2, App. C.2): (1) LQP re-optimization requests are sent
only when the completed stage clears the *last* dependency of some join —
non-join events and joins with incomplete input statistics are skipped or
deferred; (2) joins whose decision is statistically obvious (build side far
from every θp threshold) are skipped; (3) QS requests are sent only for
non-scan stages whose shuffle input exceeds the advisory partition size s1.
The paper reports 86%/92% fewer requests on TPC-H/TPC-DS.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .plan import Query, SubQ
from .simulator import (CostModel, DEFAULT_COST, QuerySim, plan_joins,
                        simulate_query, upgrade_joins)

__all__ = ["AQEResult", "AQEPlanState", "LQPRequest", "QSRequest",
           "aqe_request_stream", "realize_aqe", "run_with_aqe",
           "RuntimeOptimizer"]


# A runtime optimizer callback: (query, collapsed_ids, theta_c, theta_p_cur,
# true-stats dict) -> new theta_p row (9,) or None to keep current.
RuntimeOptimizer = Callable[..., Optional[np.ndarray]]


@dataclasses.dataclass
class LQPRequest:
    """L̄QP re-optimization request: re-tune θp before planning ``subq``."""
    query: Query
    subq: SubQ
    theta_c: np.ndarray          # (8,) fixed context
    theta_p: np.ndarray          # (9,) θp copy in effect at the event
    kind: str = "lqp"


@dataclasses.dataclass
class QSRequest:
    """QS optimization request: re-tune θs for the newly created ``subq``."""
    query: Query
    subq: SubQ
    theta_c: np.ndarray
    theta_s: np.ndarray          # (2,) θs copy in effect at the event
    kind: str = "qs"


@dataclasses.dataclass
class AQEPlanState:
    """Planning outcome of one AQE pass, before execution is realized."""
    theta_p_eff: np.ndarray      # (m, 9) θp in effect per stage
    theta_s_eff: np.ndarray      # (m, 2)
    planned: np.ndarray          # (m,) submission-time join algorithms
    lqp_requests_sent: int
    qs_requests_sent: int
    requests_total: int


@dataclasses.dataclass
class AQEResult:
    sim: QuerySim                      # realized execution (n = 1)
    theta_p_eff: np.ndarray            # (m, 9) θp in effect per stage
    theta_s_eff: np.ndarray            # (m, 2)
    final_join: np.ndarray             # (m,) realized algorithms
    lqp_requests_sent: int
    qs_requests_sent: int
    requests_total: int                # unpruned request count (~2m)

    @property
    def requests_sent(self) -> int:
        return self.lqp_requests_sent + self.qs_requests_sent

    @property
    def prune_rate(self) -> float:
        if self.requests_total == 0:
            return 0.0
        return 1.0 - self.requests_sent / self.requests_total


def _join_obvious(sq: SubQ, theta_p: np.ndarray, margin: float = 4.0) -> bool:
    """True when runtime statistics cannot change the join decision.

    The build side is more than ``margin``× away from both the broadcast
    (s4) and shuffled-hash (s3) thresholds, on the same side as the estimate
    — re-optimizing cannot flip the parametric rule.
    """
    build_true = min(sq.input_bytes)
    build_est = min(sq.est_input_bytes)
    for thr_mb in (theta_p[2], theta_p[3]):
        thr = thr_mb * 1e6
        if thr <= 0:
            continue
        same_side = (build_true > thr) == (build_est > thr)
        near = thr / margin <= build_true <= thr * margin
        if near or not same_side:
            return False
    return True


def aqe_request_stream(
    query: Query,
    theta_c: np.ndarray,
    theta_p0: np.ndarray,
    theta_s0: np.ndarray,
    *,
    prune: bool = True,
):
    """Generator form of the AQE planning loop (the batchable protocol).

    Walks stage completions in topological order and *yields* each unpruned
    :class:`LQPRequest` / :class:`QSRequest` instead of invoking a callback;
    the consumer answers via ``send(new_theta_row)`` (or ``send(None)`` to
    keep the current copy).  Returns the final :class:`AQEPlanState` as the
    generator's ``StopIteration.value``.

    :func:`run_with_aqe` drives this with synchronous callbacks; the serving
    layer (``repro_torch.serve.runtime``) drives many streams concurrently and
    fuses their outstanding requests into batched optimizer calls.  Both see
    the identical event order, pruning decisions, and request counts.
    """
    theta_c = np.asarray(theta_c, np.float64).reshape(-1)
    theta_p0 = np.asarray(theta_p0, np.float64).reshape(-1)
    theta_s0 = np.asarray(theta_s0, np.float64).reshape(-1)
    m = query.n_subqs
    topo = query.topo_subqs()

    theta_p_eff = np.tile(theta_p0, (m, 1))
    theta_s_eff = np.tile(theta_s0, (m, 1))

    # Submission-time planned algorithms (CBO estimates + θp0): the physical
    # plan Spark builds before any stage runs.
    planned = plan_joins(query, theta_p_eff[None, :, :],
                         from_estimates=True)[0]

    completed: set = set()
    theta_p_cur = theta_p0.copy()
    lqp_sent = 0
    qs_sent = 0
    # Unpruned baseline: every stage completion triggers one L̄QP request and
    # every created stage triggers one QS request.
    requests_total = 2 * m

    # Map each join to the event (child completion) that clears its inputs.
    for sid in topo:
        sq = query.subqs[sid]

        # --- L̄QP re-optimization opportunity before planning this stage ---
        if sq.kind == "join":
            stats_ready = all(c in completed for c in sq.children)
            send = stats_ready
            if prune and send:
                send = not _join_obvious(sq, theta_p_cur)
            if send:
                newp = yield LQPRequest(query=query, subq=sq,
                                        theta_c=theta_c,
                                        theta_p=theta_p_cur)
                lqp_sent += 1
                if newp is not None:
                    theta_p_cur = np.asarray(newp, np.float64).reshape(-1)
        theta_p_eff[sid] = theta_p_cur

        # --- QS optimization when the stage is created ---------------------
        send_qs = True
        if prune:
            shuffle_in = sum(sq.input_bytes)
            s1_bytes = max(theta_p_cur[0], 1.0) * 1e6
            send_qs = (sq.kind != "scan") and (shuffle_in >= s1_bytes)
        if send_qs:
            qs_sent += 1
            news = yield QSRequest(query=query, subq=sq, theta_c=theta_c,
                                   theta_s=theta_s_eff[sid])
            if news is not None:
                theta_s_eff[sid] = np.asarray(news, np.float64).reshape(-1)

        completed.add(sid)

    return AQEPlanState(theta_p_eff=theta_p_eff, theta_s_eff=theta_s_eff,
                        planned=planned, lqp_requests_sent=lqp_sent,
                        qs_requests_sent=qs_sent,
                        requests_total=requests_total)


def realize_aqe(
    query: Query,
    theta_c: np.ndarray,
    state: AQEPlanState,
    *,
    cost: CostModel = DEFAULT_COST,
    rng: Optional[np.random.Generator] = None,
) -> AQEResult:
    """Realize execution for a finished planning pass.

    Runtime decisions come from true statistics under each stage's effective
    θp, constrained by submission-planned convertibility (a planned broadcast
    is never demoted).
    """
    theta_c = np.asarray(theta_c, np.float64).reshape(-1)
    runtime_choice = plan_joins(query, state.theta_p_eff[None, :, :],
                                from_estimates=False)[0]
    final_join = upgrade_joins(state.planned, runtime_choice)
    sim = simulate_query(
        query, theta_c[None, :], state.theta_p_eff[None, :, :],
        state.theta_s_eff[None, :, :], cost=cost, aqe=True,
        planned_join=final_join[None, :], rng=rng)
    return AQEResult(sim=sim, theta_p_eff=state.theta_p_eff,
                     theta_s_eff=state.theta_s_eff, final_join=final_join,
                     lqp_requests_sent=state.lqp_requests_sent,
                     qs_requests_sent=state.qs_requests_sent,
                     requests_total=state.requests_total)


def run_with_aqe(
    query: Query,
    theta_c: np.ndarray,
    theta_p0: np.ndarray,
    theta_s0: np.ndarray,
    *,
    lqp_optimizer: Optional[RuntimeOptimizer] = None,
    qs_optimizer: Optional[RuntimeOptimizer] = None,
    prune: bool = True,
    cost: CostModel = DEFAULT_COST,
    rng: Optional[np.random.Generator] = None,
) -> AQEResult:
    """Execute one query under AQE with optional runtime re-optimization.

    Synchronous driver over :func:`aqe_request_stream`: each yielded request
    is answered immediately by the matching callback.

    Args:
      theta_c: (8,) context parameters (fixed for the whole query).
      theta_p0: (9,) submission-time θp copy (paper §5.2 aggregation output).
      theta_s0: (2,) submission-time θs copy.
      lqp_optimizer / qs_optimizer: runtime tuning callbacks; None reproduces
        plain Spark AQE under the submitted configuration.
      prune: apply the request-pruning rules.
    """
    stream = aqe_request_stream(query, theta_c, theta_p0, theta_s0,
                                prune=prune)
    response: Optional[np.ndarray] = None
    while True:
        try:
            req = stream.send(response)
        except StopIteration as stop:
            state: AQEPlanState = stop.value
            break
        if req.kind == "lqp":
            response = None if lqp_optimizer is None else lqp_optimizer(
                query=req.query, subq=req.subq, theta_c=req.theta_c,
                theta_p=req.theta_p)
        else:
            response = None if qs_optimizer is None else qs_optimizer(
                query=req.query, subq=req.subq, theta_c=req.theta_c,
                theta_s=req.theta_s)
    return realize_aqe(query, theta_c, state, cost=cost, rng=rng)
