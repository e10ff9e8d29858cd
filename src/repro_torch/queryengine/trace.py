"""Training-trace collection (paper §6: 50k parametric queries, LHS configs).

Each trace row pairs one (query, configuration) execution with the stage- and
query-level targets the three model families learn:

* subQ  (compile time): analytical latency + IO per stage, CBO statistics,
  β = 0, γ = 0 (paper §4.3 "adapting to different modeling targets").
* QS    (runtime): analytical latency + IO per stage, *true* statistics,
  observed partition-size distribution β, contention γ.
* L̄QP  (runtime): end-to-end latency + IO of the whole (collapsed) plan.

Configurations are Latin-Hypercube sampled in the unit cube over the full 19
parameter space (θc ⊕ θp ⊕ θs), matching the paper's data-collection setup.
Traces are host numpy: the simulator is the data source, and a trace set
comes out bit-equal to the reference package's for the same queries and
seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..core.models.features import contention_gamma
from ..core.tuning.spark_space import (theta_c_space, theta_p_space,
                                       theta_s_space)
from .plan import Query
from .simulator import CostModel, DEFAULT_COST, simulate_query

__all__ = ["TraceSet", "collect_traces", "ALPHA_DIM", "GAMMA_DIM"]


@dataclasses.dataclass
class TraceSet:
    """Flat arrays over (query × config × subQ) samples."""

    # Per-sample indices into ``queries``.
    queries: List[Query]
    query_idx: np.ndarray          # (S,) int — which query
    subq_idx: np.ndarray           # (S,) int — which stage within the query
    # Features (unit-space θ; raw-space non-decision variables).
    theta_c: np.ndarray            # (S, 8)  unit
    theta_p: np.ndarray            # (S, 9)  unit
    theta_s: np.ndarray            # (S, 2)  unit
    alpha_cbo: np.ndarray          # (S, a)  compile-time input stats
    alpha_true: np.ndarray         # (S, a)  runtime input stats
    beta: np.ndarray               # (S, 3)  partition-size distribution
    gamma: np.ndarray              # (S, g)  contention stats
    # Targets.
    y_subq: np.ndarray             # (S, 2)  [analytical latency, IO GB]
    # Query-level samples (one per query × config).
    q_query_idx: np.ndarray        # (Sq,)
    q_theta_c: np.ndarray          # (Sq, 8)
    q_theta_p: np.ndarray          # (Sq, 9)
    q_theta_s: np.ndarray          # (Sq, 2)
    q_alpha: np.ndarray            # (Sq, a)
    y_query: np.ndarray            # (Sq, 2) [actual latency, IO GB]

    def split(self, fractions=(0.8, 0.1, 0.1), seed: int = 0):
        """Split by *query* (not row) into train/val/test index masks."""
        nq = len(self.queries)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(nq)
        n_tr = int(fractions[0] * nq)
        n_va = int(fractions[1] * nq)
        groups = {"train": perm[:n_tr], "val": perm[n_tr:n_tr + n_va],
                  "test": perm[n_tr + n_va:]}
        masks = {}
        for name, qids in groups.items():
            qset = set(qids.tolist())
            masks[name] = (
                np.array([qi in qset for qi in self.query_idx]),
                np.array([qi in qset for qi in self.q_query_idx]),
            )
        return masks


def _alpha_stats(rows: Sequence[float], bys: Sequence[float]) -> np.ndarray:
    """Input-characteristics vector: log-scaled sizes of the stage inputs."""
    r = float(sum(rows))
    b = float(sum(bys))
    r1 = float(max(rows))
    b1 = float(max(bys))
    return np.array([np.log1p(r) / 20.0, np.log1p(b) / 25.0,
                     np.log1p(r1) / 20.0, np.log1p(b1) / 25.0,
                     len(rows) / 2.0], np.float64)


ALPHA_DIM = 5
GAMMA_DIM = 4


def collect_traces(
    queries: Sequence[Query],
    n_conf_per_query: int,
    *,
    seed: int = 0,
    cost: CostModel = DEFAULT_COST,
) -> TraceSet:
    """Run every query under LHS-sampled configurations; gather all targets."""
    cs, ps, ss = theta_c_space(), theta_p_space(), theta_s_space()
    rng = np.random.default_rng(seed)

    rows: Dict[str, List[np.ndarray]] = {k: [] for k in
        ["qi", "si", "tc", "tp", "ts", "ac", "at", "be", "ga", "y"]}
    qrows: Dict[str, List[np.ndarray]] = {k: [] for k in
        ["qi", "tc", "tp", "ts", "al", "y"]}

    for qi, q in enumerate(queries):
        n = n_conf_per_query
        u_c = cs.sample_lhs(rng, n)
        u_p = ps.sample_lhs(rng, n)
        u_s = ss.sample_lhs(rng, n)
        tc = cs.to_raw(u_c)
        tp = ps.to_raw(u_p)
        ts = ss.to_raw(u_s)
        sim = simulate_query(q, tc, tp, ts, cost=cost, runtime_reopt=True,
                             rng=np.random.default_rng(seed + qi))

        depths = q.subq_depths()
        # Contention γ per stage: tasks of sibling stages at the same depth.
        for sq in q.subqs:
            d = depths[sq.sq_id]
            sib = [j for j in range(q.n_subqs)
                   if depths[j] == d and j != sq.sq_id]
            p = sim.per_subq[sq.sq_id]
            sib_tasks = (np.sum([sim.per_subq[j].n_tasks for j in sib], 0)
                         if sib else np.zeros(n))
            sib_work = (np.sum([sim.per_subq[j].task_seconds for j in sib], 0)
                        if sib else np.zeros(n))
            gamma = contention_gamma(sib_tasks, sib_work, len(sib), d)

            rows["qi"].append(np.full(n, qi))
            rows["si"].append(np.full(n, sq.sq_id))
            rows["tc"].append(u_c)
            rows["tp"].append(u_p)
            rows["ts"].append(u_s)
            rows["ac"].append(np.tile(_alpha_stats(
                sq.est_input_rows, sq.est_input_bytes), (n, 1)))
            rows["at"].append(np.tile(_alpha_stats(
                sq.input_rows, sq.input_bytes), (n, 1)))
            rows["be"].append(p.beta)
            rows["ga"].append(gamma)
            rows["y"].append(np.stack([p.ana_latency, p.io_gb], -1))

        qrows["qi"].append(np.full(n, qi))
        qrows["tc"].append(u_c)
        qrows["tp"].append(u_p)
        qrows["ts"].append(u_s)
        tot_r = sum(s.out_rows for s in q.subqs if s.kind == "scan")
        tot_b = sum(s.out_bytes for s in q.subqs if s.kind == "scan")
        qrows["al"].append(np.tile(
            _alpha_stats([tot_r], [tot_b]), (n, 1)))
        qrows["y"].append(np.stack([sim.actual_latency, sim.io_gb], -1))

    cat = lambda k, d: np.concatenate(d[k], axis=0)
    return TraceSet(
        queries=list(queries),
        query_idx=cat("qi", rows).astype(int),
        subq_idx=cat("si", rows).astype(int),
        theta_c=cat("tc", rows), theta_p=cat("tp", rows),
        theta_s=cat("ts", rows),
        alpha_cbo=cat("ac", rows), alpha_true=cat("at", rows),
        beta=cat("be", rows), gamma=cat("ga", rows),
        y_subq=cat("y", rows),
        q_query_idx=cat("qi", qrows).astype(int),
        q_theta_c=cat("tc", qrows), q_theta_p=cat("tp", qrows),
        q_theta_s=cat("ts", qrows), q_alpha=cat("al", qrows),
        y_query=cat("y", qrows),
    )
