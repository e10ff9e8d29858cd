"""Batched runtime re-optimization service (paper §5.2 at serving scale).

The compile-time half of the paper's hybrid architecture is the batched
HMOOC service (:mod:`.service`); this module scales the runtime half: the
AQE-triggered θp/θs re-tuning of *many concurrent queries* served through
one shared, vectorized optimizer backend.

Each query advances through its
:func:`~repro_torch.queryengine.aqe.aqe_request_stream` — the generator form of
the AQE planning loop, which yields L̄QP/QS requests instead of invoking
synchronous callbacks.  Every round the session collects the outstanding
request of each still-active query and fuses them:

* same-kind **oracle** requests stack their candidate rows into ONE
  :func:`~repro_torch.queryengine.simulator.simulate_stage_rows` call;
* same-model requests stack into ONE :meth:`PerfModel.predict` call
  (cached GTN embeddings; the misses of a round resolve in one
  :meth:`PerfModel.embed_round` dispatch a model and node width, of a
  batch width set by the device alone);
* every pick resolves through
  :func:`~repro_torch.core.tuning.runtime.weighted_pick_batch`, which
  routes dominance filtering and weighted-sum scoring to the CUDA
  ``pareto_filter`` / ``ws_reduce`` kernels on the session's device (every
  set on the card by default) above the same env-gated thresholds as the
  compile-time solver, and to float64 numpy on the host.

After planning, execution realization fuses the same way: one stage-core
call per stage *kind* across all queries, folded back per query with
:func:`~repro_torch.queryengine.simulator.assemble_query_sim`.

Because the fused paths run the identical code the per-query loop runs
(single-request batches), ``run_batch`` output is bit-identical to calling
:func:`~repro_torch.queryengine.aqe.run_with_aqe` with
:func:`~repro_torch.core.tuning.runtime.make_runtime_optimizers` callbacks
per query on the oracle backend under the same kernel routing; the f32
kernels (the card's default routing) carry the usual f32 tie caveat
against the host's float64 numpy routing.

The session is an *open set*: entries join (:meth:`RuntimeSession.admit`)
and retire (:meth:`RuntimeSession.retire_ready`) independently, and
:meth:`RuntimeSession.step_round` fuses whatever is outstanding *right
now* — so a streaming server can admit late arrivals between fusion rounds
of a running session.  Every per-query decision depends only on that
query's own candidate rows (scoring is row-independent and each weighted
pick normalizes within its own set), so batch composition never changes a
query's outcome: mid-session admission keeps the bit-identity guarantee.
``run_batch`` is the closed-set convenience wrapper over the same
lifecycle.

Seeds flow from the compile-time layer: a
:class:`~repro_torch.serve.TuningService` batch returns per-query
:class:`CompileTimeResult` objects whose per-subQ θp/θs become the runtime
candidate seeds and whose aggregated submission copies
(``core/tuning/aggregation.py``) initialize the live θp/θs.

Multi-tenant serving: every entry may carry its own preference vector
(``admit(..., weights=...)``) — fused picks resolve per-entry weights
through :func:`weighted_pick_batch`'s per-set path — and model-backed
re-scoring consumes the paper's §4.3 contention features γ
(``gamma_mode``: structural per-query siblings by default, live
open-entry-set pressure opt-in, or zeroed).

The session runs on one torch device (``device=None`` = the CUDA card,
resolved when the session is built) and hands it to every backend.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from ..core.models.features import contention_gamma
from ..core.models.perf_model import PerfModel
from ..core.tuning.compile_time import CompileTimeResult
from ..device import resolve_device
from ..core.tuning.runtime import (RuntimeOptimizerBackend, fusion_key,
                                   score_requests, stage_pressure,
                                   structural_pressure, weighted_pick_batch)
from ..queryengine.aqe import (AQEPlanState, AQEResult, aqe_request_stream)
from ..queryengine.plan import Query
from ..queryengine.simulator import (CostModel, DEFAULT_COST, SubQSim,
                                     assemble_query_sim, decide_join,
                                     join_decision_stats,
                                     simulate_stage_rows, stage_stats_batch)
from .cache import CandidatePoolCache

__all__ = ["RuntimeSession", "RuntimeSessionStats", "CandidatePoolCache"]


@dataclasses.dataclass
class RuntimeSessionStats:
    n_queries: int = 0
    rounds: int = 0                  # lock-step fusion rounds
    fused_calls: int = 0             # backend calls actually issued
    requests_sent: int = 0           # optimizer requests serviced
    requests_total: int = 0          # unpruned baseline (~2m per query)
    wall_time: float = 0.0

    @property
    def prune_rate(self) -> float:
        if self.requests_total == 0:
            return 0.0
        return 1.0 - self.requests_sent / self.requests_total


@dataclasses.dataclass
class _Entry:
    query: Query
    ct: CompileTimeResult
    backend: RuntimeOptimizerBackend
    gen: object                              # aqe_request_stream generator
    pending: object = None                   # outstanding LQP/QS request
    state: Optional[AQEPlanState] = None
    final_join: Optional[np.ndarray] = None  # reported (m,) algorithms
    realized: Optional[np.ndarray] = None    # algorithms realized in the sim
    rng: Optional[np.random.Generator] = None
    tag: object = None                       # caller handle (e.g. server rid)
    weights: Optional[tuple] = None          # per-entry (tenant) preference
    gamma_raw: Optional[np.ndarray] = None   # (m, 3) intra-query γ sums
    gamma_depths: Optional[np.ndarray] = None  # (m,) stage depths

    @property
    def done(self) -> bool:
        """Planning finished (generator exhausted, realization pending)."""
        return self.pending is None and self.state is not None


def _slice_subqsim(sim: SubQSim, r: int) -> SubQSim:
    return SubQSim(**{f.name: getattr(sim, f.name)[r:r + 1]
                      for f in dataclasses.fields(SubQSim)})


class RuntimeSession:
    """Runtime (§5.2) re-optimization server for batches of queries."""

    def __init__(
        self,
        *,
        model_subq: Optional[PerfModel] = None,
        model_qs: Optional[PerfModel] = None,
        weights: Tuple[float, float] = (0.9, 0.1),
        n_candidates: int = 64,
        cost: CostModel = DEFAULT_COST,
        seed: int = 0,
        prune: bool = True,
        pool_cache: Optional[CandidatePoolCache] = None,
        gamma_mode: str = "structural",
        device=None,
    ):
        """``gamma_mode`` controls the §4.3 contention features the model
        backends consume (the oracle backend ignores γ entirely):

        * ``"structural"`` (default) — per-stage γ from the query's own
          same-depth sibling stages (:func:`structural_gamma`): nonzero,
          matches the trace-collection definition, and depends only on the
          query — so serving output stays bit-identical to the offline
          pipeline however the stream is sliced.
        * ``"live"`` — structural γ *plus* cross-query pressure from the
          open entry set at each fusion round (co-running queries'
          outstanding stages).  Adaptive to real concurrency, but decisions
          then depend on batch composition: the bit-identity guarantee is
          deliberately traded away.
        * ``"off"`` — γ zeroed.

        ``device`` (``None`` = the CUDA card) is where every backend's
        dominance and weighted-sum kernels run; the models run on their own
        devices.
        """
        if gamma_mode not in ("off", "structural", "live"):
            raise ValueError(f"unknown gamma_mode: {gamma_mode!r}")
        self.device = resolve_device(device)
        self.model_subq = model_subq
        self.model_qs = model_qs
        self.weights = weights
        self.n_candidates = n_candidates
        self.cost = cost
        self.seed = seed
        self.prune = prune
        self.gamma_mode = gamma_mode
        self.pool_cache = pool_cache if pool_cache is not None \
            else CandidatePoolCache()
        self.last_batch = RuntimeSessionStats()
        # Open entry set: entries join via admit() and leave via
        # retire_ready(); step_round() fuses whatever is outstanding now.
        self._active: List[_Entry] = []
        self.rounds_total = 0        # fusion rounds over the session's life
        self.fused_total = 0         # fused backend calls, cumulative
        self.admitted_total = 0

    # -- open-set lifecycle --------------------------------------------------
    def admit(
        self,
        query: Query,
        ct: CompileTimeResult,
        *,
        rng: Optional[np.random.Generator] = None,
        tag: object = None,
        weights: Optional[Tuple[float, float]] = None,
        pool_scope: object = None,
    ) -> _Entry:
        """Join ``query`` to the running session (between fusion rounds).

        ``ct`` seeds the entry: θc fixes its cluster, per-subQ θp/θs become
        runtime candidates, and the aggregated submission copies initialize
        the live θp/θs.  Admission order only affects row order inside fused
        calls — never any query's decisions — so joining a running session
        yields the same plan as joining a fresh one.

        ``weights`` is the entry's own preference vector (a tenant's MOO
        weights); ``None`` inherits the session default, reproducing the
        single-stream behavior bit-identically.  ``pool_scope`` scopes the
        candidate-pool cache entry (tenant isolation; the draw itself is
        scope-independent).
        """
        w = tuple(weights) if weights is not None else tuple(self.weights)
        has_model = self.model_subq is not None or self.model_qs is not None
        gamma = None                                  # backend auto/none
        if self.gamma_mode == "off":
            gamma = np.zeros((query.n_subqs, 4), np.float64)
        backend = RuntimeOptimizerBackend(
            query, ct.theta_c, seed_theta_p=ct.theta_p_sub,
            seed_theta_s=ct.theta_s_sub, model_subq=self.model_subq,
            model_qs=self.model_qs, weights=w,
            cost=self.cost,
            pools=self.pool_cache.get(self.seed, self.n_candidates,
                                      scope=pool_scope),
            gamma_by_stage=gamma, device=self.device)
        gen = aqe_request_stream(query, ct.theta_c, ct.theta_p0, ct.theta_s0,
                                 prune=self.prune)
        e = _Entry(query=query, ct=ct, backend=backend, gen=gen, rng=rng,
                   tag=tag, weights=w)
        if self.gamma_mode == "live" and has_model:
            e.gamma_raw, e.gamma_depths = structural_pressure(query)
        self._step(e, None)
        self._active.append(e)
        self.admitted_total += 1
        return e

    @property
    def n_active(self) -> int:
        return len(self._active)

    def has_pending(self) -> bool:
        """True when some active entry has an outstanding optimizer request."""
        return any(e.pending is not None for e in self._active)

    def pending_tags(self) -> list:
        """Tags of the entries the next fusion round serves."""
        return [e.tag for e in self._active if e.pending is not None]

    def step_round(self) -> int:
        """One fusion round over every outstanding request; 0 when idle.

        Collects each waiting entry's request, fuses them into batched
        backend calls, resolves the weighted picks, and advances each
        generator.  Returns the number of requests serviced.
        """
        waiting = [e for e in self._active if e.pending is not None]
        if not waiting:
            return 0
        self.rounds_total += 1
        reqs, cands = [], []
        for e in waiting:
            sr, cand = e.backend.request_for(e.pending)
            if e.gamma_raw is not None:
                sr.gamma = self._live_gamma(e, sr.subq.sq_id)
            reqs.append(sr)
            cands.append(cand)
        self.fused_total += len({fusion_key(sr) for sr in reqs}) + 1  # + pick
        tr = tracing.TRACE
        if tr is not None:
            sp = tr.open("round.score")
        Fs = score_requests(reqs)
        if tr is not None:
            tr.close(sp, requests=len(reqs))
            sp = tr.open("round.pick")
        picks = weighted_pick_batch(
            Fs, np.asarray([e.weights for e in waiting], np.float64),
            device=self.device)
        if tr is not None:
            tr.close(sp)
        for e, cand, j in zip(waiting, cands, picks):
            self._step(e, cand[j])
        return len(waiting)

    def _live_gamma(self, e: _Entry, sq_id: int) -> np.ndarray:
        """γ for one request under ``gamma_mode="live"``: the entry's
        intra-query sibling sums plus the pressure of every *other* active
        entry's outstanding stage (the open entry set, right now)."""
        cross_t = cross_w = 0.0
        n_co = 0
        for o in self._active:
            if o is e or o.pending is None:
                continue
            t, w = stage_pressure(o.pending.subq)
            cross_t += t
            cross_w += w
            n_co += 1
        raw = e.gamma_raw[sq_id]
        return contention_gamma(raw[0] + cross_t, raw[1] + cross_w,
                                raw[2] + n_co, e.gamma_depths[sq_id])

    def retire_ready(self) -> List[_Entry]:
        """Remove and return entries whose planning pass has finished.

        Returned entries are ready for :meth:`realize`; admission order is
        preserved.
        """
        done = [e for e in self._active if e.done]
        if done:
            self._active = [e for e in self._active if not e.done]
        return done

    def realize(self, entries: Sequence[_Entry]) -> List[AQEResult]:
        """Fused execution realization for a cohort of retired entries.

        Row-independent throughout, so realizing per-retirement cohorts
        (streaming) and realizing one big batch (offline) produce identical
        per-query results.
        """
        return self._realize_batch(list(entries))

    # -- closed-set convenience ---------------------------------------------
    def run_batch(
        self,
        queries: Sequence[Query],
        compile_results: Sequence[CompileTimeResult],
        *,
        rngs: Optional[Sequence[Optional[np.random.Generator]]] = None,
    ) -> List[AQEResult]:
        """Run AQE with runtime re-tuning for every query; aligned results.

        Admits the whole batch, drains the fusion loop, and realizes —
        the fixed-batch wrapper over the open-set lifecycle.
        """
        if len(queries) != len(compile_results):
            raise ValueError(
                f"got {len(compile_results)} compile results for "
                f"{len(queries)} queries")
        if self._active:
            raise RuntimeError(
                f"run_batch on a session with {len(self._active)} active "
                "entries; use admit()/step_round() for streaming admission")
        t0 = time.perf_counter()
        rounds0, fused0 = self.rounds_total, self.fused_total
        entries = [self.admit(q, ct,
                              rng=rngs[i] if rngs is not None else None)
                   for i, (q, ct) in enumerate(zip(queries, compile_results))]
        while self.step_round():
            pass
        self.retire_ready()
        results = self._realize_batch(entries)
        self.last_batch = RuntimeSessionStats(
            n_queries=len(entries), rounds=self.rounds_total - rounds0,
            fused_calls=self.fused_total - fused0,
            requests_sent=sum(r.requests_sent for r in results),
            requests_total=sum(r.requests_total for r in results),
            wall_time=time.perf_counter() - t0)
        return results

    def tune_and_run(self, queries: Sequence[Query], tuning_service
                     ) -> Tuple[List[CompileTimeResult], List[AQEResult]]:
        """Compile-time batch solve (seeds) + runtime batch execution."""
        cts = tuning_service.tune_batch(queries, self.weights)
        return cts, self.run_batch(queries, cts)

    # -- internals -----------------------------------------------------------
    @staticmethod
    def _step(e: _Entry, response) -> None:
        try:
            e.pending = e.gen.send(response)
        except StopIteration as stop:
            e.pending = None
            e.state = stop.value

    def _realize_batch(self, entries: List[_Entry]) -> List[AQEResult]:
        """Fused execution realization: one stage-core call per stage kind."""
        # Join planning first, fused: every (query, join) pair resolves its
        # true-stats and estimates-based decisions in two decide_join calls
        # (the per-query path runs plan_joins twice per query instead).
        jm = [(i, sq) for i, e in enumerate(entries)
              for sq in e.query.subqs if sq.kind == "join"]
        for e in entries:
            e.final_join = e.state.planned.copy()
            e.realized = e.state.planned.copy()
        if jm:
            subqs = [sq for _, sq in jm]
            tp = np.stack([entries[i].state.theta_p_eff[sq.sq_id]
                           for i, sq in jm])
            parts = np.maximum(tp[:, 4], 1.0)
            true_choice = decide_join(
                *join_decision_stats(subqs, from_estimates=False), tp, parts)
            # simulate_query re-upgrades the given plan against the
            # estimates-based choice under the effective θp; replicate so
            # the realized algorithms match the per-query path exactly.
            est_choice = decide_join(
                *join_decision_stats(subqs, from_estimates=True), tp, parts)
            for r, (i, sq) in enumerate(jm):
                e = entries[i]
                fj = max(e.state.planned[sq.sq_id], float(true_choice[r]))
                e.final_join[sq.sq_id] = fj
                e.realized[sq.sq_id] = max(fj, float(est_choice[r]))

        groups: Dict[str, List[Tuple[int, int]]] = {}
        for idx, e in enumerate(entries):
            for sq in e.query.subqs:
                groups.setdefault(sq.kind, []).append((idx, sq.sq_id))

        sims: Dict[Tuple[int, int], SubQSim] = {}
        for kind, members in groups.items():
            stats = stage_stats_batch(
                [entries[i].query.subqs[s] for i, s in members])
            tc = np.stack([np.asarray(entries[i].ct.theta_c, np.float64)
                           for i, s in members])
            tp = np.stack([entries[i].state.theta_p_eff[s]
                           for i, s in members])
            ts = np.stack([entries[i].state.theta_s_eff[s]
                           for i, s in members])
            algo = None
            if kind == "join":
                algo = np.array([entries[i].realized[s] for i, s in members])
            sim = simulate_stage_rows(kind, stats, tc, tp, ts,
                                      cost=self.cost, aqe=True,
                                      join_algo=algo)
            for r, (i, s) in enumerate(members):
                sims[(i, s)] = _slice_subqsim(sim, r)

        results: List[AQEResult] = []
        for idx, e in enumerate(entries):
            st = e.state
            per = [sims[(idx, s)] for s in range(e.query.n_subqs)]
            qsim = assemble_query_sim(
                e.query, np.asarray(e.ct.theta_c, np.float64)[None, :], per,
                e.final_join[None, :], cost=self.cost, rng=e.rng)
            results.append(AQEResult(
                sim=qsim, theta_p_eff=st.theta_p_eff,
                theta_s_eff=st.theta_s_eff, final_join=e.final_join,
                lqp_requests_sent=st.lqp_requests_sent,
                qs_requests_sent=st.qs_requests_sent,
                requests_total=st.requests_total))
        return results
