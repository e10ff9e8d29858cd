"""Streaming-admission optimizer server (compile-time + runtime, unified).

The paper's cloud constraint is a 1–2 s solving budget per query arriving
in an *online stream*; the two optimizer halves (:mod:`.service`,
:mod:`.runtime`) solve fixed, fully-formed batches.
:class:`OptimizerServer` closes the gap: it accepts queries as they
arrive (a simulated-clock event queue fed by
:func:`~repro_torch.queryengine.workloads.serving_stream` or
:func:`~repro_torch.queryengine.workloads.multi_tenant_stream`),
accumulates them into deadline-aware micro-batches, routes each
micro-batch through the batched compile-time solve
(:meth:`TuningService.tune_batch`) and then drives the resulting AQE
generators through one long-lived, shared :class:`RuntimeSession` —
admitting late arrivals into the *running* session between fusion rounds
instead of holding them for the next batch.

Multi-tenant admission: requests carry a tenant id and each tenant
(:class:`~repro_torch.queryengine.workloads.TenantSpec`) brings its own
MOO preference weights, weighted-fair share, priority tier, and solve
budget.  Waiting-room policy lives in
:class:`~repro_torch.serve.admission.TenantScheduler`: per-tenant queues
with per-tenant deadline reserves, deficit-round-robin micro-batch
composition, and priority tiers bounded by overdue promotion (no tenant
starves).  Tenant weights thread through ``tune_batch`` (per-query
weights + tenant-scoped response-cache keys) and into per-entry runtime
picks; the candidate-pool cache is tenant-scoped too.  Fairness shapes
*latency* only: per-query outputs equal the offline pipeline solved under
that tenant's weights, so tenants can never perturb each other's plans.

Admission policy (deadline-aware micro-batching):

* a micro-batch flushes when ``max_batch`` requests are waiting, or
* when the simulated clock reaches some tenant's flush deadline
  ``oldest arrival + tenant budget − reserve``, where the reserve is a
  per-query EWMA of recent solve times scaled by the expected batch size
  (seeded by ``solve_reserve_s``) — i.e. the latest moment solving can
  start and still make that tenant's budget.

Overload handling: when a waiting request's budget has become
*unmeetable* (its flush deadline has passed — even solving immediately
would blow the budget), the tenant's SLO class decides: ``strict``
requests are **shed** (``status="shed"``: rejected as first-class
outcomes, never solved, excluded from latency percentiles), ``degrade``
requests are admitted through the **cheap compile path**
(``TuningService.tune_batch(degraded=...)``: cached template banks or the
Spark defaults — zero fresh Algorithm 1 solves), and ``best_effort``
requests keep queueing as before.  Under sustained overload the server
sheds/degrades exactly the excess instead of silently blowing every
tenant's budget; surviving queries' outputs are untouched (the golden
determinism invariant extends to overload).

Clock model: arrivals advance on the simulated clock; optimizer work
(compile solves, fusion rounds, realization) advances it by measured wall
time — or, with ``ServerConfig.clock`` set to a :class:`ServiceTimeModel`,
by a calibrated deterministic cost model, making the whole admission
timeline a pure function of the stream and the config.  Batch composition
therefore depends on timing — but no per-query *output* does:
compile-time results are per-query deterministic (caches are exact and
tenant-scoped) and every runtime decision depends only on the query's own
candidate rows and its tenant's weights, so the served plans and
objectives are bit-identical to the offline ``tune_batch`` →
``RuntimeSession.run_batch`` pipeline per tenant, however the stream is
sliced, on the oracle backend and on the model backend (whose regressor
pads its rows to fixed buckets), on the host and on the card.

Device: the server runs on one torch device (``device=None`` = the CUDA
card), which it hands to the service and the session it builds.  The
measured windows need no device synchronisation: ``tune_batch`` returns
host numpy, and a fusion round reads its picks back before it returns,
so every window closes after the card's work inside it.

Caches (:class:`~repro_torch.serve.cache.EffectiveSetCache`,
:class:`~repro_torch.serve.service.ResponseCache`,
:class:`~repro_torch.serve.cache.CandidatePoolCache`) live on the
long-lived service/session objects, so they amortize across micro-batches
and admission epochs — the whole point of serving over per-request
solving.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from ..core.models.perf_model import PerfModel
from ..core.moo.hmooc import HMOOCConfig
from ..core.tuning.compile_time import CompileTimeResult
from ..queryengine.aqe import AQEResult
from ..device import resolve_device
from ..queryengine.workloads import StreamRequest, TenantSpec
from .admission import ElasticController, ElasticPolicy, TenantScheduler
from .runtime import RuntimeSession
from .service import TuningService

__all__ = ["OptimizerServer", "ServerConfig", "ServedQuery", "ServerStats",
           "ServiceTimeModel", "jain_index", "REJECTED_STATUSES"]

Weights = Tuple[float, float]

# Statuses that never produced a plan: excluded from latency percentiles,
# counted against goodput.
REJECTED_STATUSES = ("shed", "rate_limited")


@dataclasses.dataclass(frozen=True)
class ServiceTimeModel:
    """Deterministic charged-time model for the simulated clock.

    By default :meth:`OptimizerServer.serve` charges *measured wall time*
    for optimizer work, so batch composition — and with it every
    shed/degrade/scale decision — inherits host timing noise.  A
    ``ServiceTimeModel`` replaces those charges with a calibrated cost
    model, making ``serve()`` a pure function of the stream and the
    config: two runs over the same scenario charge identical clock
    windows, flush identical batches, and reach identical admission
    outcomes.  Per-query *outputs* are clock-independent either way (the
    golden replay invariant); what the model pins down is the admission
    *timeline*, which is exactly what policy benchmarks (elastic vs
    static capacity) need to compare free of noise.

    ``flush_points`` is a sorted ``((batch_size, seconds), ...)`` table
    of calibrated flush costs (compile solve + admission for one
    micro-batch of that size); charges interpolate linearly between knots
    and extrapolate the outermost segments, clamped at 0.  ``round_s`` is
    charged per fusion round (step + retire + realize).

    Not every batch member costs a full solve: response-cache hits and
    degraded queries (template-bank reuse, default θ) skip the solver and
    cost well under a millisecond where a fresh solve costs tens.
    ``flush_s`` therefore takes the number of such *cheap* members and
    charges ``flush_s(n_full) + n_cheap * cheap_s`` — pricing the very
    mechanism preemptive degradation exploits (converting full solves
    into cheap ones under pressure) instead of flattening it into a
    size-only charge.  Calibrate all three from measured warm flush
    windows — ``chip_smoke.py``'s ``calibrate_clock`` does so on the
    card.

    Worker concurrency: a fleet co-locates ``n_workers`` replicas on the
    shared host, so each replica's optimizer work runs slower than the
    single-process calibration by a contention factor.  ``worker_scale``
    is a ``((n_workers, multiplier), ...)`` knot table (same interpolation
    rules as ``flush_points``; the default single knot ``((1, 1.0),)``
    means no contention at any width) and every charged cost — flush,
    round, cheap member — is scaled by the multiplier at ``n_workers``.
    :meth:`with_workers` re-prices the *same* calibrated model for a
    different replica count, so a fleet's per-worker admission timelines
    stay a pure function of stream + config at every width.
    """
    flush_points: Tuple[Tuple[int, float], ...]
    round_s: float = 0.0
    cheap_s: float = 0.0
    n_workers: int = 1
    worker_scale: Tuple[Tuple[int, float], ...] = ((1, 1.0),)

    def __post_init__(self):
        pts = tuple(sorted((int(n), float(s)) for n, s in self.flush_points))
        object.__setattr__(self, "flush_points", pts)
        if not pts:
            raise ValueError("flush_points needs at least one knot")
        if pts[0][0] < 1 or len({n for n, _ in pts}) != len(pts):
            raise ValueError(f"batch-size knots must be unique and >= 1, "
                             f"got {pts}")
        bad = [s for _, s in pts] + [self.round_s, self.cheap_s]
        if any(not math.isfinite(s) or s < 0.0 for s in bad):
            raise ValueError(f"costs must be finite and >= 0, got {bad}")
        object.__setattr__(self, "n_workers", int(self.n_workers))
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        ws = tuple(sorted((int(n), float(m)) for n, m in self.worker_scale))
        object.__setattr__(self, "worker_scale", ws)
        if not ws or ws[0][0] < 1 or len({n for n, _ in ws}) != len(ws):
            raise ValueError(f"worker-count knots must be unique and >= 1, "
                             f"got {ws}")
        if any(not math.isfinite(m) or m <= 0.0 for _, m in ws):
            raise ValueError(f"worker-scale multipliers must be finite and "
                             f"> 0, got {ws}")

    def flush_s(self, n: int, n_cheap: int = 0) -> float:
        """Charged cost of flushing ``n`` queries, ``n_cheap`` of which
        skipped the full solver (cache hits / degraded paths)."""
        n_cheap = min(max(int(n_cheap), 0), int(n))
        full = int(n) - n_cheap
        return (self._interp(full)
                + n_cheap * self.cheap_s) * self.worker_mult()

    def round_cost_s(self) -> float:
        """Charged cost of one fusion round at the current worker count."""
        return self.round_s * self.worker_mult()

    def worker_mult(self) -> float:
        """Contention multiplier of ``worker_scale`` at ``n_workers``."""
        return self._interp_pts(self.worker_scale, self.n_workers)

    def with_workers(self, n: int) -> "ServiceTimeModel":
        """The same calibrated model re-priced for ``n`` co-located
        workers (idempotent: only ``n_workers`` changes)."""
        return dataclasses.replace(self, n_workers=int(n))

    def _interp(self, n: int) -> float:
        if n <= 0:
            return 0.0
        return self._interp_pts(self.flush_points, n)

    @staticmethod
    def _interp_pts(pts: Tuple[Tuple[int, float], ...], n: int) -> float:
        if len(pts) == 1:
            return pts[0][1]
        if n <= pts[0][0]:
            (n0, s0), (n1, s1) = pts[0], pts[1]
        elif n >= pts[-1][0]:
            (n0, s0), (n1, s1) = pts[-2], pts[-1]
        else:
            i = next(i for i in range(1, len(pts)) if n <= pts[i][0])
            (n0, s0), (n1, s1) = pts[i - 1], pts[i]
        return max(s0 + (s1 - s0) * (n - n0) / (n1 - n0), 0.0)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Admission/scheduling policy of the streaming server."""
    max_batch: int = 8                 # flush when this many requests wait
    solve_budget_s: float = 1.0        # the paper's per-query cloud budget
    solve_reserve_s: float = 0.25      # initial per-QUERY solve reserve (EWMA
                                       # seed; deadlines scale it by the
                                       # expected batch size)
    reserve_ewma: float = 0.3          # EWMA weight of the newest solve
    admit_mid_session: bool = True     # late arrivals join the running session
    isolate_tenant_pools: bool = True  # tenant-scoped candidate-pool entries
    elastic: Optional[ElasticPolicy] = None  # None → static capacity
    clock: Optional[ServiceTimeModel] = None  # None → measured wall time


@dataclasses.dataclass
class ServedQuery:
    """One request's lifecycle through the server (simulated-clock times).

    ``status`` is the request's admission outcome:

    * ``"served"``   — full-quality solve, finished normally;
    * ``"degraded"`` — budget was unmeetable at admission and the tenant's
      SLO class is ``degrade``: solved via the cheap compile path
      (template-cache banks / Spark defaults, no fresh Algorithm 1);
    * ``"shed"``     — budget was unmeetable and the tenant's SLO class is
      ``strict``: rejected without solving (``ct``/``result`` stay None;
      ``finished_s`` records the rejection time);
    * ``"rate_limited"`` — rejected at the door by the tenant's token
      bucket: never enqueued, never composed, never solved
      (``finished_s`` is the arrival time).

    Latency reports must aggregate over finished (non-rejected) queries
    only — a shed query's ``compiled_s`` is NaN by construction.
    """
    rid: int
    request: StreamRequest
    arrival_s: float
    tenant: str = "default"
    status: str = "served"      # served | degraded | shed | rate_limited
    admitted_s: float = math.nan       # micro-batch flush began
    compiled_s: float = math.nan       # compile-time θ ready
    finished_s: float = math.nan       # final plan realized (or shed time)
    joined_running: bool = False       # admitted into an already-live session
    ct: Optional[CompileTimeResult] = None
    result: Optional[AQEResult] = None
    worker: Optional[int] = None       # fleet replica index that served it
                                       # (None outside a fleet)

    @property
    def solve_latency_s(self) -> float:
        """Arrival-to-compile-time-θ latency (the paper's solve budget is
        stated against this span: it includes the waiting-room time)."""
        return self.compiled_s - self.arrival_s

    @property
    def plan_latency_s(self) -> float:
        """Arrival-to-final-plan latency (through runtime re-tuning)."""
        return self.finished_s - self.arrival_s


@dataclasses.dataclass
class ServerStats:
    n_queries: int = 0
    n_finished: int = 0                # solved to completion (non-rejected)
    n_micro_batches: int = 0
    n_joined_running: int = 0          # admissions into a live session
    n_shed: int = 0                    # strict-SLO rejections
    n_degraded: int = 0                # degrade-SLO cheap-path admissions
    n_rate_limited: int = 0            # token-bucket door rejections
    rounds: int = 0                    # fusion rounds over the run
    makespan_s: float = 0.0            # last *served* finish − first arrival
                                       # (sim; rejections don't extend it)
    wall_time_s: float = 0.0           # real time spent in serve()
    tenant_slots: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Per-flush (charged clock window, batch size): the exact amounts the
    # simulated clock advanced by and note_solve folded into the reserve
    # EWMAs — the reserve regression test replays these.
    flush_windows: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    # Per-flush (tune_batch wall time, batch size): the compile-time solve
    # slice of each flush window, excluding AQE admission — what a p99
    # solve latency of the batched solve alone is read from.
    tune_windows: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    # Per-flush batch cap in effect at compose time (capacity events +
    # elastic scaling visible per flush; constant without either).
    flush_caps: List[int] = dataclasses.field(default_factory=list)
    # The call's spans and counter deltas (``tracing``); None when tracing
    # was off.
    trace: Optional[tracing.Trace] = None

    @property
    def qps(self) -> float:
        """Served throughput: *finished* queries over the makespan — a shed
        request is rejected, not served, and must not inflate qps."""
        return self.n_finished / self.makespan_s if self.makespan_s else 0.0


class OptimizerServer:
    """Unified streaming server over both optimizer halves.

    One instance is a long-lived process: :meth:`serve` can be called on
    successive streams and every cache — and the tenant scheduler's
    fairness/reserve state — keeps amortizing.
    """

    def __init__(
        self,
        *,
        config: ServerConfig = ServerConfig(),
        weights: Optional[Weights] = None,
        cfg: Optional[HMOOCConfig] = None,
        model: Optional[PerfModel] = None,
        tuning: Optional[TuningService] = None,
        session: Optional[RuntimeSession] = None,
        tenants: Sequence[TenantSpec] = (),
        device=None,
    ):
        """``weights`` parameterizes the default-built session and is the
        fallback preference for tenants that configure none; ``cfg`` and
        ``model`` parameterize the default-built *compile-time* service
        (``model`` is the §5.1 subQ objective model; the default session
        stays on the oracle runtime backend).  For model-backed runtime
        re-scoring pass a prebuilt ``session`` with
        ``model_subq``/``model_qs`` set; prebuilt ``tuning``/``session``
        objects also share caches across servers.  ``tenants`` registers
        per-tenant admission policy (weights, share, priority, budget);
        tenant ids not listed get default policy on first sight.  Mixing a
        prebuilt object with the knobs it subsumes is rejected rather than
        silently resolved.

        ``device`` (``None`` = the CUDA card) is where the default-built
        service and session run.  Prebuilt objects keep their own device:
        with ``device=None`` the server takes theirs (they must agree), and
        an explicit ``device`` that differs from one of them is rejected."""
        if tuning is not None and (cfg is not None or model is not None):
            raise ValueError(
                "pass cfg/model or a prebuilt tuning service, not both")
        if session is not None and weights is not None \
                and tuple(weights) != tuple(session.weights):
            raise ValueError(
                f"weights={tuple(weights)} conflicts with the prebuilt "
                f"session's weights={tuple(session.weights)}")
        self.device = _server_device(device, tuning, session)
        self.config = config
        self.tuning = tuning if tuning is not None else TuningService(
            model=model, cfg=cfg if cfg is not None else HMOOCConfig(),
            device=self.device)
        self.session = session if session is not None else RuntimeSession(
            weights=weights if weights is not None else (0.9, 0.1),
            device=self.device)
        self.weights = self.session.weights
        self.scheduler = TenantScheduler(
            tenants, budget_s=config.solve_budget_s,
            reserve_q_s=config.solve_reserve_s,
            reserve_ewma=config.reserve_ewma)
        # Long-lived like the scheduler: the queue-delay forecast keeps
        # amortizing across serve() epochs.
        self.elastic = (ElasticController(config.elastic)
                        if config.elastic is not None else None)
        self.last_run = ServerStats()

    # -- per-tenant policy ---------------------------------------------------
    def tenant_weights(self, tenant: str) -> Weights:
        w = self.scheduler.state(tenant).weights
        return tuple(w) if w is not None else tuple(self.weights)

    # -- main loop -----------------------------------------------------------
    def serve(self, requests: Sequence[StreamRequest], *,
              capacity_events: Sequence[Tuple[float, int]] = ()
              ) -> List[ServedQuery]:
        """Serve a timed stream to completion; results in request order.

        Each returned :class:`ServedQuery` carries the compile-time result,
        the realized :class:`AQEResult`, and the simulated-clock lifecycle
        times the latency metrics derive from.

        ``capacity_events`` is an optional ``(at_s, max_batch)`` timeline
        (e.g. :attr:`~repro_torch.queryengine.scenarios.Scenario.capacity_events`)
        changing the server's *base* batch cap on the simulated clock —
        modelling executors joining/leaving the deployment.  With
        ``config.elastic`` set, an :class:`ElasticController` additionally
        scales the base cap from its queue-delay forecast and arms
        preemptive degradation of ``degrade``-class heads.

        A request whose ``StreamRequest.weights`` is set is solved under
        exactly those weights (scenario streams stamp mid-stream
        preference shifts per request at build time); otherwise the
        tenant's registered weights apply.

        With tracing on (:func:`tracing.enable`, a ``torch.profiler``
        recording when the call starts, or inside a caller's
        :func:`tracing.recording`) ``last_run.trace`` holds the call's
        spans: ``serve`` > ``flush`` and ``round``, each ``flush`` and
        ``round`` with the deltas of :meth:`counters`.
        """
        if tracing.TRACE is not None:
            return self._serve_traced(requests, capacity_events,
                                      tracing.TRACE)
        if not (tracing.enabled() or tracing.profiler_recording()):
            return self._serve(requests, capacity_events, None)
        with tracing.recording() as tr:
            return self._serve_traced(requests, capacity_events, tr)

    def _serve_traced(self, requests, capacity_events,
                      tr: tracing.Trace) -> List[ServedQuery]:
        root = tr.open("serve")
        out = self._serve(requests, capacity_events, tr)
        tr.close(root)
        self.last_run.trace = tr
        return out

    def counters(self) -> Dict[str, int]:
        """The cumulative counters a trace records deltas of: K1 launches,
        and the performance models' embedding-memo misses, those embedded
        at a node width above four (stages of five operators or more), the
        GTN dispatches that embedded them (a round's misses take one a
        model and node width),
        host-to-device copies, the regressor rows ``predict_rows`` scored
        and the θ rows it copied to the device (``theta_rows_sent`` over
        ``rows_predicted`` on a flush is the share of rows the stage
        evaluation could not deduplicate), summed over the distinct
        models."""
        return self._counter_reader()()

    def _counter_reader(self):
        """A function that reads :meth:`counters` (what it reads is looked
        up once, so a traced flush or round pays only the reads)."""
        # repro: allow[KP003] reads the kernels' launch counter; routes nothing to a kernel
        from ..kernels.pareto_filter import ops as pareto_ops  # lazy
        models: List[PerfModel] = []
        for m in (self.tuning.model, self.session.model_subq,
                  self.session.model_qs):
            if m is not None and all(m is not o for o in models):
                models.append(m)

        def read() -> Dict[str, int]:
            return {"k1_launches": pareto_ops.LAUNCHES,
                    "emb_misses": sum([m.emb_misses for m in models]),
                    "emb_wide_misses": sum([m.emb_wide_misses
                                            for m in models]),
                    "emb_dispatches": sum([m.emb_dispatches
                                           for m in models]),
                    "h2d_copies": sum([m.h2d_copies for m in models]),
                    "rows_predicted": sum([m.rows_predicted
                                           for m in models]),
                    "theta_rows_sent": sum([m.theta_rows_sent
                                            for m in models])}
        return read

    def _serve(self, requests: Sequence[StreamRequest],
               capacity_events: Sequence[Tuple[float, int]],
               tr: Optional[tracing.Trace]) -> List[ServedQuery]:
        counters = self._counter_reader() if tr is not None else None
        wall0 = time.perf_counter()
        cfgv = self.config
        sched = self.scheduler
        if self.session.n_active:
            raise RuntimeError(
                f"serve() requires an idle session; {self.session.n_active} "
                "entries are already active (admitted outside this server)")
        if sched.total_waiting():
            raise RuntimeError(
                "serve() requires an empty admission queue; "
                f"{sched.total_waiting()} requests are already waiting")
        served: Dict[int, ServedQuery] = {
            r.rid: ServedQuery(rid=r.rid, request=r, arrival_s=r.arrival_s,
                               tenant=r.tenant)
            for r in requests}
        if len(served) != len(requests):
            raise ValueError(
                f"duplicate rids in request stream: {len(requests)} requests "
                f"but {len(served)} distinct rids")
        incoming = sorted(served.values(),
                          key=lambda s: (s.arrival_s, s.rid))
        pos = 0                                # next unadmitted arrival
        in_flight: Dict[int, ServedQuery] = {}  # rid -> admitted, unrealized
        t = incoming[0].arrival_s if incoming else 0.0
        first_arrival = t
        n_batches = 0
        n_joined_running = 0
        n_shed = 0
        n_degraded = 0
        n_rate_limited = 0
        flush_windows: List[Tuple[float, int]] = []
        tune_windows: List[Tuple[float, int]] = []
        flush_caps: List[int] = []
        flushes_since_round = 0
        rounds0 = self.session.rounds_total
        slots0 = {st.name: st.slots_granted for st in sched.states()}
        cap_events = sorted(((float(at), int(mb))
                             for at, mb in capacity_events),
                            key=lambda e: e[0])
        ev_pos = 0
        base_cap = cfgv.max_batch

        def apply_capacity(now: float) -> None:
            nonlocal ev_pos, base_cap
            while ev_pos < len(cap_events) and cap_events[ev_pos][0] <= now:
                base_cap = cap_events[ev_pos][1]
                ev_pos += 1

        def cur_cap() -> int:
            return (self.elastic.batch_cap(base_cap) if self.elastic
                    else base_cap)

        def admit_arrived(now: float) -> None:
            nonlocal pos, n_rate_limited
            while pos < len(incoming) and incoming[pos].arrival_s <= now:
                s = incoming[pos]
                if sched.admit_arrival(s.tenant, s, s.arrival_s):
                    pos += 1
                    continue
                # Door rejection: the token bucket (clocked by arrival
                # times) said no — a first-class outcome, never solved.
                s.status = "rate_limited"
                s.finished_s = s.arrival_s
                n_rate_limited += 1
                pos += 1

        def flush_due(now: float) -> bool:
            if not sched.total_waiting():
                return False
            if self.session.n_active:
                # A session is live: join it eagerly between fusion rounds
                # (the optimizer is busy either way), unless running
                # batch-only.  At most one flush per round, so sustained
                # arrivals can never starve in-flight queries of the rounds
                # they need to finish.
                return cfgv.admit_mid_session and flushes_since_round < 1
            if sched.total_waiting() >= cur_cap():
                return True
            if pos >= len(incoming):
                # End of stream: nothing else will arrive, waiting longer
                # only adds latency.
                return True
            return sched.deadline_due(now, cur_cap())

        def finish(cohort, results, now: float) -> None:
            for e, res in zip(cohort, results):
                s = served[e.tag]
                s.result = res
                s.finished_s = now
                in_flight.pop(s.rid, None)

        admit_arrived(t)
        apply_capacity(t)
        while pos < len(incoming) or sched.total_waiting() or in_flight:
            apply_capacity(t)
            if flush_due(t):
                if tr is not None:
                    sp = tr.open("flush")
                    c0 = counters()
                cap = cur_cap()
                # Overload triage first: strict-SLO requests whose budget is
                # already unmeetable are rejected here — first-class
                # outcomes, never solved, never poisoning latency stats.
                for _, s in sched.shed_unmeetable(t, cap):
                    s.status = "shed"
                    s.finished_s = t
                    n_shed += 1
                lead = (self.elastic.degrade_lead_s(
                            cfgv.solve_budget_s, sched.default_reserve_q_s,
                            base_cap)
                        if self.elastic else 0.0)
                admits = sched.compose(t, cap, lead)
                if not admits:
                    if tr is not None:
                        tr.close(sp, rids=[], cap=cap, n_solved=0,
                                 n_cheap=0,
                                 counters=_deltas(c0, counters()))
                    continue           # everything waiting was shed
                batch = [a.item for a in admits]
                n_batches += 1
                flushes_since_round += 1
                flush_caps.append(cap)
                if self.elastic:
                    # Observed queue delay of this flush (mean wait at
                    # compose time) feeds the forecast for the next one.
                    self.elastic.note_flush(
                        sum(t - s.arrival_s for s in batch) / len(batch))
                for a, s in zip(admits, batch):
                    s.admitted_s = t
                    if a.degrade:
                        s.status = "degraded"
                        n_degraded += 1
                batch_w = [tuple(s.request.weights)
                           if s.request.weights is not None
                           else self.tenant_weights(s.tenant)
                           for s in batch]
                t0 = time.perf_counter()
                cts = self.tuning.tune_batch(
                    [s.request.query for s in batch], batch_w,
                    tenants=[s.tenant for s in batch],
                    degraded=[a.degrade for a in admits])
                tune_windows.append((self.tuning.last_batch.wall_time,
                                     len(batch)))
                joined_running = self.session.n_active > 0
                if tr is not None:
                    sp_admit = tr.open("session_admit")
                for s, ct, w in zip(batch, cts, batch_w):
                    s.ct = ct
                    s.joined_running = joined_running
                    if joined_running:
                        n_joined_running += 1
                    self.session.admit(
                        s.request.query, ct, tag=s.rid, weights=w,
                        pool_scope=(s.tenant if cfgv.isolate_tenant_pools
                                    else None))
                    in_flight[s.rid] = s
                if tr is not None:
                    tr.close(sp_admit)
                # One window feeds both the clock charge and the reserve
                # EWMA: the whole flush — the batched solve plus each
                # query's initial AQE planning step inside admit().
                # (Feeding note_solve only the tune_batch slice made the
                # reserve undershoot the true per-query admission cost.)
                # Under a ServiceTimeModel the charged window is the
                # model's, so the admission timeline is deterministic.
                # Cheap members (cache hits + degraded paths, per the
                # tuning service's own accounting of the flush we just
                # ran) are priced at cheap_s instead of the solve curve.
                n_cheap = len(batch) - self.tuning.last_batch.n_solved
                window = (cfgv.clock.flush_s(len(batch), n_cheap)
                          if cfgv.clock is not None
                          else time.perf_counter() - t0)
                sched.note_solve(window, len(batch),
                                 (s.tenant for s in batch))
                flush_windows.append((window, len(batch)))
                t += window
                for s in batch:
                    s.compiled_s = t
                admit_arrived(t)
                if tr is not None:
                    tr.close(sp, rids=[s.rid for s in batch], cap=cap,
                             n_solved=self.tuning.last_batch.n_solved,
                             n_cheap=n_cheap,
                             counters=_deltas(c0, counters()))
                continue
            if self.session.has_pending() or self.session.n_active:
                if tr is not None:
                    sp = tr.open("round")
                    c0 = counters()
                    rids = self.session.pending_tags()
                flushes_since_round = 0
                t0 = time.perf_counter()
                self.session.step_round()
                if tr is not None:
                    sp_retire = tr.open("round.retire")
                done = self.session.retire_ready()
                results = self.session.realize(done) if done else []
                if tr is not None:
                    tr.close(sp_retire, retired=len(done))
                t += (cfgv.clock.round_cost_s() if cfgv.clock is not None
                      else time.perf_counter() - t0)
                if done:
                    finish(done, results, t)
                admit_arrived(t)
                if tr is not None:
                    tr.close(sp, rids=rids,
                             counters=_deltas(c0, counters()))
                continue
            # Idle: jump the simulated clock to the next event (arrival,
            # flush deadline, or capacity change — a cap drop can make the
            # waiting pool flush-ready with no new arrival).
            nxt = min(incoming[pos].arrival_s if pos < len(incoming)
                      else math.inf,
                      sched.next_deadline(cur_cap()),
                      cap_events[ev_pos][0] if ev_pos < len(cap_events)
                      else math.inf)
            if not math.isfinite(nxt):
                break
            t = max(t, nxt)
            admit_arrived(t)
            apply_capacity(t)

        out = [served[r.rid] for r in requests]
        # Makespan spans *served* work only: a shed/rate-limited request's
        # finished_s is a rejection timestamp, not service — counting it
        # would stretch the makespan (and deflate qps) on tail-shed streams
        # where the last event is a rejection, not a finish.
        finished = [s.finished_s for s in out
                    if s.status not in REJECTED_STATUSES
                    and math.isfinite(s.finished_s)]
        self.last_run = ServerStats(
            n_queries=len(out),
            n_finished=sum(1 for s in out
                           if s.status not in REJECTED_STATUSES
                           and math.isfinite(s.finished_s)),
            n_micro_batches=n_batches,
            n_joined_running=n_joined_running,
            n_shed=n_shed, n_degraded=n_degraded,
            n_rate_limited=n_rate_limited,
            rounds=self.session.rounds_total - rounds0,
            makespan_s=(max(finished) - first_arrival) if finished else 0.0,
            wall_time_s=time.perf_counter() - wall0,
            tenant_slots={st.name: st.slots_granted - slots0.get(st.name, 0)
                          for st in sched.states()
                          if st.slots_granted - slots0.get(st.name, 0)},
            flush_windows=flush_windows,
            tune_windows=tune_windows,
            flush_caps=flush_caps)
        return out

    # -- reporting -----------------------------------------------------------
    def _goodput(self, sub: Sequence[ServedQuery]) -> float:
        """Fraction of requests finishing inside their tenant's budget.

        Rejected requests (shed or rate-limited) count against goodput —
        they never produced a plan; the denominator is *all* requests, so
        goodput + rejection rate + late rate partition the stream.
        """
        if not sub:
            return math.nan
        ok = sum(1 for s in sub
                 if s.status not in REJECTED_STATUSES
                 and math.isfinite(s.finished_s)
                 and s.plan_latency_s
                 <= self.scheduler.state(s.tenant).budget_s)
        return ok / len(sub)

    @staticmethod
    def _counts(sub: Sequence[ServedQuery]) -> dict:
        """Status counts + rates over one sample of served queries."""
        n_shed = sum(1 for s in sub if s.status == "shed")
        n_deg = sum(1 for s in sub if s.status == "degraded")
        n_rl = sum(1 for s in sub if s.status == "rate_limited")
        n = len(sub)
        return {
            "n_shed": n_shed,
            "n_degraded": n_deg,
            "n_rate_limited": n_rl,
            "shed_rate": n_shed / n if n else math.nan,
            "degrade_rate": n_deg / n if n else math.nan,
            "rate_limited_rate": n_rl / n if n else math.nan,
        }

    def latency_report(self, served: Sequence[ServedQuery], *,
                       window_s: Optional[float] = None) -> dict:
        """p50/p99/max of the two latency metrics plus throughput.

        Latency percentiles aggregate over *finished* queries only
        (status not shed/rate-limited): one rejected request must not
        NaN-poison the whole report.  Shed/degrade/rate-limited are
        reported as first-class counts and rates alongside, plus goodput
        — the fraction of all requests that finished within their
        tenant's budget.

        Every count and rate derives from the ``served`` argument (the
        sample under report), never from run-level state, so a report
        over a slice — one tenant, one phase of a nonstationary stream —
        is internally consistent.  (Run-level fields — micro-batches,
        rounds, makespan, qps — are explicitly about the *last run* and
        keep coming from :attr:`last_run`.)

        With multi-tenant traffic the report adds a per-tenant breakdown
        (including each tenant's SLO class and shed/degrade counts) and
        the Jain fairness index over per-tenant p99 plan latency of
        finished queries (1.0 = perfectly even tails across tenants;
        tenants with nothing finished are excluded).

        ``window_s`` adds a ``windows`` section: the stream is bucketed
        by *arrival* time into consecutive windows of that width and
        p50/p99, goodput, and shed/degrade/rate-limited rates are
        reported per window — stream-wide aggregates mask phase behavior
        under nonstationary load (a flash crowd's recovery is invisible
        in one pooled p99).
        """
        def _fin(sub):
            return [s for s in sub if s.status not in REJECTED_STATUSES
                    and math.isfinite(s.finished_s)]

        fin = _fin(served)
        plan = np.array([s.plan_latency_s for s in fin], np.float64)
        solve = np.array([s.solve_latency_s for s in fin], np.float64)
        st = self.last_run
        rep = {
            "n_queries": len(served),
            "n_finished": len(fin),
            **self._counts(served),
            "goodput": self._goodput(served),
            "n_micro_batches": st.n_micro_batches,
            "n_joined_running": st.n_joined_running,
            "rounds": st.rounds,
            "makespan_s": st.makespan_s,
            "qps": st.qps,
            "solve_latency_s": _pcts(solve),
            "plan_latency_s": _pcts(plan),
        }
        names = sorted({s.tenant for s in served})
        if len(names) > 1 or (names and names != ["default"]):
            per = {}
            for name in names:
                sub = [s for s in served if s.tenant == name]
                sub_fin = _fin(sub)
                ts = self.scheduler.state(name)
                per[name] = {
                    "n_queries": len(sub),
                    "n_finished": len(sub_fin),
                    "slo": ts.slo,
                    "budget_s": ts.budget_s,
                    **self._counts(sub),
                    "goodput": self._goodput(sub),
                    "batch_slots": st.tenant_slots.get(name, 0),
                    "solve_latency_s": _pcts(np.array(
                        [s.solve_latency_s for s in sub_fin], np.float64)),
                    "plan_latency_s": _pcts(np.array(
                        [s.plan_latency_s for s in sub_fin], np.float64)),
                }
            rep["tenants"] = per
            rep["fairness_jain"] = jain_index(
                [per[n]["plan_latency_s"]["p99"] for n in names])
        if window_s is not None and served:
            if window_s <= 0:
                raise ValueError(f"window_s must be positive, got "
                                 f"{window_s}")
            t0 = min(s.arrival_s for s in served)
            t1 = max(s.arrival_s for s in served)
            n_w = int(math.floor((t1 - t0) / window_s)) + 1
            windows = []
            for i in range(n_w):
                lo = t0 + i * window_s
                hi = lo + window_s
                sub = [s for s in served if lo <= s.arrival_s < hi]
                sub_fin = _fin(sub)
                windows.append({
                    "t0_s": lo,
                    "t1_s": hi,
                    "n_arrived": len(sub),
                    "n_finished": len(sub_fin),
                    **self._counts(sub),
                    "goodput": self._goodput(sub),
                    "plan_latency_s": _pcts(np.array(
                        [s.plan_latency_s for s in sub_fin], np.float64)),
                })
            rep["windows"] = windows
        return rep


def _same_device(a, b) -> bool:
    """Two torch devices name one device (an unset CUDA index matches
    any index: it means the current card)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _server_device(device, tuning, session):
    """The device a server runs on: ``device`` resolved, else the
    prebuilt objects' own, else the CUDA card; a prebuilt object on
    another device than the one asked for is rejected."""
    built = [(name, obj.device) for name, obj in (("tuning", tuning),
                                                  ("session", session))
             if obj is not None]
    if device is None and built:
        dev = built[0][1]
    else:
        dev = resolve_device(device)
    for name, d in built:
        if not _same_device(d, dev):
            raise ValueError(f"device={dev} conflicts with the prebuilt "
                             f"{name}'s device={d}")
    return dev


def _deltas(before: Dict[str, int], after: Dict[str, int]
            ) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def jain_index(x: Sequence[float]) -> float:
    """Jain fairness index (Σx)² / (n·Σx²): 1.0 = perfectly even.

    Non-finite entries are dropped (an all-shed tenant's p99 is NaN — it
    must not wipe out the whole fairness report); NaN only when nothing
    finite (or nonzero) remains.
    """
    a = np.asarray(list(x), np.float64)
    a = a[np.isfinite(a)]
    if a.size == 0 or (a == 0).all():
        return math.nan
    return float(a.sum() ** 2 / (a.size * (a * a).sum()))


def _pcts(x: np.ndarray) -> dict:
    if x.size == 0:
        return {"p50": math.nan, "p99": math.nan, "max": math.nan,
                "mean": math.nan}
    return {"p50": float(np.percentile(x, 50)),
            "p99": float(np.percentile(x, 99)),
            "max": float(x.max()),
            "mean": float(x.mean())}
