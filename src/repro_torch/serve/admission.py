"""Multi-tenant admission accounting for the streaming server.

The paper's cloud premise makes tuning *per user*: preference weights are a
user's cost/performance trade-off (UDAO), and the 1–2 s solve budget is a
per-request promise the server must keep for every tenant at once.
:class:`TenantScheduler` owns the waiting-room half of that promise for
:class:`~repro_torch.serve.server.OptimizerServer`:

* **Per-tenant queues + deadlines.**  Each tenant's requests wait in their
  own FIFO; the tenant's flush deadline is its oldest request's
  ``arrival + budget − reserve`` where the reserve is a per-*query* EWMA of
  recent solve times scaled by the expected batch size.  (Per-query
  normalization keeps one large batch from inflating the reserve applied
  to subsequent small batches, as a whole-batch EWMA would.)
* **Weighted-fair composition.**  A micro-batch is composed by
  deficit-round-robin over the tenant queues: every pass credits each
  waiting tenant ``share / max(shares in tier)`` slots and pops while the
  credit covers a whole slot, so long-run batch shares converge to the
  configured ratios without starving fractional shares — and composition
  always makes progress in O(1) passes per slot, however small a share.
* **Priority tiers that cannot starve.**  Higher-priority tenants compose
  first — but any tenant whose head request has passed its deadline is
  promoted ahead of *all* tiers (oldest first).  A lower tier therefore
  waits at most its budget while higher tiers burst: preemption bounds
  latency instead of unbounding it.  Overdue pops are charged against the
  tenant's DRR credit (floored at the standard empty-queue reset), so a
  bursty tenant served via promotion cannot *also* spend its banked
  credit on the next normal pass (no double dip).
* **Overload triage (SLO classes).**  A request is *unmeetable* when even
  an immediate flush would blow its budget:
  ``arrival + budget − reserve·E[n] < now``.  What happens then is the
  tenant's :class:`~repro_torch.queryengine.workloads.TenantSpec` ``slo`` class:
  ``strict`` heads are shed (popped and rejected, never solved) by
  :meth:`TenantScheduler.shed_unmeetable`; ``degrade`` heads are composed
  with ``Admit.degrade=True`` so the server routes them through the cheap
  compile path; ``best_effort`` heads queue on as before.  Under sustained
  overload the server therefore *adapts* — strict tenants keep their
  latency promise by dropping excess load, degrade tenants trade plan
  quality for admission, best-effort tenants absorb the queueing — instead
  of silently blowing every tenant's budget.

The scheduler only orders and accounts — it never touches solver state —
so per-query *outputs* remain independent of composition (the golden
determinism invariant); fairness and overload policy shape latency (and
which requests are served at full quality) only.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Iterable, List, NamedTuple, Optional, Tuple

from ..queryengine.workloads import TenantSpec

__all__ = ["TenantScheduler", "TenantState", "Admit", "TokenBucket",
           "ElasticPolicy", "ElasticController"]


class Admit(NamedTuple):
    """One composed batch slot: ``(tenant, item, degrade)``.

    ``degrade`` is True when the item was unmeetable at pop time and its
    tenant's SLO class is ``"degrade"`` — the server must route it through
    the cheap compile path instead of a fresh Algorithm 1 solve.
    """
    tenant: str
    item: object
    degrade: bool = False


@dataclasses.dataclass
class TokenBucket:
    """Per-tenant rate limiter ahead of the waiting room.

    A bucket holds at most ``burst`` tokens and refills continuously at
    ``rate_qps``; each admitted arrival takes one token, and an arrival
    finding less than a whole token is rejected at the door (status
    ``"rate_limited"`` — never enqueued, never solved).  The bucket is
    clocked by *arrival* times, which are a pure function of the stream,
    so the admit/reject pattern is deterministic per seed regardless of
    how fast the server happens to be running.

    Invariants (property-tested in ``tests/test_torch_admission.py``):

    * never admits more than ``burst`` arrivals at one instant;
    * over any span, admits at most ``burst + elapsed · rate_qps`` tokens'
      worth (token conservation);
    * after an idle gap of ``1 / rate_qps`` at least one token is always
      available (no starvation — churny traffic cannot wedge the bucket).
    """
    rate_qps: float
    burst: float
    tokens: float = math.nan         # NaN → starts full (= burst)
    clock_s: float = -math.inf       # last refill instant (monotone)

    def __post_init__(self):
        if self.rate_qps <= 0:
            raise ValueError(f"rate_qps must be positive, got "
                             f"{self.rate_qps}")
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if math.isnan(self.tokens):
            self.tokens = self.burst

    def take(self, now: float) -> bool:
        """Refill to ``now`` and take one token; False = rate-limited.

        Out-of-order calls (``now`` before the bucket clock) refill
        nothing — time never runs backwards for the token supply.
        """
        if now > self.clock_s:
            if math.isfinite(self.clock_s):
                self.tokens = min(self.burst, self.tokens
                                  + (now - self.clock_s) * self.rate_qps)
            self.clock_s = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Elastic capacity policy: how the server autoscales per flush.

    The controller keeps an EWMA *forecast* of queue delay over flush
    windows and scales the base ``max_batch`` by the pressure ratio
    ``forecast / target_delay_s`` whenever the forecast exceeds the
    target (the scaling is clipped to ``[min_batch, max_batch]``, but a
    base cap already above the ceiling passes through unclamped) —
    bigger batches amortize the solve when the waiting room is falling
    behind.  The same
    forecast drives *preemptive degradation*: as forecast headroom
    against the solve budget shrinks below ``degrade_frac · budget``,
    degrade-class heads are routed to the cheap path with a positive
    lead time — before the budget actually blows — instead of at the
    deadline.
    """
    min_batch: int = 1
    max_batch: int = 32              # elastic ceiling on the batch cap
    target_delay_s: float = 0.5      # queue-delay forecast target
    ewma: float = 0.4                # EWMA weight of the newest window
    degrade_frac: float = 0.5        # preemptive-degrade headroom fraction

    def __post_init__(self):
        if not 1 <= self.min_batch <= self.max_batch:
            raise ValueError(f"need 1 <= min_batch <= max_batch, got "
                             f"{self.min_batch}, {self.max_batch}")
        if self.target_delay_s <= 0:
            raise ValueError(f"target_delay_s must be positive, got "
                             f"{self.target_delay_s}")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {self.ewma}")
        if not 0.0 <= self.degrade_frac <= 1.0:
            raise ValueError(f"degrade_frac must be in [0, 1], got "
                             f"{self.degrade_frac}")


class ElasticController:
    """Queue-delay forecast + the three controls derived from it.

    Monotonicity contract (property-tested): with everything else fixed,
    a higher forecast never *lowers* :meth:`batch_cap`, never *raises*
    :meth:`headroom_s`, and never lowers :meth:`degrade_lead_s` — the
    controller always reacts to more pressure with at least as much
    capacity and at least as early degradation.
    """

    def __init__(self, policy: ElasticPolicy):
        self.policy = policy
        self.forecast_s = 0.0            # EWMA queue delay over flushes
        self.n_windows = 0

    def note_flush(self, queue_delay_s: float) -> None:
        """Fold one flush's observed queue delay (mean wait of the batch
        at compose time) into the forecast."""
        a = self.policy.ewma
        self.forecast_s = ((1 - a) * self.forecast_s
                           + a * max(queue_delay_s, 0.0))
        self.n_windows += 1

    def batch_cap(self, base_cap: int) -> int:
        """Elastic batch cap: base capacity scaled by forecast pressure.

        ``max_batch`` bounds the *scaling*, never the provisioned base:
        a capacity event that raises ``base_cap`` above the elastic
        ceiling is honored as-is — elasticity only ever adds capacity on
        top of what the deployment provides.
        """
        p = self.policy
        pressure = max(1.0, self.forecast_s / p.target_delay_s)
        cap = min(int(math.floor(base_cap * pressure)), p.max_batch)
        return max(p.min_batch, base_cap, cap)

    def flush_budget_s(self, reserve_q_s: float, base_cap: int) -> float:
        """Expected solve cost of one full elastic flush."""
        return reserve_q_s * self.batch_cap(base_cap)

    def headroom_s(self, budget_s: float, reserve_q_s: float,
                   base_cap: int) -> float:
        """Budget slack left after the forecast delay and a full flush.

        Monotone nonincreasing in the forecast: delay subtracts directly
        and a larger elastic cap only grows the flush cost.
        """
        return (budget_s - self.forecast_s
                - self.flush_budget_s(reserve_q_s, base_cap))

    def degrade_lead_s(self, budget_s: float, reserve_q_s: float,
                       base_cap: int) -> float:
        """How far *ahead of* the deadline degrade-class heads should be
        routed to the cheap path (0 = only at the deadline, the static
        behavior).  Grows as headroom shrinks below
        ``degrade_frac · budget``; clipped to ``[0, budget]``."""
        head = self.headroom_s(budget_s, reserve_q_s, base_cap)
        lead = self.policy.degrade_frac * budget_s - head
        return float(min(max(lead, 0.0), budget_s))


@dataclasses.dataclass
class TenantState:
    """Admission state of one tenant (queue + fairness accounting)."""

    name: str
    weights: Optional[Tuple[float, float]] = None   # None → server default
    share: float = 1.0
    priority: int = 0
    budget_s: float = 1.0
    slo: str = "best_effort"         # strict | degrade | best_effort
    reserve_q_s: float = 0.25        # per-query solve-time EWMA
    deficit: float = 0.0             # DRR credit carried across flushes
    queue: Deque[Tuple[float, object]] = dataclasses.field(
        default_factory=deque)       # (arrival_s, item) FIFO
    bucket: Optional[TokenBucket] = None   # None → no rate limiter
    n_enqueued: int = 0
    n_dequeued: int = 0
    n_shed: int = 0                  # strict-SLO rejections (never solved)
    n_degraded: int = 0              # degrade-SLO cheap-path admissions
    n_rate_limited: int = 0          # door rejections (never enqueued)
    slots_granted: int = 0           # batch slots over the scheduler's life

    @property
    def waiting(self) -> int:
        return len(self.queue)

    def head_arrival(self) -> float:
        return self.queue[0][0] if self.queue else math.inf


class TenantScheduler:
    """Deficit-round-robin admission over per-tenant queues.

    Drives no clock of its own: the server asks ``next_deadline`` when
    idle, tests ``flush_due``-style conditions itself, and calls
    ``shed_unmeetable`` + ``compose`` to draw one micro-batch.  Unknown
    tenant names are auto-registered with default policy, so anonymous
    single-stream traffic needs no configuration.
    """

    def __init__(self, tenants: Iterable[TenantSpec] = (), *,
                 budget_s: float = 1.0, reserve_q_s: float = 0.25,
                 reserve_ewma: float = 0.3):
        self.default_budget_s = budget_s
        self.default_reserve_q_s = reserve_q_s
        self.reserve_ewma = reserve_ewma
        self._states: Dict[str, TenantState] = {}
        for spec in tenants:
            if spec.name in self._states:
                raise ValueError(f"duplicate tenant spec: {spec.name!r}")
            self._states[spec.name] = TenantState(
                name=spec.name, weights=spec.weights, share=spec.share,
                priority=spec.priority,
                budget_s=(spec.solve_budget_s if spec.solve_budget_s
                          is not None else budget_s),
                slo=spec.slo,
                reserve_q_s=reserve_q_s,
                bucket=(TokenBucket(spec.rate_limit_qps,
                                    spec.rate_limit_burst)
                        if spec.rate_limit_qps is not None else None))

    # -- registry ------------------------------------------------------------
    def state(self, name: str) -> TenantState:
        st = self._states.get(name)
        if st is None:
            st = TenantState(name=name, budget_s=self.default_budget_s,
                             reserve_q_s=self.default_reserve_q_s)
            self._states[name] = st
        return st

    def states(self) -> List[TenantState]:
        return list(self._states.values())

    # -- queueing ------------------------------------------------------------
    def enqueue(self, name: str, item: object, arrival_s: float) -> None:
        st = self.state(name)
        st.queue.append((arrival_s, item))
        st.n_enqueued += 1

    def admit_arrival(self, name: str, item: object,
                      arrival_s: float) -> bool:
        """Door admission: rate-limit check, then enqueue.

        Returns False (and enqueues nothing) when the tenant's token
        bucket rejects the arrival — the server records the request as
        ``rate_limited``.  The bucket is clocked by the arrival time, a
        pure function of the stream, so rejections are deterministic per
        seed.  Tenants without a configured bucket always admit.
        """
        st = self.state(name)
        if st.bucket is not None and not st.bucket.take(arrival_s):
            st.n_rate_limited += 1
            return False
        st.queue.append((arrival_s, item))
        st.n_enqueued += 1
        return True

    def total_waiting(self) -> int:
        return sum(st.waiting for st in self._states.values())

    # -- deadlines -----------------------------------------------------------
    def _deadline(self, st: TenantState, expected_n: int) -> float:
        """Latest flush start that still meets ``st``'s head budget."""
        return (st.head_arrival() + st.budget_s
                - st.reserve_q_s * max(expected_n, 1))

    def _expected_n(self, cap: int, picked: int = 0) -> int:
        """Expected size of the flush batch being (or about to be) composed.

        ``picked`` counts slots already drawn into the batch under
        composition: they stay in the same flush (one solve window, one
        ``compiled_s`` for every member), so the head being tested will
        join a batch of ``picked + remaining`` (capped).  Shed items, by
        contrast, leave the batch entirely — the shed loop passes
        ``picked=0`` and sees the genuinely shrunken pool.
        """
        return min(max(picked + self.total_waiting(), 1), cap)

    def next_deadline(self, cap: int) -> float:
        """Earliest flush deadline over all waiting tenants (inf if idle)."""
        n = self._expected_n(cap)
        return min((self._deadline(st, n)
                    for st in self._states.values() if st.queue),
                   default=math.inf)

    def deadline_due(self, now: float, cap: int) -> bool:
        return now >= self.next_deadline(cap)

    def unmeetable(self, st: TenantState, now: float, cap: int,
                   picked: int = 0) -> bool:
        """True when even an immediate flush would blow the head's budget:
        ``head_arrival + budget − reserve·E[n] < now`` (strictly — at
        exactly the deadline, flushing now still meets the budget).
        ``picked`` sizes E[n] for a batch already under composition."""
        return bool(st.queue) \
            and self._deadline(st, self._expected_n(cap, picked)) < now

    # -- overload triage -----------------------------------------------------
    def shed_unmeetable(self, now: float, cap: int
                        ) -> List[Tuple[str, object]]:
        """Pop and return every strict-SLO request whose budget is already
        unmeetable — the server records them as rejected, they are never
        solved.  Queues are FIFO, so popping stops at the first meetable
        head; the expected batch size is re-derived as the pool drains
        (shed items shrink the batch every later head would solve in).
        """
        shed: List[Tuple[str, object]] = []
        while True:
            over = [st for st in self._states.values()
                    if st.slo == "strict" and self.unmeetable(st, now, cap)]
            if not over:
                return shed
            st = min(over, key=lambda s: (s.head_arrival(), s.name))
            _, item = st.queue.popleft()
            st.n_dequeued += 1
            st.n_shed += 1
            if not st.queue:
                st.deficit = 0.0           # standard DRR empty-queue reset
            shed.append((st.name, item))

    # -- batch composition ---------------------------------------------------
    def compose(self, now: float, cap: int,
                degrade_lead_s: float = 0.0) -> List[Admit]:
        """Draw one micro-batch of at most ``cap`` items.

        Overdue heads first (any tier, oldest arrival first — the
        no-starvation guarantee), then priority tiers high→low with
        deficit-round-robin inside each tier.  Overdue pops are charged
        against the tenant's DRR credit (floored at the standard
        empty-queue reset of 0), so a burst served via promotion cannot
        double-dip on the next normal pass.  The expected batch size used
        by the overdue/degrade checks counts slots already composed plus
        the remaining pool (capped): every member of this batch shares one
        flush window, so an item popped late is *not* solving in a smaller
        batch — only genuinely removed items (sheds, between composes)
        shrink E[n].  An overdue head of a ``degrade``-SLO tenant is
        admitted with ``degrade=True`` (its budget is already unmeetable
        at full quality in the batch it joins).  Per-tenant slot grants
        are recorded in :attr:`TenantState.slots_granted`; their sum
        always equals the number of items returned (conservation).

        ``degrade_lead_s`` arms *preemptive* degradation (elastic
        control): degrade-SLO heads are tested against ``now + lead``
        instead of ``now``, routing them to the cheap path before the
        budget actually blows.  The lead shifts only the degrade flag,
        never pop order or shedding — capacity policy, not fairness.
        """
        picked: List[Admit] = []
        while len(picked) < cap:
            n_p = len(picked)
            over = [st for st in self._states.values()
                    if st.queue
                    and self._deadline(st,
                                       self._expected_n(cap, n_p)) <= now]
            if not over:
                break
            st = min(over, key=lambda s: (s.head_arrival(), s.name))
            degrade = st.slo == "degrade" \
                and self.unmeetable(st, now + degrade_lead_s, cap, n_p)
            picked.append(self._pop(st, degrade))
            # Promotion is not free slot-wise: consume any banked credit
            # (never below the standard empty-queue reset of 0, which also
            # applies if the promotion just drained the queue).
            st.deficit = 0.0 if not st.queue else max(st.deficit - 1.0, 0.0)
        while len(picked) < cap:
            busy = [st for st in self._states.values() if st.queue]
            if not busy:
                break
            tier = max(st.priority for st in busy)
            tier_states = sorted((s for s in busy if s.priority == tier),
                                 key=lambda s: s.name)
            # Credits are normalized by the tier's largest share: ratios are
            # preserved (a common factor) and the largest-share tenant
            # reaches a whole slot every pass, so composing one slot costs
            # O(1) passes even for arbitrarily small (but valid) shares.
            qmax = max(st.share for st in tier_states)
            for st in tier_states:
                st.deficit += st.share / qmax
                while st.deficit >= 1.0 and st.queue and len(picked) < cap:
                    degrade = st.slo == "degrade" \
                        and self.unmeetable(st, now + degrade_lead_s, cap,
                                            len(picked))
                    picked.append(self._pop(st, degrade))
                    st.deficit -= 1.0
                if not st.queue:
                    st.deficit = 0.0       # standard DRR: no banked credit
        return picked

    def _pop(self, st: TenantState, degrade: bool = False) -> Admit:
        _, item = st.queue.popleft()
        st.n_dequeued += 1
        st.slots_granted += 1
        if degrade:
            st.n_degraded += 1
        return Admit(st.name, item, degrade)

    # -- solve-time accounting ----------------------------------------------
    def note_solve(self, dt: float, n: int,
                   tenant_names: Iterable[str]) -> None:
        """Fold one micro-batch admission window of ``n`` queries into the
        reserves.

        ``dt`` must be the *full* clock charge of the flush — the batched
        compile solve plus each query's initial AQE planning step inside
        ``session.admit()`` — i.e. exactly what the server's simulated
        clock advances by (feeding only the ``tune_batch`` slice would
        make the reserve systematically undershoot the true per-query
        admission cost, scheduling deadlines too late and hiding
        overload).  The EWMA tracks *per-query* time (``dt / n``) so a
        large batch cannot inflate the reserve later applied to a small
        one; the deadline scales it back up by the expected batch size.
        """
        dt_q = dt / max(n, 1)
        a = self.reserve_ewma
        # dict.fromkeys, not set(): dedup must preserve arrival order so
        # `state()` auto-registration order (and hence any downstream
        # iteration over the tenant table) is a function of the transcript,
        # not of the hash-randomized set order.
        for name in dict.fromkeys(tenant_names):
            st = self.state(name)      # auto-registers off the OLD default
            st.reserve_q_s = (1 - a) * st.reserve_q_s + a * dt_q
        self.default_reserve_q_s = ((1 - a) * self.default_reserve_q_s
                                    + a * dt_q)
