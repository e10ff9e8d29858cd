"""Nonstationary serving scenarios: seeded event timelines over streams.

The paper's headline claim is *adaptability* — the optimizer dominates
alternatives "when shifting preferences between latency and cost" (§6) —
but a stationary Poisson stream with fixed tenants and fixed capacity
never exercises it.  A :class:`ScenarioSpec` composes the three
nonstationary axes the serving stack must adapt to:

* **arrival shape** — any :class:`~repro_torch.queryengine.workloads.ArrivalModel`
  per tenant, including the time-varying kinds (``diurnal`` sinusoid,
  ``spike`` flash crowd, ``ramp``);
* **event timeline** — a seeded list of :class:`ScenarioEvent`\\ s:
  mid-stream tenant preference-weight shifts (``weights``), tenant churn
  (``join`` / ``leave``), and server capacity changes (``capacity``);
* **tenant population** — the usual
  :class:`~repro_torch.queryengine.workloads.TenantSpec` mix (SLO classes,
  shares, priorities, rate limits).

Determinism contract: :meth:`ScenarioSpec.build` is a **pure function of
its seeds**.  Weight shifts are resolved at build time — every
:class:`~repro_torch.queryengine.workloads.StreamRequest` is stamped with the
weights effective at its arrival — so the (request → weights) mapping
never depends on when the server happens to dequeue a request, and the
streamed server's surviving outputs replay bit-identically offline even
across shift and churn boundaries (``tests/test_torch_server.py`` pins this
for the whole :func:`scenario_matrix`).

Capacity events are *not* folded into the requests (they are server-side,
not client-side); :meth:`ScenarioSpec.build` returns them alongside the
stream and ``OptimizerServer.serve(requests, capacity_events=...)``
consumes them on its simulated clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple

from .workloads import (ArrivalModel, StreamRequest, TenantSpec,
                        _tenant_seed, serving_stream)

__all__ = ["ScenarioEvent", "CapacityEvent", "Scenario", "ScenarioSpec",
           "scenario_matrix", "EVENT_KINDS"]

EVENT_KINDS = ("weights", "join", "leave", "capacity")


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One timeline event; the payload fields required depend on ``kind``.

    * ``weights``  — tenant ``tenant`` switches preference weights to
      ``weights`` for every request arriving at or after ``at_s``;
    * ``join``     — a new tenant (``spec``) starts emitting at ``at_s``;
    * ``leave``    — tenant ``tenant`` stops emitting at ``at_s`` (its
      requests arriving at or after ``at_s`` are dropped at build time);
    * ``capacity`` — the server's base ``max_batch`` becomes ``max_batch``
      at simulated time ``at_s``.
    """
    at_s: float
    kind: str
    tenant: Optional[str] = None
    weights: Optional[Tuple[float, float]] = None
    spec: Optional[TenantSpec] = None
    max_batch: Optional[int] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; expected "
                             f"one of {EVENT_KINDS}")
        if not (math.isfinite(self.at_s) and self.at_s >= 0.0):
            raise ValueError(f"at_s must be finite and >= 0, got {self.at_s}")
        if self.kind == "weights":
            if self.tenant is None or self.weights is None:
                raise ValueError("weights event needs tenant= and weights=")
            if len(self.weights) != 2:
                raise ValueError(f"weights must be a (latency, cost) pair, "
                                 f"got {self.weights}")
        elif self.kind == "join":
            if self.spec is None:
                raise ValueError("join event needs spec=")
            if self.tenant is not None and self.tenant != self.spec.name:
                raise ValueError(f"join tenant {self.tenant!r} != spec name "
                                 f"{self.spec.name!r}")
        elif self.kind == "leave":
            if self.tenant is None:
                raise ValueError("leave event needs tenant=")
        elif self.kind == "capacity":
            if self.max_batch is None or self.max_batch < 1:
                raise ValueError("capacity event needs max_batch= >= 1, got "
                                 f"{self.max_batch}")


class CapacityEvent(NamedTuple):
    """Server capacity change on the simulated clock."""
    at_s: float
    max_batch: int


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A built scenario: the timed stream plus the server-side inputs."""
    spec: "ScenarioSpec"
    requests: Tuple[StreamRequest, ...]
    capacity_events: Tuple[CapacityEvent, ...]
    tenants: Tuple[TenantSpec, ...]   # initial + joined, declaration order


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Declarative nonstationary scenario; :meth:`build` is seed-pure."""
    name: str
    benchmark: str = "tpch"
    tenants: Tuple[TenantSpec, ...] = ()
    n_per_tenant: int = 8
    events: Tuple[ScenarioEvent, ...] = ()
    zipf_a: float = 1.3
    n_variants: int = 3

    def __post_init__(self):
        if not self.name:
            raise ValueError("scenario name must be non-empty")
        if not self.tenants:
            raise ValueError("scenario needs at least one tenant")
        if self.n_per_tenant < 1:
            raise ValueError(f"n_per_tenant must be >= 1, got "
                             f"{self.n_per_tenant}")
        names = [t.name for t in self.tenants] \
            + [e.spec.name for e in self.events if e.kind == "join"]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in scenario: {names}")
        known = set(names)
        for e in self.events:
            if e.kind in ("weights", "leave") and e.tenant not in known:
                raise ValueError(f"{e.kind} event names unknown tenant "
                                 f"{e.tenant!r}")

    # -- per-tenant timeline collation --------------------------------------
    def _shifts(self, name: str) -> List[ScenarioEvent]:
        return sorted((e for e in self.events
                       if e.kind == "weights" and e.tenant == name),
                      key=lambda e: e.at_s)

    def _leave_at(self, name: str) -> float:
        return min((e.at_s for e in self.events
                    if e.kind == "leave" and e.tenant == name),
                   default=math.inf)

    def build(self, *, seed: int = 0, query_seed: int = 0) -> Scenario:
        """Materialize the scenario: a merged, weight-stamped request
        stream (sorted by arrival, globally re-rid'd) plus the capacity
        timeline and the full tenant population for server registration.
        """
        pop: List[Tuple[TenantSpec, Optional[float]]] = \
            [(t, None) for t in self.tenants]
        pop += [(e.spec, e.at_s) for e in sorted(
            (e for e in self.events if e.kind == "join"),
            key=lambda e: (e.at_s, e.spec.name))]
        merged: List[StreamRequest] = []
        for spec, join_at in pop:
            arrivals = spec.arrivals if join_at is None else \
                dataclasses.replace(spec.arrivals, start_s=join_at)
            reqs = serving_stream(
                self.benchmark, self.n_per_tenant,
                seed=_tenant_seed(seed, spec.name), zipf_a=self.zipf_a,
                n_variants=self.n_variants, arrivals=arrivals,
                query_seed=query_seed)
            leave_at = self._leave_at(spec.name)
            shifts = self._shifts(spec.name)
            for r in reqs:
                if r.arrival_s >= leave_at:
                    continue
                w = spec.weights
                for ev in shifts:
                    if ev.at_s <= r.arrival_s:
                        w = ev.weights
                merged.append(dataclasses.replace(
                    r, tenant=spec.name, weights=w))
        merged.sort(key=lambda r: (r.arrival_s, r.tenant, r.rid))
        cap = tuple(sorted(
            (CapacityEvent(e.at_s, int(e.max_batch))
             for e in self.events if e.kind == "capacity"),
            key=lambda c: c.at_s))
        return Scenario(
            spec=self,
            requests=tuple(dataclasses.replace(r, rid=i)
                           for i, r in enumerate(merged)),
            capacity_events=cap,
            tenants=tuple(s for s, _ in pop))


# ---------------------------------------------------------------------------
# The bench/test matrix: arrival shapes × event timelines
# ---------------------------------------------------------------------------

def _shape_arrivals(shape: str, rate_qps: float, horizon_s: float
                    ) -> ArrivalModel:
    if shape == "diurnal":
        return ArrivalModel(kind="diurnal", rate_qps=rate_qps,
                            period_s=horizon_s, amplitude=0.8)
    if shape == "flash_crowd":
        return ArrivalModel(kind="spike", rate_qps=rate_qps,
                            spike_at_s=0.25 * horizon_s,
                            spike_dur_s=0.25 * horizon_s, spike_factor=4.0)
    if shape == "ramp":
        return ArrivalModel(kind="ramp", rate_qps=rate_qps,
                            ramp_to_qps=3.0 * rate_qps,
                            ramp_dur_s=0.5 * horizon_s)
    raise ValueError(f"unknown arrival shape {shape!r}")


ARRIVAL_SHAPES = ("diurnal", "flash_crowd", "ramp")
TIMELINES = ("steady", "pref_shift", "churn")


def scenario_matrix(*, benchmark: str = "tpch", n_per_tenant: int = 5,
                    rate_qps: float = 30.0) -> List[ScenarioSpec]:
    """The full (arrival shape × event timeline) scenario matrix.

    Each scenario carries three tenants spanning the SLO classes — a
    ``strict`` latency-weighted tenant with priority, a ``degrade``
    balanced tenant, and a rate-limited ``best_effort`` cost-weighted
    tenant.  ``pref_shift`` timelines flip two tenants' latency↔cost
    preferences mid-stream; ``churn`` timelines add a joining tenant, a
    leaving tenant, and a capacity dip-and-recover.  Event times scale
    with the expected stream horizon ``n_per_tenant / rate_qps`` so the
    matrix stays meaningful at any configured load.
    """
    horizon_s = n_per_tenant / rate_qps
    out: List[ScenarioSpec] = []
    for shape in ARRIVAL_SHAPES:
        arr = _shape_arrivals(shape, rate_qps, horizon_s)
        tenants = (
            TenantSpec(name="strict", weights=(0.9, 0.1), slo="strict",
                       priority=1, arrivals=arr),
            TenantSpec(name="deg", weights=(0.5, 0.5), slo="degrade",
                       arrivals=arr),
            TenantSpec(name="be", weights=(0.1, 0.9), slo="best_effort",
                       rate_limit_qps=2.0 * rate_qps, rate_limit_burst=4.0,
                       arrivals=arr),
        )
        for timeline in TIMELINES:
            if timeline == "steady":
                events: Tuple[ScenarioEvent, ...] = ()
            elif timeline == "pref_shift":
                events = (
                    ScenarioEvent(at_s=0.5 * horizon_s, kind="weights",
                                  tenant="strict", weights=(0.1, 0.9)),
                    ScenarioEvent(at_s=0.6 * horizon_s, kind="weights",
                                  tenant="be", weights=(0.9, 0.1)),
                )
            else:  # churn
                events = (
                    ScenarioEvent(at_s=0.4 * horizon_s, kind="join",
                                  spec=TenantSpec(
                                      name="joiner", weights=(0.7, 0.3),
                                      arrivals=dataclasses.replace(
                                          arr, kind="poisson"))),
                    ScenarioEvent(at_s=0.6 * horizon_s, kind="leave",
                                  tenant="be"),
                    ScenarioEvent(at_s=0.3 * horizon_s, kind="capacity",
                                  max_batch=2),
                    ScenarioEvent(at_s=0.7 * horizon_s, kind="capacity",
                                  max_batch=8),
                )
            out.append(ScenarioSpec(
                name=f"{shape}-{timeline}", benchmark=benchmark,
                tenants=tenants, n_per_tenant=n_per_tenant, events=events))
    return out
