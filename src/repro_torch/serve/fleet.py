"""Multi-worker optimizer fleet: sharded streaming admission at scale.

One :class:`~repro_torch.serve.server.OptimizerServer` is one admission loop.
:class:`OptimizerFleet` shards the streaming admission loop across N
worker replicas, each wrapping its own ``OptimizerServer`` (caches,
tenant scheduler, elastic controller and all), and merges the served
results back into request order.  The replicas share one torch device
(``device=None`` = the CUDA card) and are served one after another in
one process.

Routing is where the fleet either keeps or squanders the cache
amortization the serving stack is built on:

* **affinity** (default) — a consistent-hash ring over the template
  dims of the cache fingerprint (:func:`route_key`): every parametric
  variant and duplicate of a template lands on the same worker, so
  that worker's :class:`~repro_torch.serve.cache.EffectiveSetCache` structure
  hits and :class:`~repro_torch.serve.service.ResponseCache` dedup hits stay
  warm instead of being diluted N ways.  A **work-stealing fallback**
  kicks in when the owning worker's queue-delay forecast exceeds
  ``steal_delay_s``: the request is re-routed to the least-loaded
  worker (losing warmth, winning latency) — safe because per-query
  outputs are composition-independent (the golden-determinism
  invariant), so *where* a query is served can never change *what* is
  served.
* **random** — seeded hash of the request id: the load-balance-only
  baseline the affinity hit-rate claim is measured against.
* **single** — everything to worker 0: the pre-fleet baseline.

Timelines: with :class:`~repro_torch.serve.server.ServiceTimeModel` set, the
fleet re-prices it via ``with_workers(n_workers)`` (co-located replicas
contend for the host), so every worker's admission timeline — and hence
the whole fleet run — is a pure function of stream + config.

Process-external caches: the three serving caches expose
``snapshot()``/``restore()`` (content-fingerprinted entries only — see
each cache's snapshot contract for the id()-pin exclusion), and a
:class:`CacheStore` holds the published blobs.  A fleet constructed with
a store warm-starts every worker from it, and (by default) publishes a
merged snapshot back after each :meth:`OptimizerFleet.serve` — so a new
worker, or a whole new fleet generation, starts with the previous
generation's warmth instead of a cold cache.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import pickle
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.models.perf_model import PerfModel
from ..core.moo.hmooc import HMOOCConfig
from ..device import resolve_device
from ..queryengine.plan import Query
from ..queryengine.workloads import StreamRequest, TenantSpec
from .cache import query_fingerprint
from .server import (REJECTED_STATUSES, OptimizerServer, ServedQuery,
                     ServerConfig, ServerStats)

__all__ = ["OptimizerFleet", "FleetStats", "FleetRouter", "HashRing",
           "CacheStore", "route_key", "ROUTING_POLICIES", "CACHE_KINDS"]

Weights = Tuple[float, float]

ROUTING_POLICIES = ("affinity", "random", "single")

# Snapshot kinds a CacheStore holds, one per serving cache.
CACHE_KINDS = ("eset", "response", "pools")


def route_key(query: Query) -> Tuple:
    """Template-affinity routing key: the fleet-variable dims of the
    cache fingerprint.

    ``template_key`` is ``(benchmark, template, cfg, cost, model-fp)``
    and the response key adds qid/statistics/weights/tenant on top.  Every
    replica of one fleet is configured identically, so cfg/cost/model can
    never differentiate workers; the dims that decide *which worker's
    caches can be warm for this query* are exactly ``(benchmark,
    template)`` — hashing on them sends every variant and duplicate of a
    template to its one owning worker, which is what keeps structure and
    dedup hits local instead of N-way diluted.
    """
    return (query.benchmark, query.template)


def _h32(*parts) -> int:
    """Stable 32-bit hash of a part tuple (crc32 — process-independent,
    unlike builtin ``hash``)."""
    return zlib.crc32("|".join(str(p) for p in parts).encode()) & 0xFFFFFFFF


class HashRing:
    """Consistent-hash ring over worker indices (virtual-node variant).

    Each worker owns ``replicas`` pseudo-random points on a 32-bit ring;
    a key maps to the first point clockwise from its hash.  Consistency
    is the point: growing the fleet from N to N+1 workers moves only the
    keys the new worker's points capture (~1/(N+1) of the space), so most
    templates keep their warm owner across a resize — a modulo router
    would reshuffle nearly everything.
    """

    def __init__(self, n_workers: int, *, replicas: int = 64,
                 salt: int = 0):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.n_workers = n_workers
        self.replicas = replicas
        self.salt = salt
        pts = [(_h32("vnode", salt, w, r), w)
               for w in range(n_workers) for r in range(replicas)]
        pts.sort()
        self._points = pts
        self._hashes = [h for h, _ in pts]

    def worker_for(self, key: Tuple) -> int:
        h = _h32("key", self.salt, *key)
        i = bisect.bisect_left(self._hashes, h)
        return self._points[i % len(self._points)][1]


class FleetRouter:
    """Assigns each request of a timed stream to a worker replica.

    Routing is deterministic and output-blind: it reads only the stream
    itself (arrival order, request ids, query templates) plus the
    config, never a solve result — so the assignment, like the admission
    timeline under a :class:`~repro_torch.serve.server.ServiceTimeModel`, is a
    pure function of stream + config.

    Work stealing (affinity policy only): the router keeps a per-worker
    backlog forecast — a ready-time clock charged ``est_full_s`` per
    first-seen request and ``est_cheap_s`` per exact repeat (the dedup a
    warm response cache will serve in microseconds).  When the affinity
    target's forecast queue delay at a request's arrival exceeds
    ``steal_delay_s``, the request is stolen by the least-loaded worker
    (ties break to the lowest index).  ``steal_delay_s=None`` disables
    stealing (strict affinity).
    """

    def __init__(self, n_workers: int, *, policy: str = "affinity",
                 seed: int = 0, steal_delay_s: Optional[float] = None,
                 ring_replicas: int = 64, est_full_s: float = 0.25,
                 est_cheap_s: float = 0.001):
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"expected one of {ROUTING_POLICIES}")
        if steal_delay_s is not None and (not math.isfinite(steal_delay_s)
                                          or steal_delay_s < 0.0):
            raise ValueError(f"steal_delay_s must be None or finite >= 0, "
                             f"got {steal_delay_s}")
        self.n_workers = n_workers
        self.policy = policy
        self.seed = seed
        self.steal_delay_s = steal_delay_s
        self.est_full_s = float(est_full_s)
        self.est_cheap_s = float(est_cheap_s)
        self.ring = HashRing(n_workers, replicas=ring_replicas, salt=seed)
        self.n_stolen = 0
        self.worker_counts = [0] * n_workers
        self._ready_s = [0.0] * n_workers
        self._seen: List[Set[Tuple]] = [set() for _ in range(n_workers)]

    def assign(self, requests: Sequence[StreamRequest]) -> List[int]:
        """Worker index per request, aligned with ``requests``.

        Requests are routed in arrival order (ties broken by rid, like
        the server's own admission order) so the backlog forecast each
        steal decision reads is the state a live dispatcher would see.
        """
        order = sorted(range(len(requests)),
                       key=lambda i: (requests[i].arrival_s,
                                      requests[i].rid))
        out = [0] * len(requests)
        for i in order:
            out[i] = self._route_one(requests[i])
        return out

    def _route_one(self, r: StreamRequest) -> int:
        if self.policy == "single":
            w = 0
        elif self.policy == "random":
            w = _h32("random", self.seed, r.rid) % self.n_workers
        else:
            w = self.ring.worker_for(route_key(r.query))
            if self.steal_delay_s is not None and self.n_workers > 1:
                delay = max(0.0, self._ready_s[w] - r.arrival_s)
                if delay > self.steal_delay_s:
                    alt = min(range(self.n_workers),
                              key=lambda j: (max(0.0, self._ready_s[j]
                                                 - r.arrival_s), j))
                    if alt != w:
                        w = alt
                        self.n_stolen += 1
        self._charge(r, w)
        self.worker_counts[w] += 1
        return w

    def _charge(self, r: StreamRequest, w: int) -> None:
        dup = (r.tenant, r.query.qid, query_fingerprint(r.query),
               None if r.weights is None else tuple(r.weights))
        cost = self.est_cheap_s if dup in self._seen[w] else self.est_full_s
        self._seen[w].add(dup)
        self._ready_s[w] = max(self._ready_s[w], r.arrival_s) + cost


class CacheStore:
    """Process-external store of published cache snapshots.

    One opaque blob per cache kind (``eset`` / ``response`` / ``pools``
    — the formats are versioned and validated by the caches themselves).
    Workers warm-start from the store and fleets publish merged
    snapshots back to it; :meth:`save`/:meth:`load` round-trip the whole
    store through a file, which is what carries cache warmth across
    *processes* and fleet generations.
    """

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}

    def publish(self, kind: str, blob: bytes) -> None:
        if kind not in CACHE_KINDS:
            raise ValueError(f"unknown cache kind {kind!r}; expected one "
                             f"of {CACHE_KINDS}")
        if not isinstance(blob, bytes):
            raise TypeError(f"snapshot blob must be bytes, got "
                            f"{type(blob).__name__}")
        self._blobs[kind] = blob

    def fetch(self, kind: str) -> Optional[bytes]:
        return self._blobs.get(kind)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(k for k in CACHE_KINDS if k in self._blobs)

    def save(self, path) -> None:
        payload = {"format": "repro-cache-store", "version": 1,
                   "blobs": dict(self._blobs)}
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path) -> "CacheStore":
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) \
                or payload.get("format") != "repro-cache-store":
            raise ValueError(f"{path} is not a cache-store file")
        if payload.get("version") != 1:
            raise ValueError(f"unsupported cache-store version "
                             f"{payload.get('version')!r}")
        store = cls()
        for kind, blob in sorted(payload["blobs"].items()):
            store.publish(kind, blob)
        return store


@dataclasses.dataclass
class FleetStats:
    """Aggregate outcome of one :meth:`OptimizerFleet.serve` call."""
    n_workers: int = 1
    policy: str = "affinity"
    n_queries: int = 0
    n_finished: int = 0
    n_shed: int = 0
    n_degraded: int = 0
    n_rate_limited: int = 0
    n_stolen: int = 0                  # affinity targets overridden by load
    makespan_s: float = 0.0            # last served finish − first arrival
    worker_counts: List[int] = dataclasses.field(default_factory=list)
    per_worker: List[ServerStats] = dataclasses.field(default_factory=list)

    @property
    def qps(self) -> float:
        """Aggregate served throughput over the fleet makespan."""
        return self.n_finished / self.makespan_s if self.makespan_s else 0.0


class OptimizerFleet:
    """N ``OptimizerServer`` replicas behind a template-affinity router.

    Every replica is configured identically (same config / weights / cfg
    / model / tenant policy); with ``config.clock`` set it is re-priced
    via ``with_workers(n_workers)`` so co-located contention is charged.
    Output safety needs no cross-worker coordination: per-query outputs
    are composition-independent (the golden-determinism invariant), so
    sharding changes only *latency* — each tenant's served plans stay
    bit-identical to the offline per-tenant pipeline under any worker
    count and any routing policy.

    ``cache_store`` (optional) plugs the fleet into a process-external
    :class:`CacheStore`: workers :meth:`warm_start` from it at
    construction, and each :meth:`serve` ends by :meth:`publish`-ing a
    merged snapshot back (disable with ``publish_on_serve=False``).

    ``device`` (``None`` = the CUDA card) is resolved once and handed to
    every replica: the workers share one device.  Every cache entry a
    fleet publishes is numpy or plain Python, so a published store loads
    on a host without a card.
    """

    def __init__(
        self,
        *,
        n_workers: int,
        config: ServerConfig = ServerConfig(),
        weights: Optional[Weights] = None,
        cfg: Optional[HMOOCConfig] = None,
        model: Optional[PerfModel] = None,
        tenants: Sequence[TenantSpec] = (),
        policy: str = "affinity",
        steal_delay_s: Optional[float] = None,
        ring_replicas: int = 64,
        seed: int = 0,
        cache_store: Optional[CacheStore] = None,
        publish_on_serve: bool = True,
        device=None,
    ):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"expected one of {ROUTING_POLICIES}")
        if config.clock is not None:
            config = dataclasses.replace(
                config, clock=config.clock.with_workers(n_workers))
        self.device = resolve_device(device)
        self.n_workers = n_workers
        self.config = config
        self.policy = policy
        self.steal_delay_s = steal_delay_s
        self.ring_replicas = ring_replicas
        self.seed = seed
        self.cache_store = cache_store
        self.publish_on_serve = publish_on_serve
        self.workers = [
            OptimizerServer(config=config, weights=weights, cfg=cfg,
                            model=model, tenants=tenants,
                            device=self.device)
            for _ in range(n_workers)]
        clock = config.clock
        # Backlog-forecast cost estimates for the work-stealing router:
        # one full solve per fresh request (the clock model's single-query
        # flush, or the configured reserve seed), the cheap-member cost
        # per exact repeat.
        self._est_full_s = (clock.flush_s(1) if clock is not None
                            else config.solve_reserve_s)
        self._est_cheap_s = (clock.flush_s(1, 1) if clock is not None
                             else 0.0)
        self.last_run = FleetStats(n_workers=n_workers, policy=policy)
        if cache_store is not None:
            self.warm_start()

    # -- cache plumbing ------------------------------------------------------
    def _cache(self, server: OptimizerServer, kind: str):
        if kind == "eset":
            return server.tuning.cache
        if kind == "response":
            return server.tuning._results      # None when dedupe is off
        if kind == "pools":
            return server.session.pool_cache
        raise ValueError(f"unknown cache kind {kind!r}")

    def warm_start(self) -> Dict[str, int]:
        """Restore every published snapshot into every worker's caches.

        Returns per-kind totals of entries inserted (across workers).
        Safe at any time: restore merges, existing entries win, and all
        snapshot entries are exact artifacts for their keys — warmth
        changes hit rates and timing, never outputs.
        """
        counts = {kind: 0 for kind in CACHE_KINDS}
        if self.cache_store is None:
            return counts
        for kind in CACHE_KINDS:
            blob = self.cache_store.fetch(kind)
            if blob is None:
                continue
            for worker in self.workers:
                cache = self._cache(worker, kind)
                if cache is not None:
                    counts[kind] += cache.restore(blob)
        return counts

    def publish(self) -> Dict[str, int]:
        """Merge every worker's snapshot and publish to the cache store.

        Per kind: each worker's snapshot-eligible entries (content-
        fingerprinted only — the snapshot contract) are merged in worker
        order into one cache image, whose snapshot becomes the published
        blob.  Returns per-kind merged entry counts.
        """
        if self.cache_store is None:
            raise RuntimeError("fleet has no cache store to publish to")
        counts: Dict[str, int] = {}
        for kind in CACHE_KINDS:
            caches = [c for c in (self._cache(worker, kind)
                                  for worker in self.workers)
                      if c is not None]
            if not caches:
                continue
            merged = type(caches[0])(max_entries=caches[0].max_entries)
            for c in caches:
                merged.restore(c.snapshot())
            self.cache_store.publish(kind, merged.snapshot())
            counts[kind] = len(merged)
        return counts

    # -- serving -------------------------------------------------------------
    def serve(self, requests: Sequence[StreamRequest], *,
              capacity_events: Sequence[Tuple[float, int]] = ()
              ) -> List[ServedQuery]:
        """Route, shard, serve, and merge back into request order.

        Each worker serves its shard on its own simulated clock (all
        replicas run concurrently in the modelled deployment, so worker
        timelines overlap rather than queue behind each other);
        ``capacity_events`` apply to every worker, modelling a
        deployment-wide capacity change.  Every returned
        :class:`ServedQuery` carries the index of the worker that served
        it in ``worker``.
        """
        router = FleetRouter(
            self.n_workers, policy=self.policy, seed=self.seed,
            steal_delay_s=self.steal_delay_s,
            ring_replicas=self.ring_replicas,
            est_full_s=self._est_full_s, est_cheap_s=self._est_cheap_s)
        assign = router.assign(requests)
        shards: List[List[StreamRequest]] = [[] for _ in
                                             range(self.n_workers)]
        for r, w in zip(requests, assign):
            shards[w].append(r)
        merged: Dict[int, ServedQuery] = {}
        per_worker: List[ServerStats] = []
        for w, (worker, shard) in enumerate(zip(self.workers, shards)):
            for s in worker.serve(shard, capacity_events=capacity_events):
                s.worker = w
                merged[s.rid] = s
            per_worker.append(worker.last_run)
        out = [merged[r.rid] for r in requests]
        fin = [s.finished_s for s in out
               if s.status not in REJECTED_STATUSES
               and math.isfinite(s.finished_s)]
        first = min((s.arrival_s for s in out), default=0.0)
        self.last_run = FleetStats(
            n_workers=self.n_workers,
            policy=self.policy,
            n_queries=len(out),
            n_finished=len(fin),
            n_shed=sum(1 for s in out if s.status == "shed"),
            n_degraded=sum(1 for s in out if s.status == "degraded"),
            n_rate_limited=sum(1 for s in out
                               if s.status == "rate_limited"),
            n_stolen=router.n_stolen,
            makespan_s=(max(fin) - first) if fin else 0.0,
            worker_counts=list(router.worker_counts),
            per_worker=per_worker)
        if self.cache_store is not None and self.publish_on_serve:
            self.publish()
        return out

    # -- reporting -----------------------------------------------------------
    def latency_report(self, served: Sequence[ServedQuery]) -> dict:
        """Fleet-level latency report: worker 0's report shape over the
        merged sample, with run-level fields replaced by fleet
        aggregates (per-worker reports remain available via
        ``workers[i].latency_report``)."""
        rep = self.workers[0].latency_report(served)
        st = self.last_run
        rep.update(n_micro_batches=sum(w.n_micro_batches
                                       for w in st.per_worker),
                   rounds=sum(w.rounds for w in st.per_worker),
                   makespan_s=st.makespan_s, qps=st.qps,
                   n_workers=st.n_workers, policy=st.policy,
                   n_stolen=st.n_stolen,
                   worker_counts=list(st.worker_counts))
        return rep

    def cache_report(self) -> dict:
        """Aggregate cache statistics across workers, with hit rates.

        ``effective_set.warm_rate`` counts any non-miss lookup (full /
        approx / structure hit) — the fraction of solves that skipped at
        least Algorithm 1's candidate sampling; ``response.hit_rate`` is
        exact dedup.  Routing policy is what moves these: affinity keeps
        a template's traffic on one worker's caches, random dilutes it.
        """
        def _sum(dicts: List[dict]) -> Dict[str, int]:
            out: Dict[str, int] = {}
            for d in dicts:
                for k, v in d.items():
                    out[k] = out.get(k, 0) + v
            return out

        eset = _sum([w.tuning.cache.stats() for w in self.workers])
        resp = _sum([w.tuning._results.stats() for w in self.workers
                     if w.tuning._results is not None])
        pools = _sum([w.session.pool_cache.stats() for w in self.workers])
        warm = (eset.get("hits", 0) + eset.get("approx_hits", 0)
                + eset.get("structure_hits", 0))
        eset_total = warm + eset.get("misses", 0)
        resp_total = resp.get("hits", 0) + resp.get("misses", 0)
        return {
            "effective_set": {
                **eset,
                "warm_rate": warm / eset_total if eset_total else math.nan},
            "response": {
                **resp,
                "hit_rate": (resp.get("hits", 0) / resp_total
                             if resp_total else math.nan)},
            "pools": pools,
        }
