"""Batched tuning services (multi-query serving for both paper halves).

Every entry point that builds a service, a session, a server or a fleet
takes ``device`` (``None`` = the CUDA card; the host runs only when asked
for, ``device="cpu"``).

Compile time (§5.1):

* :func:`tune_batch` — solve the compile-time MOO for a batch of queries.
* :class:`TuningService` — long-lived server holding the effective-set
  cache so repeated-template traffic skips Algorithm 1.
* :class:`EffectiveSetCache` — the template-keyed cache itself.
* :class:`ResponseCache` — shareable exact result-dedup LRU.

Runtime (§5.2):

* :class:`RuntimeSession` — AQE-triggered θp/θs re-optimization of many
  concurrent queries through one fused, vectorized optimizer backend,
  seeded by the compile-time results.  Open entry set: ``admit`` /
  ``step_round`` / ``retire_ready`` / ``realize``.

Streaming (both halves unified):

* :class:`OptimizerServer` — streaming-admission serving loop: deadline-
  aware micro-batches through ``tune_batch``, AQE generators through one
  shared ``RuntimeSession``, late arrivals admitted mid-session.
* :class:`TenantScheduler` — multi-tenant admission accounting: per-tenant
  queues/deadline reserves, deficit-round-robin batch composition,
  priority tiers with overdue promotion (no starvation), and per-tenant
  SLO triage under overload (shed strict heads whose budget is
  unmeetable, flag degrade heads for the cheap compile path).
* Elastic capacity: :class:`ElasticPolicy`/:class:`ElasticController`
  autoscale the batch cap and arm preemptive degradation from a
  queue-delay forecast; :class:`TokenBucket` rate-limits per tenant
  ahead of the waiting room.

Fleet (multi-worker):

* :class:`OptimizerFleet` — N server replicas behind a consistent-hash
  template-affinity router (:class:`FleetRouter`/:class:`HashRing`) with
  a work-stealing fallback; per-tenant outputs stay bit-identical to the
  offline pipeline under any worker count and routing policy.
* :class:`CacheStore` — process-external snapshot store the serving
  caches ``snapshot()``/``restore()`` through (content-fingerprinted
  entries only), carrying cache warmth across workers and processes.
"""
from .admission import (Admit, ElasticController, ElasticPolicy,
                        TenantScheduler, TenantState, TokenBucket)
from .cache import CandidatePoolCache, EffectiveSetCache
from .fleet import (CacheStore, FleetRouter, FleetStats, HashRing,
                    OptimizerFleet, ROUTING_POLICIES, route_key)
from .runtime import RuntimeSession, RuntimeSessionStats
from .server import (REJECTED_STATUSES, OptimizerServer, ServedQuery,
                     ServerConfig, ServerStats, ServiceTimeModel,
                     jain_index)
from .service import ResponseCache, TuningService, tune_batch

__all__ = ["EffectiveSetCache", "TuningService", "tune_batch",
           "ResponseCache", "RuntimeSession", "RuntimeSessionStats",
           "CandidatePoolCache", "OptimizerServer", "ServerConfig",
           "ServedQuery", "ServerStats", "TenantScheduler", "TenantState",
           "Admit", "jain_index", "ElasticPolicy", "ElasticController",
           "TokenBucket", "ServiceTimeModel", "REJECTED_STATUSES",
           "OptimizerFleet", "FleetStats", "FleetRouter", "HashRing",
           "CacheStore", "route_key", "ROUTING_POLICIES"]
