"""Batched tuning service, compile-time (paper §5.1) and runtime (§5.2).

* :func:`tune_batch` — solve the compile-time MOO for a batch of queries.
* :class:`TuningService` — long-lived server holding the effective-set
  cache so repeated-template traffic skips Algorithm 1.
* :class:`EffectiveSetCache` — the template-keyed cache itself.
* :class:`ResponseCache` — shareable exact result-dedup LRU.
* :class:`RuntimeSession` — AQE-time θp/θs re-tuning of many concurrent
  queries, fused across queries each round.
* :class:`CandidatePoolCache` — the runtime candidate pools it shares.

The streaming server and the fleet come with later slices of the port.
"""
from .cache import CandidatePoolCache, EffectiveSetCache
from .runtime import RuntimeSession, RuntimeSessionStats
from .service import ResponseCache, TuningService, tune_batch

__all__ = ["EffectiveSetCache", "TuningService", "tune_batch",
           "ResponseCache", "RuntimeSession", "RuntimeSessionStats",
           "CandidatePoolCache"]
