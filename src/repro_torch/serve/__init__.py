"""Batched compile-time tuning service (paper §5.1 at scale).

* :func:`tune_batch` — solve the compile-time MOO for a batch of queries.
* :class:`TuningService` — long-lived server holding the effective-set
  cache so repeated-template traffic skips Algorithm 1.
* :class:`EffectiveSetCache` — the template-keyed cache itself.
* :class:`ResponseCache` — shareable exact result-dedup LRU.

The runtime (AQE) session, the streaming server and the fleet come with
later slices of the port.
"""
from .cache import EffectiveSetCache
from .service import ResponseCache, TuningService, tune_batch

__all__ = ["EffectiveSetCache", "TuningService", "tune_batch",
           "ResponseCache"]
