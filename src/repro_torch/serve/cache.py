"""Serving-layer cache of the compile-time half.

:class:`EffectiveSetCache` — template-keyed Algorithm 1 artifacts for the
compile-time service.  It is long-lived by design: one instance serves
every micro-batch of a :class:`~repro_torch.serve.service.TuningService`,
which is where the amortization comes from.  (The runtime half's candidate
pool cache comes with the runtime slice.)

Algorithm 1's candidate sampling (LHS θc set, clustering, crossover
enrichment, θp⊕θs pool) depends only on the parameter spaces and the
:class:`~repro_torch.core.moo.hmooc.HMOOCConfig` — never on the query — so those
artifacts are shareable across *all* queries solved under one config.  The
per-representative optimal-θp banks (``opt_idx``) are computed from one
query's statistics; they are exact to reuse for an identical query (same
template, same parametric variant → same CBO statistics) and a
template-level approximation otherwise.

Cache policy, per (benchmark, template, config, model) key:

* **full hit** — stored fingerprint matches the incoming query: reuse
  candidates *and* banks; the solve skips Algorithm 1 and is bit-identical
  to a cold solve.
* **structure hit** — same template, different parametric variant: reuse
  the candidate samples, recompute banks (exact).  With
  ``reuse_banks_across_variants=True`` the stored banks are reused instead
  (approximate, amortized — the paper's repeated-template serving regime).
* **miss** — first sight of the template: full solve, artifacts stored.

Entries are LRU-evicted above ``max_entries``.
"""
from __future__ import annotations

import dataclasses
import pickle
import zlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from ..core.moo.hmooc import EffectiveSet, HMOOCConfig
from ..queryengine.plan import Query

__all__ = ["EffectiveSetCache", "query_fingerprint", "template_key",
           "model_fingerprint"]

SNAPSHOT_FORMAT = "repro-cache-snapshot"
SNAPSHOT_VERSION = 1


def pack_snapshot(kind: str, entries: list) -> bytes:
    """Serialize one cache's snapshot-eligible entries to an opaque blob."""
    return pickle.dumps(
        {"format": SNAPSHOT_FORMAT, "version": SNAPSHOT_VERSION,
         "kind": kind, "entries": entries},
        protocol=pickle.HIGHEST_PROTOCOL)


def unpack_snapshot(blob: bytes, kind: str) -> list:
    """Validate and decode a blob produced by :func:`pack_snapshot`."""
    payload = pickle.loads(blob)
    if not isinstance(payload, dict) \
            or payload.get("format") != SNAPSHOT_FORMAT:
        raise ValueError("blob is not a serving-cache snapshot")
    if payload.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported snapshot version {payload.get('version')!r}")
    if payload.get("kind") != kind:
        raise ValueError(
            f"snapshot of kind {payload.get('kind')!r} cannot restore "
            f"into a {kind!r} cache")
    return payload["entries"]


def model_fingerprint(model) -> Optional[object]:
    """Stable cache identity for an objective model.

    Prefers the model's content fingerprint (weights + config digest) so
    cache keys survive the model object being reloaded, and — critically —
    so a *different* model landing at a recycled ``id()`` can never satisfy
    a key minted under its predecessor.  Models without a ``fingerprint``
    method (test doubles, duck-typed oracles) fall back to ``id``; the
    caches pin those objects for the life of their entries so the id stays
    unique.
    """
    if model is None:
        return None
    fp = getattr(model, "fingerprint", None)
    if callable(fp):
        return fp()
    # repro: allow[RP004] documented live-object pin: id-fingerprinted entries are pinned alive for their lifetime, excluded from snapshots by the `model is None` filter, and the id is never compared across processes or replays
    return id(model)


def query_fingerprint(query: Query) -> int:
    """Hash of the statistics the stage objectives read from a query."""
    h = zlib.crc32(query.qid.encode())
    for sq in query.subqs:
        vals = np.asarray(
            list(sq.est_input_rows) + list(sq.est_input_bytes)
            + list(sq.input_rows) + list(sq.input_bytes)
            + [sq.est_out_rows, sq.est_out_bytes, sq.out_rows, sq.out_bytes,
               sq.cpu_weight, sq.skew, float(sq.depth)], np.float64)
        h = zlib.crc32(vals.tobytes(), h)
    return h


def template_key(query: Query, cfg: HMOOCConfig, model, cost=None) -> Tuple:
    # The banks depend on everything stage_eval reads: query statistics
    # (fingerprinted separately), the objective model, and the cost model.
    return (query.benchmark, query.template, cfg, cost,
            model_fingerprint(model))


def _freeze_eset(es: EffectiveSet) -> None:
    """Re-freeze an unpickled effective set in place.

    Unpickling always yields writable arrays, and a restored entry's
    arrays are handed out by reference to every future cache hit — the
    shared-mutable-array hazard: a caller mutating one hit would poison
    every later hit, so restores re-freeze them ``writeable=False``.
    """
    for a in (es.Uc, es.labels, es.reps, es.pool):
        a.setflags(write=False)
    if es.opt_idx is not None:
        for bank in es.opt_idx:
            for idx in bank:
                idx.setflags(write=False)


@dataclasses.dataclass
class _Entry:
    eset: EffectiveSet
    fingerprint: int
    # Strong reference kept only for models keyed by the id() fallback,
    # which CPython may reuse after a model is collected — pinning keeps
    # live entries' ids unique.  Content-fingerprinted models need no pin.
    model: object = None


class EffectiveSetCache:
    """LRU cache of Algorithm 1 artifacts keyed by query template."""

    def __init__(self, max_entries: int = 256, *,
                 reuse_banks_across_variants: bool = False):
        self.max_entries = max_entries
        self.reuse_banks_across_variants = reuse_banks_across_variants
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self.hits = 0            # full hits (banks reused, exact)
        self.approx_hits = 0     # banks reused across variants (approximate)
        self.structure_hits = 0  # candidates reused, banks recomputed
        self.misses = 0
        self.peek_hits = 0       # degraded-path bank probes that found banks
        self.peek_misses = 0     # degraded-path probes with nothing to reuse

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, query: Query, cfg: HMOOCConfig,
               model=None, cost=None) -> Optional[EffectiveSet]:
        key = template_key(query, cfg, model, cost)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        if entry.fingerprint == query_fingerprint(query):
            self.hits += 1
            return entry.eset
        if self.reuse_banks_across_variants \
                and entry.eset.opt_idx is not None \
                and len(entry.eset.opt_idx[0]) == query.n_subqs:
            # Cross-variant bank reuse is only shape-valid when the stored
            # banks cover exactly this query's subQ count — the same guard
            # peek() enforces.  A variant with a different plan shape falls
            # through to a structure hit (candidates reused, banks rebuilt).
            self.approx_hits += 1
            return entry.eset
        self.structure_hits += 1
        return entry.eset.without_banks()

    def peek(self, query: Query, cfg: HMOOCConfig,
             model=None, cost=None) -> Optional[Tuple[EffectiveSet, bool]]:
        """Degraded-path probe: banks for this template, or None.

        Unlike :meth:`lookup`, a fingerprint mismatch does *not* strip the
        banks and ``reuse_banks_across_variants`` is ignored — the degraded
        serving path explicitly opts into approximate cross-variant reuse
        (its alternative is no solve at all, never a fresh Algorithm 1).
        Returns ``(effective_set_with_banks, exact)`` where ``exact`` is
        True when the stored fingerprint matches the query (bank reuse is
        then bit-identical to a cold solve); returns None when the
        template has no stored banks usable for this query's subQ count.
        Never mutates LRU order or hit/miss stats of the normal path.
        """
        entry = self._entries.get(template_key(query, cfg, model, cost))
        if entry is None or entry.eset.opt_idx is None \
                or len(entry.eset.opt_idx[0]) != query.n_subqs:
            self.peek_misses += 1
            return None
        self.peek_hits += 1
        return entry.eset, entry.fingerprint == query_fingerprint(query)

    def store(self, query: Query, cfg: HMOOCConfig, eset: EffectiveSet,
              model=None, cost=None) -> None:
        key = template_key(query, cfg, model, cost)
        pin = model if (model is not None
                        and not callable(getattr(model, "fingerprint", None))
                        ) else None
        self._entries[key] = _Entry(eset=eset,
                                    fingerprint=query_fingerprint(query),
                                    model=pin)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "approx_hits": self.approx_hits,
                "structure_hits": self.structure_hits,
                "misses": self.misses,
                "peek_hits": self.peek_hits,
                "peek_misses": self.peek_misses}

    def snapshot(self) -> bytes:
        """Opaque blob of this cache's process-external entries (LRU order).

        **Snapshot contract:** only entries minted under a content-
        fingerprinted model (or no model) are included.  Entries keyed by
        the ``id()`` fallback — the ones holding a live-object pin — are
        process-local by construction (the id is meaningless elsewhere and
        the pinned object cannot travel) and are silently excluded; they
        simply stay warm on the worker that built them.
        """
        items = [(k, e.eset, e.fingerprint)
                 for k, e in self._entries.items() if e.model is None]
        return pack_snapshot("eset", items)

    def restore(self, blob: bytes) -> int:
        """Merge a :meth:`snapshot` blob into this cache; returns the
        number of entries inserted.  Existing entries win over snapshot
        entries under the same key (both are exact artifacts for that key,
        so preference only affects LRU age, never results); the merge
        respects ``max_entries`` by evicting from the cold end."""
        n = 0
        for k, es, fp in unpack_snapshot(blob, "eset"):
            if k in self._entries:
                continue
            _freeze_eset(es)
            self._entries[k] = _Entry(eset=es, fingerprint=fp)
            n += 1
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return n
