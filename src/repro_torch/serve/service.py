"""Batched multi-query compile-time tuning service (paper §5.1 at scale).

``tune_batch`` amortizes solver work across a batch of concurrent tuning
requests, the serving regime of the paper's 1–2 s cloud budget:

* **Request dedup / response cache** — identical requests (byte-identical
  statistics + weights), within a batch or across batches, are solved once
  and the stored result is shared (exact: the solver is deterministic).
* **Effective-set cache** — Algorithm 1 artifacts are reused across
  batches for repeated-template traffic (see
  :mod:`repro_torch.serve.cache`).
* **Vectorized solver** — the underlying HMOOC solve batches every
  stage-model evaluation to one call per subQ and routes dominance
  filtering through the CUDA ``pareto_filter`` kernel.

The service runs on one torch device (``device=None`` = the CUDA card):
the dominance filters run there, and a model-backed service's model sits
on its own device.

Every returned :class:`CompileTimeResult` is bit-identical to what a
standalone ``compile_time_optimize`` call would produce for that query
(dedup shares exact results; cache reuse is exact for identical queries and
disabled across variants unless explicitly opted in).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import tracing
from ..core.models.perf_model import PerfModel
from ..device import resolve_device
from ..core.moo.hmooc import HMOOCConfig, HmoocPlan
from ..core.tuning.compile_time import (CompileTimeResult,
                                        compile_time_optimize,
                                        default_theta_result, finish_result)
from ..core.tuning.objectives import StageObjectives, fused_stage_eval
from ..queryengine.plan import Query
from ..queryengine.simulator import CostModel, DEFAULT_COST
from .cache import (EffectiveSetCache, model_fingerprint, pack_snapshot,
                    query_fingerprint, template_key, unpack_snapshot)

__all__ = ["TuningService", "tune_batch", "ResponseCache"]

Weights = Tuple[float, float]


@dataclasses.dataclass
class BatchStats:
    n_queries: int = 0
    n_solved: int = 0            # actual solver invocations (post-dedup)
    n_deduped: int = 0           # served from an identical request (any age)
    n_cheap: int = 0             # degraded: solved on reused template banks
    n_default_theta: int = 0     # degraded: served the Spark defaults
    wall_time: float = 0.0


class ResponseCache:
    """Bounded LRU of finished results keyed by (tenant, fingerprint,
    weights).

    Exact by construction: the solver is deterministic, so an identical
    request (same statistics, weights, config, model) maps to a
    bit-identical :class:`CompileTimeResult`.  Shareable: a streaming
    server passes one instance to its :class:`TuningService` so dedup
    spans micro-batches and admission epochs, not just one batch.  The
    tenant id is part of the key, so one tenant's weighted picks are never
    served to another — even before the preference weights (also in the
    key) would force a miss.

    The model's *content fingerprint* (not its live object identity) is the
    last key element: a reloaded model with identical weights keeps its
    entries valid, while a retrained model can never be served a
    predecessor's picks — even if the old object is collected and its id
    recycled.  :meth:`clear_model` drops every entry minted under a given
    fingerprint (the retire-a-model path).
    """

    def __init__(self, max_entries: int = 4096):
        from collections import OrderedDict
        self.max_entries = max_entries
        self._d: "OrderedDict[tuple, CompileTimeResult]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.model_evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key):
        r = self._d.get(key)
        if r is not None:
            self.hits += 1
            self._d.move_to_end(key)
        else:
            self.misses += 1
        return r

    def put(self, key, result) -> None:
        self._d[key] = result
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def clear_model(self, model_fp) -> int:
        """Evict every entry keyed under model fingerprint ``model_fp``."""
        victims = [k for k in self._d if k and k[-1] == model_fp]
        for k in victims:
            del self._d[k]
        self.model_evictions += len(victims)
        return len(victims)

    def stats(self) -> dict:
        return {"entries": len(self._d), "hits": self.hits,
                "misses": self.misses,
                "model_evictions": self.model_evictions}

    def snapshot(self) -> bytes:
        """Opaque blob of the process-external entries (LRU order).

        **Snapshot contract:** response keys end with the model
        fingerprint; an ``int`` there is the ``id()`` fallback for models
        without a content fingerprint, meaningful only inside this
        process.  Those entries are silently excluded — they stay warm
        locally.  Content-fingerprinted (str) and model-less (None) keys
        serialize, including the degrade-marked ``("degraded", ...)``
        variants (their :class:`_CheapEntry` kind travels with them).
        """
        items = [(k, v) for k, v in self._d.items()
                 if not isinstance(k[-1], int)]
        return pack_snapshot("response", items)

    def restore(self, blob: bytes) -> int:
        """Merge a :meth:`snapshot` blob; returns entries inserted.
        Existing entries win under the same key (both are the solver's
        deterministic output for that key); ``max_entries`` is enforced
        from the cold end."""
        n = 0
        for k, v in unpack_snapshot(blob, "response"):
            if k in self._d:
                continue
            self._d[k] = v
            n += 1
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
        return n


@dataclasses.dataclass
class _CheapEntry:
    """Degraded-path response-cache entry: the result plus how it was made.

    The kind travels with the entry because a later hit cannot re-derive
    it: bank availability may have changed between the store and the hit
    (e.g. the effective-set cache evicted the template), so re-probing at
    hit time would relabel a cached cheap solve as a default — corrupting
    the degraded-path accounting the overload controller steers by.
    """
    result: CompileTimeResult
    kind: str                     # "cheap" | "default"


class TuningService:
    """Long-lived compile-time tuning server with an effective-set cache."""

    def __init__(
        self,
        *,
        model: Optional[PerfModel] = None,
        cfg: HMOOCConfig = HMOOCConfig(),
        cost: CostModel = DEFAULT_COST,
        cache: Optional[EffectiveSetCache] = None,
        reuse_banks_across_variants: bool = False,
        dedupe: bool = True,
        response_cache: Optional[ResponseCache] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.cost = cost
        self.cache = cache if cache is not None else EffectiveSetCache(
            reuse_banks_across_variants=reuse_banks_across_variants)
        self.dedupe = dedupe
        if response_cache is not None:
            self._results: Optional[ResponseCache] = response_cache
        else:
            self._results = ResponseCache() if dedupe else None
        self.last_batch = BatchStats()
        self.totals = BatchStats()     # cumulative over the service's life

    @property
    def model(self) -> Optional[PerfModel]:
        return self._model

    @model.setter
    def model(self, m: Optional[PerfModel]) -> None:
        # Response-cache keys carry the fingerprint of the model that
        # produced them, so swapping in a retrained model invalidates old
        # entries by key mismatch alone.
        self._model = m
        self._model_fp = model_fingerprint(m)

    def tune_batch(
        self,
        queries: Sequence[Query],
        weights: Union[Weights, Sequence[Weights]] = (0.9, 0.1),
        *,
        tenants: Optional[Sequence[Optional[str]]] = None,
        degraded: Optional[Sequence[bool]] = None,
    ) -> List[CompileTimeResult]:
        """Solve the compile-time MOO for every query; aligned results.

        ``tenants`` (aligned with ``queries``) scopes response-cache
        entries per tenant: a multi-tenant server passes each request's
        tenant id so cached weighted picks never cross tenants.  ``None``
        keeps the anonymous single-stream behavior.

        ``degraded`` (aligned with ``queries``) marks queries whose solve
        budget is already blown (degrade-SLO overload admissions): they are
        routed through the *cheap* compile path — an exact response-cache
        hit if one exists, else a solve on the template's cached Algorithm 1
        banks (approximate across parametric variants), else the Spark
        default configuration — never a fresh Algorithm 1 bank build.
        Approximate degraded results are cached under a degrade-marked key,
        so they can never be served to a later full-quality request.
        """
        t0 = time.perf_counter()
        tr = tracing.TRACE
        if tr is not None:
            sp = tr.open("tune")
        per_q_weights = _expand_weights(weights, len(queries))
        if tenants is not None and len(tenants) != len(queries):
            raise ValueError(
                f"got {len(tenants)} tenant ids for {len(queries)} queries")
        if degraded is not None and len(degraded) != len(queries):
            raise ValueError(
                f"got {len(degraded)} degrade flags for {len(queries)} "
                "queries")
        results: List[Optional[CompileTimeResult]] = [None] * len(queries)
        # A model-backed service solves in lockstep batches; the oracle
        # backend keeps the sequential per-query loop (its evaluator is
        # already one vectorized simulator call per stage).
        use_batched = self._model is not None
        n_solved = n_cheap = n_default = 0
        run: List[int] = []

        def flush_run() -> None:
            nonlocal n_solved
            if run:
                # repro: allow[CK002] batched full solves store under the exact (non-degrade-marked) key on purpose — same contract as the direct put below; `degraded` never reaches _solve_run (degraded queries act as run barriers above)
                n_solved += self._solve_run(queries, per_q_weights, tenants,
                                            run, results)
                run.clear()

        for qi, (q, w) in enumerate(zip(queries, per_q_weights)):
            if use_batched and not (degraded is not None and degraded[qi]):
                # Batched across the run of non-degraded neighbors; any
                # degraded query below acts as a barrier so cache traffic
                # keeps the sequential order (and therefore stats).
                run.append(qi)
                continue
            flush_run()
            key = self._response_key(q, w,
                                     tenants[qi] if tenants is not None
                                     else None)
            if self._results is not None:
                hit = self._results.get(key)
                if hit is not None:
                    results[qi] = hit
                    continue
            if degraded is not None and degraded[qi]:
                # repro: allow[CK002] _tune_cheap stores twice by design: under the degrade-marked key AND under the exact key, so a later exact hit upgrades the degraded answer — the `degraded` dimension is deliberately absent from the exact-key store
                results[qi], kind = self._tune_cheap(q, w, key)
                if kind == "cheap":
                    n_cheap += 1
                else:
                    n_default += 1
                continue
            results[qi] = compile_time_optimize(
                q, model=self._model, weights=w, cfg=self.cfg,
                cost=self.cost, cache=self.cache, device=self.device)
            n_solved += 1
            if self._results is not None:
                # repro: allow[CK002] full solves store under the exact key on purpose: degraded results are minted in _tune_cheap under degrade-marked keys, and an exact hit serving a later degraded request is the intended upgrade path
                self._results.put(key, results[qi])
        flush_run()
        dt = time.perf_counter() - t0
        self.last_batch = BatchStats(
            n_queries=len(queries), n_solved=n_solved,
            n_deduped=(len(queries) - n_solved - n_cheap - n_default),
            n_cheap=n_cheap, n_default_theta=n_default, wall_time=dt)
        for f in dataclasses.fields(BatchStats):
            setattr(self.totals, f.name,
                    getattr(self.totals, f.name) + getattr(self.last_batch,
                                                           f.name))
        if tr is not None:
            tr.close(sp, n=len(queries), n_solved=n_solved)
        return results  # type: ignore[return-value]

    def _response_key(self, q: Query, w: Weights, tenant) -> tuple:
        # qid + statistics fingerprint: the 32-bit crc alone could collide
        # across distinct queries in a long-lived service.  cfg/cost/model
        # fingerprint complete the inputs the solver reads, so one
        # ResponseCache can be shared across differently-configured
        # services and survives model reloads (see ResponseCache).
        return (tenant, q.qid, query_fingerprint(q), w, self.cfg, self.cost,
                self._model_fp)

    def _solve_run(self, queries: Sequence[Query],
                   per_q_weights: Sequence[Weights],
                   tenants: Optional[Sequence[Optional[str]]],
                   idxs: Sequence[int],
                   results: List[Optional[CompileTimeResult]]) -> int:
        """Batched micro-batch solve of one run of non-degraded queries.

        Semantically a transcript of the sequential loop: every
        response-cache get/put and effective-set lookup/store happens with
        the same keys and — per cache key — in the same order, so hit/miss
        statistics and stored artifacts match the legacy path exactly, and
        each result is bit-identical to its ``compile_time_optimize``
        counterpart.  What changes is the dispatch shape: all queries'
        stage evaluations per solver phase are fused into one bucket-padded
        model call (:func:`fused_stage_eval`), and the HMOOC solves advance
        in lockstep as externally-driven :class:`HmoocPlan` state machines.
        Returns the number of actual solves (post-dedup).
        """
        model = self._model
        tr = tracing.TRACE
        if tr is not None:
            sp = tr.open("tune.responses")
        # -- response planning: dedup within and across batches ------------
        keys: dict = {}
        pending: dict = {}            # key -> first qi solving it this run
        deferred_gets: List[Tuple[int, tuple]] = []
        solved: List[int] = []
        for qi in idxs:
            key = self._response_key(
                queries[qi], per_q_weights[qi],
                tenants[qi] if tenants is not None else None)
            keys[qi] = key
            if self._results is not None:
                if key in pending:
                    # An identical request is already solving in this run;
                    # resolve the get after its put so the dedup registers
                    # as a response-cache hit, like the sequential order.
                    deferred_gets.append((qi, key))
                    continue
                hit = self._results.get(key)
                if hit is not None:
                    results[qi] = hit
                    continue
                pending[key] = qi
            solved.append(qi)
        if tr is not None:
            tr.close(sp)
        if solved:
            # -- embedding prefetch: one GTN dispatch for the whole run ----
            if tr is not None:
                sp = tr.open("tune.embed")
            pairs = []
            for qi in solved:
                pairs.extend((queries[qi], i)
                             for i in range(queries[qi].n_subqs))
            model.embed_many(pairs)
            if tr is not None:
                tr.close(sp)
                sp = tr.open("tune.esets")
            objs = {qi: StageObjectives(queries[qi], model=model,
                                        cost=self.cost) for qi in solved}
            # -- effective-set planning ------------------------------------
            t0s: dict = {}
            plans: dict = {}
            deferred_lookup: set = set()
            pending_eset: dict = {}   # template key -> (owner qi, owner fp)
            waiting: List[Tuple[int, int]] = []   # (qi, owner qi)
            for qi in solved:
                q, obj = queries[qi], objs[qi]
                t0s[qi] = time.perf_counter()
                tk = template_key(q, self.cfg, model, self.cost)
                fp = query_fingerprint(q)
                if tk in pending_eset:
                    # The template's banks are being (re)built by an
                    # earlier query of this run; the cache lookup is
                    # deferred past the owner's store so stats match the
                    # sequential transcript.
                    owner_qi, owner_fp = pending_eset[tk]
                    deferred_lookup.add(qi)
                    if (fp == owner_fp
                            or self.cache.reuse_banks_across_variants):
                        waiting.append((qi, owner_qi))
                        continue
                    # Different variant, no cross-variant reuse: fresh
                    # banks over the owner's (query-independent)
                    # candidates; this query's store supersedes the
                    # owner's, so it becomes the template's new owner.
                    plans[qi] = HmoocPlan(
                        q.n_subqs, obj.d_c, obj.d_ps, self.cfg,
                        snap_c=obj.snap_c, snap_ps=obj.snap_ps,
                        effective_set=plans[owner_qi].eset.without_banks(),
                        device=self.device)
                    pending_eset[tk] = (qi, fp)
                    continue
                eset = self.cache.lookup(q, self.cfg, model, self.cost)
                plans[qi] = HmoocPlan(
                    q.n_subqs, obj.d_c, obj.d_ps, self.cfg,
                    snap_c=obj.snap_c, snap_ps=obj.snap_ps,
                    effective_set=eset, device=self.device)
                if not plans[qi].reused_banks:
                    pending_eset[tk] = (qi, fp)
            if tr is not None:
                tr.close(sp)
            # -- lockstep rounds: one fused model call per solver phase ----
            while True:
                active = [qi for qi in solved
                          if qi in plans and not plans[qi].done]
                if not active and not waiting:
                    break
                if tr is not None:
                    sp = tr.open("tune.phase")
                items, spans = [], []
                for qi in active:
                    reqs = plans[qi].requests()
                    items.extend((objs[qi], i, Tc, Tps)
                                 for i, Tc, Tps in reqs)
                    spans.append((qi, len(reqs)))
                evals = fused_stage_eval(items)
                off = 0
                for qi, n in spans:
                    if tr is not None:
                        sp_feed = tr.open("hmooc.feed")
                        phase = ("assign" if plans[qi].banks_ready
                                 else "banks")
                    plans[qi].feed(evals[off:off + n])
                    if tr is not None:
                        tr.close(sp_feed, pos=qi, phase=phase)
                    off += n
                still = []
                for qi, owner_qi in waiting:
                    if plans[owner_qi].banks_ready:
                        plans[qi] = HmoocPlan(
                            queries[qi].n_subqs, objs[qi].d_c,
                            objs[qi].d_ps, self.cfg,
                            snap_c=objs[qi].snap_c,
                            snap_ps=objs[qi].snap_ps,
                            effective_set=plans[owner_qi].eset,
                            device=self.device)
                    else:
                        still.append((qi, owner_qi))
                waiting = still
                if tr is not None:
                    tr.close(sp, plans=len(active), requests=len(items))
            # -- finalize in request order ---------------------------------
            if tr is not None:
                sp = tr.open("tune.finalize")
            for qi in solved:
                q, w = queries[qi], per_q_weights[qi]
                if qi in deferred_lookup:
                    # Stats-only replay of the lookup the sequential path
                    # would have issued here (after the owner's store).
                    self.cache.lookup(q, self.cfg, model, self.cost)
                plan = plans[qi]
                res = plan.result
                if not plan.reused_banks and res.effective_set is not None:
                    self.cache.store(q, self.cfg, res.effective_set, model,
                                     self.cost)
                ct = finish_result(q, objs[qi], res, w, t0s[qi])
                results[qi] = ct
                if self._results is not None:
                    self._results.put(keys[qi], ct)
            if tr is not None:
                tr.close(sp)
        for qi, key in deferred_gets:
            results[qi] = self._results.get(key)
        return len(solved)

    def _tune_cheap(self, q: Query, w: Weights, exact_key: tuple
                    ) -> Tuple[CompileTimeResult, str]:
        """Budget-blown solve: cached template banks or the Spark defaults.

        Never builds fresh Algorithm 1 banks.  The caller has already
        missed the exact response cache for ``exact_key``; approximate
        results are stored under a degrade-marked variant of that key
        (exact bank reuse — matching fingerprint — is bit-identical to a
        full solve and stored under the exact key itself).  Degrade-marked
        entries carry their kind (:class:`_CheapEntry`) so a hit reports
        how the cached result was actually produced, not what this call's
        bank probe would have done — the two diverge whenever the
        effective-set cache evicted (or gained) the template between the
        store and the hit.
        """
        peeked = self.cache.peek(q, self.cfg, self._model, self.cost)
        if peeked is not None and peeked[1]:
            # Exact bank reuse is bit-identical to a full solve: share the
            # exact key with the full-quality path.
            if self._results is not None:
                hit = self._results.get(exact_key)
                if hit is not None:
                    return hit, "cheap"
            res = compile_time_optimize(
                q, model=self._model, weights=w, cfg=self.cfg,
                cost=self.cost, effective_set=peeked[0], device=self.device)
            if self._results is not None:
                self._results.put(exact_key, res)
            return res, "cheap"
        key = ("degraded",) + exact_key
        if self._results is not None:
            hit = self._results.get(key)
            if hit is not None:
                return hit.result, hit.kind
        if peeked is not None:
            res = compile_time_optimize(
                q, model=self._model, weights=w, cfg=self.cfg,
                cost=self.cost, effective_set=peeked[0], device=self.device)
            kind = "cheap"
        else:
            res = default_theta_result(q, model=self._model, cost=self.cost)
            kind = "default"
        if self._results is not None:
            self._results.put(key, _CheapEntry(res, kind))
        return res, kind


def tune_batch(
    queries: Sequence[Query],
    weights: Union[Weights, Sequence[Weights]] = (0.9, 0.1),
    cfg: HMOOCConfig = HMOOCConfig(),
    *,
    model: Optional[PerfModel] = None,
    cost: CostModel = DEFAULT_COST,
    cache: Optional[EffectiveSetCache] = None,
    dedupe: bool = True,
    device=None,
) -> List[CompileTimeResult]:
    """One-shot batched solve; see :class:`TuningService` for a server."""
    svc = TuningService(model=model, cfg=cfg, cost=cost, cache=cache,
                        dedupe=dedupe, device=device)
    return svc.tune_batch(queries, weights)


def _expand_weights(weights, n: int) -> List[Weights]:
    arr = np.asarray(weights, np.float64)
    if arr.ndim == 1:
        return [tuple(arr.tolist())] * n
    if arr.shape[0] != n:
        raise ValueError(
            f"got {arr.shape[0]} weight rows for {n} queries")
    return [tuple(row.tolist()) for row in arr]
