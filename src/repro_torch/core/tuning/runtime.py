"""Runtime optimization: the AQE plugin that re-tunes θp / θs (paper §5.2).

Invoked by :func:`repro_torch.queryengine.aqe.run_with_aqe` each time a collapsed
plan (L̄QP) or a new query stage (QS) needs optimization.  The optimizer sees
*true* statistics (AQE has revealed the completed stages' cardinalities) and
re-solves a small MOO for the stage at hand, picking the weighted-best
candidate under the user preference — mirroring the paper's client/server
design where the server runs model inference + MOO per request.

Backends:
  * oracle — simulate the stage on true inputs (used for algorithm studies);
  * model  — θp decisions (L̄QP requests) re-score the subQ model with true
    statistics; θs decisions (QS requests) use the runtime QS model (θp
    dropped; θc ⊕ θs decision).

The scoring path is request-shaped so a serving layer can fuse it across
queries: :func:`score_requests` stacks same-kind oracle requests into one
:func:`~repro_torch.queryengine.simulator.simulate_stage_rows` call and same-model
requests into one :meth:`PerfModel.predict` call, and
:func:`weighted_pick_batch` resolves every pick through the Pareto /
weighted-sum kernels.  :func:`make_runtime_optimizers` drives the identical
code with single-request batches, so per-query and fused serving results
match bit-for-bit on the oracle backend.

Device placement is explicit: the backend, :func:`weighted_pick_batch` and
:func:`make_runtime_optimizers` take ``device`` (``None`` = the CUDA card,
resolved per call), where the dominance and weighted-sum kernels run.  A
model runs on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...queryengine.plan import Query, SubQ
from ...queryengine.simulator import (CostModel, DEFAULT_COST, StageStats,
                                      simulate_stage_rows, stage_stats_batch)
from ...queryengine.trace import _alpha_stats
from ..models.perf_model import PerfModel, make_nondecision
from ..moo import hmooc as _hmooc
from ..moo import pareto as _pareto
from ..moo.pareto import pareto_masks_fast
from .objectives import resource_rate
from .spark_space import theta_c_space, theta_p_space, theta_s_space

__all__ = ["RuntimeOptimizerBackend", "ScoreRequest", "score_requests",
           "weighted_pick_batch", "sample_candidate_pools", "fusion_key",
           "make_runtime_optimizers", "stage_pressure", "structural_gamma",
           "structural_pressure"]

# Reference partition size for the γ task-pressure proxy: the runtime does
# not know a co-running stage's final partition count (it depends on that
# stage's own θ decisions), so pressure is measured against a fixed
# 128 MB advisory partition — θ-independent, hence deterministic and
# identical however requests are batched.
GAMMA_REF_PART_BYTES = 128e6


def stage_pressure(subq: SubQ) -> Tuple[float, float]:
    """(task, work) pressure proxy of one stage, from its true statistics.

    Tasks ≈ input bytes over the reference partition size; work ≈ input GB
    weighted by the stage CPU weight (the simulator's c_* coefficients are
    O(seconds/GB), so this lands on the task-seconds scale the trace-time γ
    was computed on).
    """
    b = float(sum(subq.input_bytes))
    tasks = max(1.0, b / GAMMA_REF_PART_BYTES)
    work = (b / 1e9) * float(subq.cpu_weight)
    return tasks, work


def structural_pressure(query: Query) -> Tuple[np.ndarray, np.ndarray]:
    """Per-stage raw contention sums: ((m, 3) [tasks, work, n_sib], (m,) d).

    A stage's concurrent companions are its same-depth siblings — the
    stages a scheduler would run alongside it — mirroring the trace-time
    definition (``collect_traces``, not yet in this package), but with
    statistics-based pressure proxies (:func:`stage_pressure`) instead of
    simulated task counts, so the sums are available *before* execution
    and depend only on the query.
    """
    depths = query.subq_depths()
    m = query.n_subqs
    pres = np.asarray([stage_pressure(sq) for sq in query.subqs], np.float64)
    d = np.asarray([depths[i] for i in range(m)], np.float64)
    raw = np.zeros((m, 3), np.float64)
    for i in range(m):
        sib = [j for j in range(m) if d[j] == d[i] and j != i]
        raw[i] = [pres[sib, 0].sum() if sib else 0.0,
                  pres[sib, 1].sum() if sib else 0.0, len(sib)]
    return raw, d


def structural_gamma(query: Query) -> np.ndarray:
    """(m, 4) per-stage γ from the query's own co-running stages.

    Depends only on the query, so it is bit-identical however the serving
    layer slices or fuses requests — the parity-preserving default.
    """
    from ..models.features import contention_gamma
    raw, d = structural_pressure(query)
    return contention_gamma(raw[:, 0], raw[:, 1], raw[:, 2], d)


def fusion_key(rq: "ScoreRequest") -> tuple:
    """Group key under which :func:`score_requests` fuses a request."""
    model = rq.backend.model_for(rq.decision)
    if model is not None:
        # repro: allow[RP004] within-process fusion grouping token: only group *membership* affects batching, outputs are row-independent, and the key is never serialized or compared across workers
        return ("model", rq.decision, id(model))
    # repro: allow[RP004] same within-process grouping token as above for the oracle cost object
    return ("oracle", rq.subq.kind, id(rq.backend.cost))


def sample_candidate_pools(seed: int, n_candidates: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One LHS draw of the runtime θp/θs candidate pools.

    Query-independent (the pools only depend on the parameter spaces), so a
    serving session shares one draw across every concurrent query — exactly
    the arrays a standalone per-query backend would draw for the same seed.
    """
    ps, ss = theta_p_space(), theta_s_space()
    rng = np.random.default_rng(seed)
    pool_p = ps.to_raw(ps.sample_lhs(rng, n_candidates))
    pool_s = ss.to_raw(ss.sample_lhs(rng, n_candidates))
    return pool_p, pool_s


def weighted_pick_batch(Fs: Sequence[np.ndarray], weights, *,
                        device=None) -> List[int]:
    """Weighted-best row index per candidate objective set.

    ``weights`` is one (2,) preference vector shared by every set, or a
    per-set (R, 2) stack — the multi-tenant serving shape, where each
    request carries its tenant's preference.  Per-set weights fuse by
    distinct weight row; every pick normalizes and scores within its own
    candidate set only, so on the numpy routing (the CPU default) grouping
    never changes any set's winner: a single-tenant batch resolves
    bit-identically to the shared-weights path.  Above the env-gated
    kernel thresholds the usual f32 caveat (below) additionally applies to
    the *group size*: splitting by weight row shrinks the fused score
    volume, which can route a group to numpy f64 where the homogeneous
    batch would hit the f32 kernel.

    Per set: dominated rows are dropped (at or above
    ``REPRO_PARETO_KERNEL_MIN_N`` rows), all rows are min-max normalized
    over the full set, and the weighted-sum argmin over the survivors
    scores in float32 when the group's fused score volume (sets × bank)
    clears ``REPRO_WS_KERNEL_MIN_SCORES`` and no normalized value ties
    another in float32, else in float64 — the same env-gated thresholds as
    the compile-time solver.  Single-request and fused serving calls share
    this code, so on the numpy routing (the CPU default) their picks are
    identical; above the kernel thresholds the fused call may score in
    float32 while a lone request stays on numpy, the same f32-vs-f64
    caveat the compile-time kernel routing documents.

    ``device`` (``None`` = the CUDA card) decides where the picks run and
    the thresholds' defaults.  On ``cuda`` (both thresholds 0 by default)
    the round's sets, offsets, group ids and weights cross in one pinned
    copy, one ``runtime_pick`` call prefilters, normalizes and picks them
    all on the card, and the picks come back after one synchronisation:
    the decisions the numpy route would make with the ``pareto_filter``
    and ``ws_reduce`` kernels behind it.  On ``cpu`` the numpy route runs,
    with those kernels' plain versions above the thresholds (defaults:
    never).
    """
    device = resolve_device(device)
    R = len(Fs)
    if R == 0:
        return []
    w = np.asarray(weights, np.float64)
    if w.ndim == 2 and w.shape[0] != R:
        raise ValueError(f"got {w.shape[0]} weight rows for {R} candidate sets")
    Fs = [np.asarray(F, np.float64) for F in Fs]
    if device.type == "cuda":
        return _pick_on_card(Fs, w, device)
    return _pick_composed(Fs, w, device)


def _pick_composed(Fs: List[np.ndarray], w: np.ndarray,
                   device: torch.device) -> List[int]:
    """The numpy route: masks from ``pareto_masks_fast`` and picks from
    ``_pick`` a weight group, each reaching its kernel on ``device`` above
    the thresholds (on the host, the kernels' plain versions).  The card
    takes ``_pick_on_card``, which decides alike."""
    kept = _prefilter(Fs, device)
    if w.ndim != 2:
        return _pick(Fs, kept, w, device)
    groups: Dict[tuple, List[int]] = {}
    for r, row in enumerate(map(tuple, w.tolist())):
        groups.setdefault(row, []).append(r)
    out = [0] * len(Fs)
    for row, idxs in groups.items():
        for i, j in zip(idxs, _pick([Fs[i] for i in idxs],
                                    [kept[i] for i in idxs],
                                    np.asarray(row, np.float64), device)):
            out[i] = j
    return out


def _stage_round(Fs: List[np.ndarray], w: np.ndarray, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """``runtime_pick``'s inputs on ``device``: the sets one after another
    (total, k) float64, their (R + 1,) int32 row offsets, each set's (R,)
    int32 weight group and the groups' (G, k) float64 weight rows (one
    group per distinct row of a per-set ``w``, in first-seen order, as the
    numpy route groups them).  All four fill one buffer, pinned when bound
    for the card, and cross in one copy."""
    R, k = len(Fs), Fs[0].shape[-1]
    sizes = [len(F) for F in Fs]
    if 0 in sizes:
        raise ValueError(f"candidate sets must be nonempty (n, {k}) arrays")
    gid = 0
    if w.ndim != 2:
        W = w.reshape(1, -1)
    elif (w == w[0]).all():      # one weight row: one group
        W = w[:1]
    else:
        groups: Dict[tuple, int] = {}
        gid = [groups.setdefault(row, len(groups))
               for row in map(tuple, w.tolist())]
        W = np.asarray(list(groups), np.float64).reshape(len(groups), -1)
    total = sum(sizes)
    nF, nW = total * k * 8, W.size * 8
    buf = torch.empty(nF + nW + 4 * (2 * R + 1), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    # Raises unless every set is (n, k).
    np.concatenate(Fs, out=host[:nF].view(np.float64).reshape(total, k))
    host[nF:nF + nW].view(np.float64)[...] = W.ravel()
    ints = host[nF + nW:].view(np.int32)
    ints[0] = 0
    ints[1:R + 1] = sizes
    np.cumsum(ints[1:R + 1], out=ints[1:R + 1])
    ints[R + 1:] = gid
    buf = buf.to(device, non_blocking=True)
    ints_d = buf[nF + nW:].view(torch.int32)
    return (buf[:nF].view(torch.float64).view(total, k), ints_d[:R + 1],
            ints_d[R + 1:], buf[nF:nF + nW].view(torch.float64).view(W.shape))


def _pick_thresholds(device: torch.device) -> Tuple[int, int]:
    """(prefilter rows, float32 score volume) at or above which a pick
    takes the kernels' route on ``device``."""
    thr = _pareto._KERNEL_MIN_N if _pareto._KERNEL_MIN_N is not None \
        else _pareto._default_kernel_min_n(device)
    return thr, _hmooc._ws_min_scores(device)


def _pick_on_card(Fs: List[np.ndarray], w: np.ndarray,
                  device: torch.device) -> List[int]:
    """The whole round in one ``runtime_pick`` call: one copy in
    (``_stage_round``), the picks back into one pinned buffer after one
    synchronisation."""
    # repro: allow[KP003] the tie check runs on the card inside runtime_pick, which scores a group with a float32 tie in float64 (runtime_pick_ref states the rule)
    from ...kernels.ws_reduce import runtime_pick  # lazy: kernel layer
    F, offsets, gid, W = _stage_round(Fs, w, device)
    thr, ws_thr = _pick_thresholds(device)
    out = runtime_pick(F, offsets, gid, W, kernel_min_n=thr,
                       ws_min_scores=ws_thr,
                       max_n=max(f.shape[0] for f in Fs))
    picks = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
    picks.copy_(out, non_blocking=True)
    # repro_torch: allow[TH002] a runtime round's one sync (PERF.md §3): the round's picks read back
    torch.cuda.current_stream(device).synchronize()
    j = picks.numpy()[:len(Fs)]
    if (j < 0).any():
        raise IndexError("a weighted pick fell on its bank's padding")
    return j.tolist()


def _prefilter(Fs: List[np.ndarray], device: torch.device
               ) -> List[np.ndarray]:
    """Rows of each set that a weighted pick may choose: the non-dominated
    ones, from one ``pareto_masks_fast`` call (one kernel launch) over the
    sets at or above the kernel threshold; every row of a smaller set, or
    of a set whose mask keeps nothing."""
    # Dominance prefiltering only pays when the set is large enough to hit
    # the kernel; below the threshold the weighted argmin alone is already
    # exact (a dominated row cannot win the weighted sum).
    thr = _pareto._KERNEL_MIN_N if _pareto._KERNEL_MIN_N is not None \
        else _pareto._default_kernel_min_n(device)
    big = [r for r, F in enumerate(Fs) if F.shape[0] >= thr]
    masks = dict(zip(big, pareto_masks_fast([Fs[r] for r in big],
                                            device=device)))
    kept = []
    for r, F in enumerate(Fs):
        keep = np.nonzero(masks[r])[0] if r in masks else np.zeros(0, int)
        kept.append(keep if keep.size else np.arange(F.shape[0]))
    return kept


def _pick(Fs: List[np.ndarray], kept: List[np.ndarray], w: np.ndarray,
          device: torch.device) -> List[int]:
    """Weighted-sum argmin over each set's kept rows, all rows min-max
    normalized over the full set, under one weight vector."""
    R = len(Fs)
    Fn_kept: List[np.ndarray] = []
    for F, keep in zip(Fs, kept):
        lo, hi = F.min(0), F.max(0)
        span = np.where(hi > lo, hi - lo, 1.0)
        Fn_kept.append((F[keep] - lo) / span)
    k = Fn_kept[0].shape[1]
    B = max(f.shape[0] for f in Fn_kept)
    Fb = np.full((R, B, k), 1e18)
    for r, f in enumerate(Fn_kept):
        Fb[r, :f.shape[0]] = f
    # Tie-tolerant routing (same contract as `pareto_mask_fast`): the
    # kernel computes the weighted argmin in f32, so batches whose
    # f64-distinct normalized scores collide as f32 take the f64 numpy
    # argmin regardless of volume.
    if R * B >= _hmooc._ws_min_scores(device) \
            and not _pareto._f32_tie_hazard(Fb.reshape(-1, k)):
        from ...kernels.ws_reduce import ws_reduce  # lazy: kernel layer
        _, idx = ws_reduce(torch.from_numpy(Fb).to(device),
                           torch.from_numpy(w[None, :]).to(device))  # (1, R)
        j = idx.cpu().numpy().astype(int)[0]
    else:
        j = np.argmin((Fb * w).sum(-1), axis=-1)
    return [int(kept[r][j[r]]) for r in range(R)]


class RuntimeOptimizerBackend:
    """Per-query runtime re-optimization state: pools, seeds, scoring."""

    def __init__(
        self,
        query: Query,
        theta_c_raw: np.ndarray,
        *,
        seed_theta_p: Optional[np.ndarray] = None,   # (m, 9) compile seeds
        seed_theta_s: Optional[np.ndarray] = None,   # (m, 2)
        model_subq: Optional[PerfModel] = None,
        model_qs: Optional[PerfModel] = None,
        weights: Tuple[float, float] = (0.9, 0.1),
        n_candidates: int = 64,
        cost: CostModel = DEFAULT_COST,
        seed: int = 0,
        pools: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        gamma_by_stage: Optional[np.ndarray] = None,
        device=None,
    ):
        """``gamma_by_stage`` is the (m, 4) per-stage contention vector fed
        to model-backed re-scoring.  ``None`` (the default) derives it with
        :func:`structural_gamma` when any model is attached — the paper's
        §4.3 γ features, no longer zeroed at runtime; pass an explicit
        ``np.zeros((m, 4))`` to restore the zeroed-γ behavior.  ``device``
        (``None`` = the CUDA card) is where this backend's picks run."""
        self.device = resolve_device(device)
        self.query = query
        self.cost = cost
        self.weights = weights
        self.model_subq = model_subq
        self.model_qs = model_qs
        if gamma_by_stage is None and (model_subq is not None
                                       or model_qs is not None):
            gamma_by_stage = structural_gamma(query)
        self.gamma_by_stage = gamma_by_stage
        self.seed_theta_p = seed_theta_p
        self.seed_theta_s = seed_theta_s
        self.cs, self.ps, self.ss = (theta_c_space(), theta_p_space(),
                                     theta_s_space())
        self.tc_row = np.asarray(theta_c_raw, np.float64).reshape(1, -1)
        self.tc_unit = self.cs.to_unit(self.tc_row)[0]
        self.rate = resource_rate(self.tc_row, cost)[0]
        # Candidate pools are fixed per query (one LHS draw), plus per-stage
        # compile-time seeds — the runtime MOO just rescores them on true
        # stats.  ``pools`` lets a serving session share the draw.
        if pools is None:
            pools = sample_candidate_pools(seed, n_candidates)
        self.pool_p, self.pool_s = pools

    # -- candidate sets ------------------------------------------------------
    def lqp_candidates(self, subq: SubQ, theta_p_cur: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """θp candidates for an L̄QP request (θs pinned to the stage seed)."""
        cands = [self.pool_p, theta_p_cur[None, :]]
        if self.seed_theta_p is not None:
            cands.append(self.seed_theta_p[subq.sq_id][None, :])
        tp = np.concatenate(cands, 0)
        ts = (self.seed_theta_s[subq.sq_id]
              if self.seed_theta_s is not None
              else self.ss.default_raw())[None, :]
        return tp, ts

    def qs_candidates(self, subq: SubQ, theta_s_cur: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """θs candidates for a QS request (θp pinned to the stage seed)."""
        cands = [self.pool_s, theta_s_cur[None, :]]
        if self.seed_theta_s is not None:
            cands.append(self.seed_theta_s[subq.sq_id][None, :])
        ts = np.concatenate(cands, 0)
        tp = (self.seed_theta_p[subq.sq_id]
              if self.seed_theta_p is not None
              else self.ps.default_raw())[None, :]
        return tp, ts

    def request_for(self, req) -> Tuple["ScoreRequest", np.ndarray]:
        """AQE request → (scoring request, the candidate rows it ranks).

        ``req`` is an :class:`~repro_torch.queryengine.aqe.LQPRequest` /
        ``QSRequest`` (duck-typed on ``kind``); the returned candidate rows
        are what the optimizer's response is drawn from.
        """
        if req.kind == "lqp":
            tp, ts = self.lqp_candidates(req.subq, req.theta_p)
            return ScoreRequest(self, req.subq, tp, ts, "lqp"), tp
        tp, ts = self.qs_candidates(req.subq, req.theta_s)
        return ScoreRequest(self, req.subq, tp, ts, "qs"), ts

    # -- scoring helpers -----------------------------------------------------
    def model_for(self, decision: str) -> Optional[PerfModel]:
        return self.model_subq if decision == "lqp" else self.model_qs

    def model_theta(self, rq: "ScoreRequest", n: int) -> np.ndarray:
        """Unit decision vector rows for the request's model family."""
        tcu = np.broadcast_to(self.tc_unit, (n, self.cs.dim))
        tsu = self.ss.to_unit(np.broadcast_to(rq.theta_s, (n, self.ss.dim)))
        if rq.decision == "lqp":
            tpu = self.ps.to_unit(
                np.broadcast_to(rq.theta_p, (n, self.ps.dim)))
            return np.concatenate([tcu, tpu, tsu], -1)
        # QS decision: θp is already fixed when a QS is optimized — the QS
        # model drops it (θc ⊕ θs).
        return np.concatenate([tcu, tsu], -1)

    def nondecision(self, subq: SubQ,
                    gamma: Optional[np.ndarray] = None) -> np.ndarray:
        """Runtime non-decision vector: α from *true* statistics, γ from
        the request (live contention) or the backend's per-stage default."""
        if gamma is None and self.gamma_by_stage is not None:
            gamma = self.gamma_by_stage[subq.sq_id]
        return make_nondecision(
            _alpha_stats(subq.input_rows, subq.input_bytes), gamma=gamma)

    def objectives(self, lat: np.ndarray, io: np.ndarray) -> np.ndarray:
        return np.stack(
            [lat * 1.0, lat * self.rate + io * self.cost.price_io_gb], -1)


@dataclasses.dataclass
class ScoreRequest:
    """One stage re-scoring request over a candidate θ set."""

    backend: RuntimeOptimizerBackend
    subq: SubQ
    theta_p: np.ndarray          # (np_rows, 9) raw; 1 row when pinned
    theta_s: np.ndarray          # (ns_rows, 2) raw; 1 row when pinned
    decision: str                # "lqp" | "qs"
    gamma: Optional[np.ndarray] = None   # (4,) live-contention override

    @property
    def n(self) -> int:
        return max(self.theta_p.shape[0], self.theta_s.shape[0])


def score_requests(reqs: Sequence[ScoreRequest]) -> List[np.ndarray]:
    """True-statistics objectives, (n, 2) per request, fused across requests.

    Requests group by backend mode — oracle requests by stage kind (and cost
    model), model requests by model — and each group resolves in ONE
    ``simulate_stage_rows`` / ``PerfModel.predict`` call over the stacked
    candidate rows of every member: the serving layer's cross-query fusion.
    A model group's GTN embeddings the memo lacks resolve first, in one
    :meth:`PerfModel.embed_round` dispatch a node width, of a batch width
    set by the device alone, so a stage's embedding does not depend on the
    round's other requests.  Model rows are not bucket-padded: PyTorch runs eagerly, so
    there is no compiled shape set to bound, and the rows are independent.
    """
    out: List[Optional[np.ndarray]] = [None] * len(reqs)
    groups: Dict[tuple, List[int]] = {}
    for i, rq in enumerate(reqs):
        groups.setdefault(fusion_key(rq), []).append(i)
    for key, members in groups.items():
        if key[0] == "oracle":
            _score_oracle_group(reqs, members, out)
        else:
            _score_model_group(reqs, members, key[1], out)
    return out  # type: ignore[return-value]


def _score_oracle_group(reqs: Sequence[ScoreRequest], members: List[int],
                        out: List[Optional[np.ndarray]]) -> None:
    ns = [reqs[i].n for i in members]
    base = stage_stats_batch([reqs[i].subq for i in members])
    stats = StageStats(**{
        f.name: np.repeat(getattr(base, f.name), ns)
        for f in dataclasses.fields(StageStats)})
    tc = np.concatenate([np.broadcast_to(reqs[i].backend.tc_row, (n, 8))
                         for i, n in zip(members, ns)])
    tp = np.concatenate([np.broadcast_to(reqs[i].theta_p, (n, 9))
                         for i, n in zip(members, ns)])
    ts = np.concatenate([np.broadcast_to(reqs[i].theta_s, (n, 2))
                         for i, n in zip(members, ns)])
    sim = simulate_stage_rows(
        reqs[members[0]].subq.kind, stats, tc, tp, ts,
        cost=reqs[members[0]].backend.cost, aqe=True)
    lo = 0
    for i, n in zip(members, ns):
        sl = slice(lo, lo + n)
        lo += n
        out[i] = reqs[i].backend.objectives(sim.ana_latency[sl],
                                            sim.io_gb[sl])


def _score_model_group(reqs: Sequence[ScoreRequest], members: List[int],
                       decision: str,
                       out: List[Optional[np.ndarray]]) -> None:
    """One model's requests: the group's embedding-memo misses in one
    :meth:`PerfModel.embed_round` (pairs the memo holds, such as the
    L̄QP stages the compile-time solve embedded, cost a lookup), then one
    :meth:`PerfModel.predict` over every member's candidate rows."""
    model = reqs[members[0]].backend.model_for(decision)
    model.embed_round([(reqs[i].backend.query, reqs[i].subq.sq_id)
                       for i in members])
    ns = [reqs[i].n for i in members]
    thetas, embs, nonds = [], [], []
    for i, n in zip(members, ns):
        rq = reqs[i]
        b = rq.backend
        emb = model.embed(b.query, rq.subq.sq_id)
        nond = b.nondecision(rq.subq, gamma=rq.gamma)
        thetas.append(b.model_theta(rq, n))
        embs.append(np.broadcast_to(emb, (n, emb.shape[0])))
        nonds.append(np.broadcast_to(nond, (n, nond.shape[0])))
    pred = model.predict(np.concatenate(embs),
                         np.concatenate(thetas).astype(np.float32),
                         np.concatenate(nonds))
    lo = 0
    for i, n in zip(members, ns):
        sl = slice(lo, lo + n)
        lo += n
        out[i] = reqs[i].backend.objectives(pred[sl, 0], pred[sl, 1])


def make_runtime_optimizers(
    query: Query,
    theta_c_raw: np.ndarray,
    *,
    seed_theta_p: Optional[np.ndarray] = None,   # (m, 9) compile-time seeds
    seed_theta_s: Optional[np.ndarray] = None,   # (m, 2)
    model_subq: Optional[PerfModel] = None,
    model_qs: Optional[PerfModel] = None,
    weights: Tuple[float, float] = (0.9, 0.1),
    n_candidates: int = 64,
    cost: CostModel = DEFAULT_COST,
    seed: int = 0,
    pools: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    gamma_by_stage: Optional[np.ndarray] = None,
    device=None,
):
    """Build (lqp_optimizer, qs_optimizer) callbacks for ``run_with_aqe``;
    ``device`` (``None`` = the CUDA card) is where their picks run."""
    b = RuntimeOptimizerBackend(
        query, theta_c_raw, seed_theta_p=seed_theta_p,
        seed_theta_s=seed_theta_s, model_subq=model_subq, model_qs=model_qs,
        weights=weights, n_candidates=n_candidates, cost=cost, seed=seed,
        pools=pools, gamma_by_stage=gamma_by_stage, device=device)

    def lqp_optimizer(*, query: Query, subq: SubQ, theta_c: np.ndarray,
                      theta_p: np.ndarray) -> Optional[np.ndarray]:
        """Re-tune θp for the collapsed plan exposing ``subq`` (a join)."""
        tp, ts = b.lqp_candidates(subq, theta_p)
        F = score_requests([ScoreRequest(b, subq, tp, ts, "lqp")])[0]
        return tp[weighted_pick_batch([F], b.weights, device=b.device)[0]]

    def qs_optimizer(*, query: Query, subq: SubQ, theta_c: np.ndarray,
                     theta_s: np.ndarray) -> Optional[np.ndarray]:
        """Re-tune θs for a newly created query stage."""
        tp, ts = b.qs_candidates(subq, theta_s)
        F = score_requests([ScoreRequest(b, subq, tp, ts, "qs")])[0]
        return ts[weighted_pick_batch([F], b.weights, device=b.device)[0]]

    return lqp_optimizer, qs_optimizer
