"""Hierarchical MOO with Constraints (paper §5.1, Algorithms 1–4).

Solves the compile-time fine-grained tuning problem

    argmin_{θc, {θp_i}, {θs_i}}  [ Σ_i φ_1(subQ_i, θc, θp_i, θs_i),
                                   Σ_i φ_2(subQ_i, θc, θp_i, θs_i) ]

by (1) *subQ tuning* — Algorithm 1's effective-set generation with θc
clustering, per-representative θp MOO over a shared sample pool, optimal-θp
assignment to cluster members, and crossover-based θc enrichment — and
(2) *DAG aggregation* — HMOOC1 (exact divide-and-conquer Minkowski merge),
HMOOC2 (weighted-sum over functions), HMOOC3 (boundary/extreme-point
approximation), exploiting that analytical latency and cost are sums over
subQs so the DAG reduces to a list.

The stage evaluator abstracts the objective model:

    stage_eval(i, Tc, Tps) -> (n, k) objective rows for subQ i,
        Tc: (n, d_c) unit-space θc, Tps: (n, d_p + d_s) unit-space θp⊕θs.

In production it wraps the trained subQ PerfModel; tests can plug the
analytic simulator or synthetic functions.

Hot paths are array-level: every stage_eval call covers a whole
representative set or candidate population at once (m calls per phase
instead of C·m), dominance masks route through the CUDA ``pareto_filter``
kernel on the card (``pareto_masks_fast``: the C·m banks of a phase, or
HMOOC2's per-candidate fronts, in one launch), and HMOOC2 routes its
per-weight bank argmin to the ``ws_reduce`` kernel and its whole
aggregation to the ``fused_solve`` kernel above a score-volume threshold.

Device placement is explicit: the public entry points take ``device``
(``None`` = the CUDA card, resolved per call) and carry it down to every
dominance filter.

The candidate-sampling half of Algorithm 1 (LHS, clustering, crossover) is
query-independent; :class:`EffectiveSet` captures it — together with the
per-representative optimal-θp banks — so a serving layer can reuse it across
repeated-template traffic (see ``repro_torch.serve``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ...device import resolve_device
from .clustering import kmeans_fit
from .pareto import (_f32_tie_hazard, _f32_tie_hazard_tensor,
                     pareto_mask_fast, pareto_mask_np, pareto_masks_fast)

__all__ = ["HMOOCConfig", "HMOOCResult", "EffectiveSet", "hmooc_solve",
           "HmoocPlan", "subq_tuning", "build_candidates", "dag_aggregate",
           "minkowski_merge_2d"]

StageEval = Callable[[int, np.ndarray, np.ndarray], np.ndarray]

# Score-matrix volume (N·m·B·nw) at or above which HMOOC2 uses the
# ws_reduce / fused_solve kernels.  None = resolve from the env var / device
# per call (tests monkeypatch this directly).
_WS_MIN_SCORES = None


def _ws_min_scores(device: torch.device) -> int:
    if _WS_MIN_SCORES is not None:
        return _WS_MIN_SCORES
    # Read per call, never cached (see pareto._default_kernel_min_n).  On
    # the card every nonempty score volume goes to the kernels until the
    # H100's own crossover is measured; on the host the float64 numpy route
    # stays the default (the CPU wrappers would only run the plain version).
    return int(os.environ.get(
        "REPRO_WS_KERNEL_MIN_SCORES",
        "0" if device.type == "cuda" else str(1 << 60)))


@dataclasses.dataclass(frozen=True)
class HMOOCConfig:
    n_c_init: int = 64          # initial θc candidates (LHS)
    n_clusters: int = 10        # θc clusters (Alg. 1 line 2)
    n_p_pool: int = 256         # shared θp⊕θs sample pool size
    n_c_enrich: int = 64        # crossover-generated θc candidates
    max_bank: int = 48          # per-(θc, subQ) Pareto bank cap
    dag_method: str = "hmooc3"  # "hmooc1" | "hmooc2" | "hmooc3"
    n_ws_weights: int = 11      # weight vectors for hmooc2
    seed: int = 0


@dataclasses.dataclass
class EffectiveSet:
    """Reusable Algorithm 1 artifacts.

    ``Uc``/``labels``/``reps``/``pool`` depend only on the parameter spaces
    and :class:`HMOOCConfig` (the rng never touches the query), so they are
    valid for *any* query.  ``opt_idx`` (per-representative per-subQ
    Pareto-optimal pool indices) is computed from one query's statistics;
    reusing it is exact for an identical query and a template-level
    approximation otherwise.
    """
    Uc: np.ndarray                                 # (N, d_c) θc candidates
    labels: np.ndarray                             # (N,) cluster ids
    reps: np.ndarray                               # (C, d_c) representatives
    pool: np.ndarray                               # (P, d_ps) θp⊕θs samples
    opt_idx: Optional[List[List[np.ndarray]]] = None   # [C][m] pool indices
    k_obj: int = 2

    def without_banks(self) -> "EffectiveSet":
        return dataclasses.replace(self, opt_idx=None)


@dataclasses.dataclass
class HMOOCResult:
    front: np.ndarray           # (q, k) query-level Pareto objective values
    theta_c: np.ndarray         # (q, d_c) unit
    theta_ps: np.ndarray        # (q, m, d_ps) unit per-subQ θp⊕θs
    solve_time: float
    n_evals: int
    extras: Dict[str, float]
    effective_set: Optional[EffectiveSet] = None


# ---------------------------------------------------------------------------
# Subquery tuning (Algorithm 1)
# ---------------------------------------------------------------------------

def _snap_unique(U: np.ndarray, snap) -> np.ndarray:
    Us = snap(U) if snap is not None else U
    return np.unique(np.round(Us, 9), axis=0)


def _crossover(Uc: np.ndarray, n_new: int, d: int,
               rng: np.random.Generator) -> np.ndarray:
    """θc crossover (App. C.1): random cut + Cartesian-product recombination."""
    if Uc.shape[0] < 2:
        return np.zeros((0, d))
    out = []
    for _ in range(4):  # a few cut positions
        cut = int(rng.integers(1, d))
        pre = np.unique(Uc[:, :cut], axis=0)
        suf = np.unique(Uc[:, cut:], axis=0)
        ii = rng.integers(0, pre.shape[0], size=n_new)
        jj = rng.integers(0, suf.shape[0], size=n_new)
        out.append(np.concatenate([pre[ii], suf[jj]], axis=1))
    cand = np.unique(np.concatenate(out, 0), axis=0)
    rng.shuffle(cand)
    return cand[:n_new]


def _cap_bank(F: np.ndarray, mask: np.ndarray, cap: int) -> np.ndarray:
    """Indices of the non-dominated rows of F (``mask``), capped with a
    spread."""
    idx = np.nonzero(mask)[0]
    if idx.size > cap:
        # Keep a spread: sort by first objective, take evenly spaced.
        order = idx[np.argsort(F[idx, 0])]
        keep = np.linspace(0, order.size - 1, cap).round().astype(int)
        idx = order[keep]
    return idx


def _lhs(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.random((n, d))) / n
    return u


def build_candidates(
    d_c: int,
    d_ps: int,
    cfg: HMOOCConfig,
    *,
    snap_c=None,
    snap_ps=None,
    rng: Optional[np.random.Generator] = None,
) -> EffectiveSet:
    """Query-independent half of Algorithm 1: θc candidates + θp⊕θs pool.

    Covers lines 1–2 plus the crossover enrichment of lines 5–6 (the rng
    stream is never consumed by stage evaluation, so sampling the enriched
    set up front is identical to interleaving it with the evaluations).
    """
    rng = rng or np.random.default_rng(cfg.seed)
    # Line 1: init_c (LHS over the unit cube, snapped to valid raw values).
    Uc0 = _lhs(rng, cfg.n_c_init, d_c)
    Uc0 = _snap_unique(Uc0, snap_c)
    # Line 2: cluster.
    km, labels0 = kmeans_fit(Uc0, cfg.n_clusters, rng)
    reps = km.centers
    if snap_c is not None:
        reps = snap_c(reps)
    # Shared θp⊕θs pool.
    pool = _lhs(rng, cfg.n_p_pool, d_ps)
    if snap_ps is not None:
        pool = snap_ps(pool)
    # Lines 5-6: enrich via crossover, assign to existing clusters.
    Uc1 = _crossover(Uc0, cfg.n_c_enrich, d_c, rng)
    if snap_c is not None and Uc1.size:
        Uc1 = _snap_unique(Uc1, snap_c)
    if Uc1.size:
        # Drop duplicates of the initial set.
        dup = (Uc1[:, None, :] == Uc0[None, :, :]).all(-1).any(1)
        Uc1 = Uc1[~dup]
    if Uc1.size:
        labels1 = km.assign(Uc1)
        Uc = np.concatenate([Uc0, Uc1], 0)
        labels = np.concatenate([labels0, labels1], 0)
    else:
        Uc, labels = Uc0, labels0
    return EffectiveSet(Uc=Uc, labels=labels, reps=reps, pool=pool)


def _rep_bank_requests(m: int, eset: EffectiveSet
                       ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """The stage-eval rows of the representative-MOO phase, per subQ."""
    reps, pool = eset.reps, eset.pool
    C, P = reps.shape[0], pool.shape[0]
    Tc = np.repeat(reps, P, axis=0)
    Tp = np.tile(pool, (C, 1))
    return [(i, Tc, Tp) for i in range(m)]


def _optimize_rep_banks(
    stage_eval: StageEval,
    m: int,
    eset: EffectiveSet,
    cfg: HMOOCConfig,
    device: torch.device,
) -> Tuple[List[List[np.ndarray]], int, int]:
    """Line 3: per-representative θp MOO, batched to one eval per subQ and
    one dominance-filter call (one kernel launch) for all C·m banks.

    Returns (opt_idx [C][m], k_obj, n_evals).
    """
    C, P = eset.reps.shape[0], eset.pool.shape[0]
    opt_idx: List[List[np.ndarray]] = [[] for _ in range(C)]
    k_obj = 2
    n_evals = 0
    banks: List[np.ndarray] = []                 # subQ-major: (i, r)
    for i, Tc, Tp in _rep_bank_requests(m, eset):
        F = stage_eval(i, Tc, Tp)
        n_evals += F.shape[0]
        k_obj = F.shape[1]
        banks.extend(F.reshape(C, P, k_obj))
    masks = pareto_masks_fast(banks, device=device)
    for b, (F, mask) in enumerate(zip(banks, masks)):
        opt_idx[b % C].append(_cap_bank(F, mask, cfg.max_bank))
    return opt_idx, k_obj, n_evals


def _assign_requests(m: int, eset: EffectiveSet, cfg: HMOOCConfig) -> List[
        Optional[Tuple[np.ndarray, np.ndarray,
                       List[Tuple[np.ndarray, np.ndarray]]]]]:
    """Per-subQ (θc rows, θp⊕θs rows, scatter chunks) of the assign phase.

    Entry i is None when subQ i has nothing to evaluate (no members or all
    banks empty).  Deterministic in ``eset``: rebuilding the requests for
    the same effective set yields the same rows, which is what lets a batch
    caller evaluate them externally and replay the results into
    :func:`_assign_banks`.
    """
    Uc, labels, pool = eset.Uc, eset.labels, eset.pool
    opt_idx = eset.opt_idx
    assert opt_idx is not None
    C = eset.reps.shape[0]
    B = cfg.max_bank
    members_by_rep = [np.nonzero(labels == r)[0] for r in range(C)]
    out = []
    for i in range(m):
        rows_c: List[np.ndarray] = []
        rows_p: List[np.ndarray] = []
        chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        for r in range(C):
            members = members_by_rep[r]
            sel = opt_idx[r][i] if i < len(opt_idx[r]) else np.zeros(0, int)
            if members.size == 0 or sel.size == 0:
                continue
            sel = sel[:min(sel.size, B)]
            rows_c.append(np.repeat(members, sel.size))
            rows_p.append(np.tile(sel, members.size))
            chunks.append((members, sel))
        if not chunks:
            out.append(None)
            continue
        out.append((Uc[np.concatenate(rows_c)],
                    pool[np.concatenate(rows_p)], chunks))
    return out


def _assign_banks(
    stage_eval: StageEval,
    m: int,
    eset: EffectiveSet,
    cfg: HMOOCConfig,
    k_obj: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Lines 4/7: evaluate members against their rep's optimal θp sets.

    One stage_eval per subQ covering every (member, bank slot) pair at once.
    """
    N, B = eset.Uc.shape[0], cfg.max_bank
    F_bank = np.full((N, m, B, k_obj), np.inf)
    idx_bank = np.full((N, m, B), -1, int)
    n_evals = 0
    for i, req in enumerate(_assign_requests(m, eset, cfg)):
        if req is None:
            continue
        Tc_rows, Tp_rows, chunks = req
        F = stage_eval(i, Tc_rows, Tp_rows)
        n_evals += F.shape[0]
        off = 0
        for members, sel in chunks:
            nb = sel.size
            cnt = members.size * nb
            F_bank[members, i, :nb] = \
                F[off:off + cnt].reshape(members.size, nb, k_obj)
            idx_bank[members, i, :nb] = sel
            off += cnt
    return F_bank, idx_bank, n_evals


def subq_tuning(
    stage_eval: StageEval,
    m: int,
    d_c: int,
    d_ps: int,
    cfg: HMOOCConfig,
    *,
    snap_c=None,
    snap_ps=None,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Effective-set generation (Algorithm 1).

    Returns (Uc, pool, F_bank, idx_bank, n_evals) where
      Uc: (N, d_c) θc candidates,
      pool: (P, d_ps) shared θp⊕θs samples,
      F_bank: (N, m, B, k) objective values (+inf padded),
      idx_bank: (N, m, B) pool indices (−1 padded).
    """
    device = resolve_device(device)
    eset = build_candidates(d_c, d_ps, cfg, snap_c=snap_c, snap_ps=snap_ps,
                            rng=rng)
    opt_idx, k_obj, n1 = _optimize_rep_banks(stage_eval, m, eset, cfg,
                                             device)
    eset.opt_idx, eset.k_obj = opt_idx, k_obj
    F_bank, idx_bank, n2 = _assign_banks(stage_eval, m, eset, cfg, k_obj)
    return eset.Uc, eset.pool, F_bank, idx_bank, n1 + n2


# ---------------------------------------------------------------------------
# DAG aggregation (paper §5.1.2, Appendix B)
# ---------------------------------------------------------------------------

def minkowski_merge_2d(F1: np.ndarray, S1: np.ndarray,
                       F2: np.ndarray, S2: np.ndarray,
                       device: torch.device
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Pf(Pf(F)⊕Pf(G)) — enumerate sums, keep non-dominated (Alg. 3).

    S1/S2 are (n, m) per-subQ pool-index selections (−1 = unset); merged
    entries take whichever side set each subQ.
    """
    n1, n2 = F1.shape[0], F2.shape[0]
    F = (F1[:, None, :] + F2[None, :, :]).reshape(n1 * n2, -1)
    mask = pareto_mask_fast(F, device=device)
    keep = np.nonzero(mask)[0]
    i1, i2 = keep // n2, keep % n2
    sel = np.where(S1[i1] >= 0, S1[i1], S2[i2])
    return F[keep], sel


def _hmooc1_fixed_c(Fb: np.ndarray, Ib: np.ndarray, device: torch.device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact divide-and-conquer aggregation under one θc (Alg. 2).

    Returns (front (q, k), sel (q, m)) with ``sel[:, i]`` the pool index
    chosen for subQ i.
    """
    m = Fb.shape[0]
    nodes = []
    for i in range(m):
        valid = np.isfinite(Fb[i]).all(-1)
        # Only local Pareto points can contribute (Prop. 5.1).
        valid &= pareto_mask_np(Fb[i], valid)
        idx = np.nonzero(valid)[0]
        if idx.size == 0:
            return np.zeros((0, Fb.shape[-1])), np.zeros((0, m), int)
        F = Fb[i][idx]
        sel = np.full((idx.size, m), -1, int)
        sel[:, i] = Ib[i][idx]
        nodes.append((F, sel))
    while len(nodes) > 1:
        nxt = []
        for a in range(0, len(nodes) - 1, 2):
            F, S = minkowski_merge_2d(nodes[a][0], nodes[a][1],
                                      nodes[a + 1][0], nodes[a + 1][1],
                                      device)
            nxt.append((F, S))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def _ws_pick(Fn: np.ndarray, W: np.ndarray, device: torch.device
             ) -> np.ndarray:
    """argmin_b  W[w] · Fn[c, i, b]  →  (nw, N, m) int.

    Routes through the ws_reduce kernel (float32 scores) at or above the
    score-volume threshold; otherwise a float64 numpy einsum that
    reproduces the reference arithmetic bit-for-bit.

    Routing is tie-tolerant, like ``pareto_mask_fast``: when any objective
    column of ``Fn`` holds values that are distinct in float64 but collide
    after the kernel's float32 cast, the weighted argmin itself could flip
    under the cast, so such inputs take the float64 einsum regardless of
    volume.  (Conservative input-level check — it catches the cast-
    collision class; sums that tie only after f32 accumulation remain the
    kernel regime's documented f32 semantics.)
    """
    N, m, B, k = Fn.shape
    nw = W.shape[0]
    if N * m * B * nw >= _ws_min_scores(device) \
            and not _f32_tie_hazard(Fn.reshape(-1, k)):
        from ...kernels.ws_reduce import ws_reduce  # lazy: kernel layer
        _, idx = ws_reduce(torch.from_numpy(
            np.ascontiguousarray(Fn.reshape(N * m, B, k))).to(device),
            torch.from_numpy(np.ascontiguousarray(W)).to(device))
        return idx.cpu().numpy().astype(int).reshape(nw, N, m)
    scores = np.einsum("wk,cibk->wcib", W, Fn)           # (nw, N, m, B)
    return np.argmin(scores, axis=-1)


def _ws_weights(n_weights: int) -> np.ndarray:
    ws = np.linspace(0.0, 1.0, n_weights)
    return np.stack([ws, 1.0 - ws], axis=1)              # (nw, 2)


def _hmooc2_normalize(F_bank: np.ndarray) -> np.ndarray:
    # Normalize per OBJECTIVE over each candidate's whole bank (one affine
    # transform shared by every subQ).  The paper's Alg. 4 normalizes per
    # subQ, but per-subQ scales give each subQ different effective weights
    # and void Lemma 1's guarantee that each WS pick is query-level Pareto
    # optimal (hypothesis-tested in tests/test_hmooc.py); a shared affine
    # transform commutes with the sum aggregator and preserves the proof.
    finite = np.isfinite(F_bank)
    lo = np.min(np.where(finite, F_bank, np.inf), axis=(1, 2), keepdims=True)
    hi = np.max(np.where(finite, F_bank, -np.inf), axis=(1, 2), keepdims=True)
    span = np.where(hi > lo, hi - lo, 1.0)
    with np.errstate(invalid="ignore"):
        Fn = (F_bank - lo) / span
    return np.where(finite, Fn, 1e18)


def _hmooc2_all(F_bank: np.ndarray, idx_bank: np.ndarray, n_weights: int,
                device: torch.device
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """WS-over-functions aggregation (Alg. 4), batched over θc candidates.

    Returns per-candidate (front (q, k), sel (q, m)) pairs.
    """
    N, m, B, k = F_bank.shape
    assert k == 2
    W = _ws_weights(n_weights)
    Fn = _hmooc2_normalize(F_bank)
    j = _ws_pick(Fn, W, device)                          # (nw, N, m)
    jj = np.transpose(j, (1, 0, 2))                      # (N, nw, m)
    cc = np.arange(N)[:, None, None]
    ii = np.arange(m)[None, None, :]
    G = F_bank[cc, ii, jj]                               # (N, nw, m, k)
    S = idx_bank[cc, ii, jj]                             # (N, nw, m)
    ok = np.isfinite(G).all(axis=(2, 3))                 # (N, nw)
    P_all = G.sum(axis=2)                                # (N, nw, k)
    rows = [np.nonzero(ok[c])[0] for c in range(N)]
    live = [c for c in range(N) if rows[c].size]
    masks = dict(zip(live, pareto_masks_fast(
        [P_all[c, rows[c]] for c in live], device=device)))
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for c in range(N):
        if c not in masks:
            out.append((np.zeros((0, k)), np.zeros((0, m), int)))
            continue
        keep = rows[c][masks[c]]
        out.append((P_all[c, keep], S[c, keep]))
    return out


def _hmooc2_fixed_c(Fb: np.ndarray, Ib: np.ndarray, n_weights: int,
                    device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """WS-over-functions aggregation under one θc (Alg. 4)."""
    return _hmooc2_all(Fb[None], Ib[None], n_weights, device)[0]


def _hmooc2_stage(F_bank: np.ndarray, W: np.ndarray, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """F_bank and W as float64 tensors on ``device``.  Bound for the card,
    both fill one pinned buffer (allocated per call, so no later call
    refills it while its copy is in flight) and cross in one non-blocking
    copy."""
    nb = F_bank.size
    buf = torch.empty(nb + W.size, dtype=torch.float64,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:nb].reshape(F_bank.shape)[...] = F_bank
    host[nb:].reshape(W.shape)[...] = W
    buf = buf.to(device, non_blocking=True)
    return buf[:nb].view(F_bank.shape), buf[nb:].view(W.shape)


def _host_arrays(*ts: torch.Tensor) -> List[np.ndarray]:
    """numpy copies of ``ts``; from the card, non-blocking copies into one
    pinned buffer and one synchronisation for all of them."""
    if ts[0].device.type != "cuda":
        return [t.numpy() for t in ts]
    sizes = [t.numel() * t.element_size() for t in ts]
    starts = np.cumsum([0] + [-(-n // 8) * 8 for n in sizes])
    buf = torch.empty(int(starts[-1]), dtype=torch.uint8, pin_memory=True)
    outs = [buf[a:a + n].view(t.dtype).view(t.shape)
            for t, a, n in zip(ts, starts, sizes)]
    for o, t in zip(outs, ts):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(ts[0].device).synchronize()
    return [o.numpy() for o in outs]


def _hmooc2_all_fused(Uc: np.ndarray, pool: np.ndarray, F_bank, idx_bank:
                      np.ndarray, W, device: torch.device
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel-regime HMOOC2: the whole aggregation in one fused launch.

    ``F_bank`` (N, m, B, k) and the (nw, k) weights ``W`` are numpy on the
    host or tensors already staged on the card.  The ``fused_solve``
    kernel normalises the bank and makes the weighted-sum picks, the
    objective-sum gather and the per-candidate dominance mask, and the
    ``pareto_filter`` kernel the final global filter, from one C call;
    the picks, sums and mask come back after one synchronisation.  Returns
    the already-globally-filtered (front, theta_c, theta_ps) in the same
    row order the per-candidate numpy route produces (candidate-major,
    weight ascending), with its same f32 score/compare semantics.
    """
    from ...kernels.fused_solve import fused_ws_front  # lazy: kernel layer
    _, m, _, k = F_bank.shape
    assert k == 2
    jj, P_all, keep = _host_arrays(*fused_ws_front(None, F_bank, W,
                                                   device=device))
    keep_c, keep_w = np.nonzero(keep)
    S = idx_bank[keep_c[:, None], np.arange(m)[None, :],
                 jj[keep_c, keep_w]]                     # (q, m)
    theta_ps = pool[np.maximum(S, 0)]                    # (q, m, d_ps)
    return P_all[keep_c, keep_w], Uc[keep_c], theta_ps


def _hmooc3_extremes(F_bank: np.ndarray, idx_bank: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Extreme points per θc (Prop. 5.2/5.3), fully vectorized.

    Returns (E, J): E (N, k, k) extreme objective vectors, J (N, k, m)
    per-subQ bank choices; E[c, v] is the query-level point minimizing
    objective v under θc candidate c.
    """
    N, m, B, k = F_bank.shape
    E = np.full((N, k, k), np.inf)
    J = np.full((N, k, m), -1, int)
    for v in range(k):
        j = np.argmin(np.where(np.isfinite(F_bank[..., v]),
                               F_bank[..., v], np.inf), axis=2)  # (N, m)
        gather = np.take_along_axis(
            F_bank, j[:, :, None, None].repeat(k, -1), axis=2)[:, :, 0, :]
        E[:, v, :] = gather.sum(1)
        J[:, v, :] = j
    return E, J


def dag_aggregate(
    Uc: np.ndarray,
    pool: np.ndarray,
    F_bank: np.ndarray,
    idx_bank: np.ndarray,
    method: str,
    *,
    n_ws_weights: int = 11,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover query-level Pareto solutions from per-subQ banks.

    Returns (front (q, k), theta_c (q, d_c), theta_ps (q, m, d_ps)).
    """
    device = resolve_device(device)
    N, m, B, k = F_bank.shape
    d_ps = pool.shape[1]

    if method == "hmooc3":
        E, J = _hmooc3_extremes(F_bank, idx_bank)
        pts = E.reshape(N * k, k)
        finite = np.isfinite(pts).all(-1)
        mask = pareto_mask_fast(pts, device=device) & finite
        keep = np.nonzero(mask)[0]
        front = pts[keep]
        theta_c = Uc[keep // k]
        c, v = keep // k, keep % k
        sel = np.take_along_axis(idx_bank[c], J[c, v][:, :, None],
                                 axis=2)[:, :, 0]          # (q, m)
        theta_ps = pool[np.maximum(sel, 0)]                # (q, m, d_ps)
        return front, theta_c, theta_ps

    fronts, tcs, sels = [], [], []
    if method == "hmooc2":
        # Tie-tolerant routing (same contract as `pareto_mask_fast`): the
        # fused kernel casts the bank to f32 for both the ws picks and the
        # global Pareto filter, so banks whose f64-distinct objective values
        # collide as f32 must take the per-candidate f64 numpy route even in
        # the kernel volume regime.  Input-level check on F_bank covers Fn
        # too (Fn is an affine renormalization of F_bank).
        # On the card the bank is staged first and checked there: one
        # flag comes back, then the route is taken.
        if N * m * B * n_ws_weights >= _ws_min_scores(device):
            W = _ws_weights(n_ws_weights)
            if device.type == "cuda":
                Fb, W = _hmooc2_stage(F_bank, W, device)
                hazard = bool(_f32_tie_hazard_tensor(Fb.view(-1, k)))
            else:
                Fb, hazard = F_bank, _f32_tie_hazard(F_bank.reshape(-1, k))
            if not hazard:
                return _hmooc2_all_fused(Uc, pool, Fb, idx_bank, W, device)
        per_c: Sequence[Tuple[np.ndarray, np.ndarray]] = \
            _hmooc2_all(F_bank, idx_bank, n_ws_weights, device)
    elif method == "hmooc1":
        per_c = [_hmooc1_fixed_c(F_bank[c], idx_bank[c], device)
                 for c in range(N)]
    else:
        raise ValueError(method)
    for c, (F, S) in enumerate(per_c):
        if F.shape[0]:
            fronts.append(F)
            tcs.append(np.tile(Uc[c], (F.shape[0], 1)))
            sels.append(S)
    if not fronts:
        z = np.zeros((0, k))
        return z, np.zeros((0, Uc.shape[1])), np.zeros((0, m, d_ps))
    F = np.concatenate(fronts, 0)
    TC = np.concatenate(tcs, 0)
    SEL = np.concatenate(sels, 0)
    mask = pareto_mask_fast(F, device=device)
    keep = np.nonzero(mask)[0]
    theta_ps = pool[np.maximum(SEL[keep], 0)]   # (q, m, d_ps)
    return F[keep], TC[keep], theta_ps


# ---------------------------------------------------------------------------
# Full solve
# ---------------------------------------------------------------------------

def hmooc_solve(
    stage_eval: StageEval,
    m: int,
    d_c: int,
    d_ps: int,
    cfg: HMOOCConfig = HMOOCConfig(),
    *,
    snap_c=None,
    snap_ps=None,
    effective_set: Optional[EffectiveSet] = None,
    device=None,
) -> HMOOCResult:
    """Compile-time fine-grained MOO (subQ tuning + DAG aggregation).

    ``effective_set`` reuses Algorithm 1 artifacts from a previous solve:
    the candidate samples are always safe to share (they are
    query-independent for a fixed config); if ``opt_idx`` banks are present
    they are reused too, which skips the per-representative MOO entirely —
    exact when the query is identical to the one they were computed on.
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    reused_banks = False
    if effective_set is None:
        rng = np.random.default_rng(cfg.seed)
        eset = build_candidates(d_c, d_ps, cfg, snap_c=snap_c,
                                snap_ps=snap_ps, rng=rng)
    else:
        eset = effective_set
    n_evals = 0
    if eset.opt_idx is not None and len(eset.opt_idx[0]) == m:
        k_obj = eset.k_obj
        reused_banks = True
    else:
        opt_idx, k_obj, n_evals = _optimize_rep_banks(stage_eval, m, eset,
                                                      cfg, device)
        eset = dataclasses.replace(eset, opt_idx=opt_idx, k_obj=k_obj)
    F_bank, idx_bank, n2 = _assign_banks(stage_eval, m, eset, cfg, k_obj)
    n_evals += n2
    front, theta_c, theta_ps = dag_aggregate(
        eset.Uc, eset.pool, F_bank, idx_bank, cfg.dag_method,
        n_ws_weights=cfg.n_ws_weights, device=device)
    dt = time.perf_counter() - t0
    return HMOOCResult(front=front, theta_c=theta_c, theta_ps=theta_ps,
                       solve_time=dt, n_evals=n_evals,
                       extras={"n_theta_c": float(eset.Uc.shape[0]),
                               "reused_banks": float(reused_banks)},
                       effective_set=eset)


class HmoocPlan:
    """Externally-driven :func:`hmooc_solve`: one query's solve as a
    two-phase state machine whose stage evaluations are surfaced as request
    lists instead of executed inline.

    A batch caller (``repro_torch.serve.service``) holds one plan per in-flight
    query, fuses every plan's pending requests into a single batched model
    dispatch per round, and feeds the results back — so a micro-batch of M
    queries costs two regressor calls total instead of 2·M·m.  The
    arithmetic is :func:`hmooc_solve`'s exactly: each phase replays the fed
    results through the same :func:`_optimize_rep_banks` /
    :func:`_assign_banks` the sequential solve calls (request row-building
    is deterministic in the effective set, so the replayed rows are the
    rows the results were computed on).

    Protocol: while ``not plan.done``, call ``requests()`` (a list of
    ``(i, Tc, Tps)`` stage requests), evaluate them externally, and pass
    the aligned objective arrays to ``feed()``.  ``banks_ready`` flips
    after the first phase, at which point ``eset`` carries the optimal-θp
    banks — the caller hands it to same-template plans to reuse, mirroring a
    sequential store→lookup between their solves.
    """

    def __init__(self, m: int, d_c: int, d_ps: int,
                 cfg: HMOOCConfig = HMOOCConfig(), *,
                 snap_c=None, snap_ps=None,
                 effective_set: Optional[EffectiveSet] = None,
                 device=None):
        self._t0 = time.perf_counter()
        self.m, self.cfg = m, cfg
        self.device = resolve_device(device)
        self.n_evals = 0
        self.reused_banks = False
        self.result: Optional[HMOOCResult] = None
        if effective_set is None:
            rng = np.random.default_rng(cfg.seed)
            self.eset = build_candidates(d_c, d_ps, cfg, snap_c=snap_c,
                                         snap_ps=snap_ps, rng=rng)
        else:
            self.eset = effective_set
        if self.eset.opt_idx is not None and len(self.eset.opt_idx[0]) == m:
            self.k_obj = self.eset.k_obj
            self.reused_banks = True
            self._phase = "assign"
        else:
            self.k_obj = 2
            self._phase = "banks"
        self._reqs: Optional[List[Tuple[int, np.ndarray, np.ndarray]]] = None

    @property
    def done(self) -> bool:
        return self._phase == "done"

    @property
    def banks_ready(self) -> bool:
        return self._phase in ("assign", "done")

    def requests(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        # Row-building is deterministic in (eset, cfg), so the per-phase
        # request list is memoized: the caller calls this once to collect
        # work and feed() consumes it again to align results.
        if self._reqs is not None:
            return self._reqs
        if self._phase == "banks":
            self._reqs = _rep_bank_requests(self.m, self.eset)
        elif self._phase == "assign":
            self._reqs = [(i, req[0], req[1]) for i, req in
                          enumerate(_assign_requests(self.m, self.eset,
                                                     self.cfg))
                          if req is not None]
        else:
            raise RuntimeError("plan is already done")
        return self._reqs

    def feed(self, results: Sequence[np.ndarray]) -> None:
        """Advance one phase with the objective arrays for ``requests()``."""
        fmap = {i: F for (i, _, _), F in zip(self.requests(), results)}

        def replay(i, Tc, Tps):
            return fmap[i]

        if self._phase == "banks":
            opt_idx, k_obj, n1 = _optimize_rep_banks(replay, self.m,
                                                     self.eset, self.cfg,
                                                     self.device)
            self.eset = dataclasses.replace(self.eset, opt_idx=opt_idx,
                                            k_obj=k_obj)
            self.k_obj = k_obj
            self.n_evals += n1
            self._phase = "assign"
            self._reqs = None
            return
        F_bank, idx_bank, n2 = _assign_banks(replay, self.m, self.eset,
                                             self.cfg, self.k_obj)
        self.n_evals += n2
        front, theta_c, theta_ps = dag_aggregate(
            self.eset.Uc, self.eset.pool, F_bank, idx_bank,
            self.cfg.dag_method, n_ws_weights=self.cfg.n_ws_weights,
            device=self.device)
        self.result = HMOOCResult(
            front=front, theta_c=theta_c, theta_ps=theta_ps,
            solve_time=time.perf_counter() - self._t0, n_evals=self.n_evals,
            extras={"n_theta_c": float(self.eset.Uc.shape[0]),
                    "reused_banks": float(self.reused_banks)},
            effective_set=self.eset)
        self._phase = "done"
        self._reqs = None
