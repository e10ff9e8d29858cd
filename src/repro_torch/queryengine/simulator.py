"""Analytical Spark-cluster simulator: the reproduction's ground truth.

Maps (query, θc, {θp}, {θs}) → per-stage and end-to-end latency / IO / cost,
vectorized over a batch of configurations (numpy, config axis first).  It
encodes the mechanisms the paper's tuning problem lives on:

* **Mixed control.**  θc fixes the cluster (cores = k1·k3, memory = k2·k3,
  shuffle behaviors k5–k8) for the whole query; θp decides join algorithms
  and partition counts per collapsed plan; θs rebalances partitions per stage.
* **Correlation.**  The optimal shuffle-partition count (s5) and advisory
  partition size (s1) shift with total cores (k1·k3) — paper Fig. 3(c) —
  because task overhead, wave quantization, and per-task memory all couple
  them.
* **Cardinality-estimation risk.**  Join algorithms planned from CBO
  estimates can broadcast a relation that is *actually* huge (paper
  Fig. 3(b)); AQE may upgrade SMJ→SHJ→BHJ at runtime from true statistics
  but can never downgrade a planned broadcast.
* **Resource sharing.**  Stages at the same DAG depth share executors; the
  *analytical* latency (Σ task-seconds / total cores) stays stable under
  sharing while wall-clock latency varies — why the paper models analytical
  latency (§4.2, Fig. 5).

Units: bytes for sizes, seconds for time, GB for IO accounting; θ arrays are
**raw** values as produced by ``repro_torch.core.tuning.spark_space``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .plan import Query, SubQ

__all__ = ["CostModel", "SubQSim", "QuerySim", "StageStats", "stage_stats",
           "stage_stats_batch",
           "simulate_stage_rows", "simulate_query", "assemble_query_sim",
           "join_decision_stats",
           "JOIN_SMJ", "JOIN_SHJ", "JOIN_BHJ", "default_theta"]

MB = 1e6
GB = 1e9

# Join algorithm codes (ordered by AQE convertibility: can only move up).
JOIN_SMJ, JOIN_SHJ, JOIN_BHJ = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibration constants (seconds per GB on one core unless noted)."""

    c_scan: float = 1.1          # read + decode + filter/project
    c_hash_build: float = 1.4    # hash-table build
    c_hash_probe: float = 0.55   # hash probe
    c_sort: float = 0.22         # per GB per log2(rows/part) factor
    c_merge: float = 0.45        # merge-join pass
    c_agg: float = 0.9           # aggregation
    c_shuffle_write: float = 0.55
    c_shuffle_read: float = 0.45
    c_net_broadcast: float = 0.30   # per GB per receiving executor
    compress_ratio: float = 0.45    # shuffle bytes kept when k7 on
    compress_cpu: float = 0.35      # extra CPU fraction when k7 on
    task_overhead: float = 0.09     # seconds per task (schedule+launch)
    spill_penalty: float = 1.8      # extra passes when data > task memory
    oom_penalty: float = 6.0        # broadcast build exceeding executor heap
    fetch_wait_c: float = 14.0      # maxSizeInFlight (MB) diminishing factor
    # Cloud pricing (per hour, arbitrary $ units; IO per GB).  Resource-hours
    # dominate so that latency (buy more cores) trades against cost (pay for
    # more core-hours: core-hours = work + overhead·cores grows with cores).
    price_core_h: float = 0.30
    price_mem_gb_h: float = 0.012
    price_io_gb: float = 0.0005


DEFAULT_COST = CostModel()


@dataclasses.dataclass
class SubQSim:
    """Vectorized per-stage outcome; every field has shape (n_configs,)."""

    ana_latency: np.ndarray      # task-seconds / total cores
    wall_latency: np.ndarray     # wave-quantized stage wall-clock (isolated)
    task_seconds: np.ndarray
    io_gb: np.ndarray
    n_tasks: np.ndarray
    join_algo: np.ndarray        # -1 for non-join stages
    shuffle_gb: np.ndarray
    beta: np.ndarray             # (n, 3) partition-size distribution metrics


@dataclasses.dataclass
class QuerySim:
    """Vectorized end-to-end outcome."""

    ana_latency: np.ndarray      # (n,) sum over stages
    actual_latency: np.ndarray   # (n,) wall clock under shared execution
    io_gb: np.ndarray            # (n,)
    cost: np.ndarray             # (n,) cloud cost $
    per_subq: List[SubQSim]      # stage-level detail, query subQ order
    planned_join: np.ndarray     # (n, m) planned algos (-1 non-join)


def _as2d(theta: np.ndarray, d: int) -> np.ndarray:
    theta = np.asarray(theta, np.float64)
    if theta.ndim == 1:
        theta = theta[None, :]
    assert theta.shape[-1] == d, f"expected {d} params, got {theta.shape}"
    return theta


def _beta_metrics(mean_part: np.ndarray, skew: np.ndarray) -> np.ndarray:
    """Partition-size distribution metrics (σ/μ, (max-μ)/μ, (max-min)/μ)."""
    skew = np.broadcast_to(np.asarray(skew, np.float64), mean_part.shape)
    return np.stack([skew * 1.2, skew * 4.0 + 0.05, skew * 5.0 + 0.1], -1)


def decide_join(build_bytes: np.ndarray, probe_rows: np.ndarray,
                theta_p: np.ndarray, n_parts: np.ndarray) -> np.ndarray:
    """Join-algorithm selection from statistics + θp thresholds.

    BHJ if build ≤ s4 (autoBroadcastJoinThreshold, MB) and the non-empty
    partition ratio gate (s2) passes; else SHJ if per-partition build map
    ≤ s3 (maxShuffledHashJoinLocalMapThreshold); else SMJ.
    """
    s2 = theta_p[:, 1]
    s3 = theta_p[:, 2] * MB
    s4 = theta_p[:, 3] * MB
    nonempty_ratio = np.clip(probe_rows / np.maximum(n_parts, 1.0), 0, 1)
    nonempty_ratio = np.where(probe_rows >= n_parts, 1.0, nonempty_ratio)
    bhj = (build_bytes <= s4) & (nonempty_ratio >= np.minimum(s2, 0.99))
    shj = build_bytes / np.maximum(n_parts, 1.0) <= s3
    return np.where(bhj, JOIN_BHJ, np.where(shj, JOIN_SHJ, JOIN_SMJ))


def _post_shuffle_parts(shuffle_bytes: np.ndarray, theta_p: np.ndarray,
                        theta_s: np.ndarray,
                        aqe: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Partition count after exchange (+ θs coalesce/rebalance at runtime).

    Returns (n_parts, small_part_overhead_factor).
    """
    s5 = np.maximum(theta_p[:, 4], 1.0)             # shuffle.partitions
    if not aqe:
        return s5, np.ones_like(s5)
    s1 = np.maximum(theta_p[:, 0], 1.0) * MB        # advisory partition size
    s11 = np.maximum(theta_s[:, 1], 0.25) * MB      # min partition size
    target = np.clip(np.ceil(shuffle_bytes / s1), 1.0, s5)
    # Coalescing can't create partitions smaller than s11: cap count.
    cap = np.maximum(np.floor(shuffle_bytes / s11), 1.0)
    parts = np.minimum(target, cap)
    # Rebalance small partitions: factor s10 merges the tail of tiny
    # partitions, trimming per-task overhead on skewed stages.
    s10 = np.clip(theta_s[:, 0], 0.05, 0.95)
    overhead_factor = 1.0 - 0.35 * (1.0 - s10)
    return parts, overhead_factor


@dataclasses.dataclass
class StageStats:
    """Per-row stage statistics for the batched core; every field is (n,).

    A stage's statistics are scalars; lifting them to per-row arrays lets
    same-kind stages from *different* queries share one
    :func:`simulate_stage_rows` call (the serving layer's cross-query
    fusion) while staying bit-identical to the per-stage path — both run
    the same elementwise arithmetic.
    """

    in_bytes0: np.ndarray        # first (or only) input, bytes
    in_bytes1: np.ndarray        # second input (joins); 0 otherwise
    in_rows0: np.ndarray
    in_rows1: np.ndarray
    in_bytes_sum: np.ndarray     # Σ inputs, bytes (skew gate)
    out_bytes: np.ndarray
    cpu_weight: np.ndarray
    skew: np.ndarray


def stage_stats(sq: SubQ, n: int, *, use_est_inputs: bool = False
                ) -> StageStats:
    """Lift one subQ's scalar statistics to ``n`` rows."""
    inp = sq.est_input_bytes if use_est_inputs else sq.input_bytes
    inr = sq.est_input_rows if use_est_inputs else sq.input_rows
    out_bytes = sq.est_out_bytes if use_est_inputs else sq.out_bytes
    full = lambda v: np.full(n, float(v))
    return StageStats(
        in_bytes0=full(inp[0]),
        in_bytes1=full(inp[1] if len(inp) > 1 else 0.0),
        in_rows0=full(inr[0]),
        in_rows1=full(inr[1] if len(inr) > 1 else 0.0),
        in_bytes_sum=full(sum(inp)),
        out_bytes=full(out_bytes),
        cpu_weight=full(sq.cpu_weight),
        skew=full(sq.skew),
    )


def stage_stats_batch(subqs: Sequence[SubQ], *, use_est_inputs: bool = False
                      ) -> StageStats:
    """One statistics row per subQ (n = len(subqs)), built in a single pass.

    The subQs may come from different queries; only the caller's grouping
    by ``kind`` matters for :func:`simulate_stage_rows`.
    """
    rows = []
    for sq in subqs:
        inp = sq.est_input_bytes if use_est_inputs else sq.input_bytes
        inr = sq.est_input_rows if use_est_inputs else sq.input_rows
        ob = sq.est_out_bytes if use_est_inputs else sq.out_bytes
        rows.append((inp[0], inp[1] if len(inp) > 1 else 0.0,
                     inr[0], inr[1] if len(inr) > 1 else 0.0,
                     sum(inp), ob, sq.cpu_weight, sq.skew))
    a = np.asarray(rows, np.float64).reshape(len(rows), 8)
    return StageStats(*(a[:, i] for i in range(8)))


def simulate_stage_rows(
    kind: str,
    st: StageStats,
    theta_c: np.ndarray,
    theta_p: np.ndarray,
    theta_s: np.ndarray,
    *,
    cost: CostModel = DEFAULT_COST,
    aqe: bool = True,
    join_algo: Optional[np.ndarray] = None,
) -> SubQSim:
    """Row-batched stage core: row i is an independent (stats, θ) sample.

    All stages in one call share ``kind`` (the fusion group key); statistics
    and θ vary per row, so stacked candidate sets from many queries resolve
    in a single pass.
    """
    n = st.in_bytes0.shape[0]
    theta_c = np.broadcast_to(_as2d(theta_c, 8), (n, 8))
    theta_p = np.broadcast_to(_as2d(theta_p, 9), (n, 9))
    theta_s = np.broadcast_to(_as2d(theta_s, 2), (n, 2))

    k1 = np.maximum(theta_c[:, 0], 1.0)              # cores/executor
    k2 = np.maximum(theta_c[:, 1], 0.5) * GB         # heap/executor
    k3 = np.maximum(theta_c[:, 2], 1.0)              # executors
    k4 = np.maximum(theta_c[:, 3], 1.0)              # default parallelism
    k5 = np.maximum(theta_c[:, 4], 1.0)              # maxSizeInFlight MB
    k6 = theta_c[:, 5]                               # bypassMergeThreshold
    k7 = theta_c[:, 6] >= 0.5                        # shuffle compress
    k8 = np.clip(theta_c[:, 7], 0.05, 0.95)          # memory fraction
    cores = k1 * k3
    task_mem = k2 * k8 / k1

    out_bytes = st.out_bytes
    cw = st.cpu_weight

    compress_ratio = np.where(k7, cost.compress_ratio, 1.0)
    compress_cpu = np.where(k7, 1.0 + cost.compress_cpu, 1.0)
    # Shuffle fetch efficiency: small in-flight buffers stall the reader.
    fetch_eff = 1.0 + cost.fetch_wait_c / (cost.fetch_wait_c + k5)

    io_gb = np.zeros(n)
    cpu_sec = np.zeros(n)
    shuffle_gb = np.zeros(n)
    algo_out = np.full(n, -1.0)

    if kind == "scan":
        B = st.in_bytes0
        s8 = np.maximum(theta_p[:, 7], 1.0) * MB     # maxPartitionBytes
        s9 = np.maximum(theta_p[:, 8], 0.25) * MB    # openCostInBytes
        n_files = np.maximum(B / (128 * MB), 1.0)
        eff_bytes = B + n_files * s9
        parts = np.maximum(np.ceil(eff_bytes / s8), 1.0)
        parts = np.maximum(parts, np.minimum(k4, 4 * cores))  # parallelism floor
        per_task = B / parts
        spill = np.where(per_task > task_mem,
                         1.0 + cost.spill_penalty *
                         np.clip(per_task / np.maximum(task_mem, 1.0) - 1, 0, 4),
                         1.0)
        cpu_sec = (B / GB) * cost.c_scan * cw * spill
        io_gb = B / GB
        # Stage output feeds an exchange: shuffle write.
        w_bytes = out_bytes * compress_ratio
        cpu_sec += (out_bytes / GB) * cost.c_shuffle_write * compress_cpu
        # Sort-based shuffle merge unless partition count under bypass thresh.
        s5 = np.maximum(theta_p[:, 4], 1.0)
        merge_f = np.where(s5 <= k6, 0.85, 1.0)
        cpu_sec *= merge_f
        io_gb += w_bytes / GB
        shuffle_gb = w_bytes / GB
        small_f = np.ones(n)

    elif kind == "join":
        bl, br = st.in_bytes0, st.in_bytes1
        rl, rr = st.in_rows0, st.in_rows1
        left_small = bl <= br
        build_b = np.where(left_small, bl, br)
        probe_b = np.where(left_small, br, bl)
        probe_r = np.where(left_small, rr, rl)
        shuffle_in = (bl + br) * compress_ratio
        parts, small_f = _post_shuffle_parts(shuffle_in, theta_p, theta_s,
                                             aqe)
        if join_algo is None:
            algo = decide_join(build_b, probe_r, theta_p, parts)
        else:
            algo = np.broadcast_to(np.asarray(join_algo), (n,))
        algo_out = algo.astype(np.float64)

        # ---- broadcast hash join: ship build to every executor ----------
        bhj_net = (build_b / GB) * cost.c_net_broadcast * k3
        bhj_build = (build_b / GB) * cost.c_hash_build * k3
        bhj_probe = (probe_b / GB) * cost.c_hash_probe
        bhj_oom = np.where(build_b > k2 * k8,
                           cost.oom_penalty * (build_b / GB), 0.0)
        bhj_cpu = bhj_net + bhj_build + bhj_probe + bhj_oom
        bhj_io = build_b * k3 / GB
        bhj_shuffle = np.zeros(n)
        bhj_parts = np.maximum(np.ceil(probe_b / (128 * MB)), 1.0)

        # ---- shuffled hash join ------------------------------------------
        per_part_build = build_b / np.maximum(parts, 1.0)
        shj_spill = np.where(per_part_build > task_mem,
                             1.0 + cost.spill_penalty, 1.0)
        shj_cpu = ((bl + br) / GB) * (cost.c_shuffle_write * compress_cpu
                                      + cost.c_shuffle_read * fetch_eff) \
            + (build_b / GB) * cost.c_hash_build * shj_spill \
            + (probe_b / GB) * cost.c_hash_probe
        shj_io = 2 * shuffle_in / GB
        shj_shuffle = shuffle_in / GB

        # ---- sort-merge join ---------------------------------------------
        rows_per_part = (rl + rr) / np.maximum(parts, 1.0)
        logf = np.log2(np.maximum(rows_per_part, 2.0))
        smj_cpu = ((bl + br) / GB) * (cost.c_shuffle_write * compress_cpu
                                      + cost.c_shuffle_read * fetch_eff
                                      + cost.c_sort * logf / 8.0
                                      + cost.c_merge)
        smj_io = 2 * shuffle_in / GB
        smj_shuffle = shuffle_in / GB

        cpu_sec = np.select([algo == JOIN_BHJ, algo == JOIN_SHJ],
                            [bhj_cpu, shj_cpu], smj_cpu)
        io_gb = np.select([algo == JOIN_BHJ, algo == JOIN_SHJ],
                          [bhj_io, shj_io], smj_io)
        shuffle_gb = np.select([algo == JOIN_BHJ, algo == JOIN_SHJ],
                               [bhj_shuffle, shj_shuffle], smj_shuffle)
        parts = np.where(algo == JOIN_BHJ, bhj_parts, parts)
        # Join work + output write; the stage CPU weight applies exactly
        # once to each term.
        cpu_sec = cpu_sec * cw + (out_bytes / GB) * 0.25 * cw

    else:  # agg (and sort)
        B = st.in_bytes0
        shuffle_in = B * compress_ratio
        parts, small_f = _post_shuffle_parts(shuffle_in, theta_p, theta_s,
                                             aqe)
        per_part = B / np.maximum(parts, 1.0)
        spill = np.where(per_part > task_mem, 1.0 + cost.spill_penalty, 1.0)
        cpu_sec = (B / GB) * (cost.c_shuffle_write * compress_cpu
                              + cost.c_shuffle_read * fetch_eff
                              + cost.c_agg * spill) * cw
        io_gb = 2 * shuffle_in / GB
        shuffle_gb = shuffle_in / GB

    # ---- skew: AQE skew-split (s6 threshold, s7 factor) mitigates the tail.
    skew = st.skew
    if aqe and kind != "scan":
        s6 = theta_p[:, 5] * MB
        s7 = np.maximum(theta_p[:, 6], 2.0)
        # Mean partition size from the *post-coalesce* partition count, so
        # s1/s11 coalescing feeds the skew-split decision.
        mean_part_b = st.in_bytes_sum / np.maximum(parts, 1.0)
        split = (skew * 5.0 * mean_part_b > s6)
        skew_eff = np.where(split, skew / s7, skew)
    else:
        skew_eff = skew

    # ---- assemble stage timing ------------------------------------------
    parts = np.maximum(parts, 1.0)
    overhead = cost.task_overhead * parts * small_f
    task_seconds = cpu_sec + overhead
    ana_latency = task_seconds / cores
    mean_task = task_seconds / parts
    waves = np.ceil(parts / cores)
    wall = waves * mean_task * (1.0 + 2.5 * skew_eff)
    wall = np.maximum(wall, ana_latency)

    return SubQSim(
        ana_latency=ana_latency,
        wall_latency=wall,
        task_seconds=task_seconds,
        io_gb=io_gb,
        n_tasks=parts,
        join_algo=algo_out,
        shuffle_gb=shuffle_gb,
        beta=_beta_metrics(task_seconds / parts, skew),
    )


def simulate_subq(
    sq: SubQ,
    theta_c: np.ndarray,
    theta_p: np.ndarray,
    theta_s: np.ndarray,
    *,
    cost: CostModel = DEFAULT_COST,
    aqe: bool = True,
    join_algo: Optional[np.ndarray] = None,
    use_est_inputs: bool = False,
) -> SubQSim:
    """Simulate one stage for a batch of configurations.

    ``join_algo`` overrides the algorithm (the *planned* decision realized on
    true bytes); ``use_est_inputs`` sizes work from CBO estimates (used by
    compile-time "what the optimizer believes" evaluations, never for ground
    truth).
    """
    theta_c = _as2d(theta_c, 8)
    theta_p = _as2d(theta_p, 9)
    theta_s = _as2d(theta_s, 2)
    n = max(theta_c.shape[0], theta_p.shape[0], theta_s.shape[0])
    return simulate_stage_rows(
        sq.kind, stage_stats(sq, n, use_est_inputs=use_est_inputs),
        theta_c, theta_p, theta_s, cost=cost, aqe=aqe, join_algo=join_algo)


def plan_joins(query: Query, theta_p_sub: np.ndarray,
               *, from_estimates: bool) -> np.ndarray:
    """Planned join algorithm per subQ (−1 for non-joins), (n, m).

    ``theta_p_sub`` is (n, m, 9): the θp copy in effect for each subQ's
    planning decision.  ``from_estimates`` selects CBO stats (submission
    time) vs true stats (AQE re-planning).  All joins resolve in one
    :func:`decide_join` call over the flattened (config, join) rows.
    """
    n, m = theta_p_sub.shape[0], query.n_subqs
    out = np.full((n, m), -1.0)
    joins = [sq for sq in query.subqs if sq.kind == "join"]
    if not joins:
        return out
    ids = [sq.sq_id for sq in joins]
    build, probe = join_decision_stats(joins, from_estimates=from_estimates)
    tp = np.asarray(theta_p_sub[:, ids, :], np.float64).reshape(-1, 9)
    parts = np.maximum(tp[:, 4], 1.0)
    algo = decide_join(np.tile(build, n), np.tile(probe, n), tp, parts)
    out[:, ids] = algo.reshape(n, len(joins))
    return out


def join_decision_stats(subqs: Sequence[SubQ], *, from_estimates: bool
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(build_bytes, probe_rows) rows for :func:`decide_join`, one per join.

    Build side is the smaller input; probe rows come from the other side
    (ties go left-as-build).  Shared by :func:`plan_joins` and the serving
    layer's fused realization so the tie-breaking can never diverge.
    """
    build = np.empty(len(subqs))
    probe = np.empty(len(subqs))
    for j, sq in enumerate(subqs):
        inp = sq.est_input_bytes if from_estimates else sq.input_bytes
        inr = sq.est_input_rows if from_estimates else sq.input_rows
        bl, br = float(inp[0]), float(inp[1])
        build[j] = min(bl, br)
        probe[j] = float(inr[1] if bl <= br else inr[0])
    return build, probe


def upgrade_joins(planned: np.ndarray, runtime_choice: np.ndarray) -> np.ndarray:
    """AQE convertibility: SMJ→{SHJ,BHJ}, SHJ→BHJ, BHJ fixed (paper §5.2)."""
    return np.where(planned < 0, planned, np.maximum(planned, runtime_choice))


def simulate_query(
    query: Query,
    theta_c: np.ndarray,
    theta_p_sub: np.ndarray,
    theta_s_sub: np.ndarray,
    *,
    cost: CostModel = DEFAULT_COST,
    aqe: bool = True,
    runtime_reopt: bool = False,
    planned_join: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> QuerySim:
    """End-to-end execution for a batch of configurations.

    Args:
      theta_c: (n, 8) raw context parameters.
      theta_p_sub: (n, m, 9) or (n, 9) raw plan parameters per subQ (a
        query-level copy broadcasts).
      theta_s_sub: (n, m, 2) or (n, 2) raw stage parameters per subQ.
      aqe: adaptive execution on (partition coalescing + join upgrades).
      runtime_reopt: join re-planning sees *true* statistics (AQE); when
        False, the submission-time decision from CBO estimates is realized.
      planned_join: optionally force the submission-time decisions (n, m).
    """
    theta_c = _as2d(theta_c, 8)
    n = theta_c.shape[0]
    m = query.n_subqs
    if theta_p_sub.ndim == 2:
        theta_p_sub = np.broadcast_to(theta_p_sub[:, None, :], (n, m, 9))
    if theta_s_sub.ndim == 2:
        theta_s_sub = np.broadcast_to(theta_s_sub[:, None, :], (n, m, 2))
    theta_p_sub = np.asarray(theta_p_sub, np.float64)
    theta_s_sub = np.asarray(theta_s_sub, np.float64)

    if planned_join is None:
        planned_join = plan_joins(query, theta_p_sub, from_estimates=True)
    if aqe:
        runtime_stats = runtime_reopt
        runtime_choice = plan_joins(query, theta_p_sub,
                                    from_estimates=not runtime_stats)
        final_join = upgrade_joins(planned_join, runtime_choice)
    else:
        final_join = planned_join

    per: List[SubQSim] = []
    for sq in query.subqs:
        algo = final_join[:, sq.sq_id] if sq.kind == "join" else None
        per.append(simulate_subq(
            sq, theta_c, theta_p_sub[:, sq.sq_id, :],
            theta_s_sub[:, sq.sq_id, :], cost=cost, aqe=aqe, join_algo=algo))

    return assemble_query_sim(query, theta_c, per, planned_join,
                              cost=cost, rng=rng)


def assemble_query_sim(
    query: Query,
    theta_c: np.ndarray,
    per: List[SubQSim],
    planned_join: np.ndarray,
    *,
    cost: CostModel = DEFAULT_COST,
    rng: Optional[np.random.Generator] = None,
) -> QuerySim:
    """Fold per-stage outcomes into the end-to-end :class:`QuerySim`.

    Shared by :func:`simulate_query` and the serving layer's fused
    realization path (which computes ``per`` from cross-query stacked
    stage calls).
    """
    n = theta_c.shape[0]
    ana = np.sum([p.ana_latency for p in per], axis=0)
    io = np.sum([p.io_gb for p in per], axis=0)

    # Wall clock with resource sharing: stages grouped by DAG depth run
    # concurrently on shared cores; each depth-group takes
    # max(work-conserving time, longest skew-tail stage).
    depths = query.subq_depths()
    actual = np.zeros(n)
    for d in sorted(set(depths)):
        grp = [i for i, dd in enumerate(depths) if dd == d]
        work = np.sum([per[i].task_seconds for i in grp], axis=0)
        k1 = np.maximum(theta_c[:, 0], 1.0)
        k3 = np.maximum(theta_c[:, 2], 1.0)
        cores = k1 * k3
        tail = np.max([per[i].wall_latency for i in grp], axis=0)
        actual += np.maximum(work / cores, tail)
    if rng is not None:
        actual = actual * np.exp(rng.normal(0.0, 0.03, size=n))

    k1, k2, k3 = theta_c[:, 0], theta_c[:, 1], theta_c[:, 2]
    dollars = (actual / 3600.0) * (k1 * k3 * cost.price_core_h
                                   + k2 * k3 * cost.price_mem_gb_h) \
        + io * cost.price_io_gb
    return QuerySim(ana_latency=ana, actual_latency=actual, io_gb=io,
                    cost=dollars, per_subq=per, planned_join=planned_join)


def default_theta(n: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spark-default (θc, θp, θs) raw rows, tiled to n."""
    from ..core.tuning.spark_space import theta_c_space, theta_p_space, theta_s_space
    tc = np.tile(theta_c_space().default_raw(), (n, 1))
    tp = np.tile(theta_p_space().default_raw(), (n, 1))
    ts = np.tile(theta_s_space().default_raw(), (n, 1))
    return tc, tp, ts
