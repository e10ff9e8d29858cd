"""HMOOC-driven cluster autotuning (the paper's optimizer, re-targeted).

Compile-time: solve the (θc, {θp}, {θs}) MOO over [step latency, $ cost]
with HMOOC3 — θc (chips, TP split, moment dtype, carry sharding) is shared
across all layer blocks, θp/θs tuned per block — then pick a launch plan by
WUN under the user's latency/cost preference.  Runtime: between steps the
θs knobs (accum, unroll) can be re-picked from *observed* step metrics, the
AQE analogue (a recompile is the "new physical plan").

The solve's dominance filters run on ``device`` (``None`` = the CUDA
card); the cost model runs on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..archs.common import ArchConfig
from ..archs.registry import get_config
from ..core.moo.hmooc import HMOOCConfig, hmooc_solve
from ..core.moo.wun import wun_select
from ..launch.shapes import SHAPES
from .costmodel import ClusterCostModel
from .params import BLOCKS, cluster_theta_c, cluster_theta_p, cluster_theta_s

__all__ = ["LaunchPlan", "autotune"]


@dataclasses.dataclass
class LaunchPlan:
    arch: str
    shape: str
    theta_c: Dict[str, float]           # launch-time knobs
    theta_p: Dict[str, Dict[str, float]]  # per-block
    theta_s: Dict[str, Dict[str, float]]
    predicted: Tuple[float, float]      # (latency s, $ per step)
    front: np.ndarray
    solve_time: float

    def summary(self) -> str:
        tc = self.theta_c
        return (f"{self.arch}×{self.shape}: chips={int(tc['n_chips'])} "
                f"tp={int(tc['model_par'])} "
                f"moments={'bf16' if tc['moment_bf16'] else 'f32'} "
                f"carry_shard={'tp' if tc['act_shard_model'] else 'batch'} "
                f"→ {self.predicted[0]*1e3:.0f} ms/step, "
                f"${self.predicted[1]*1e3:.2f}e-3/step "
                f"({self.front.shape[0]} Pareto pts, "
                f"{self.solve_time:.2f}s solve)")


def autotune(arch_id: str, shape: str = "train_4k",
             weights: Tuple[float, float] = (0.5, 0.5),
             cfg: Optional[HMOOCConfig] = None,
             arch_cfg: Optional[ArchConfig] = None,
             device=None) -> LaunchPlan:
    """The launch plan of ``arch_id`` at ``shape`` that WUN picks under
    ``weights`` from the HMOOC3 front.  ``arch_cfg`` gives the
    configuration directly (``get_config`` serves the ported families
    only)."""
    arch_cfg = arch_cfg or get_config(arch_id)
    cell = SHAPES[shape]
    model = ClusterCostModel(arch_cfg, cell)
    cs, ps, ss = cluster_theta_c(), cluster_theta_p(), cluster_theta_s()
    hm = cfg or HMOOCConfig(n_c_init=48, n_clusters=8, n_p_pool=128,
                            n_c_enrich=48, seed=0)

    def snap_ps(U):
        out = U.copy()
        out[..., :ps.dim] = ps.snap_unit(U[..., :ps.dim])
        out[..., ps.dim:] = ss.snap_unit(U[..., ps.dim:])
        return out

    t0 = time.perf_counter()
    res = hmooc_solve(model.stage_eval, m=len(BLOCKS), d_c=cs.dim,
                      d_ps=ps.dim + ss.dim, cfg=hm,
                      snap_c=cs.snap_unit, snap_ps=snap_ps, device=device)
    finite = np.isfinite(res.front).all(-1)
    if not finite.any():
        raise RuntimeError("no feasible launch plan")
    front = res.front[finite]
    tcs = res.theta_c[finite]
    tps = res.theta_ps[finite]
    choice, _ = wun_select(front, np.asarray(weights))
    dt = time.perf_counter() - t0

    tc_raw = cs.to_raw(tcs[choice])
    theta_c = cs.raw_dict(tc_raw)
    theta_p = {}
    theta_s = {}
    for i, b in enumerate(BLOCKS):
        tp_raw = ps.to_raw(tps[choice, i, :ps.dim])
        ts_raw = ss.to_raw(tps[choice, i, ps.dim:])
        theta_p[b] = ps.raw_dict(tp_raw)
        theta_s[b] = ss.raw_dict(ts_raw)
    return LaunchPlan(arch=arch_id, shape=shape, theta_c=theta_c,
                      theta_p=theta_p, theta_s=theta_s,
                      predicted=tuple(front[choice]),
                      front=front, solve_time=dt)
