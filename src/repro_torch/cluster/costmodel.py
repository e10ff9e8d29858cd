"""Analytical roofline cost model for cluster autotuning on H100 GPUs.

Three terms (compute / HBM / collective) as closed forms over (arch,
shape, θc, θp, θs), so the HMOOC solver can evaluate tens of thousands of
candidates in milliseconds — the same role the GTN models play for Spark
queries.  Latency decomposes into per-block terms (embed / attention /
ffn / head) whose SUM is the step latency, which is exactly the structure
HMOOC's DAG aggregation requires.

Infeasible configurations (projected HBM > capacity) evaluate to +inf.

The hardware figures are module constants, read on every call (a test may
set them), for one NVIDIA H100 SXM 80GB in a cluster of 8-GPU nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..archs.common import ArchConfig
from ..launch.shapes import ShapeCell
from .params import BLOCKS, cluster_theta_c, cluster_theta_p, cluster_theta_s

__all__ = ["ClusterCostModel", "CHIP_PRICE_H", "HBM_CAP"]

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part at 700 W: dense bf16
# tensor-core rate, HBM3 bandwidth and capacity.
PEAK_FLOPS = 989e12     # FLOP/s
HBM_BW = 3.35e12        # bytes/s
HBM_CAP = 80e9          # bytes per GPU
# Per-GPU bandwidth between nodes: one 400 Gb/s NDR InfiniBand port
# (ConnectX-7) per GPU, as in NVIDIA's DGX H100 design.  At 64-512 GPUs
# the data-parallel collectives leave the 8-GPU NVLink domain; the
# tensor-parallel ones are charged at the same rate.
LINK_BW = 50e9          # bytes/s
# $ per GPU-hour: AWS EC2 p5.48xlarge (8 x H100 SXM 80GB), on-demand,
# us-east-1, $98.32 an hour as listed at the instance's launch (July 2023).
CHIP_PRICE_H = 98.32 / 8
# Fraction of PEAK_FLOPS that block-sized bf16 products reach: glm4-9b's
# scoring forward spends about 250 ms in its products, which need 135 ms
# at peak (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py; PERF.md §5-6).
# chip_smoke.py's [cluster] phase measures it again.
TC_EFF = 0.54


@dataclasses.dataclass
class ClusterCostModel:
    cfg: ArchConfig
    cell: ShapeCell

    def __post_init__(self):
        self.cs = cluster_theta_c()
        self.ps = cluster_theta_p()
        self.ss = cluster_theta_s()
        self.tokens = self.cell.global_batch * self.cell.seq_len
        self.params_block: Dict[str, float] = self._params_by_block()
        self.train = self.cell.kind == "train"

    # -- static parameter accounting ------------------------------------------
    def _params_by_block(self) -> Dict[str, float]:
        c = self.cfg
        d, f, L = c.d_model, c.d_ff, c.n_layers
        hd = c.head_dim
        attn = L * (d * hd * (c.n_heads + 2 * c.n_kv) + c.n_heads * hd * d)
        if c.n_experts:
            ffn = L * (3 * d * f * c.n_experts + d * c.n_experts)
        else:
            ffn = L * 3 * d * f
        emb = c.vocab * d
        head = 0 if c.tie_embeddings else c.vocab * d
        return {"embed": emb, "attention": attn, "ffn": ffn, "head": head}

    def _flops_by_block(self, cap: np.ndarray) -> Dict[str, np.ndarray]:
        c = self.cfg
        Tq = self.tokens
        d, f, L = c.d_model, c.d_ff, c.n_layers
        hd = c.head_dim
        S = self.cell.seq_len          # the decode cells' context length
        proj = 2 * Tq * d * hd * (c.n_heads + 2 * c.n_kv) \
            + 2 * Tq * c.n_heads * hd * d
        attn_mm = 4 * Tq * S * c.n_heads * hd * \
            (0.5 if self.cell.kind == "train" else 1.0)   # causal half
        attn = L * (proj + attn_mm)
        if c.n_experts:
            ffn = L * (6 * Tq * c.top_k * d * f * cap
                       + 2 * Tq * d * c.n_experts)
        else:
            ffn = L * 6 * Tq * d * f
        embed = np.zeros_like(cap) + 2 * Tq * d
        head = np.zeros_like(cap) + 2 * Tq * d * c.vocab
        return {"embed": embed, "attention": attn + np.zeros_like(cap),
                "ffn": ffn, "head": head}

    # -- evaluation --------------------------------------------------------------
    def stage_eval(self, block_idx: int, Tc_unit: np.ndarray,
                   Tps_unit: np.ndarray) -> np.ndarray:
        """HMOOC stage evaluator: (n, d_c) ⊕ (n, d_p + d_s) → (n, 2)."""
        block = BLOCKS[block_idx]
        tc = self.cs.to_raw(Tc_unit)
        dp_p = self.ps.dim
        tp_raw = self.ps.to_raw(Tps_unit[..., :dp_p])
        ts_raw = self.ss.to_raw(Tps_unit[..., dp_p:])

        chips = tc[:, 0]
        tp = np.minimum(tc[:, 1], chips)
        moment_bf16 = tc[:, 2] > 0.5
        act_shard = tc[:, 3] > 0.5
        remat = tp_raw[:, 0] > 0.5
        chunked = tp_raw[:, 1] > 0.5
        cap = np.clip(tp_raw[:, 2], 1.0, 2.0)
        accum = ts_raw[:, 0]
        dp = np.maximum(chips / tp, 1.0)

        c = self.cfg
        T = self.tokens
        d, L = c.d_model, c.n_layers
        P_b = self.params_block[block]
        flops = self._flops_by_block(cap)[block]

        # --- compute term ------------------------------------------------------
        bwd = (3.0 if self.train else 1.0)
        re = np.where(remat & self.train, 4.0 / 3.0, 1.0)
        compute_s = flops * bwd * re / (chips * PEAK_FLOPS * TC_EFF)

        # --- HBM term ----------------------------------------------------------
        passes = (2.0 + accum if self.train else 1.0)   # fwd+bwd(+per-μb re-read)
        w_bytes = P_b * 2.0 * passes / chips
        act_traffic = {"embed": 4, "attention": 12, "ffn": 10, "head": 6}[block]
        act_traffic = act_traffic + np.where(
            (block == "attention") & chunked, 4.0, 0.0)  # KV re-streamed
        a_bytes = T * d * 2.0 * act_traffic * bwd / chips
        memory_s = (w_bytes + a_bytes) / HBM_BW

        # --- collective term -----------------------------------------------------
        coll = np.zeros_like(chips, dtype=np.float64)
        if self.train:
            # grad reduce-scatter + param all-gather across dp (per chip).
            coll += 2.0 * (P_b * 2.0 / tp) * (dp - 1) / dp
        if block in ("attention", "ffn"):
            # TP boundary all-reduces: 2 per layer on (T/dp, d) activations.
            coll += 2.0 * L * (T / dp) * d * 2.0 * (tp - 1) / tp * bwd / 8.0
            # Model-sharded scan carry: per-layer activation all-gather.
            coll += np.where(act_shard,
                             L * (T / dp) * d * 2.0 * bwd / 8.0, 0.0)
        if c.n_experts and block == "ffn":
            coll += 2.0 * (T / dp) * c.top_k * d * 2.0 * bwd
        collective_s = coll / LINK_BW

        # --- feasibility ----------------------------------------------------------
        P_total = sum(self.params_block.values())
        mom = np.where(moment_bf16, 4.0, 8.0)
        state = P_total * (2.0 + mom) / chips
        act_res = np.where(
            self.train,
            L * (T / (dp * np.maximum(accum, 1.0))) * d * 2.0
            / np.where(act_shard, tp, 1.0),
            (T / dp) * d * 2.0)
        transient = np.where(chunked, 1e9, 3e9)
        peak = state + act_res + transient
        feasible = peak <= HBM_CAP

        # Roofline: the block is bound by its slowest engine (partial
        # overlap of compute with comm/HBM is the optimistic max model).
        lat = np.maximum.reduce([compute_s, memory_s, collective_s])
        dollars = lat * chips * CHIP_PRICE_H / 3600.0
        lat = np.where(feasible, lat, np.inf)
        dollars = np.where(feasible, dollars, np.inf)
        return np.stack([lat, dollars], -1)
