"""Parameter space for cluster autotuning — the paper's θc/θp/θs taxonomy
mapped onto a training job.  The space is the reference's, unchanged.

θc (launch-time context — fixes the job's "Spark context"):
    n_chips        — chips leased for the job (cost ↔ latency tradeoff)
    model_par      — TP axis size (data axis = n_chips / model_par)
    moment_dtype   — optimizer moment precision (bf16 halves opt HBM)
    act_shard_model— shard layer carries over TP (HBM ↔ all-gather tradeoff)

θp (per layer-block, recompile to change — the "collapsed plan" analogue):
    remat          — recompute policy for the block
    attn_impl      — einsum vs chunked attention (working-set shape)
    capacity_factor— MoE expert capacity

θs (per-step runtime knobs — the "query stage" analogue):
    accum          — gradient-accumulation microbatches
    unroll         — scan unroll factor
"""
from __future__ import annotations

from ..core.tuning.spaces import Param, ParamSpace

__all__ = ["cluster_theta_c", "cluster_theta_p", "cluster_theta_s",
           "BLOCKS"]

# Layer blocks = the "subQs" of a training step (sum-aggregating latency).
BLOCKS = ["embed", "attention", "ffn", "head"]


def cluster_theta_c() -> ParamSpace:
    return ParamSpace([
        Param("n_chips", "cat", choices=[64, 128, 256, 512], default=256),
        Param("model_par", "cat", choices=[4, 8, 16, 32], default=16),
        Param("moment_bf16", "bool", default=0),
        Param("act_shard_model", "bool", default=1),
    ])


def cluster_theta_p() -> ParamSpace:
    return ParamSpace([
        Param("remat", "bool", default=1),
        Param("chunked_attn", "bool", default=0),
        Param("capacity_factor", "float", 1.0, 2.0, default=1.25),
    ])


def cluster_theta_s() -> ParamSpace:
    return ParamSpace([
        Param("accum", "cat", choices=[1, 2, 4, 8, 16], default=1),
        Param("unroll", "cat", choices=[1, 2, 4], default=1),
    ])
