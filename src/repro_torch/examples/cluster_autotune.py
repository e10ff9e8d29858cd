"""Beyond-paper: HMOOC tunes the training cluster itself.

    PYTHONPATH=src python -m repro_torch.examples.cluster_autotune \\
        [--arch qwen2-72b] [--device cpu]

θc = (chips, TP split, moment dtype, carry sharding), θp per layer block
(remat / attention impl / MoE capacity), θs = (accum, unroll).  The Pareto
front trades step latency against $ per step on H100 GPUs; WUN picks per
preference.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..cluster.autotune import autotune
from ..device import resolve_device

WEIGHTS = [(0.95, 0.05), (0.7, 0.3), (0.5, 0.5), (0.3, 0.7), (0.05, 0.95)]


def run(arch: str = "qwen2-72b", shape: str = "train_4k",
        device=None) -> dict:
    """Print the plan WUN picks for each preference and the front; return
    the (weights, plan) pairs and the front sorted by latency."""
    device = resolve_device(device)
    print(f"autotuning {arch} × {shape}\n")
    plans = []
    for w in WEIGHTS:
        plan = autotune(arch, shape, weights=w, device=device)
        print(f"w(lat,cost)=({w[0]:.2f},{w[1]:.2f}) → {plan.summary()}")
        for block, tp in plan.theta_p.items():
            ts = plan.theta_s[block]
            print(f"    {block:10s} remat={int(tp['remat'])} "
                  f"chunked_attn={int(tp['chunked_attn'])} "
                  f"cap={tp['capacity_factor']:.2f} "
                  f"accum={int(ts['accum'])} unroll={int(ts['unroll'])}")
        plans.append((w, plan))

    plan = autotune(arch, shape, weights=(0.5, 0.5), device=device)
    F = plan.front[np.argsort(plan.front[:, 0])]
    print("\nPareto front (latency s, $/step):")
    for row in F:
        print(f"  {row[0]:8.2f}  {row[1]:.5f}")
    return {"plans": plans, "front": F}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.arch, args.shape, device=args.device)


if __name__ == "__main__":
    main()
