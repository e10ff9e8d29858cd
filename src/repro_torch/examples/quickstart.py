"""Quickstart: tune one TPC-H query with HMOOC3, end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds the query, solves the compile-time MOO (oracle objectives — no
model training needed), aggregates the submission θp/θs, executes under
AQE with runtime re-optimization, and prints the before/after.  The
solve's dominance filters and the runtime's picks run on ``--device``
(default: the CUDA card).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..core.moo.hmooc import HMOOCConfig
from ..core.tuning.compile_time import compile_time_optimize
from ..core.tuning.runtime import make_runtime_optimizers
from ..device import resolve_device
from ..queryengine.aqe import run_with_aqe
from ..queryengine.simulator import default_theta
from ..queryengine.workloads import make_benchmark


def run(device=None) -> dict:
    """Print the walk-through and return its results: the query, the
    compile-time result and the AQE runs under Spark's defaults, the
    HMOOC3 pick and the pick with runtime re-optimization."""
    device = resolve_device(device)
    query = make_benchmark("tpch")[18]         # a long-running join query
    print(f"query {query.qid}: {query.n_subqs} subQs, "
          f"{len(query.ops)} operators")

    # --- default Spark configuration -------------------------------------
    tc, tp, ts = default_theta(1)
    base = run_with_aqe(query, tc[0], tp[0], ts[0])
    print(f"default:   latency {base.sim.actual_latency[0]:8.2f} s   "
          f"cost ${base.sim.cost[0]:.4f}")

    # --- compile-time optimization (θc* + fine-grained θp/θs) -------------
    ct = compile_time_optimize(query, weights=(0.9, 0.1),
                               cfg=HMOOCConfig(dag_method="hmooc3"),
                               device=device)
    print(f"HMOOC3 solved in {ct.solve_time:.2f}s: "
          f"{ct.front.shape[0]} Pareto points; picked "
          f"cores={ct.theta_c[0]:.0f}×{ct.theta_c[2]:.0f} "
          f"mem={ct.theta_c[1]:.0f}GB")

    opt = run_with_aqe(query, ct.theta_c, ct.theta_p0, ct.theta_s0)
    print(f"HMOOC3:    latency {opt.sim.actual_latency[0]:8.2f} s   "
          f"cost ${opt.sim.cost[0]:.4f}")

    # --- + runtime optimization (AQE plugin) ------------------------------
    lqp_o, qs_o = make_runtime_optimizers(
        query, ct.theta_c, seed_theta_p=ct.theta_p_sub,
        seed_theta_s=ct.theta_s_sub, weights=(0.9, 0.1), device=device)
    rt = run_with_aqe(query, ct.theta_c, ct.theta_p0, ct.theta_s0,
                      lqp_optimizer=lqp_o, qs_optimizer=qs_o)
    print(f"HMOOC3+:   latency {rt.sim.actual_latency[0]:8.2f} s   "
          f"cost ${rt.sim.cost[0]:.4f}   "
          f"({rt.requests_sent}/{rt.requests_total} runtime requests after "
          f"pruning)")

    red = 1 - rt.sim.actual_latency[0] / base.sim.actual_latency[0]
    print(f"\nlatency reduction vs default: {red:.0%}")
    return {"query": query, "default": base, "compile_time": ct,
            "hmooc3": opt, "runtime": rt, "latency_reduction": float(red)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
