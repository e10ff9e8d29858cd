"""Workload tuning: all 22 TPC-H queries, HMOOC3+ vs default (Table 4 style).

    PYTHONPATH=src python -m repro_torch.examples.tpch_tuning \\
        [--model] [--device cpu]

``--model`` trains the performance models first (the benchmarks' fast
TPC-H budget: 3 variants × 32 configurations, 1,500 steps; minutes on the
host) and tunes with the trained subQ model, re-scoring runtime query
stages with the trained QS model; the default uses oracle objectives for
a fast demonstration.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.models.perf_model import PerfModel
from ..core.models.training import train_all_models
from ..core.moo.hmooc import HMOOCConfig
from ..core.tuning.compile_time import compile_time_optimize
from ..core.tuning.runtime import make_runtime_optimizers
from ..device import resolve_device
from ..queryengine.aqe import run_with_aqe
from ..queryengine.simulator import default_theta
from ..queryengine.trace import collect_traces
from ..queryengine.workloads import default_workload, make_benchmark


def train_models(device=None) -> Tuple[PerfModel, PerfModel]:
    """The subQ and QS models at the benchmarks' fast TPC-H budget."""
    traces = collect_traces(default_workload("tpch", 3), 32, seed=0)
    models = train_all_models(traces, steps=1500, lqp_steps=500,
                              device=device)
    return models["subq"][0], models["qs"][0]


def run(model: Optional[PerfModel] = None,
        model_qs: Optional[PerfModel] = None,
        weights: Tuple[float, float] = (0.9, 0.1), device=None) -> dict:
    """Tune every TPC-H query (with the subQ ``model``, or the oracle
    objectives when it is None; runtime query stages re-scored by
    ``model_qs``, or the oracle), print a line a query and the totals, and
    return a row a query (its compile-time result and the AQE runs under
    Spark's defaults and under the tuned plan) with the totals."""
    device = resolve_device(device)
    rows, lat_d, lat_o, st = [], [], [], []
    for q in make_benchmark("tpch"):
        tc, tp, ts = default_theta(1)
        base = run_with_aqe(q, tc[0], tp[0], ts[0])
        ct = compile_time_optimize(q, model=model, weights=weights,
                                   cfg=HMOOCConfig(dag_method="hmooc3"),
                                   device=device)
        lqp_o, qs_o = make_runtime_optimizers(
            q, ct.theta_c, seed_theta_p=ct.theta_p_sub,
            seed_theta_s=ct.theta_s_sub, model_subq=model,
            model_qs=model_qs, weights=weights, device=device)
        opt = run_with_aqe(q, ct.theta_c, ct.theta_p0, ct.theta_s0,
                           lqp_optimizer=lqp_o, qs_optimizer=qs_o)
        lat_d.append(base.sim.actual_latency[0])
        lat_o.append(opt.sim.actual_latency[0])
        st.append(ct.solve_time)
        red = 1 - lat_o[-1] / lat_d[-1]
        print(f"{q.qid}: {lat_d[-1]:7.2f}s → {lat_o[-1]:7.2f}s "
              f"({red:+.0%})  solve {st[-1]:.2f}s")
        rows.append({"query": q, "default": base, "compile_time": ct,
                     "tuned": opt})

    lat_d, lat_o = np.array(lat_d), np.array(lat_o)
    total = 1 - lat_o.sum() / lat_d.sum()
    avg = np.mean(1 - lat_o / lat_d)
    print(f"\ntotal latency reduction: {total:.0%} "
          f"(avg per-query {avg:.0%}); "
          f"solve time avg {np.mean(st):.2f}s max {np.max(st):.2f}s")
    return {"rows": rows, "total_reduction": float(total),
            "avg_reduction": float(avg), "solve_times": st}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", action="store_true")
    ap.add_argument("--weights", default="0.9,0.1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    w = tuple(float(x) for x in args.weights.split(","))
    device = resolve_device(args.device)
    models = train_models(device) if args.model else (None, None)
    return run(*models, weights=w, device=device)


if __name__ == "__main__":
    main()
