"""Find a configuration's knee: the highest offered rate its server
sustains on a mix with no backlog growing.

    python portbench/sweep.py --workload tpch.fresh.steady \
        --rates 8,12,16,20 --seconds 20 --seed 1

One process: the cell's set-up once, then one ``serve`` a rate (in the
order given, each on its own fresh requests).  A rate is sustained when
the server finishes at least 95 % of the rate the stream offered
(finished over first arrival to last finish, against arrivals over the
arrivals' span) and its last request finishes within the solve budget of
the last arrival.  Prints one JSON line a
rate.  The knee is written into the traffic files by hand, as a number.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    run._environment()
    import numpy as np
    import torch
    from portbench.harness import cell, traffic
    from portbench.harness.bench import Benchmark

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    bench = Benchmark()
    c = bench.cell(args.workload)
    cfg = bench.config(c["config"])
    mix = bench.traffic(c["traffic"])
    queries = bench.queries(cfg)
    srv, _, _, _, _ = cell.setup(cfg, mix, queries, args.seed, args.seconds,
                                 dev)
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        m = json.loads(json.dumps(mix))
        m["arrivals"]["rate_qps"] = rate
        tr = traffic.build(m, queries, args.seed + 1000 * (k + 1),
                           args.seconds, cfg["query_seed"])
        t0 = time.perf_counter()
        served = srv.serve(tr.window)
        wall = time.perf_counter() - t0
        arr = np.array([s.arrival_s for s in served])
        fin = np.array([s.finished_s for s in served])
        sol = np.array([s.solve_latency_s for s in served])
        n = len(served)
        q = n // 4
        row = {"rate_qps": rate, "offered": n, "wall_s": wall,
               "served_qps": n / (fin.max() - arr.min()),
               "last_lag_s": float(fin[np.argmax(arr)] - arr.max()),
               "end_lag_s": float(fin.max() - arr.max()),
               "solve_p50_s": float(np.median(sol)),
               "solve_p95_s": float(np.sort(sol)[math.ceil(0.95 * n) - 1]),
               "solve_p95_first_quarter_s": float(np.percentile(sol[:q], 95)),
               "solve_p95_last_quarter_s": float(np.percentile(sol[-q:], 95)),
               "tune_ms_per_query": 1e3 * sum(w for w, _ in
                                              srv.last_run.tune_windows)
               / max(1, sum(b for _, b in srv.last_run.tune_windows)),
               "rounds": srv.last_run.rounds,
               "micro_batches": srv.last_run.n_micro_batches}
        row["offered_qps"] = (n - 1) / (arr.max() - arr.min())
        row["sustained"] = bool(row["served_qps"]
                                >= 0.95 * row["offered_qps"]
                                and row["end_lag_s"]
                                <= srv.config.solve_budget_s)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
