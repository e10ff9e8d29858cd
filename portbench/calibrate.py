"""Readings for the limits of the comparison: the program's numbers and
the control's, cell by cell, seed by seed, in one process.

    python portbench/calibrate.py --workload tpch.fresh.steady \
        --seeds 11,12,13 --seconds 30 [--control]

Each seed is a whole run of the cell (set-up, window, comparison) at the
cell's own load; with ``--control`` the control (the reference one
precision step down: TF32 matmuls in the network, bfloat16 runtime
scores) is read at the same questions.  Prints one JSON line a seed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    run._environment()
    import torch
    from portbench.harness import cell, correct
    from portbench.harness.bench import Benchmark

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    bench = Benchmark()
    cfg = bench.config(bench.cell(args.workload)["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out, rec = cell.run(bench, args.workload, seed, args.seconds, False,
                            dev, t0)
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: c["value"] for k, c in out["checks"].items()},
               "metrics": {k: m["value"] for k, m in out["metrics"].items()},
               "samples": {"stage_rows": sum(len(r[4]) for r in
                                             rec.samples.stage_rows),
                           "score_rows": sum(len(r[7]) for r in
                                             rec.samples.score_rows),
                           "banks": len(rec.samples.banks),
                           "rounds": len(rec.samples.rounds),
                           "plans": len(rec.served)}}
        if args.control:
            t1 = time.perf_counter()
            _, host_w = cell.make_weights(cell.model_configs(cfg),
                                          cfg["models"]["model_seed"], dev)
            row["control"] = correct.control_readings(rec, host_w, cfg, dev)
            row["control_s"] = time.perf_counter() - t1
        row["run_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del rec
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
