"""Batched compile-time tuning service demo.

Feeds a Zipf-distributed repeated-template request stream through a
long-lived :class:`repro_torch.serve.TuningService` and prints per-batch
throughput plus cache behavior — the serving regime behind the paper's
1–2 s per-query cloud budget.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_tuning \\
          --bench tpch --batch 16 [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..core.moo.hmooc import HMOOCConfig
from ..device import resolve_device
from ..queryengine.workloads import serving_stream
from ..serve import TuningService


def run(bench: str = "tpch", n_requests: int = 48, batch: int = 16,
        seed: int = 0, device=None) -> dict:
    """Print a line a batch and the cache's statistics; return the stream,
    each batch's results and statistics, and the cache's statistics."""
    device = resolve_device(device)
    stream = serving_stream(bench, n_requests, seed=seed)
    svc = TuningService(cfg=HMOOCConfig(seed=seed), device=device)
    weights = (0.9, 0.1)

    batches = []
    for lo in range(0, len(stream), batch):
        results = svc.tune_batch(stream[lo:lo + batch], weights)
        st = svc.last_batch
        qps = st.n_queries / st.wall_time if st.wall_time else 0.0
        lat = np.array([r.chosen_objectives[0] for r in results])
        print(f"batch {lo // batch}: {st.n_queries} queries "
              f"({st.n_solved} solved, {st.n_deduped} served from cache) "
              f"in {st.wall_time:.2f}s = {qps:.1f} q/s | "
              f"mean believed latency {lat.mean():.1f}s")
        batches.append({"results": results, "stats": st})
    cache = svc.cache.stats()
    print("effective-set cache:", cache)
    return {"stream": stream, "batches": batches, "cache": cache}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="tpch", choices=["tpch", "tpcds"])
    ap.add_argument("--n-requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.bench, args.n_requests, args.batch, args.seed,
        device=args.device)


if __name__ == "__main__":
    main()
