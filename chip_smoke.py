"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout,
holds each kernel against its plain PyTorch version on the card, drives the
port's main path (model-backed compile-time serving through
``TuningService.tune_batch``) at the default model and solver widths, and
checks the results.  Every phase raises on failure, so the script exits 0
only when all of them passed.  The last line of standard output is one JSON
object, ``{"ok": true, "device": {...}}``; the line before it lists each
kernel with its launches on the main path, its error against the plain
version and its times.

Without a CUDA card, or without the rest of the repository beside it, the
script fails before it prints any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.models.perf_model import ModelConfig, PerfModel  # noqa: E402
from repro_torch.core.moo import hmooc  # noqa: E402
from repro_torch.core.moo.hmooc import HMOOCConfig  # noqa: E402
from repro_torch.core.tuning.spark_space import (  # noqa: E402
    theta_c_space, theta_p_space, theta_s_space)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pareto_filter import ops as pareto_ops  # noqa: E402
from repro_torch.kernels.pareto_filter.ref import pareto_mask_ref  # noqa: E402
from repro_torch.queryengine.workloads import serving_stream  # noqa: E402
from repro_torch.serve import TuningService  # noqa: E402
from repro_torch.serve import service as service_mod  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Every kernel of the main path: name, wrapper module, TPU kernel it replaces.
KERNELS = [
    {"name": "pareto_filter", "ops": pareto_ops,
     "source": "src/repro_torch/kernels/pareto_filter/csrc/pareto_filter.cu",
     "replaces": "src/repro/kernels/pareto_filter/kernel.py:54"},
]
MAIN_PATH_SHAPE = (256, 2)          # one Algorithm 1 bank: 256-row pool, k=2
# (n, k, layout): "uniform" rows are mostly dominated within the first tile;
# "front" rows lie near one trade-off surface, so most survive and scan
# every tile of dominators.
CHECK_SHAPES = ([MAIN_PATH_SHAPE + ("uniform",), MAIN_PATH_SHAPE + ("front",)]
                + [(n, k, "uniform") for n in (128, 1000, 4096)
                   for k in (2, 3, 8)]
                + [(4096, k, "front") for k in (2, 3, 8)])
WEIGHTS = (0.9, 0.1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def build_all() -> float:
    """Compile every kernel library from the checkout's sources."""
    t0 = time.perf_counter()
    for k in KERNELS:
        _build.load(k["name"], k["ops"].SOURCES)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version, on the card
# ---------------------------------------------------------------------------

def pareto_case(n: int, k: int, seed: int, device, layout="uniform"):
    """f32 objectives, ~10% invalid rows, some +inf rows.  ``uniform``:
    uniform in [0, 10)^k.  ``front``: near the surface sum(F) = 10 with a
    small jitter, anti-correlated objectives like a bank of predictions."""
    rng = np.random.default_rng(seed)
    if layout == "front":
        F = rng.dirichlet(np.ones(k), n) * 10 + rng.random((n, k)) * 1e-3
    else:
        F = rng.random((n, k)) * 10
    F = F.astype(np.float32)
    F[rng.random(n) < 0.05] = np.inf
    valid = (rng.random(n) > 0.1) & np.isfinite(F).all(-1)
    return (torch.from_numpy(F).to(device), torch.from_numpy(valid).to(device))


def time_cuda(fn, iters: int) -> float:
    """Milliseconds per call, CUDA events around ``iters`` warm calls."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, name: str, iters: int = 200):
    """Mean device time (µs) of kernels whose name contains ``name``, from
    a torch.profiler trace of ``iters`` calls; None if the trace has none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
    count = sum(e.count for e in hits)
    return total / count if count and total > 0 else None


def pareto_bound_ms(F: torch.Tensor, valid: torch.Tensor, mask: torch.Tensor):
    """Least time for the card: bytes moved vs compares this data needs.

    Bytes: F read once (f32), valid read once, the mask written once.
    Compares: 2k per pair test; a surviving row must be tested against
    every valid row, a dominated one needs only its dominator.
    """
    n, k = F.shape
    n_bytes = n * k * 4 + n + n
    V = int(valid.sum())
    S = int(mask.sum())
    ops = 2 * k * (S * V + (V - S))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_pareto_filter(device) -> dict:
    worst = 0
    for i, (n, k, layout) in enumerate(CHECK_SHAPES):
        F, valid = pareto_case(n, k, seed=100 + i, device=device,
                               layout=layout)
        got = pareto_ops.pareto_filter(F, valid)
        torch.cuda.synchronize()
        want = pareto_mask_ref(F, valid)
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if err != 0:
            raise AssertionError(f"pareto_filter disagrees with its plain "
                                 f"version at n={n} k={k} ({layout})")
        worst = max(worst, err)
        log(f"[kernels] pareto_filter == plain version at n={n} k={k} "
            f"({layout}): survivors {int(want.sum())}/{n}")
    log(f"[kernels] pareto_filter == plain version on {len(CHECK_SHAPES)} "
        "cases (exact)")
    timings = {}
    for n, k, layout in (MAIN_PATH_SHAPE + ("uniform",), (4096, 2, "uniform"),
                         MAIN_PATH_SHAPE + ("front",), (4096, 2, "front")):
        F, valid = pareto_case(n, k, seed=7, device=device, layout=layout)
        mask = pareto_ops.pareto_filter(F, valid)
        ms = time_cuda(lambda: pareto_ops.pareto_filter(F, valid), 2000)
        plain = time_cuda(lambda: pareto_mask_ref(F, valid), 200)
        bound, by = pareto_bound_ms(F, valid, mask)
        dev = device_us(lambda: pareto_ops.pareto_filter(F, valid),
                        "pareto_filter_kernel")
        timings[(n, k, layout)] = (ms, plain, bound, by)
        log(f"[kernels] pareto_filter n={n} k={k} ({layout}): "
            f"{ms:.6f} ms per call "
            f"(events), kernel alone "
            f"{'not measured' if dev is None else f'{dev:.3f} us'} "
            f"(profiler), plain {plain:.6f} ms, bound {bound:.9f} ms ({by}), "
            f"survivors {int(mask.sum())}/{n}")
    ms, plain, bound, by = timings[MAIN_PATH_SHAPE + ("uniform",)]
    return {"max_abs_err": float(worst), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


# ---------------------------------------------------------------------------
# Phase 3: the slice's main path
# ---------------------------------------------------------------------------

class Timers:
    """Host wall time spent inside wrapped functions during one batch."""

    def __init__(self):
        self.t = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.t[name] = self.t.get(name, 0.0) \
                    + time.perf_counter() - t0
        return timed


def check_results(queries, results) -> None:
    for q, r in zip(queries, results):
        if r.front.ndim != 2 or r.front.shape[0] == 0 \
                or r.front.shape[1] != 2:
            raise AssertionError(f"{q.qid}: bad front shape {r.front.shape}")
        if not np.isfinite(r.front).all():
            raise AssertionError(f"{q.qid}: non-finite front")
        if not 0 <= r.choice < r.front.shape[0]:
            raise AssertionError(f"{q.qid}: WUN pick out of range")
        if r.theta_p_sub.shape[0] != q.n_subqs:
            raise AssertionError(f"{q.qid}: θp rows != subQs")


def check_theta_bounds(queries, results) -> None:
    """Every chosen θ lies in its parameter's range (θ ∈ [0, 1] in the
    solver's unit space)."""
    spaces = (theta_c_space(), theta_p_space(), theta_s_space())
    for q, r in zip(queries, results):
        for space, raw in zip(spaces, (r.theta_c[None], r.theta_p_sub,
                                       r.theta_s_sub)):
            lo = np.array([p.lo for p in space.params])
            hi = np.array([p.hi for p in space.params])
            if not ((raw >= lo) & (raw <= hi)).all():
                raise AssertionError(f"{q.qid}: θ outside its range")


def warm_up(device, cfg: HMOOCConfig) -> float:
    """Pay the card's first-use costs (cuBLAS set-up, lazy loading of each
    kernel) before anything is timed: one batch at the main path's widths
    through a model and a service of its own, on queries outside the
    measured streams, so none of its caches serve a timed batch."""
    model = PerfModel(ModelConfig("subq", 19), seed=1, device=device)
    queries = serving_stream("tpch", 8, seed=1, query_seed=1)
    t0 = time.perf_counter()
    TuningService(model=model, cfg=cfg, device=device).tune_batch(queries,
                                                                  WEIGHTS)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_main_path(device, n_queries: int = 32,
                  cfg: HMOOCConfig = HMOOCConfig()) -> dict:
    """Three batches through the port's service at the default widths:
    TPC-H, the same TPC-H stream again (warm caches), then TPC-DS."""
    log(f"[warmup] first-use batch of 8 queries: "
        f"{warm_up(device, cfg):.6f} s (not timed below)")
    model = PerfModel(ModelConfig("subq", 19), seed=0, device=device)
    if any(p.device.type != device.type for p in model.net.parameters()):
        raise AssertionError(f"model parameters are not on {device}")
    svc = TuningService(model=model, cfg=cfg, device=device)
    batches = [("tpch", serving_stream("tpch", n_queries, seed=0)),
               ("tpch warm", serving_stream("tpch", n_queries, seed=0)),
               ("tpcds", serving_stream("tpcds", n_queries, seed=0))]
    timers = Timers()
    orig = (service_mod.fused_stage_eval, hmooc.pareto_mask_fast,
            model.predict_rows, model.embed_many)
    service_mod.fused_stage_eval = timers.wrap("stage_eval", orig[0])
    hmooc.pareto_mask_fast = timers.wrap("pareto_masks", orig[1])
    model.predict_rows = timers.wrap("predict_rows", orig[2])
    model.embed_many = timers.wrap("embed_many", orig[3])
    for k in KERNELS:
        k["ops"].LAUNCHES = 0
    per_batch = []
    try:
        for name, queries in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            timers.t.clear()
            rows0 = model.rows_predicted
            l0 = pareto_ops.LAUNCHES
            t0 = time.perf_counter()
            results = svc.tune_batch(queries, WEIGHTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_results(queries, results)
            check_theta_bounds(queries, results)
            s = svc.last_batch
            row = {"batch": name, "queries": len(queries),
                   "qps": len(queries) / wall, "wall_s": wall,
                   "solved": s.n_solved, "deduped": s.n_deduped,
                   "regressor_rows": model.rows_predicted - rows0,
                   "pareto_launches": pareto_ops.LAUNCHES - l0,
                   "max_memory_bytes": torch.cuda.max_memory_allocated(),
                   "host_s": {k: round(v, 6) for k, v in timers.t.items()},
                   "mean_solve_s": float(np.mean([r.solve_time
                                                  for r in results]))}
            per_batch.append(row)
            log(f"[slice] {json.dumps(row)}")
    finally:
        (service_mod.fused_stage_eval, hmooc.pareto_mask_fast) = orig[:2]
        del model.predict_rows, model.embed_many
    launches = {k["name"]: k["ops"].LAUNCHES for k in KERNELS}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    log(f"[slice] cache {svc.cache.stats()}")
    return {"launches": launches, "batches": per_batch, "model": model}


# ---------------------------------------------------------------------------
# Phase 4: the card's answers against the host's, on a small input
# ---------------------------------------------------------------------------

def check_against_host(model_cuda, device) -> None:
    """The main path's model on the card and the same weights on the host
    give fronts of equal shape within rtol 1e-4 (float32 sums in another
    order on the card) on a small input.  The oracle backend's exact
    card-equals-host check is ``tests/test_torch_cuda.py``."""
    cfg = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                      max_bank=12, seed=3)
    queries = serving_stream("tpch", 6, seed=5)
    host_model = PerfModel(model_cuda.cfg,
                           params={k: v.cpu() for k, v in
                                   model_cuda.params.items()},
                           target_stats=model_cuda.target_stats,
                           device="cpu")
    card = TuningService(model=model_cuda, cfg=cfg,
                         device=device).tune_batch(queries, WEIGHTS)
    host = TuningService(model=host_model, cfg=cfg,
                         device="cpu").tune_batch(queries, WEIGHTS)
    worst = 0.0
    for q, a, b in zip(queries, card, host):
        if a.front.shape != b.front.shape:
            raise AssertionError(f"{q.qid}: model front shape differs "
                                 f"{a.front.shape} vs {b.front.shape}")
        worst = max(worst, float(np.max(np.abs(a.front - b.front)
                                        / np.abs(b.front))))
    if worst > 1e-4:
        raise AssertionError(f"model fronts differ by relative {worst:.3g}")
    log(f"[check] model fronts on the card within relative {worst:.3g} "
        f"of the host's on {len(queries)} queries")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    log(f"[build] kernels built in {build_all():.2f} s")
    entries = {"pareto_filter": check_pareto_filter(device)}
    main_path = run_main_path(device)
    check_against_host(main_path["model"], device)
    kernels = []
    for k in KERNELS:
        e = entries[k["name"]]
        kernels.append({"name": k["name"], "route": "cuda",
                        "source": k["source"], "replaces": k["replaces"],
                        "launches": main_path["launches"][k["name"]],
                        **e})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
