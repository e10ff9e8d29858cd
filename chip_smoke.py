"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout
(one ``nvcc`` per kernel, all started together), holds each kernel against
its plain PyTorch version on the card, and drives the port's paths at the
default model and solver widths:

* compile-time serving, ``TuningService.tune_batch`` (hmooc3 aggregation);
* the runtime (AQE) half, ``RuntimeSession.run_batch``, seeded by the
  compile-time results;
* HMOOC2, the same service with ``HMOOCConfig(dag_method="hmooc2")``;
* dense-LM serving (``lm``): ``glm4-9b`` at full width in bfloat16 with
  random weights from a seed, one prompt-scoring forward of 4 × 2048 tokens
  through the flash-attention kernel's tensor-core body (every launch must
  take it), then generation through the port's ``make_serve_fns``
  (prefill into a KV cache, 31 greedy decode steps).

Each path runs with every kernel's launch count set to 0 just before it
and read just after; the script fails if a kernel of a path was not
launched there, if a compile-time stream makes more than 2
``pareto_filter`` launches per solved query (one for the banks phase, one
for the DAG filter), or if a runtime batch's rounds make other than one
``runtime_pick`` call and one host synchronisation each, or any
``pareto_filter`` or ``ws_reduce`` launch.  ``runtime_pick`` is held to
its plain version on the planted cases of the CPU parity tests and on
sets past its shared-memory budget, and timed at the batch's largest
round beside the composed route it replaces (``pareto_masks_fast``,
numpy normalisation and ``ws_reduce``) and, at 1-32 sets, beside the
host's float64 route.  On the HMOOC2 path it counts
each aggregation's host time and host synchronisations, holds the
router's on-card tie flag against ``_f32_tie_hazard`` on every bank the
batch checked, and times the fused kernel (which normalises the staged
bank itself) per call and the caller's whole aggregation at the batch's
largest bank.  It also prints the crossover
between one float64 numpy mask and one kernel launch with its copies, and
the spread of the LM's bfloat16 logits over three prompt seeds for both
flash-attention bodies and SDPA.  It checks the results of every path and the card's
answers against the host's on small inputs (for the LM: the flash route
against the plain route at 4 layers, and the card against the host at 2
layers, both at full width in float32).  Every phase raises on failure,
so the script exits 0 only when all of them passed.  The last line of
standard output is one JSON object, ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches, its error against the
plain version and its times.

Without a CUDA card, or without the rest of the repository beside it, the
script fails before it prints any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # the runtime pick's test cases

from repro_torch.archs import blocks as arch_blocks  # noqa: E402
from repro_torch.archs.common import DTYPES  # noqa: E402
from repro_torch.archs.registry import build_model, get_config  # noqa: E402
from repro_torch.core.models.perf_model import ModelConfig, PerfModel  # noqa: E402
from repro_torch.core.moo import hmooc  # noqa: E402
from repro_torch.core.moo import pareto as pareto_core  # noqa: E402
from repro_torch.core.moo.hmooc import HMOOCConfig  # noqa: E402
from repro_torch.core.tuning import runtime as runtime_core  # noqa: E402
from repro_torch.core.tuning.spark_space import (  # noqa: E402
    theta_c_space, theta_p_space, theta_s_space)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels import fused_solve as fused_pkg  # noqa: E402
from repro_torch.kernels import ws_reduce as ws_pkg  # noqa: E402
from repro_torch.kernels.fused_solve import ops as fused_ops  # noqa: E402
from repro_torch.kernels.fused_solve.ref import (  # noqa: E402
    fused_ws_front_ref, local_mask_ref)
from repro_torch.kernels.pareto_filter import ops as pareto_ops  # noqa: E402
from repro_torch.kernels import pareto_filter as pareto_pkg  # noqa: E402
from repro_torch.kernels.pareto_filter.ref import (  # noqa: E402
    pareto_mask_ref, pareto_masks_ref)
from repro_torch.kernels.ws_reduce import ops as ws_ops  # noqa: E402
from repro_torch.kernels.ws_reduce.ref import (  # noqa: E402
    kept_normalised, runtime_pick_ref, ws_reduce_ref)
from repro_torch.queryengine.aqe import LQPRequest, QSRequest  # noqa: E402
from repro_torch.queryengine.simulator import plan_joins  # noqa: E402
from repro_torch.queryengine.workloads import serving_stream  # noqa: E402
from repro_torch.serve import RuntimeSession, TuningService  # noqa: E402
from repro_torch.serve import runtime as runtime_mod  # noqa: E402
from repro_torch.serve import service as service_mod  # noqa: E402
from repro_torch.train.serve import make_serve_fns  # noqa: E402
from _runtime_pick_cases import (  # noqa: E402
    CASES as PICK_CASES, PICK_THRESHOLDS, budget_round, case_weights)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12             # tensor cores, dense

# Every kernel of the port: name, wrapper module and its launch counter,
# TPU kernel it replaces, and the paths that must launch it.  ws_reduce
# alone is on no path since the runtime's rounds take runtime_pick
# (HMOOC2's float64 route still calls it); both build into one library.
KERNELS = [
    {"name": "pareto_filter", "ops": pareto_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/pareto_filter/csrc/pareto_filter.cu",
     "replaces": "src/repro/kernels/pareto_filter/kernel.py:54",
     "paths": ("compile",)},
    {"name": "ws_reduce", "ops": ws_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/ws_reduce/csrc/ws_reduce.cu",
     "replaces": "src/repro/kernels/ws_reduce/kernel.py:35",
     "paths": ()},
    {"name": "runtime_pick", "ops": ws_ops,
     "counter": "RUNTIME_PICK_LAUNCHES",
     "source": "src/repro_torch/kernels/ws_reduce/csrc/runtime_pick.cu",
     "replaces": "src/repro/kernels/ws_reduce/kernel.py:35",
     "paths": ("runtime",)},
    {"name": "fused_solve", "ops": fused_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/fused_solve/csrc/fused_solve.cu",
     "replaces": "src/repro/kernels/fused_solve/ops.py:79",
     "paths": ("hmooc2",)},
    {"name": "flash_attention", "ops": flash_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_wgmma.cu",
     "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
     "paths": ("lm",)},
]
MAIN_PATH_SHAPE = (256, 2)          # one Algorithm 1 bank: 256-row pool, k=2
# (n, k, layout): "uniform" rows are mostly dominated within the first tile;
# "front" rows lie near one trade-off surface, so most survive and scan
# every tile of dominators.
CHECK_SHAPES = ([MAIN_PATH_SHAPE + ("uniform",), MAIN_PATH_SHAPE + ("front",)]
                + [(n, k, "uniform") for n in (128, 1000, 4096)
                   for k in (2, 3, 8)]
                + [(4096, k, "front") for k in (2, 3, 8)])
# The segmented launch (S, n, k): one bank, a banks phase of 5 and of 9
# representatives x 10 subQs, a runtime round's candidate sets, K3's global
# filter at the largest HMOOC2 bank (126 candidates x 11 weights, bucketed),
# and two long segments at k = 8.  Every case with S > 2 holds a ragged
# segment, and every case with S > 1 an all-invalid one.
SEGMENT_SHAPES = [(1, 256, 2), (50, 256, 2), (90, 256, 2), (32, 66, 2),
                  (3, 1408, 2), (2, 4096, 8)]
# Timed (S, n, k, layout): a bank alone, a banks phase, K3's global filter,
# a long segment; the front layouts as in earlier runs.
SEGMENT_TIMINGS = [(1, 256, 2, "uniform"), (50, 256, 2, "uniform"),
                   (1, 1408, 2, "uniform"), (1, 4096, 2, "uniform"),
                   (1, 256, 2, "front"), (1, 4096, 2, "front")]
# Bank sizes at which the float64 numpy mask and one kernel launch (with its
# copies and synchronisation) are timed against each other.
CROSSOVER_N = (16, 32, 64, 128, 256)
WEIGHTS = (0.9, 0.1)
# ws_reduce (m, B, k, nw): the kernel tests' shapes, the largest runtime
# pick (one round of 32 sets of 64 pool rows + 2 seeds, one weight row, if
# no row were dominated), and HMOOC2's picks (128 candidates x 8 subQs,
# bank cap 48, 11 weights).  The largest pick the runtime path really made
# is checked and timed after it.
WS_RUNTIME_SHAPE = (32, 66, 2, 1)
WS_SHAPES = [(1, 8, 2, 3), (4, 130, 2, 11), (3, 48, 3, 33), (2, 256, 4, 128),
             WS_RUNTIME_SHAPE, (1024, 48, 2, 11)]
# ws_reduce is timed for the table on a bank shaped as the largest one the
# composed route hands it in the runtime batch: 31 sets of 5 kept rows,
# normalised, padded with 1e18.
WS_TIMED_SHAPE = (31, 5, 2, 1)
# Rounds of PICK_CROSSOVER_R sets of 64 rows are timed by the runtime
# pick's card route and the host's float64 route.
PICK_CROSSOVER_R = (1, 4, 16, 32)
# fused_solve (N, m, B, k, nw): the reference's four parity cases and its
# padding-invalid case.  The largest bank of the HMOOC2 batch is checked
# and timed after that batch.
FUSED_SHAPES = [(1, 1, 2, 2, 3), (3, 2, 8, 2, 11), (7, 3, 16, 2, 6),
                (33, 5, 4, 2, 4), (5, 3, 4, 2, 6)]
# Banks past the kernel's shared-memory budget: tiles of subQs, and chunks
# of one subQ's bank rows (k = 2 and k = 8).
FUSED_TILED = [(4, 40, 64, 2, 11), (3, 3, 2200, 2, 11), (3, 5, 900, 8, 6)]
# The LM path: 4 requests of 2048 prompt tokens, 32 generated tokens each,
# in a cache of 2080 slots.
LM_ARCH = "glm4-9b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_CAPACITY = 4, 2048, 32, 2080
# flash_attention (B, Hq, Hkv, Sq, Skv, D, causal, dtype): the reference
# kernel tests' six float32 shapes (CUDA-core body) and their bfloat16
# case, the LM path's shape (glm4-9b at 4 × 2048 tokens), which is timed
# for the table, a minicpm-2b-shaped case (36 heads of 64) and the LM shape
# in float16 (all tensor-core body).
FLASH_LM_SHAPE = (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, True,
                  torch.bfloat16)
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64, True, torch.float32),
                (2, 8, 2, 256, 256, 64, True, torch.float32),
                (1, 4, 1, 100, 100, 128, True, torch.float32),
                (1, 4, 2, 1, 300, 64, False, torch.float32),
                (1, 8, 4, 96, 480, 64, True, torch.float32),
                (2, 2, 2, 64, 64, 128, False, torch.float32),
                (1, 4, 4, 128, 128, 128, True, torch.bfloat16),
                FLASH_LM_SHAPE,
                (1, 36, 36, 2048, 2048, 64, True, torch.bfloat16),
                FLASH_LM_SHAPE[:-1] + (torch.float16,)]
# The profiler's name of each flash-attention body's kernel.
FLASH_KERNEL_NAMES = {"wgmma": "flash_attention_wgmma_kernel",
                      "simt": "flash_attention_kernel"}
# Stated tolerances: float32 as the reference's kernel test (the online
# softmax sums in another order than one softmax); 16-bit outputs differ
# by about one rounding of the output.  The LM checks compare float32
# logits of magnitude up to about 5 after 2 or 4 layers of float32 sums in
# other orders (flash against plain, card against host).
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2,
              torch.float16: 3e-2}
# 16-bit outputs are also held to a bound that scales with them, against
# the float32 plain version before its rounding: |got − want| ≤ a + r·|want|
# per element.  r is twice the most that rounding to the type moves a
# value (2^-8 relative for bfloat16, 2^-11 for float16); a covers the
# float32 sums taken in another order.  Late causal rows have |o| of about
# 0.03–0.05 on these unit-normal inputs, so atol 3e-2 alone would let a
# wrong key/value tile through; this bound does not.
FLASH_SCALED_TOL = {torch.bfloat16: (1e-3, 2 ** -7),
                    torch.float16: (1.25e-4, 2 ** -10)}
LM_F32_ATOL = 5e-4
# glm4-9b bfloat16 scoring logits (flash route) against the prefill logits
# (plain route, float32 attention) after 40 layers: the largest difference
# allowed, and every request's next token must agree.  Both routes keep
# float32 probabilities; 40 bfloat16 layers that sum in other orders move
# the logits (|logit| < 8, bfloat16 steps of 2^-5 there) by about three
# steps (0.0898 and 0.0957 measured, PERF.md).  2^-3 is four steps.
LM_BF16_LOGIT_ATOL = 0.125
# Prompt seeds of the logit-spread measurement (flash bodies and SDPA
# against the plain route on the same glm4-9b weights).
LM_SPREAD_SEEDS = (0, 1, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_launches() -> None:
    for k in KERNELS:
        setattr(k["ops"], k["counter"], 0)
        for body in getattr(k["ops"], "LAUNCHES_BY_BODY", {}):
            k["ops"].LAUNCHES_BY_BODY[body] = 0


def read_launches() -> dict:
    return {k["name"]: getattr(k["ops"], k["counter"]) for k in KERNELS}


def require_launches(path: str, launches: dict) -> None:
    for k in KERNELS:
        if path in k["paths"] and launches[k["name"]] <= 0:
            raise AssertionError(f"kernel {k['name']} was not launched on "
                                 f"the {path} path")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def build_all() -> float:
    """Compile every kernel library from the checkout's sources, one nvcc
    per library, all started together."""
    libs = {(k["ops"].__name__.split(".")[-2], k["ops"].SOURCES)
            for k in KERNELS}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: _build.load(*lib), libs))
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

def pareto_case(n: int, k: int, seed: int, device, layout="uniform"):
    """One (n, k) segment of :func:`segments_case`."""
    F, valid = segments_case(1, n, k, seed, device, layout)
    return F[0], valid[0]


def segments_case(S: int, n: int, k: int, seed: int, device,
                  layout="uniform"):
    """(S, n, k) f32 objectives, ~10% invalid rows, some +inf rows.
    ``uniform``: uniform in [0, 10)^k.  ``front``: near the surface
    sum(F) = 10 with a small jitter, anti-correlated objectives like a bank
    of predictions.  For S > 2 segment 1 is ragged (its tail padded with
    invalid +inf rows); for S > 1 the last segment is all invalid."""
    rng = np.random.default_rng(seed)
    if layout == "front":
        F = rng.dirichlet(np.ones(k), (S, n)) * 10 \
            + rng.random((S, n, k)) * 1e-3
    else:
        F = rng.random((S, n, k)) * 10
    F = F.astype(np.float32)
    F[rng.random((S, n)) < 0.05] = np.inf
    valid = (rng.random((S, n)) > 0.1) & np.isfinite(F).all(-1)
    if S > 2:
        F[1, n // 3:] = np.inf
        valid[1, n // 3:] = False
    if S > 1:
        valid[-1] = False
    return (torch.from_numpy(F).to(device), torch.from_numpy(valid).to(device))


def time_cuda(fn, iters: int, warm: int = 20) -> float:
    """Milliseconds per call, CUDA events around ``iters`` warm calls."""
    for _ in range(warm):
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


def device_us_per_call(fn, names, iters: int = 200):
    """Mean device time (µs) one call of ``fn`` spends in kernels whose
    name contains one of ``names`` (profiler); None if the trace has
    none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages()
                if any(n in e.key for n in names))
    return total / iters if total > 0 else None


def host_ms(fn, iters: int, warm: int = 5) -> float:
    """Milliseconds per call on the host's clock, each call ending on the
    host (a readback or a synchronisation), after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def count_syncs(fn):
    """(fn's result, the host synchronisations it made): PyTorch's sync
    debug mode, on only during the call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def device_busy_ms(fn) -> float:
    """Milliseconds the card spent in kernels (summed over every kernel of a
    torch.profiler trace) during one call of ``fn``; set against the call's
    untraced wall time it gives the card's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.3f} us"


def bound_ms(n_bytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least time for the card: bytes over HBM rate vs operations over
    the rate of their type (float32 unless given), whichever is larger, and
    which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pareto_bound_ms(F: torch.Tensor, valid: torch.Tensor, mask: torch.Tensor):
    """Bytes: F read once (f32), valid read once, the mask written once.
    Compares: 2k per pair test within a segment; a surviving row must be
    tested against every valid row of its segment, a dominated one needs
    only its dominator.  F is (n, k) or (S, n, k)."""
    k = F.shape[-1]
    rows = F.numel() // k
    V = valid.reshape(-1, valid.shape[-1]).sum(-1).double()
    S = mask.reshape(-1, mask.shape[-1]).sum(-1).double()
    return bound_ms(rows * k * 4 + rows + rows,
                    2 * k * float((S * V + (V - S)).sum()))


def check_pareto_filter(device) -> dict:
    """The kernel against its plain version, exactly: single masks (S = 1)
    at CHECK_SHAPES, then the segmented launch at SEGMENT_SHAPES (one launch
    each); then the SEGMENT_TIMINGS cases timed."""
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
    for i, (S, n, k) in enumerate(SEGMENT_SHAPES):
        for layout in ("uniform", "front"):
            F, valid = segments_case(S, n, k, seed=300 + i, device=device,
                                     layout=layout)
            l0 = pareto_ops.LAUNCHES
            got = pareto_ops.pareto_filter_segments(F, valid)
            torch.cuda.synchronize()
            if pareto_ops.LAUNCHES != l0 + 1:
                raise AssertionError("pareto_filter_segments made "
                                     f"{pareto_ops.LAUNCHES - l0} launches")
            want = pareto_masks_ref(F, valid)
            err = int((got.to(torch.int32)
                       - want.to(torch.int32)).abs().max())
            if err != 0 or (S > 1 and bool(got[-1].any())):
                raise AssertionError(f"pareto_filter_segments disagrees with "
                                     f"its plain version at (S, n, k)="
                                     f"{(S, n, k)} ({layout})")
            log(f"[kernels] pareto_filter_segments == plain version at "
                f"(S, n, k)={(S, n, k)} ({layout}), one launch: survivors "
                f"{int(want.sum())}/{S * n}")
    log(f"[kernels] pareto_filter == plain version on {len(CHECK_SHAPES)} "
        f"single masks and {2 * len(SEGMENT_SHAPES)} segmented launches "
        "(exact)")
    for S, n, k, layout in SEGMENT_TIMINGS:
        F, valid = segments_case(S, n, k, seed=7, device=device,
                                 layout=layout)
        measure_pareto_filter(F, valid, f"(S, n, k)={(S, n, k)} ({layout})")
    return {"max_abs_err": float(worst)}


def measure_pareto_filter(F: torch.Tensor, valid: torch.Tensor,
                          label: str) -> dict:
    """One segmented launch on (S, n, k) inputs: per call (events), the
    kernel alone (profiler), the plain version, and the bound."""
    call = (lambda: pareto_ops.pareto_filter_segments(F, valid))
    mask = call()
    err = int((mask.to(torch.int32) - pareto_masks_ref(F, valid).to(
        torch.int32)).abs().max())
    if err != 0:
        raise AssertionError(f"pareto_filter_segments disagrees with its "
                             f"plain version at {label}")
    ms = time_cuda(call, 2000)
    big = F.shape[0] * F.shape[1] ** 2 > 1 << 24
    plain = time_cuda(lambda: pareto_masks_ref(F, valid), 20 if big else 200,
                      warm=3 if big else 20)
    bound, by = pareto_bound_ms(F, valid, mask)
    dev = device_us(call, "pareto_filter_kernel")
    log(f"[kernels] pareto_filter {label}: {ms:.6f} ms per call (events), "
        f"kernel alone {fmt_us(dev)} (profiler), plain {plain:.6f} ms, "
        f"bound {bound:.9f} ms ({by}), survivors "
        f"{int(mask.sum())}/{mask.numel()}")
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "kernel_us": dev, "shape": list(F.shape)}


def measure_crossover(device) -> dict:
    """Host wall time of one mask by the float64 numpy route and by the
    kernel route (tie check, staging, one copy in, one launch, one copy
    out), at each CROSSOVER_N, k = 2, and of a banks phase (50 banks of
    256) by each route.  Reports the least n at which the launch wins; the
    routing default is not changed here."""
    rng = np.random.default_rng(21)
    saved = pareto_core._KERNEL_MIN_N
    pareto_core._KERNEL_MIN_N = 0
    rows, cross = [], None
    try:
        for n in CROSSOVER_N:
            F = (rng.random((n, 2)) * 10).astype(np.float32).astype(
                np.float64)
            np_ms = host_ms(lambda: pareto_core.pareto_mask_np(F), 300)
            k_ms = host_ms(lambda: pareto_core.pareto_masks_fast(
                [F], device=device), 300)
            rows.append({"n": n, "numpy_ms": np_ms, "kernel_route_ms": k_ms})
            if cross is None and k_ms < np_ms:
                cross = n
        banks = [(rng.random((256, 2)) * 10).astype(np.float32).astype(
            np.float64) for _ in range(50)]
        phase_np = host_ms(lambda: [pareto_core.pareto_mask_np(F)
                                    for F in banks], 30)
        phase_k = host_ms(lambda: pareto_core.pareto_masks_fast(
            banks, device=device), 30)
    finally:
        pareto_core._KERNEL_MIN_N = saved
    for r in rows:
        log(f"[crossover] n={r['n']} k=2: float64 numpy {r['numpy_ms']:.6f}"
            f" ms, kernel route {r['kernel_route_ms']:.6f} ms per mask "
            "(host clock)")
    log(f"[crossover] 50 banks of (256, 2): float64 numpy {phase_np:.6f} ms "
        f"(50 masks), kernel route {phase_k:.6f} ms (one launch)")
    log(f"[crossover] the single launch beats float64 numpy from n = "
        f"{cross if cross is not None else 'none of ' + str(CROSSOVER_N)}; "
        "REPRO_PARETO_KERNEL_MIN_N's default is unchanged (0 on cuda)")
    return {"rows": rows, "crossover_n": cross, "phase_numpy_ms": phase_np,
            "phase_kernel_route_ms": phase_k}


def ws_case(m: int, B: int, k: int, nw: int, seed: int, device):
    """Uniform f32 banks with two padded (+inf) slots each; from the third
    bank on, bank 0 holds padding alone and the last bank an exact score
    tie at its minimum (rows 1 and 3 both zero)."""
    rng = np.random.default_rng(seed)
    F = rng.random((m, B, k)).astype(np.float32)
    F[:, -2:] = np.inf
    if m > 2:
        F[0] = np.inf
        F[-1, 1] = F[-1, 3] = 0.0
    W = rng.random((nw, k)).astype(np.float32)
    return torch.from_numpy(F).to(device), torch.from_numpy(W).to(device)


def measure_ws_reduce(F: torch.Tensor, W: torch.Tensor, label: str) -> dict:
    """The kernel on the banks as float64 (what HMOOC2 passes; the kernel
    casts and sanitises each element) and as float32:
    indices exact, values within rtol 1e-5 of the plain version (after the
    host-side cast and nan_to_num); its time per call on each (events) and
    alone on float64 (profiler), the plain version's, one einsum + min
    library call's on the prepared float32 banks, and the bound (float64
    banks read once)."""
    m, B, k = F.shape
    nw = W.shape[0]
    F32 = torch.nan_to_num(F.to(torch.float32), posinf=1e30)
    W32 = W.to(torch.float32)
    rv, ri = ws_reduce_ref(F32, W32)
    err, ms = 0.0, {}
    for dt in (torch.float64, torch.float32):
        Fd, Wd = F.to(dt), W.to(dt)
        vals, idx = ws_ops.ws_reduce(Fd, Wd)
        torch.cuda.synchronize()
        if not torch.equal(idx, ri):
            raise AssertionError(f"ws_reduce indices differ from the plain "
                                 f"version ({label}, {dt})")
        if not torch.allclose(vals, rv, rtol=1e-5, atol=0.0):
            raise AssertionError(f"ws_reduce values differ from the plain "
                                 f"version ({label}, {dt})")
        err = max(err, float((vals - rv).abs().max()))
        ms[dt] = time_cuda(lambda: ws_ops.ws_reduce(Fd, Wd), 2000)
    F64, W64 = F.to(torch.float64), W.to(torch.float64)
    plain = time_cuda(lambda: ws_reduce_ref(F32, W32), 200)
    lib = time_cuda(lambda: torch.min(
        torch.einsum("wk,mbk->wmb", W32, F32), dim=-1), 200)
    dev = device_us(lambda: ws_ops.ws_reduce(F64, W64), "ws_reduce_kernel")
    bound, by = bound_ms(m * B * k * 8 + nw * k * 8 + nw * m * 8,
                         2 * k * nw * m * B)
    log(f"[kernels] ws_reduce (m, B, k, nw)={(m, B, k, nw)} ({label}) == "
        f"plain version (indices exact, max |dv| {err:.3g}): float64 banks "
        f"{ms[torch.float64]:.6f} ms per call (events), kernel alone "
        f"{fmt_us(dev)} (profiler); float32 banks "
        f"{ms[torch.float32]:.6f} ms; plain {plain:.6f} ms, library "
        f"einsum+min {lib:.6f} ms, bound {bound:.9f} ms ({by})")
    return {"max_abs_err": err, "ms": ms[torch.float64],
            "ms_float32_banks": ms[torch.float32], "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "kernel_us": dev, "shape": [m, B, k, nw]}


def check_ws_reduce(device) -> float:
    """Every WS_SHAPES case, padding-only banks and exact ties included,
    as float64 and float32 banks."""
    worst = 0.0
    for i, (m, B, k, nw) in enumerate(WS_SHAPES):
        F, W = ws_case(m, B, k, nw, seed=200 + i, device=device)
        worst = max(worst, measure_ws_reduce(F, W, "synthetic")
                    ["max_abs_err"])
        if m > 2:
            _, idx = ws_ops.ws_reduce(F, W)
            if not ((idx[:, 0] == 0).all() and (idx[:, -1] == 1).all()):
                raise AssertionError("ws_reduce: padding or tie rule broken")
    log(f"[kernels] ws_reduce == plain version on {len(WS_SHAPES)} cases "
        "(padding-only banks and exact ties included)")
    return worst


def runtime_ws_bank(device, seed: int = 210):
    """A float64 bank shaped as the composed route's largest runtime pick
    (WS_TIMED_SHAPE): min-max normalised rows of 31 sets, 2-5 kept rows
    each, the rest of each set's slots padded with 1e18 as the numpy route
    pads them, and one weight row."""
    m, B, k, nw = WS_TIMED_SHAPE
    rng = np.random.default_rng(seed)
    F = np.full((m, B, k), 1e18)
    for i in range(m):
        n = rng.integers(2, B + 1)
        F[i, :n] = rng.dirichlet(np.ones(k), n)
    W = np.tile(WEIGHTS, (nw, 1))
    return torch.from_numpy(F).to(device), torch.from_numpy(W).to(device)


def staged_pick(Fs, w, thresholds, device):
    """The round staged on the card as the caller stages it, and a call of
    the wrapper on it."""
    Fs = [np.asarray(F, np.float64) for F in Fs]
    staged = runtime_core._stage_round(Fs, np.asarray(w, np.float64), device)
    max_n = max(len(F) for F in Fs)
    return staged, (lambda: ws_ops.runtime_pick(
        *staged, kernel_min_n=thresholds[0], ws_min_scores=thresholds[1],
        max_n=max_n))


def check_pick(Fs, w, thresholds, device, label: str) -> None:
    """One call against the plain version on the same staged tensors:
    picks and routes exactly equal, one launch."""
    staged, call = staged_pick(Fs, w, thresholds, device)
    l0 = ws_ops.RUNTIME_PICK_LAUNCHES
    got = call()
    torch.cuda.synchronize()
    if ws_ops.RUNTIME_PICK_LAUNCHES != l0 + 1:
        raise AssertionError(f"runtime_pick made "
                             f"{ws_ops.RUNTIME_PICK_LAUNCHES - l0} launches")
    want = runtime_pick_ref(*staged, *thresholds)
    if not torch.equal(got, want):
        raise AssertionError(f"runtime_pick differs from its plain version "
                             f"({label}, thresholds {thresholds}): "
                             f"{got.tolist()} against {want.tolist()}")


def check_runtime_pick(device) -> float:
    """The planted cases of the CPU parity tests (shared and per-set
    weights) under each of PICK_THRESHOLDS, and rounds past the kernel's
    shared-memory budget at k = 2 and 8; exact, so the error is 0."""
    n = 0
    for name, make in sorted(PICK_CASES.items()):
        Fs = make()
        for per_set in (False, True):
            for thr in PICK_THRESHOLDS:
                check_pick(Fs, case_weights(name, per_set, len(Fs)), thr,
                           device, name)
                n += 1
    # Rows counted before every dominance scan ends would raise B_g: with
    # the float32 route from 4 R_g + 1 scores (each set keeps 4 rows) the
    # route flips.  The race depends on timing, hence 200 calls.
    Fs = PICK_CASES["late_dominators"]()
    for _ in range(200):
        check_pick(Fs, WEIGHTS, (0, 4 * len(Fs) + 1), device,
                   "late dominators")
    for k in (2, 8):
        Fs, w = budget_round(k)
        for thr in PICK_THRESHOLDS[:2]:
            check_pick(Fs, w, thr, device, f"past the budget, k={k}")
            n += 1
        log(f"[kernels] runtime_pick == plain version on a round past the "
            f"shared-memory budget: sets of {[len(F) for F in Fs]} rows, "
            f"k={k}")
    log(f"[kernels] runtime_pick == plain version on {n} rounds: "
        f"{len(PICK_CASES)} planted cases x shared and per-set weights x "
        f"{len(PICK_THRESHOLDS)} thresholds, and 4 past the budget, and "
        "200 calls on sets that race a kept count taken early (picks and "
        "routes exact)")
    return 0.0


def runtime_pick_bound_ms(Fs, G: int, thresholds):
    """Bytes: the round's float64 sets, offsets, group ids and weights read
    once, picks and routes written once.  Operations: min and max (2 per
    value); the dominance tests, 2k per pair as for pareto_filter (a
    surviving row against every finite row of its set, a dominated one
    against its dominator), for sets of at least kernel_min_n rows; the
    normalisation (2 per kept value) and both scores (4 per kept value).
    At the float32 rate of the table."""
    R, k = len(Fs), Fs[0].shape[1]
    total = sum(len(F) for F in Fs)
    ops = 0
    for F in Fs:
        X = torch.from_numpy(np.asarray(F, np.float64))
        keep, _ = kept_normalised(X, thresholds[0])
        ops += 2 * X.numel() + 6 * len(keep) * k
        if len(F) >= thresholds[0]:
            V = int(torch.isfinite(X).all(-1).sum())
            S = len(keep) if len(keep) < len(F) else V
            ops += 2 * k * (S * V + (V - S))
    return bound_ms(total * k * 8 + (2 * R + 1) * 4 + G * k * 8
                    + (R + G) * 4, ops)


def measure_runtime_pick(device, Fs, w, label: str) -> dict:
    """At one round (``Fs``, ``w``): the plain version's answer and the
    composed route's picks checked; the wrapper per call on the
    staged round (events), both kernels alone (profiler), the plain
    version on the card, the caller's whole pick (``weighted_pick_batch``:
    staging, one copy in, the C call, the readback and its one
    synchronisation) against the composed route it replaces
    (``_pick_composed`` on the card: ``pareto_masks_fast``, numpy
    normalisation and ``ws_reduce``), host clock, in turns, with each
    one's host synchronisations; and the bound."""
    Fs = [np.asarray(F, np.float64) for F in Fs]
    w = np.asarray(w, np.float64)
    thr = runtime_core._pick_thresholds(device)
    staged, call = staged_pick(Fs, w, thr, device)
    got = call()
    if not torch.equal(got, runtime_pick_ref(*staged, *thr)):
        raise AssertionError(f"runtime_pick differs from its plain version "
                             f"({label})")
    new, syncs = count_syncs(
        lambda: runtime_core.weighted_pick_batch(Fs, w, device=device))
    old, old_syncs = count_syncs(
        lambda: runtime_core._pick_composed(Fs, w, device))
    if new != old or new != got[:len(Fs)].tolist():
        raise AssertionError(f"the card route picks {new}, the composed "
                             f"route {old} ({label})")
    ms = time_cuda(call, 2000)
    dev = device_us_per_call(call, ("pick_sets_kernel",
                                    "pick_groups_kernel"))
    plain = time_cuda(lambda: runtime_pick_ref(*staged, *thr), 20, warm=3)
    turns = []
    for fn in ("composed", "whole", "whole", "composed"):
        turns.append(host_ms(
            (lambda: runtime_core._pick_composed(Fs, w, device))
            if fn == "composed" else
            (lambda: runtime_core.weighted_pick_batch(Fs, w, device=device)),
            300))
    G = staged[3].shape[0]
    bound, by = runtime_pick_bound_ms(Fs, G, thr)
    routes = got[len(Fs):].tolist()
    log(f"[kernels] runtime_pick at the {label} ({len(Fs)} sets of "
        f"{min(map(len, Fs))}-{max(map(len, Fs))} rows, k={Fs[0].shape[1]}, "
        f"{G} weight groups, routes {routes}) == plain version, picks equal "
        f"to the composed route's: {ms:.6f} ms per call (events), both "
        f"kernels {fmt_us(dev)} a call (profiler), plain {plain:.6f} ms, "
        f"bound {bound:.9f} ms ({by}); library: none (no single PyTorch call "
        "prefilters, normalises and picks)")
    log(f"[kernels] runtime_pick: the whole pick (weighted_pick_batch) "
        f"{turns[1]:.6f} / {turns[2]:.6f} ms, {syncs} host sync; the "
        f"composed route {turns[0]:.6f} / {turns[3]:.6f} ms, "
        f"{old_syncs} host syncs (host clock, composed, whole, whole, "
        "composed)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "kernel_us": dev, "whole_pick_ms": turns[1:3],
            "composed_route_ms": [turns[0], turns[3]],
            "host_syncs": syncs, "composed_host_syncs": old_syncs,
            "shape": {"sets": len(Fs), "rows": sum(map(len, Fs)),
                      "k": int(Fs[0].shape[1]), "groups": G}}


def measure_pick_crossover(device) -> list:
    """One round of R sets of 64 rows (R in PICK_CROSSOVER_R, one weight
    row) by the card route and by the host's float64 route (the CPU
    defaults: no prefilter, numpy argmin), host clock.  The routing
    defaults are not changed here."""
    rng = np.random.default_rng(22)
    rows = []
    for R in PICK_CROSSOVER_R:
        Fs = [rng.random((64, 2)) * 10 for _ in range(R)]
        w = np.tile(WEIGHTS, (R, 1))
        same = runtime_core.weighted_pick_batch(Fs, w, device=device) == \
            runtime_core.weighted_pick_batch(Fs, w, device="cpu")
        card = host_ms(lambda: runtime_core.weighted_pick_batch(
            Fs, w, device=device), 300)
        host = host_ms(lambda: runtime_core.weighted_pick_batch(
            Fs, w, device="cpu"), 300)
        rows.append({"sets": R, "card_ms": card, "host_float64_ms": host,
                     "same_picks": same})
        log(f"[crossover] runtime pick, {R} sets of (64, 2): card route "
            f"{card:.6f} ms, host float64 route {host:.6f} ms per round "
            f"(host clock; same picks: {same})")
    return rows


def fused_case(N: int, m: int, B: int, k: int, nw: int, seed: int):
    """The reference's parity-case layout: uniform banks, the last slot of
    every bank and one more of the first padded (+inf), per-candidate
    normalized scores; from N > 2, m > 1 on a subQ of candidate 2 holds
    padding alone (that candidate can never be valid)."""
    rng = np.random.default_rng(seed)
    Fb = rng.random((N, m, B, k))
    if B > 2:
        Fb[:, :, -1] = np.inf
        Fb[0, 0, -2] = np.inf
    if N > 2 and m > 1:
        Fb[2, 1] = np.inf
    W = np.stack([np.linspace(0.05, 0.95, nw),
                  1.0 - np.linspace(0.05, 0.95, nw)], -1) if k == 2 \
        else rng.dirichlet(np.ones(k), nw)
    return hmooc._hmooc2_normalize(Fb), Fb, W


def host_scores(Fb: np.ndarray) -> np.ndarray:
    """The solver's float32 scores, normalised on the host in float64."""
    with np.errstate(over="ignore", invalid="ignore"):
        return np.nan_to_num(hmooc._hmooc2_normalize(Fb).astype(np.float32),
                             posinf=1e30)


def fused_plain(Fn, Fb, W, device):
    """The plain version on the card: on ``Fn`` or, for ``Fn=None``, on
    the host-normalised scores of the bank."""
    Fn = host_scores(Fb) if Fn is None else Fn
    return [t.cpu().numpy() for t in fused_ws_front_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (Fn, Fb, W)))]


def fused_card(Fn, Fb, W, device):
    """The wrapper on the card (the bank already staged there), read back."""
    return [t.cpu().numpy() for t in fused_ops.fused_ws_front(
        Fn, torch.from_numpy(np.ascontiguousarray(Fb)).to(device), W,
        device=device)]


def check_fused_case(Fn, Fb, W, device, label: str) -> float:
    """Given scores and ``Fn=None`` (normalised in the kernel), each
    against the plain version: picks and mask exact, sums within rtol
    1e-12, nothing invalid kept, one launch of each kernel a call."""
    worst = 0.0
    for given in (Fn, None):
        l0 = fused_ops.LAUNCHES, pareto_ops.LAUNCHES
        jj, P_all, keep = fused_card(given, Fb, W, device)
        if (fused_ops.LAUNCHES, pareto_ops.LAUNCHES) != (l0[0] + 1,
                                                         l0[1] + 1):
            raise AssertionError("fused_ws_front did not launch each kernel "
                                 f"once ({label})")
        jr, Pr, kr = fused_plain(given, Fb, W, device)
        how = "Fn=None" if given is None else "Fn given"
        if not (np.array_equal(jj, jr) and np.array_equal(keep, kr)):
            raise AssertionError(f"fused_solve picks or mask differ from the "
                                 f"plain version ({label}, {how})")
        fin = np.isfinite(Pr)
        if not (np.array_equal(fin, np.isfinite(P_all))
                and np.allclose(P_all[fin], Pr[fin], rtol=1e-12, atol=0.0)):
            raise AssertionError(f"fused_solve sums differ from the plain "
                                 f"version ({label}, {how})")
        if not np.isfinite(P_all[keep]).all():
            raise AssertionError(f"fused_solve kept an invalid point "
                                 f"({label}, {how})")
        if fin.any():
            worst = max(worst, float(np.abs(P_all[fin] - Pr[fin]).max()))
    return worst


def check_fused_solve(device) -> float:
    """Every FUSED_SHAPES case, checked and timed; the normalisation's edge
    cases; banks past the kernel's shared-memory budget (FUSED_TILED)."""
    worst = 0.0
    for i, shape in enumerate(FUSED_SHAPES):
        worst = max(worst, measure_fused_solve(
            *fused_case(*shape, seed=300 + i), device,
            "synthetic")["max_abs_err"])
    Fn, Fb, W = fused_case(9, 4, 12, 2, 11, seed=310)
    Fb[3] = np.inf                          # no finite entry
    Fb[4, :, :, 1] = 2.5                    # a constant objective
    Fb[5, 1, 2, 0] = np.nan
    Fb[6, :, :, 0] *= 1e300                 # huge values, float32 overflow
    worst = max(worst, check_fused_case(host_scores(Fb), Fb, W, device,
                                        "edge cases"))
    for i, shape in enumerate(FUSED_TILED):
        worst = max(worst, check_fused_case(
            *fused_case(*shape, seed=320 + i), device,
            f"tiled bank {shape}"))
    log(f"[kernels] fused_solve == plain version on {len(FUSED_SHAPES)} "
        f"cases, the normalisation's edge cases and {len(FUSED_TILED)} "
        "banks past the shared-memory budget, with given scores and with "
        "Fn=None (picks and mask exact, sums within rtol 1e-12)")
    return worst


def check_tie_flag(device, recorded) -> None:
    """The router's on-card tie flag against ``_f32_tie_hazard``: on a
    planted tie and on every bank the HMOOC2 batch checked (``recorded``:
    (staged rows, flag) pairs)."""
    rng = np.random.default_rng(330)
    X = (rng.random((72576, 2)) * 10).astype(np.float32).astype(np.float64)
    X[::9] = np.inf
    for planted in (False, True):
        if planted:
            X[60000, 1] = X[17, 1] + 1e-12
        got = bool(pareto_core._f32_tie_hazard_tensor(
            torch.from_numpy(X).to(device)))
        if got != pareto_core._f32_tie_hazard(X) or got != planted:
            raise AssertionError(f"on-card tie flag {got} on a bank with"
                                 f"{'' if planted else 'out'} a planted tie")
    for F, flag in recorded:
        if bool(flag) != pareto_core._f32_tie_hazard(F.cpu().numpy()):
            raise AssertionError("the on-card tie flag differs from "
                                 "_f32_tie_hazard on a bank of the HMOOC2 "
                                 "batch")
    log(f"[check] on-card tie flag == _f32_tie_hazard on a planted tie and "
        f"on all {len(recorded)} banks of the HMOOC2 batch "
        f"({sum(bool(f) for _, f in recorded)} with a hazard)")


def fused_bound_ms(Fb, W, jj, keep, valid, normalise: bool = True):
    """Bytes: the raw bank read once (f64), W once (f64), and jj, P_all
    and keep written once; with ``normalise=False`` (the earlier count,
    for the kernel that took host-normalised scores, kept beside it) Fn
    read once (f32), W (f32) and only the picked raw rows (distinct
    (candidate, subQ, row) triples) instead of the whole bank.
    Operations: the normalisation (a min and a max compare, a subtract and
    a divide per element), 2k per weighted score and its compare, the
    float64 sums, 2k per local pair test among each candidate's valid
    picks, and the global filter's pair tests as for pareto_filter.  All
    at the float32 rate of the table."""
    N, m, B, k = Fb.shape
    nw = W.shape[0]
    rows = (np.arange(N)[:, None, None] * m
            + np.arange(m)[None, None, :]) * B + jj
    out_bytes = jj.size * 4 + N * nw * k * 8 + N * nw
    n_bytes = (Fb.size * 8 if normalise
               else Fb.size * 4 + np.unique(rows).size * k * 8) \
        + W.size * (8 if normalise else 4) + out_bytes
    V = int(valid.sum())
    S = int(keep.sum())
    ops = (4 * Fb.size * normalise + 2 * k * nw * N * m * B
           + N * nw * m * k + 2 * k * nw * nw * N + 2 * k * (S * V + (V - S)))
    return bound_ms(n_bytes, ops)


def measure_fused_solve(Fn, Fb, W, device, label: str) -> dict:
    """Check one case, then time it with the bank normalised in the kernel
    (``Fn=None``): the wrapper per call on a bank staged on the card
    (events; what the solver pays besides the staging and the readback),
    the wrapper with numpy in and out (Fn given, as the earlier kernel's
    callers used it), each kernel alone (profiler), the plain version on
    the card (normalisation included), and the bound beside the earlier
    count."""
    err = check_fused_case(Fn, Fb, W, device, label)
    Fb_d = torch.from_numpy(np.ascontiguousarray(Fb)).to(device)
    W_d = torch.from_numpy(np.ascontiguousarray(W)).to(device)
    call = (lambda: fused_ops.fused_ws_front(None, Fb_d, W_d, device=device))
    jj, P_all, keep = (t.cpu().numpy() for t in call())
    G = np.asarray(Fb)[np.arange(Fb.shape[0])[:, None, None],
                       np.arange(Fb.shape[1])[None, None, :], jj]
    ok = np.isfinite(G).all(axis=(2, 3))
    valid = ok & local_mask_ref(torch.from_numpy(P_all),
                                torch.from_numpy(ok)).numpy()
    ms = time_cuda(call, 500)
    ms_numpy = time_cuda(lambda: [t.cpu() for t in fused_ops.fused_ws_front(
        Fn, Fb, W, device=device)], 200)
    plain = time_cuda(lambda: fused_ws_front_ref(None, Fb_d, W_d), 50)
    dev = device_us(call, "fused_ws_front_kernel")
    dev_k1 = device_us(call, "pareto_filter_kernel")
    bound, by = fused_bound_ms(np.asarray(Fb), W, jj, keep, valid)
    old_bound, old_by = fused_bound_ms(np.asarray(Fb), W, jj, keep, valid,
                                       normalise=False)
    log(f"[kernels] fused_solve (N, m, B, k, nw)="
        f"{Fb.shape + (W.shape[0],)} ({label}) == plain version "
        f"(max |dP| {err:.3g}): {ms:.6f} ms per call (events, Fn=None, "
        f"tensors on the card), {ms_numpy:.6f} ms per call with numpy in "
        f"and out; fused kernel alone {fmt_us(dev)}, its pareto_filter "
        f"launch {fmt_us(dev_k1)} (profiler), plain {plain:.6f} ms, bound "
        f"{bound:.9f} ms ({by}; the earlier count {old_bound:.9f} ms, "
        f"{old_by}), kept {int(keep.sum())}/{keep.size}; library: none (no "
        "single PyTorch call makes the picks, the gather, the sums and both "
        "dominance masks)")
    return {"max_abs_err": err, "ms": ms, "ms_numpy_in_out": ms_numpy,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "bound_ms_scores_given": old_bound, "library_ms": None,
            "kernel_us": dev, "pareto_us": dev_k1}


def measure_aggregation(device, args) -> dict:
    """Host wall time of one whole HMOOC2 aggregation on the caller's side
    (``dag_aggregate``'s hmooc2 branch: staging, tie check, K3 and K1,
    readback, gathers) on ``args``, the batch's largest bank."""
    Uc, pool, F_bank, idx_bank = args

    def agg():
        return hmooc.dag_aggregate(Uc, pool, F_bank, idx_bank, "hmooc2",
                                   device=device)

    for _ in range(10):
        agg()
    torch.cuda.synchronize()
    n = 100
    t0 = time.perf_counter()
    for _ in range(n):
        agg()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    log(f"[kernels] fused_solve: one whole HMOOC2 aggregation at the "
        f"largest bank {tuple(F_bank.shape)}: {ms:.6f} ms (host clock, "
        "staging, tie check, both kernels, readback and gathers)")
    return {"aggregation_ms": ms}


def flash_case(B, Hq, Hkv, Sq, Skv, D, dtype, seed: int, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=dtype)
        for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    """Bytes: q, k, v read once, o written once.  Operations: the two
    products, 2·D each per (query, key) pair that this mask lets through
    (query t sees keys ≤ t + Skv − Sq when causal), at the tensor-core rate
    for 16-bit inputs and the float32 rate for float32."""
    elt = torch.tensor([], dtype=dtype).element_size()
    t = np.arange(Sq)
    pairs = (int(np.minimum(Skv, t + Skv - Sq + 1).clip(0).sum()) if causal
             else Sq * Skv)
    rate = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    return bound_ms(elt * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv),
                    4 * D * pairs * B * Hq, rate)


def sdpa(q, k, v, causal: bool):
    """The library call for the same function: PyTorch's fused attention,
    with the causal mask aligned at the ends as the kernel aligns it."""
    Sq, Skv = q.shape[2], k.shape[2]
    mask = None
    if causal and Sq != Skv:
        qi = torch.arange(Sq, device=q.device)[:, None]
        mask = torch.arange(Skv, device=q.device)[None, :] <= qi + Skv - Sq
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=q.shape[1] != k.shape[1])


def scaled_excess(got: torch.Tensor, want32: torch.Tensor, dtype) -> float:
    """max(|got − want| − r·|want|) over the elements, r from
    FLASH_SCALED_TOL: the least a for which the scaled bound holds."""
    r = FLASH_SCALED_TOL[dtype][1]
    return float(((got.float() - want32).abs() - r * want32.abs()).max())


def check_flash_attention(device) -> dict:
    """Every FLASH_SHAPES case against the plain version on the card,
    within FLASH_ATOL (and FLASH_SCALED_TOL for 16-bit), then timed: the
    wrapper per call (events), the kernel alone (profiler), the plain
    version, SDPA, and the bound."""
    worst, entry = 0.0, None
    for i, (B, Hq, Hkv, Sq, Skv, D, causal, dtype) in enumerate(FLASH_SHAPES):
        q, k, v = flash_case(B, Hq, Hkv, Sq, Skv, D, dtype, 400 + i, device)
        got = flash_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want32 = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        want = want32.to(dtype)  # what attention_ref(q, k, v) returns
        err = float((got.float() - want.float()).abs().max())
        excess = (scaled_excess(got, want32, dtype)
                  if dtype in FLASH_SCALED_TOL else None)
        if excess is not None:
            log(f"[kernels] flash_attention {FLASH_SHAPES[i]}: max |d| "
                f"{err:.6g} against the rounded plain version; against its "
                f"float32 output max(|d| - r|want|) = {excess:.6g} (r "
                f"{FLASH_SCALED_TOL[dtype][1]:.6g}, a "
                f"{FLASH_SCALED_TOL[dtype][0]:.6g})")
        if not err <= FLASH_ATOL[dtype]:
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version by {err:.3g} at {FLASH_SHAPES[i]}")
        if excess is not None and not excess <= FLASH_SCALED_TOL[dtype][0]:
            raise AssertionError(
                f"flash_attention differs from its plain version by more "
                f"than a + r|want| at {FLASH_SHAPES[i]}: max(|d| - r|want|) "
                f"= {excess:.3g} > a = {FLASH_SCALED_TOL[dtype][0]}")
        worst = max(worst, err)
        big = Sq * Skv * B * Hq > 1 << 26
        iters = 10 if big else 200
        call = (lambda: flash_ops.flash_attention(q, k, v, causal=causal))
        ms = time_cuda(call, iters, warm=3 if big else 20)
        body = flash_ops._body(dtype, D)
        dev = device_us(call, FLASH_KERNEL_NAMES[body], 5 if big else 200)
        plain = time_cuda(lambda: attention_ref(q, k, v, causal=causal),
                          3 if big else 50, warm=2)
        lib = time_cuda(lambda: sdpa(q, k, v, causal), iters,
                        warm=3 if big else 20)
        bound, by = flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, dtype)
        log(f"[kernels] flash_attention (B, Hq, Hkv, Sq, Skv, D)="
            f"{(B, Hq, Hkv, Sq, Skv, D)} causal={causal} {dtype} {body} "
            f"body == plain version (max |d| {err:.3g}): {ms:.6f} ms per "
            "call (events), "
            f"kernel alone {fmt_us(dev)} (profiler), plain {plain:.6f} ms, "
            f"library SDPA {lib:.6f} ms, bound {bound:.9f} ms ({by})")
        if FLASH_SHAPES[i] == FLASH_LM_SHAPE:
            entry = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib, "kernel_us": dev,
                     "body": body, "shape": [B, Hq, Hkv, Sq, Skv, D]}
        del q, k, v, got, want, want32
    log(f"[kernels] flash_attention == plain version on {len(FLASH_SHAPES)} "
        f"cases (float32 within {FLASH_ATOL[torch.float32]}, bfloat16 and "
        f"float16 within {FLASH_ATOL[torch.bfloat16]} and within a + r|want| "
        f"of the float32 output: {FLASH_SCALED_TOL})")
    return {"max_abs_err": worst, **entry}


# ---------------------------------------------------------------------------
# Phase 3: the port's paths
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


def warm_up(device, cfg: HMOOCConfig):
    """Pay the card's first-use costs (cuBLAS set-up, lazy loading of each
    kernel) before anything is timed: one batch at the main path's widths
    through models and services of their own, on queries outside the
    measured streams, so none of their caches serve a timed batch.  The
    compile-time batch then seeds one runtime batch, and the same queries
    go once more through an HMOOC2 service (staging, the on-card tie
    check and K3)."""
    model = PerfModel(ModelConfig("subq", 19), seed=1, device=device)
    model_qs = PerfModel(ModelConfig("qs", 10), seed=2, device=device)
    queries = serving_stream("tpch", 8, seed=1, query_seed=1)
    t0 = time.perf_counter()
    cts = TuningService(model=model, cfg=cfg, device=device).tune_batch(
        queries, WEIGHTS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    RuntimeSession(model_subq=model, model_qs=model_qs, weights=WEIGHTS,
                   device=device).run_batch(queries, cts)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    TuningService(model=model, cfg=dataclasses.replace(
        cfg, dag_method="hmooc2"), device=device).tune_batch(queries, WEIGHTS)
    torch.cuda.synchronize()
    return t1 - t0, t2 - t1


def run_main_path(device, n_queries: int = 32,
                  cfg: HMOOCConfig = HMOOCConfig()) -> dict:
    """Three batches through the port's service at the default widths:
    TPC-H, the same TPC-H stream again (warm caches), then TPC-DS."""
    compile_s, runtime_s = warm_up(device, cfg)
    log(f"[warmup] first-use batch of 8 queries: {compile_s:.6f} s "
        f"compile-time, {runtime_s:.6f} s runtime (not timed below)")
    model = PerfModel(ModelConfig("subq", 19), seed=0, device=device)
    if any(p.device.type != device.type for p in model.net.parameters()):
        raise AssertionError(f"model parameters are not on {device}")
    svc = TuningService(model=model, cfg=cfg, device=device)
    batches = [("tpch", serving_stream("tpch", n_queries, seed=0)),
               ("tpch warm", serving_stream("tpch", n_queries, seed=0)),
               ("tpcds", serving_stream("tpcds", n_queries, seed=0))]
    timers = Timers()
    largest = []

    def segments_seen(F, valid):
        if not largest or F.numel() > largest[0][0].numel():
            largest[:] = [(F.clone(), valid.clone())]
        return seg_orig(F, valid)

    orig = (service_mod.fused_stage_eval, hmooc.pareto_mask_fast,
            hmooc.pareto_masks_fast, pareto_pkg.pareto_filter_segments,
            model.predict_rows, model.embed_many)
    seg_orig = orig[3]
    service_mod.fused_stage_eval = timers.wrap("stage_eval", orig[0])
    hmooc.pareto_mask_fast = timers.wrap("pareto_masks", orig[1])
    hmooc.pareto_masks_fast = timers.wrap("pareto_masks", orig[2])
    pareto_pkg.pareto_filter_segments = segments_seen
    model.predict_rows = timers.wrap("predict_rows", orig[4])
    model.embed_many = timers.wrap("embed_many", orig[5])
    reset_launches()
    per_batch, outputs = [], {}
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
            outputs[name] = (queries, results)
            s = svc.last_batch
            k1 = pareto_ops.LAUNCHES - l0
            row = {"batch": name, "queries": len(queries),
                   "qps": len(queries) / wall, "wall_s": wall,
                   "solved": s.n_solved, "deduped": s.n_deduped,
                   "regressor_rows": model.rows_predicted - rows0,
                   "pareto_launches": k1,
                   "pareto_launches_per_solved_query": (
                       k1 / s.n_solved if s.n_solved else None),
                   "max_memory_bytes": torch.cuda.max_memory_allocated(),
                   "host_s": {k: round(v, 6) for k, v in timers.t.items()},
                   "mean_solve_s": float(np.mean([r.solve_time
                                                  for r in results]))}
            per_batch.append(row)
            log(f"[slice] {json.dumps(row)}")
            log(f"[slice] {name}: {k1} K1 launches for {s.n_solved} solved "
                f"queries; masks' host time "
                f"{timers.t.get('pareto_masks', 0.0):.6f} s of "
                f"{wall:.6f} s")
            if k1 > 2 * s.n_solved:
                raise AssertionError(f"{name}: {k1} K1 launches for "
                                     f"{s.n_solved} solved queries; at most "
                                     "2 a query (banks phase, DAG filter)")
    finally:
        (service_mod.fused_stage_eval, hmooc.pareto_mask_fast,
         hmooc.pareto_masks_fast, pareto_pkg.pareto_filter_segments) = \
            orig[:4]
        del model.predict_rows, model.embed_many
    launches = read_launches()
    require_launches("compile", launches)
    log(f"[slice] cache {svc.cache.stats()}; launches {launches}")
    return {"launches": launches, "batches": per_batch, "model": model,
            "outputs": outputs, "k1_inputs": largest[0]}


def check_runtime_results(queries, cts, results) -> None:
    """Every query planned and realized: θ_eff of the right shape, finite
    and inside its ranges, a finite simulated outcome, request counts
    within their totals, and no planned join demoted (AQE can only upgrade
    a join algorithm)."""
    ps, ss = theta_p_space(), theta_s_space()
    for q, ct, r in zip(queries, cts, results):
        m = q.n_subqs
        if r.theta_p_eff.shape != (m, 9) or r.theta_s_eff.shape != (m, 2):
            raise AssertionError(f"{q.qid}: bad θ_eff shapes")
        for space, raw in ((ps, r.theta_p_eff), (ss, r.theta_s_eff)):
            lo = np.array([p.lo for p in space.params])
            hi = np.array([p.hi for p in space.params])
            if not (np.isfinite(raw).all() and (raw >= lo).all()
                    and (raw <= hi).all()):
                raise AssertionError(f"{q.qid}: θ_eff outside its range")
        for f in ("ana_latency", "actual_latency", "io_gb", "cost"):
            v = getattr(r.sim, f)
            if v.shape != (1,) or not np.isfinite(v).all():
                raise AssertionError(f"{q.qid}: bad simulated {f}")
        if not 0 <= r.requests_sent <= r.requests_total:
            raise AssertionError(f"{q.qid}: request counts out of range")
        planned = plan_joins(q, np.tile(ct.theta_p0, (m, 1))[None],
                             from_estimates=True)[0]
        for sq in q.subqs:
            if sq.kind == "join" and \
                    r.final_join[sq.sq_id] < planned[sq.sq_id]:
                raise AssertionError(f"{q.qid}: a planned join was demoted")


def run_runtime_path(device, model_subq, compiled: dict) -> dict:
    """``RuntimeSession.run_batch`` at the default widths (64 candidates,
    structural γ, pruning on) on the TPC-H and TPC-DS batches, seeded by
    the compile-time results of the timed batches.  Each round's
    ``weighted_pick_batch`` call is timed (host clock) inside PyTorch's
    sync debug mode, which counts its host synchronisations; the largest
    round's sets and weights are kept for ``measure_runtime_pick``."""
    model_qs = PerfModel(ModelConfig("qs", 10), seed=1, device=device)
    sess = RuntimeSession(model_subq=model_subq, model_qs=model_qs,
                          weights=WEIGHTS, device=device)
    timers = Timers()
    shapes, largest = [], []
    picks = {"calls": 0, "syncs": 0}

    def pick_seen(F, offsets, gid, W, **kw):
        shapes.append((gid.numel(), F.shape[0], F.shape[1], W.shape[0]))
        return pick_orig(F, offsets, gid, W, **kw)

    def weighted_pick(Fs, weights, **kw):
        if not largest or sum(map(len, Fs)) > sum(map(len, largest[0][0])):
            largest[:] = [(list(Fs), np.array(weights))]
        out, syncs = count_syncs(lambda: timed_pick(Fs, weights, **kw))
        picks["calls"] += 1
        picks["syncs"] += syncs
        return out

    orig = (runtime_mod.score_requests, runtime_mod.weighted_pick_batch,
            ws_pkg.runtime_pick)
    pick_orig = orig[2]
    timed_pick = timers.wrap("weighted_pick_batch", orig[1])
    runtime_mod.score_requests = timers.wrap("score_requests", orig[0])
    runtime_mod.weighted_pick_batch = weighted_pick
    ws_pkg.runtime_pick = pick_seen
    for m in (model_subq, model_qs):      # inside score_requests
        m.embed = timers.wrap("embed", m.embed)
        m.predict = timers.wrap("predict", m.predict)
    reset_launches()
    per_batch = []
    try:
        for name in ("tpch", "tpcds"):
            queries, cts = compiled[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            timers.t.clear()
            shapes.clear()
            picks.update(calls=0, syncs=0)
            l0 = read_launches()
            t0 = time.perf_counter()
            results = sess.run_batch(queries, cts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_runtime_results(queries, cts, results)
            s = sess.last_batch
            l1 = read_launches()
            n = {k: l1[k] - l0[k] for k in l1}
            pick_s = timers.t.get("weighted_pick_batch", 0.0)
            row = {"batch": name, "queries": len(queries), "wall_s": wall,
                   "requests_sent": s.requests_sent,
                   "requests_total": s.requests_total,
                   "rounds": s.rounds, "fused_calls": s.fused_calls,
                   "requests_per_s": s.requests_sent / wall,
                   "runtime_pick_launches": n["runtime_pick"],
                   "pareto_launches": n["pareto_filter"],
                   "ws_reduce_launches": n["ws_reduce"],
                   "weighted_pick_batch_calls": picks["calls"],
                   "host_syncs_per_round": (picks["syncs"] / s.rounds
                                            if s.rounds else None),
                   "weighted_pick_batch_ms_per_round": (
                       pick_s / s.rounds * 1e3 if s.rounds else None),
                   "runtime_pick_max_shape": ([int(x) for x in
                                               np.max(shapes, axis=0)]
                                              if shapes else None),
                   "max_memory_bytes": torch.cuda.max_memory_allocated(),
                   "host_s": {k: round(v, 6) for k, v in timers.t.items()},
                   "mean_actual_latency_s": float(np.mean(
                       [r.sim.actual_latency[0] for r in results]))}
            per_batch.append(row)
            log(f"[runtime] {json.dumps(row)}")
            log(f"[runtime] {name}: {n['runtime_pick']} runtime_pick "
                f"launches and {picks['syncs']} host syncs in {s.rounds} "
                f"rounds; weighted_pick_batch's host time {pick_s:.6f} s of "
                f"{wall:.6f} s")
            if not (n["runtime_pick"] == picks["calls"] == s.rounds
                    == picks["syncs"]):
                raise AssertionError(
                    f"{name}: {n['runtime_pick']} runtime_pick launches and "
                    f"{picks['syncs']} host syncs for {picks['calls']} "
                    f"picks in {s.rounds} rounds; one of each a round")
            if n["pareto_filter"] or n["ws_reduce"]:
                raise AssertionError(f"{name}: the runtime path launched "
                                     f"pareto_filter or ws_reduce ({n})")
    finally:
        (runtime_mod.score_requests, runtime_mod.weighted_pick_batch,
         ws_pkg.runtime_pick) = orig
        for m in (model_subq, model_qs):
            del m.embed, m.predict
    launches = read_launches()
    require_launches("runtime", launches)
    log(f"[runtime] pools {sess.pool_cache.stats()}; launches {launches}")
    return {"launches": launches, "batches": per_batch, "model_qs": model_qs,
            "pick_inputs": largest[0]}


def run_hmooc2_path(device, model, n_queries: int = 32) -> dict:
    """One TPC-H batch through a service at the default widths with HMOOC2
    aggregation.  Counts the routes each aggregation took, its host wall
    time and the host synchronisations inside it (PyTorch's sync debug
    mode, on only inside ``dag_aggregate``'s hmooc2 calls); keeps the
    largest bank aggregated and every on-card tie flag with its rows."""
    svc = TuningService(model=model, cfg=HMOOCConfig(dag_method="hmooc2"),
                        device=device)
    queries = serving_stream("tpch", n_queries, seed=0)
    routes = {"fused": 0, "float64": 0}
    agg = {"calls": 0, "host_s": 0.0, "syncs": 0}
    largest, flags = [], []

    def fused_route(*a):
        routes["fused"] += 1
        return fused_orig(*a)

    def float64_route(*a):
        routes["float64"] += 1
        return f64_orig(*a)

    def aggregate(Uc, pool, F_bank, idx_bank, method, **kw):
        if method != "hmooc2":
            return agg_orig(Uc, pool, F_bank, idx_bank, method, **kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                return agg_orig(Uc, pool, F_bank, idx_bank, method, **kw)
            finally:
                agg["host_s"] += time.perf_counter() - t0
                torch.cuda.set_sync_debug_mode(0)
                agg["calls"] += 1
                agg["syncs"] += sum("called a synchronizing" in str(w.message)
                                    for w in caught)
                if not largest or F_bank.size > largest[0][2].size:
                    largest[:] = [(Uc, pool, F_bank, idx_bank)]

    def tie_flag(F):
        flag = tie_orig(F)
        flags.append((F, flag))
        return flag

    orig = (hmooc._hmooc2_all_fused, hmooc._hmooc2_all, hmooc.dag_aggregate,
            hmooc._f32_tie_hazard_tensor)
    fused_orig, f64_orig, agg_orig, tie_orig = orig
    hmooc._hmooc2_all_fused = fused_route
    hmooc._hmooc2_all = float64_route
    hmooc.dag_aggregate = aggregate
    hmooc._f32_tie_hazard_tensor = tie_flag
    reset_launches()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = svc.tune_batch(queries, WEIGHTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (hmooc._hmooc2_all_fused, hmooc._hmooc2_all, hmooc.dag_aggregate,
         hmooc._f32_tie_hazard_tensor) = orig
    launches = read_launches()
    check_results(queries, results)
    check_theta_bounds(queries, results)
    s = svc.last_batch
    row = {"batch": "tpch hmooc2", "queries": len(queries),
           "qps": len(queries) / wall, "wall_s": wall,
           "solved": s.n_solved, "deduped": s.n_deduped,
           "fused_route": routes["fused"],
           "float64_route_tie_guard": routes["float64"],
           "launches": launches,
           "pareto_launches_per_solved_query": (
               launches["pareto_filter"] / s.n_solved if s.n_solved
               else None),
           "aggregations": agg["calls"],
           "aggregation_host_s": agg["host_s"],
           "host_syncs_per_aggregation": (agg["syncs"] / agg["calls"]
                                          if agg["calls"] else None),
           "max_memory_bytes": torch.cuda.max_memory_allocated(),
           "mean_solve_s": float(np.mean([r.solve_time for r in results]))}
    log(f"[hmooc2] {json.dumps(row)}")
    if routes["float64"]:
        log(f"[hmooc2] {routes['float64']} of {s.n_solved} aggregations "
            "took the float64 route: their banks hold values that are "
            "distinct in float64 and equal in float32")
    require_launches("hmooc2", launches)
    if routes["fused"] and launches["fused_solve"] != routes["fused"]:
        raise AssertionError(f"{routes['fused']} fused aggregations made "
                             f"{launches['fused_solve']} K3 launches")
    Fb = largest[0][2]
    W = hmooc._ws_weights(svc.cfg.n_ws_weights)
    return {"launches": launches, "row": row, "tie_flags": flags,
            "bank": (host_scores(Fb), Fb, W),
            "aggregation_args": largest[0]}


def lm_prompts(vocab: int, batch: int, length: int, device,
               seed: int = 0) -> torch.Tensor:
    """Token ids made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, length))).to(device)


def generate(model, tokens: torch.Tensor, capacity: int, steps: int):
    """Prefill ``tokens`` into a cache of ``capacity`` slots through the
    port's serving functions, then ``steps`` greedy decode steps.  Returns
    the prefill logits, the generated tokens (B, steps + 1), the prefill and
    decode wall times (s) and the cache."""
    sf = make_serve_fns(model)
    B, S = tokens.shape
    cache = model.init_cache(B, capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = sf.prefill(tokens, cache)
    nxt = torch.argmax(logits[:, -1], -1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [nxt]
    for t in range(steps):
        pos = torch.full((B, 1), S + t, dtype=torch.int64, device=tokens.device)
        step_logits, cache = sf.decode(nxt[:, None], cache, pos)
        nxt = torch.argmax(step_logits[:, -1], -1)
        out.append(nxt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if any(c["len"] != S + steps for c in cache):
        raise AssertionError("a layer's cache holds the wrong length")
    return logits, torch.stack(out, 1), t1 - t0, t2 - t1, cache


def lm_logit_spread(model, cfg, device, batch: int = LM_BATCH,
                    prompt: int = LM_PROMPT) -> dict:
    """The bf16 scoring logits' largest difference from the plain route
    (the cacheless forward with float32 attention, chunked) on the same
    weights, for each of LM_SPREAD_SEEDS' prompts and three attention
    routes in the flash route's place: the tensor-core body, the CUDA-core
    body (on float32 copies of q, k, v, rounded back to bf16: its 16-bit
    D <= 128 builds were removed, so the body cannot be forced on bf16
    inputs), and SDPA.  Measured, not gated: it says whether the tensor-core
    body lies outside the spread that bf16 layers summing in other orders
    give."""
    def simt(q, k, v, causal=True):
        return flash_ops.flash_attention(q.float(), k.float(), v.float(),
                                         causal=causal).to(q.dtype)

    routes = {"wgmma": (flash_ops.flash_attention, "wgmma"),
              "simt": (simt, "simt"),
              "sdpa": (lambda q, k, v, causal=True: sdpa(q, k, v, causal),
                       None)}
    orig = arch_blocks.flash_attention
    rows = []
    try:
        for seed in LM_SPREAD_SEEDS:
            tokens = lm_prompts(cfg.vocab, batch, prompt, device, seed)
            with torch.no_grad():
                model.cfg = cfg.with_(use_flash=False)
                plain, _ = model(tokens, last_only=True)
                model.cfg = cfg
                row = {"seed": seed,
                       "max_abs_logit": float(plain.float().abs().max())}
                for name, (fn, body) in routes.items():
                    arch_blocks.flash_attention = fn
                    before = dict(flash_ops.LAUNCHES_BY_BODY)
                    got, _ = model(tokens, last_only=True)
                    torch.cuda.synchronize()
                    if body is not None and flash_ops.LAUNCHES_BY_BODY[body] \
                            - before[body] != cfg.n_layers:
                        raise AssertionError(f"the {name} route did not take "
                                             f"the {body} body every layer")
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"non-finite {name} logits")
                    row[name] = float((got.float() - plain.float()).abs()
                                      .max())
            rows.append(row)
            log(f"[lm] logit spread, prompt seed {seed}: bf16 logits minus "
                f"the plain route's, max |d|: tensor-core body "
                f"{row['wgmma']:.6g}, CUDA-core body {row['simt']:.6g}, SDPA "
                f"{row['sdpa']:.6g} (|logit| up to {row['max_abs_logit']:.4g})")
    finally:
        arch_blocks.flash_attention = orig
        model.cfg = cfg
    others = [r[n] for r in rows for n in ("simt", "sdpa")]
    lo, hi = min(others), max(others)
    inside = all(r["wgmma"] <= hi for r in rows)
    log(f"[lm] logit spread over {len(rows)} prompt seeds: CUDA-core body "
        f"and SDPA {lo:.6g}-{hi:.6g}; tensor-core body "
        f"{min(r['wgmma'] for r in rows):.6g}-"
        f"{max(r['wgmma'] for r in rows):.6g}, "
        f"{'not above' if inside else 'ABOVE'} the largest of the others")
    return {"rows": rows, "others_range": [lo, hi], "wgmma_inside": inside}


def run_lm_path(device, cfg=None, batch: int = LM_BATCH,
                prompt: int = LM_PROMPT, gen: int = LM_GEN,
                capacity: int = LM_CAPACITY) -> dict:
    """Dense-LM serving at full width: one prompt-scoring forward with the
    flash route (a kernel launch per layer), then generation through the
    cache (no kernel launch, as in the reference).  Both run after an
    untimed warm-up at 128 tokens."""
    cfg = cfg or get_config(LM_ARCH, use_flash=True)
    t0 = time.perf_counter()
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, {n_params} parameters drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    tokens = lm_prompts(cfg.vocab, batch, prompt, device)
    with torch.no_grad():
        model(tokens[:, :128], last_only=True)
    generate(model, tokens[:, :128], 136, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        scores, _ = model(tokens, last_only=True)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    scoring_launches = flash_ops.LAUNCHES
    scoring_bodies = dict(flash_ops.LAUNCHES_BY_BODY)
    if scoring_launches != cfg.n_layers:
        raise AssertionError(f"prompt scoring launched flash_attention "
                             f"{scoring_launches} times for {cfg.n_layers} "
                             "layers")
    want_body = flash_ops._body(DTYPES[cfg.dtype], cfg.head_dim)
    if scoring_bodies[want_body] != cfg.n_layers:
        raise AssertionError(f"prompt scoring launched the bodies "
                             f"{scoring_bodies}; all {cfg.n_layers} launches "
                             f"must take the {want_body} body")
    pre_logits, generated, prefill_s, decode_s, cache = generate(
        model, tokens, capacity, gen - 1)
    launches = read_launches()
    # Device time of one more scoring forward and one more decode step
    # (the cache has a free slot), against the untraced wall times above.
    with torch.no_grad():
        score_busy = device_busy_ms(lambda: model(tokens, last_only=True))
    pos = torch.full((batch, 1), prompt + gen - 1, device=device)
    step_busy = device_busy_ms(lambda: make_serve_fns(model).decode(
        generated[:, -1:], cache, pos))
    require_launches("lm", launches)
    if launches["flash_attention"] != scoring_launches:
        raise AssertionError("generation launched the flash kernel")
    peak = torch.cuda.max_memory_allocated()
    if scores.shape != (batch, 1, cfg.vocab) or \
            not torch.isfinite(scores).all():
        raise AssertionError(f"bad scoring logits {tuple(scores.shape)}")
    if not torch.isfinite(pre_logits).all():
        raise AssertionError("non-finite prefill logits")
    if generated.shape != (batch, gen) or not (
            (generated >= 0) & (generated < cfg.vocab)).all():
        raise AssertionError("generated tokens out of range")
    diff = float((scores.float() - pre_logits.float()).abs().max())
    agree = float((scores[:, -1].argmax(-1)
                   == pre_logits[:, -1].argmax(-1)).float().mean())
    if cfg.dtype == "bfloat16" and not diff <= LM_BF16_LOGIT_ATOL:
        raise AssertionError(f"scoring logits (flash route) differ from the "
                             f"prefill logits (plain route) by {diff:.4g} > "
                             f"{LM_BF16_LOGIT_ATOL}")
    if agree != 1.0:
        raise AssertionError(f"the flash and plain routes pick another next "
                             f"token for {1 - agree:.0%} of the requests")
    row = {"scoring_tokens_per_s": batch * prompt / score_s,
           "scoring_s": score_s, "prefill_ms": prefill_s * 1e3,
           "decode_steps": gen - 1,
           "decode_tokens_per_s": batch * (gen - 1) / decode_s,
           "decode_s": decode_s, "max_memory_bytes": peak,
           "flash_launches_scoring": scoring_launches,
           "flash_launches_scoring_by_body": scoring_bodies,
           "flash_launches_generation": launches["flash_attention"]
           - scoring_launches,
           "scoring_device_busy_ms": score_busy,
           "decode_step_ms": decode_s / (gen - 1) * 1e3,
           "decode_step_device_busy_ms": step_busy,
           "flash_vs_plain_bf16_max_logit_diff": diff,
           "max_abs_logit": float(pre_logits.float().abs().max()),
           "next_token_agreement": agree}
    row["logit_spread"] = lm_logit_spread(model, cfg, device, batch, prompt)
    log(f"[lm] {json.dumps(row)}")
    log(f"[lm] scoring {row['scoring_tokens_per_s']:.1f} tokens/s "
        f"({batch} x {prompt}); prefill {row['prefill_ms']:.3f} ms; decode "
        f"{row['decode_tokens_per_s']:.3f} tokens/s ({batch} x {gen - 1} "
        f"steps); peak memory {peak} bytes; card busy {score_busy:.3f} ms "
        f"of a {score_s * 1e3:.3f} ms scoring forward and "
        f"{step_busy:.3f} ms of a {row['decode_step_ms']:.3f} ms decode "
        f"step (profiler against untraced wall time); bfloat16 logits of the flash "
        f"route (scoring) and the plain route (prefill) differ by at most "
        f"{diff:.4g}; sample {generated[0, :12].tolist()}")
    return {"launches": launches, "row": row}


# ---------------------------------------------------------------------------
# Phase 4: the card's answers against the host's, on small inputs
# ---------------------------------------------------------------------------

def host_copy(model_cuda) -> PerfModel:
    return PerfModel(model_cuda.cfg,
                     params={k: v.cpu() for k, v in
                             model_cuda.params.items()},
                     target_stats=model_cuda.target_stats, device="cpu")


def check_against_host(model_cuda, device) -> None:
    """The main path's model on the card and the same weights on the host
    give fronts of equal shape within rtol 1e-4 (float32 sums in another
    order on the card) on a small input.  The oracle backend's exact
    card-equals-host check is ``tests/test_torch_cuda.py``."""
    cfg = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                      max_bank=12, seed=3)
    queries = serving_stream("tpch", 6, seed=5)
    card = TuningService(model=model_cuda, cfg=cfg,
                         device=device).tune_batch(queries, WEIGHTS)
    host = TuningService(model=host_copy(model_cuda), cfg=cfg,
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


def check_runtime_against_host(model_subq, model_qs, device) -> None:
    """The runtime models' ``score_requests`` objectives on the card within
    rtol 1e-4 of the same weights on the host, for every (subQ, decision)
    request of a small TPC-H stream."""
    queries = serving_stream("tpch", 4, seed=5)
    cts = TuningService(cfg=HMOOCConfig(n_c_init=16, n_clusters=4,
                                        n_p_pool=48, n_c_enrich=12,
                                        max_bank=12, seed=3),
                        device="cpu").tune_batch(queries, WEIGHTS)
    sides = {}
    for label, dev, msub, mqs in (
            ("card", device, model_subq, model_qs),
            ("host", "cpu", host_copy(model_subq), host_copy(model_qs))):
        reqs = []
        for q, ct in zip(queries, cts):
            b = runtime_core.RuntimeOptimizerBackend(
                q, ct.theta_c, seed_theta_p=ct.theta_p_sub,
                seed_theta_s=ct.theta_s_sub, model_subq=msub, model_qs=mqs,
                device=dev)
            for sq in q.subqs:
                for r in (LQPRequest(q, sq, ct.theta_c, ct.theta_p0),
                          QSRequest(q, sq, ct.theta_c, ct.theta_s0)):
                    reqs.append(b.request_for(r)[0])
        sides[label] = runtime_core.score_requests(reqs)
    worst = 0.0
    for a, b in zip(sides["card"], sides["host"]):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("runtime objectives: bad shape or values")
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    if worst > 1e-4:
        raise AssertionError(f"runtime objectives differ by relative "
                             f"{worst:.3g}")
    log(f"[check] runtime objectives on the card within relative "
        f"{worst:.3g} of the host's on {len(sides['card'])} requests")


def check_lm_flash_against_plain(device, n_layers: int = 4,
                                 cfg=None) -> float:
    """glm4-9b at full width, ``n_layers`` layers, float32 with TF32 off:
    the scoring logits with ``use_flash`` (the kernel) and without it (the
    einsum route) on the same weights and prompts, within LM_F32_ATOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(LM_ARCH, n_layers=n_layers, dtype="float32",
                            use_flash=True)
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(1))
    tokens = lm_prompts(cfg.vocab, LM_BATCH, LM_PROMPT, device)
    with torch.no_grad():
        flash, _ = model(tokens, last_only=True)
        model.cfg = cfg.with_(use_flash=False)
        plain, _ = model(tokens, last_only=True)
    err = float((flash - plain).abs().max())
    if not (torch.isfinite(flash).all() and err <= LM_F32_ATOL):
        raise AssertionError(f"flash and plain routes differ by {err:.3g}")
    log(f"[check] {cfg.n_layers}-layer {cfg.name} float32 scoring logits: "
        f"flash route within {err:.3g} of the plain route (atol "
        f"{LM_F32_ATOL}; |logit| up to {float(plain.abs().max()):.3g})")
    return err


def check_lm_against_host(device, n_layers: int = 2, cfg=None,
                          length: int = 256) -> float:
    """glm4-9b at full width, ``n_layers`` layers, float32: one prompt's
    next-token logits on the card (flash kernel) and, with the same
    weights moved to the host, there (the plain version), within
    LM_F32_ATOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or get_config(LM_ARCH, n_layers=n_layers, dtype="float32",
                            use_flash=True)
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(2))
    tokens = lm_prompts(cfg.vocab, 1, length, device)
    with torch.no_grad():
        card, _ = model(tokens, last_only=True)
        card = card.cpu()
        host, _ = model.to("cpu")(tokens.cpu(), last_only=True)
    err = float((card - host).abs().max())
    if not (torch.isfinite(host).all() and err <= LM_F32_ATOL):
        raise AssertionError(f"card and host logits differ by {err:.3g}")
    log(f"[check] {cfg.n_layers}-layer {cfg.name} float32 logits of a "
        f"{length}-token prompt on the card within {err:.3g} of the host's "
        f"(atol {LM_F32_ATOL})")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    log(f"[build] kernels built in {build_all():.2f} s (in parallel)")
    entries = {"pareto_filter": check_pareto_filter(device),
               "flash_attention": check_flash_attention(device)}
    ws_err = check_ws_reduce(device)
    pick_err = check_runtime_pick(device)
    fused_err = check_fused_solve(device)
    compile_path = run_main_path(device)
    runtime_path = run_runtime_path(device, compile_path["model"],
                                    compile_path["outputs"])
    hmooc2_path = run_hmooc2_path(device, compile_path["model"])
    k1_err = entries["pareto_filter"]["max_abs_err"]
    entries["pareto_filter"] = measure_pareto_filter(
        *compile_path["k1_inputs"], "largest banks-phase launch of the "
        "compile-time path")
    entries["pareto_filter"]["max_abs_err"] = max(
        k1_err, entries["pareto_filter"]["max_abs_err"])
    measure_crossover(device)
    entries["ws_reduce"] = measure_ws_reduce(
        *runtime_ws_bank(device), "runtime-shaped bank")
    entries["ws_reduce"]["max_abs_err"] = max(
        ws_err, entries["ws_reduce"]["max_abs_err"])
    entries["runtime_pick"] = measure_runtime_pick(
        device, *runtime_path["pick_inputs"], "largest runtime round")
    entries["runtime_pick"]["max_abs_err"] = max(
        pick_err, entries["runtime_pick"]["max_abs_err"])
    measure_pick_crossover(device)
    check_tie_flag(device, hmooc2_path["tie_flags"])
    entries["fused_solve"] = measure_fused_solve(*hmooc2_path["bank"], device,
                                                 "largest HMOOC2 bank")
    entries["fused_solve"].update(measure_aggregation(
        device, hmooc2_path["aggregation_args"]))
    entries["fused_solve"]["max_abs_err"] = max(
        fused_err, entries["fused_solve"]["max_abs_err"])
    check_against_host(compile_path["model"], device)
    check_runtime_against_host(compile_path["model"],
                               runtime_path["model_qs"], device)
    lm_path = run_lm_path(device)
    torch.cuda.empty_cache()
    check_lm_flash_against_plain(device)
    torch.cuda.empty_cache()
    check_lm_against_host(device)
    paths = {"compile": compile_path["launches"],
             "runtime": runtime_path["launches"],
             "hmooc2": hmooc2_path["launches"],
             "lm": lm_path["launches"]}
    kernels = []
    entries["flash_attention"]["lm_launches_by_body"] = \
        lm_path["row"]["flash_launches_scoring_by_body"]
    for k in KERNELS:
        e = dict(entries[k["name"]])
        by_path = {p: paths[p][k["name"]] for p in paths}
        kernels.append({"name": k["name"], "route": "cuda",
                        "source": k["source"], "replaces": k["replaces"],
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **e})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
