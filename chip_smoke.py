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
* performance-model training (``train``): TPC-H traces at the reference's
  fast budget, the three datasets, and ``subq``, ``qs`` and ``lqp`` trained
  on the card at the default widths (no kernel of the port runs there:
  training is PyTorch's autograd and AdamW, as the reference's is XLA);
  each model's steps/s, host syncs, losses and test-split accuracy, a
  save/load round trip, and 5 steps on the card held to the host's;
* the optimizer on the trained models (``trained``): the 22 TPC-H queries
  through ``tune_batch`` and ``RuntimeSession.run_batch``, with the
  simulated latency and cost under the picks against Spark's defaults;
  then the paper's MOO baselines (MO-WS, NSGA-II, Progressive Frontier)
  beside HMOOC3 on 2 of those queries (``baselines``);
* the streaming layer on the trained models: ``OptimizerServer.serve`` on
  a 64-request Poisson stream at 16 q/s on measured wall time
  (``serve``); a ``ServiceTimeModel`` calibrated on the card, then the
  nine-scenario matrix served by a static and an elastic server under it,
  the elastic one twice (``scenarios``); ``OptimizerFleet`` at 1, 2 and 4
  workers on one card with affinity and random routing on the overload
  mix, and a ``CacheStore`` round trip (``fleet``);
* the user-facing entry points on the trained models and the oracle
  (``examples``): the quickstart, the service demo (48 requests in batches
  of 16) and the 22 TPC-H queries on the oracle backend, then the TPC-H
  loop on the trained ``subq`` and ``qs``, each on the card and again on
  the host; then the cluster autotuner (``cluster``): ``autotune`` for
  the ten configurations × the shape cells each supports × the
  example's five preferences, on the card and on the host, with the
  H100 figures of ``cluster/costmodel.py``; beside it one bf16 product at
  qwen2-72b's FFN shape against the cost model's ``TC_EFF``, and
  ``pareto_mask`` on the card against K1 and ``pareto_mask_np``;
* dense-LM serving (``lm``): ``glm4-9b`` at full width in bfloat16 with
  random weights from a seed, one prompt-scoring forward of 4 × 2048 tokens
  through the flash-attention kernel's tensor-core body (every launch must
  take it), then generation through the port's ``make_serve_fns``
  (prefill into a KV cache, 31 greedy decode steps);
* MoE serving (``moe``): ``moonshot-v1-16b-a3b`` at full width and depth
  (28.1 B parameters, 64 experts top-6) served as ``lm`` is, with the
  routing of every layer recorded (token-slots dropped by capacity, top-k
  sets on which the flash and plain routes differ), two scoring forwards
  bit-equal, the flash route's logits within ``LOGIT_SPREAD_GATE`` times
  SDPA's spread of the plain route's (next tokens reported: on random
  weights routing flips cascade and every attention route ends with
  other tokens), at 4 float32 layers within ``LM_F32_ATOL`` of the plain
  route with its routing replayed and with the same next tokens; one
  layer's dispatch share, and the smoke MoE model on the card against
  the host (forward, prefill and decode, a train step);
* SSM serving (``ssm``): ``rwkv6-1.6b`` at full width and depth (1.58 B
  parameters) served as ``lm`` is on the default ``scan`` route (no
  attention, so no K4 launch), two scoring forwards bit-equal, the
  ``chunked`` route's finite share reported, in float32 (batch 1) prefill
  of 2048 tokens and 31 decode steps against one forward of the 2079
  tokens, ``python -m repro_torch.launch.serve --arch rwkv6-1.6b --full``
  once, and the smoke model on the card against the host;
* the hybrid family (``hybrid``): the smoke ``jamba-1.5-large-398b`` in
  float32 with ``use_flash`` (one K4 launch a group, the plain route and
  the host against it, prefill and decode, a train step), then one
  ``apply_mamba`` at jamba's full width (d_model 8192, din 16384) on 4 x
  2048 bf16 tokens, timed against its bound, and in float32 at 1 x 2048
  prefill and 31 single-token steps against one call on the 2079 tokens;
* the audio family (``audio``): ``whisper-base`` at full width and depth
  (6 encoder and 6 decoder layers, 0.11 B parameters) in bfloat16 with
  the flash route, 16 clips of 1500 frames: one teacher-forced scoring
  forward over 448 decoder tokens (K4 once an encoder layer,
  non-causal, and once a decoder layer, causal) against the plain route,
  then prefill of 32 tokens with the frames (K4 once an encoder layer)
  and 31 decode steps; in float32 prefill and decode against one
  forward, and the smoke model on the card against the host;
* the VLM family (``vlm``): ``internvl2-76b`` at full width with 24 of
  its 80 layers (45 GB of bf16 weights), the ``lm`` traffic behind 256
  patch embeddings: scoring over 2304 positions (K4 once a layer) against
  the prefill logits, generation from position 2304 in a 2336-slot
  cache, peak memory under 75 GB, and the smoke model against the host;
* dense-LM training (``lm_train``): ``python -m repro_torch.launch.train``
  for 20 smoke steps, the reference's loss-falls test on the smoke
  glm4-9b, 5 float32 steps with gradient accumulation on the card held to
  the host's, the refusal of ``use_flash`` (the flash kernel has no
  backward pass), ``minicpm-2b`` at full width (2.72 B parameters from a
  seed, bfloat16 with float32 moments and per-layer remat, 8 x 512 tokens
  a step with 4 microbatches: step time, tokens/s against the 6NT bound,
  peak memory, host syncs a step), and the ``train_lm`` example at its
  ``--m100`` scale with its checkpoint restored bit-equal into a fresh
  model and optimizer state.  No kernel runs on this path;
* sharding (``shard``): a one-rank NCCL world and ``make_host_mesh()``'s
  (1, 1) ("data", "model") mesh; the ``lm_train`` protocol on
  ``minicpm-2b`` at full width under the mesh (DTensor parameters,
  moments and batches), its losses bit-equal to the same steps without
  a mesh; glm4-9b's bf16 scoring forward (4 x 2048, K4 once a layer on
  each rank's heads) under the mesh, its logits bit-equal to the
  unsharded ones; a row for each other family (SHARD_FAMILIES: the
  ``moe``, ``audio``, ``vlm``, ``ssm`` and ``hybrid`` phases' serving
  traffic, the SSM's prompt cut to 512), one model served through
  ``make_serve_fns`` without a mesh and then under it: scoring, prefill
  and decode logits and greedy tokens bit-equal, K4's launches by body,
  times and peak memory of both; and the dry-run's rows for those cells
  (``launch/dryrun.py`` on a fake one-rank world, before the NCCL world
  exists; a family's decode cell): their argument bytes against the
  bytes the same state holds on the card, their roofline bound against
  the measured times;
* the port's invariant suite (``analysis``):
  ``python -m repro_torch.analysis --strict --json src/repro_torch`` in a
  subprocess on this machine, which must exit 0, and every host
  synchronisation PyTorch's sync debug mode saw on the budgeted calls
  above (``SYNC_BUDGET``: the compile-time path's K1 callers, each
  runtime round of ``runtime`` and ``serve``, each HMOOC2 aggregation,
  ``train_model``, an ``lm_train`` step and one ``lm`` decode step),
  located at its innermost frame in ``src/repro_torch/``, held to the
  suite: each site must be a TH001/TH002 finding that a ``repro_torch:``
  marker suppresses, and each path's syncs a call must stay within its
  budget.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; the script fails if a kernel of a path was not
launched there, if a compile-time stream makes more than 2
``pareto_filter`` launches per solved query (one for the banks phase, one
for the DAG filter), or if a runtime batch's rounds make other than one
``runtime_pick`` call and one host synchronisation each, or any
``pareto_filter`` or ``ws_reduce`` launch.  The streaming phases hold the
same launch rules inside the server's flushes and fusion rounds (the
examples and the cluster autotuner too: K1 in each example and at most
twice a solved query, the runtime pick wherever an example runs AQE), the
served plans to the port's offline pipeline on the card (within rtol
1e-4 for ``serve``; exactly for the scenarios' survivors and across fleet
widths), and two clocked serves of a scenario to one timeline.  The
examples' oracle plans, simulated latencies, costs and runtime requests
and every cluster plan equal the host's exactly; the model-backed TPC-H
plans are within rtol 1e-4 of the host's.  ``runtime_pick`` is held to
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
layers, both at full width in float32; for MoE the flash route against
the plain route at 4 layers of moonshot-v1-16b-a3b in float32).  Every phase raises on failure,
so the script exits 0 only when all of them passed.  The last line of
standard output is one JSON object, ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches, its error against the
plain version and its times.

Without a CUDA card, or without the rest of the repository beside it, the
script fails before it prints any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # the runtime pick's test cases

from repro_torch.archs import blocks as arch_blocks  # noqa: E402
from repro_torch.archs.common import DTYPES, rmsnorm  # noqa: E402
from repro_torch.archs.registry import (  # noqa: E402
    build_model, get_config, get_smoke_config)
from repro_torch.cluster import costmodel as cluster_costmodel  # noqa: E402
from repro_torch.cluster.autotune import autotune  # noqa: E402
from repro_torch.core.models.perf_model import (  # noqa: E402
    ModelConfig, PerfModel, _Net)
from repro_torch.core.models.training import (  # noqa: E402
    build_dataset, evaluate, train_model)
from repro_torch.core.moo import hmooc  # noqa: E402
from repro_torch.core.moo import pareto as pareto_core  # noqa: E402
from repro_torch.core.moo import baselines  # noqa: E402
from repro_torch.core.moo.hmooc import HMOOCConfig, hmooc_solve  # noqa: E402
from repro_torch.core.tuning import runtime as runtime_core  # noqa: E402
from repro_torch.core.tuning.objectives import StageObjectives  # noqa: E402
from repro_torch.core.tuning.spark_space import (  # noqa: E402
    theta_c_space, theta_p_space, theta_s_space)
from repro_torch.data.pipeline import data_iterator  # noqa: E402
from repro_torch.data.pipeline import make_batch as make_lm_batch  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    cluster_autotune as cluster_example, quickstart, serve_tuning,
    tpch_tuning, train_lm)
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
from repro_torch.archs.act_sharding import set_activation_mesh  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.dryrun import dryrun_cell, fake_world  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_host_world, make_host_mesh)
from repro_torch.launch.shapes import (  # noqa: E402
    SHAPES, ShapeCell, cell_applicable)
from repro_torch.queryengine.aqe import (  # noqa: E402
    LQPRequest, QSRequest, run_with_aqe)
from repro_torch.queryengine.simulator import (  # noqa: E402
    default_theta, plan_joins)
from repro_torch.queryengine.trace import collect_traces  # noqa: E402
from repro_torch.queryengine.scenarios import scenario_matrix  # noqa: E402
from repro_torch.queryengine.workloads import (  # noqa: E402
    ArrivalModel, TenantSpec, default_workload, make_benchmark,
    multi_tenant_stream, serving_stream)
from repro_torch.serve import (  # noqa: E402
    REJECTED_STATUSES, CacheStore, CandidatePoolCache, ElasticPolicy,
    OptimizerFleet, OptimizerServer, RuntimeSession, ServerConfig,
    ServiceTimeModel, TuningService)
from repro_torch.serve import runtime as runtime_mod  # noqa: E402
from repro_torch.serve.cache import query_fingerprint  # noqa: E402
from repro_torch.serve import service as service_mod  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.serve import make_serve_fns  # noqa: E402
from repro_torch.train.sharding import tree_map  # noqa: E402
from repro_torch.train.train_loop import (  # noqa: E402
    make_train_step as make_lm_train_step, train_loop)
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
     "paths": ("compile", "trained", "serve", "scenarios", "fleet",
               "examples", "cluster")},
    {"name": "ws_reduce", "ops": ws_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/ws_reduce/csrc/ws_reduce.cu",
     "replaces": "src/repro/kernels/ws_reduce/kernel.py:35",
     "paths": ()},
    {"name": "runtime_pick", "ops": ws_ops,
     "counter": "RUNTIME_PICK_LAUNCHES",
     "source": "src/repro_torch/kernels/ws_reduce/csrc/runtime_pick.cu",
     "replaces": "src/repro/kernels/ws_reduce/kernel.py:35",
     "paths": ("runtime", "trained", "serve", "scenarios", "fleet",
               "examples")},
    {"name": "fused_solve", "ops": fused_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/fused_solve/csrc/fused_solve.cu",
     "replaces": "src/repro/kernels/fused_solve/ops.py:79",
     "paths": ("hmooc2",)},
    {"name": "flash_attention", "ops": flash_ops, "counter": "LAUNCHES",
     "source": "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_wgmma.cu",
     "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
     "paths": ("lm", "moe", "hybrid", "audio", "vlm", "shard")},
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
# The audio path: whisper-base at full width and depth, a batched
# transcription request of AUDIO_BATCH clips of 1500 frames: one
# teacher-forced scoring forward over AUDIO_SCORE decoder tokens (the real
# model's decoder cap), then prefill of AUDIO_PROMPT tokens with the frames
# and LM_GEN - 1 decode steps.
AUDIO_ARCH = "whisper-base"
AUDIO_BATCH, AUDIO_SCORE, AUDIO_PROMPT = 16, 448, 32
# The VLM path: internvl2-76b at full width with its depth cut from 80 to
# VLM_LAYERS layers (80 are 152 GB of bf16 weights; 24 are about 41 GB,
# plus 4.2 GB of embedding and head, which leaves room for the plain
# route's float32 logits), serving the LM path's traffic behind its 256
# patches: a prompt with an image, in a cache of 256 + 2048 + 32 slots.
VLM_ARCH = "internvl2-76b"
VLM_LAYERS, VLM_PATCHES = 24, 256
# flash_attention (B, Hq, Hkv, Sq, Skv, D, causal, dtype): the reference
# kernel tests' six float32 shapes (CUDA-core body) and their bfloat16
# case, the LM path's shape (glm4-9b at 4 × 2048 tokens), which is timed
# for the table, a minicpm-2b-shaped case (36 heads of 64), the LM shape
# in float16 and the MoE path's shape (moonshot-v1-16b-a3b at 4 × 2048
# tokens, 16 heads of 128, Hq = Hkv), also timed for the table (all
# tensor-core body); then the shapes of the audio and VLM paths, timed
# too: whisper-base's encoder (non-causal over 1500 frames, 8 heads of 64,
# Skv not a multiple of the 64-key tile) and its decoder's scoring forward
# (causal over 448 tokens), and internvl2-76b's scoring forward (64/8
# heads of 128 over 256 patches + 2048 tokens).
FLASH_LM_SHAPE = (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, True,
                  torch.bfloat16)
FLASH_MOE_SHAPE = (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 128, True,
                   torch.bfloat16)
FLASH_AUDIO_ENC_SHAPE = (AUDIO_BATCH, 8, 8, 1500, 1500, 64, False,
                         torch.bfloat16)
FLASH_AUDIO_DEC_SHAPE = (AUDIO_BATCH, 8, 8, AUDIO_SCORE, AUDIO_SCORE, 64,
                         True, torch.bfloat16)
FLASH_VLM_SHAPE = (LM_BATCH, 64, 8, VLM_PATCHES + LM_PROMPT,
                   VLM_PATCHES + LM_PROMPT, 128, True, torch.bfloat16)
# The entry of the kernels line that holds each timed shape's numbers.
FLASH_TIMED = {FLASH_MOE_SHAPE: "moe_shape",
               FLASH_AUDIO_ENC_SHAPE: "audio_encoder_shape",
               FLASH_AUDIO_DEC_SHAPE: "audio_decoder_shape",
               FLASH_VLM_SHAPE: "vlm_shape"}
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64, True, torch.float32),
                (2, 8, 2, 256, 256, 64, True, torch.float32),
                (1, 4, 1, 100, 100, 128, True, torch.float32),
                (1, 4, 2, 1, 300, 64, False, torch.float32),
                (1, 8, 4, 96, 480, 64, True, torch.float32),
                (2, 2, 2, 64, 64, 128, False, torch.float32),
                (1, 4, 4, 128, 128, 128, True, torch.bfloat16),
                FLASH_LM_SHAPE,
                (1, 36, 36, 2048, 2048, 64, True, torch.bfloat16),
                FLASH_LM_SHAPE[:-1] + (torch.float16,),
                FLASH_MOE_SHAPE, FLASH_AUDIO_ENC_SHAPE,
                FLASH_AUDIO_DEC_SHAPE, FLASH_VLM_SHAPE]
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
# against the plain route on the same weights).
LM_SPREAD_SEEDS = (0, 1, 2)
# Kernels and host ops listed from a traced scoring forward and decode step.
LM_TOP = 8
# The MoE path: moonshot-v1-16b-a3b at full width and depth, bf16, served
# as the LM path is (4 × 2048 prompts, 31 decode steps, 2080 slots).  A
# bf16 rounding can flip one of a token's 6 experts near a routing tie,
# which moves its hidden state by far more than a dense layer's rounding;
# attention spreads the change to later tokens, where it flips more
# experts.  On these random weights the flips cascade through the 48
# layers, and rounding alone grows through them too: any two attention
# routes (K4's bodies, SDPA, the plain einsum route) end with unrelated
# bf16 logits and next tokens (PERF.md, section 6).  So at full depth K4's
# bf16 scoring logits may differ from the plain route's by at most
# LOGIT_SPREAD_GATE times the largest difference that SDPA in K4's place
# gives over LM_SPREAD_SEEDS (the factor 2 absorbs a heavy-tailed spread:
# one more prompt set beats the largest of three with probability 1/4 for
# two equally good routes); next tokens, and the same with K4's routing
# replayed into the other routes, are reported, not gated.  The routes'
# agreement is held where it is decided: K4 at this shape against its
# plain version (FLASH_SCALED_TOL), and MOE_CHECK_LAYERS layers of the
# same configuration in float32, K4 against the plain route with K4's
# routing replayed into it (so no rounding flips an expert), within
# LM_F32_ATOL and with the same next tokens.
MOE_ARCH = "moonshot-v1-16b-a3b"
LOGIT_SPREAD_GATE = 2.0
MOE_CHECK_LAYERS = 4
# Depths at which the routes' drift is measured on the same weights.
MOE_DRIFT_DEPTHS = (1, 2, 4, 8, 16)
# The smoke MoE model in float32 on the card against the host: forward,
# prefill and MOE_HOST_DECODE decode steps, one train step's loss, within
# MOE_HOST_ATOL (float32 sums in other orders; no routing tie at 1e-7).
MOE_HOST_DECODE = 4
MOE_HOST_ATOL = 1e-4
# The SSM path: rwkv6-1.6b at full width and depth, bf16, served as the LM
# path is (4 x 2048 prompts, 31 decode steps, 2080 slots) on the default
# scan route.  In float32 with TF32 off, batch 1: prefill of LM_PROMPT
# tokens and LM_GEN - 1 decode steps (the prompt's own next tokens) against
# one cacheless forward of all of them, within the reference's own
# prefill/decode tolerance (tests/test_archs.py:75).  The smoke model on
# the card against the host within SSM_HOST_ATOL.
SSM_ARCH = "rwkv6-1.6b"
# Tokens of each prompt in the traced scoring forward (the scan's launches
# grow with the prompt, and the card's busy share with them).
SSM_TRACE_PROMPT = 128
SSM_DECODE_ATOL = 1e-3
SSM_HOST_ATOL = 1e-5
# The hybrid path: the smoke jamba in float32 with use_flash (window 0: K4
# once a group), its logits within LM_F32_ATOL of the plain route and,
# card against host, within MOE_HOST_ATOL (its MoE layers are [moe]'s);
# then one apply_mamba at jamba's full width on MAMBA_BATCH x LM_PROMPT
# bf16 tokens, and in float32 at 1 x LM_PROMPT prefill then LM_GEN - 1
# single-token steps through its state against one call on all the
# tokens, within MAMBA_DECODE_ATOL.
HYBRID_ARCH = "jamba-1.5-large-398b"
MAMBA_BATCH = 4
MAMBA_DECODE_ATOL = 1e-3
# The audio and VLM paths' checks.  On these random weights the run_lm_path
# gate does not hold for them, nor for SDPA or the CUDA-core body in K4's
# place: 24 layers of internvl2-76b at width 8192 move the bf16 logits by
# 0.14-0.17 from the plain route's (LM_BF16_LOGIT_ATOL is 0.125), and
# next tokens flip where the plain route's bf16 logits tie exactly
# (whisper-base: one request of 16; PERF.md, section 6).  So, as on the
# MoE path, K4's bf16 logits (each request's last position) may differ
# from the plain route's by at most LOGIT_SPREAD_GATE times SDPA's largest
# difference over LM_SPREAD_SEEDS, and K4's next token must be the plain
# route's or within one bf16 rounding of it in the plain route's logits;
# the LM_BF16_LOGIT_ATOL verdict is reported.  Agreement is held where it
# is decided: K4 at these shapes against its plain version
# (FLASH_SCALED_TOL), and the same configurations in float32 (whisper-base
# at full depth, internvl2-76b at VLM_CHECK_LAYERS layers), K4 against the
# plain route within LM_F32_ATOL with the same next tokens.  In float32 (TF32 off) the audio model's
# prefill of AUDIO_PROMPT tokens with the frames and LM_GEN - 1 decode
# steps are held within AUDIO_DECODE_ATOL of one forward (the reference's
# own prefill/decode tolerance); the smoke models on the card within
# AUDIO_HOST_ATOL and VLM_HOST_ATOL (the dense smoke models' card
# tolerance) of the host; the VLM path's peak memory under
# VLM_MAX_MEMORY bytes.
AUDIO_DECODE_ATOL = 1e-3
AUDIO_HOST_ATOL = 1e-5
VLM_CHECK_LAYERS = 4
VLM_MAX_MEMORY = 75e9
VLM_HOST_ATOL = 1e-4
# Performance-model training at the reference's fast TPC-H budget
# (benchmarks/common.py's FAST: 3 variants of each template, 32
# configurations a query; 1,500 steps of 512 rows for subq and qs, 500 of
# 64 for lqp) at the default ModelConfig.
TRAIN_BENCH, TRAIN_VARIANTS, TRAIN_CONFS = "tpch", 3, 32
TRAIN_BUDGET = {"subq": (1500, 512), "qs": (1500, 512), "lqp": (500, 64)}
# The trained subq's test-split correlation must exceed these (latency, IO):
# the intent of tests/test_models.py::test_model_trains_and_roundtrips.
TRAIN_MIN_CORR = (0.5, 0.8)
# Steps of the card against the host from one start, and their losses'
# tolerance: tests/test_torch_training.py's TRAJECTORY_LOSS_RTOL, which
# holds the host's trajectory to the reference's.
TRAIN_CHECK_STEPS = 5
TRAIN_STEP_RTOL = 2e-6
# Host synchronisations allowed in one train_model call: the losses are
# read back once, after the loop.
TRAIN_MAX_SYNCS = 1
# Host synchronisations one call of each path's budgeted function may make
# (PERF.md §3): a K1 caller one (its masks read back), a runtime round
# one (runtime and serve), an HMOOC2 aggregation two (the tie flag, then
# K3's results), train_model one, an LM train step and an LM decode step
# none.  count_syncs fills SYNC_SITES on the card; the analysis phase
# holds every site to the port's suppressed TH001/TH002 findings.
SYNC_BUDGET = {"compile": 1, "runtime": 1, "serve": 1, "hmooc2": 2,
               "train": TRAIN_MAX_SYNCS, "lm_train": 0, "lm": 0}
SYNC_SITES: dict = {}
ANALYSIS_TIMEOUT_S = 300
# The baselines phase: 2 TPC-H queries in the fine-grained flat space, at
# benchmarks/bench_moo.py's budgets, beside HMOOC3 on the same objectives.
BASELINE_QUERIES = 2
BASELINE_SOLVERS = (
    ("ws", baselines.solve_ws, dict(n_samples=10000, n_weights=11)),
    ("evo", baselines.solve_evo, dict(pop=100, n_evals=500)),
    ("pf", baselines.solve_pf, dict(n_points=9)))
# The streaming phases run on the trained subq and qs at the default
# HMOOCConfig.  [serve]: benchmarks/bench_server.py run()'s defaults, a
# 64-request TPC-H stream of Poisson arrivals at 16 q/s, seed 0, through
# ServerConfig() (max_batch 8, 1 s budget) on measured wall time.
SERVE_N, SERVE_RATE_QPS = 64, 16.0
SERVE_RTOL = 1e-4
# [scenarios]: run_scenarios()'s settings (cap 1 static, elastic to 2, a
# 0.3 s budget, steady load at 0.7 of the calibrated capacity, 4 report
# windows), with the stream cut from 24 requests a tenant to 16.
SCENARIO_N_PER_TENANT = 16
SCENARIO_MAX_BATCH, SCENARIO_BUDGET_S = 1, 0.3
SCENARIO_LOAD, SCENARIO_ELASTIC_CEILING, SCENARIO_WINDOWS = 0.7, 2, 4
# The clock both [scenarios] and [fleet] charge: _calibrate_clock()'s
# procedure on the card, at batch sizes 1, 2 and 8 (every cap the two
# phases reach), cut from 24 unique queries and 3 measured passes to 16
# and 1.  The fleet's replicas share one card in one process, so the
# clock keeps the single worker knot ((1, 1.0),): bench_server's
# FLEET_WORKER_SCALE models co-location on the reference's CPU host.
CALIB_CAPS, CALIB_N, CALIB_PASSES = (1, 2, 8), 16, 1
# [fleet]: run_fleet()'s overload mix (96 requests, one tenant per SLO
# class, twice the calibrated capacity, cap 8, 1 s budget, stealing at
# the budget) at 1, 2 and 4 workers.
FLEET_N, FLEET_WORKERS, FLEET_MAX_BATCH = 96, (1, 2, 4), 8
FLEET_BUDGET_S, FLEET_LOAD = 1.0, 2.0
TENANT_PREFS = [(0.9, 0.1), (0.7, 0.3), (0.5, 0.5), (0.2, 0.8), (0.1, 0.9)]
# The user-facing entry points: model-backed example plans on the card
# against the same weights on the host (float32 sums in another order);
# the configurations the cluster phase tunes (the ported families); the
# rows of the timed bf16 product at qwen2-72b's FFN shape (one train_4k
# sequence).
EXAMPLE_MODEL_RTOL = 1e-4
CLUSTER_ARCHS = ("minicpm-2b", "deepseek-coder-33b", "glm4-9b", "qwen2-72b",
                 "dbrx-132b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
                 "rwkv6-1.6b", "whisper-base", "internvl2-76b")
CLUSTER_MATMUL_TOKENS = 4096
# Dense-LM training.  The smoke run is the reference's
# test_train_loss_decreases (glm4-9b's smoke configuration in bfloat16,
# batch 4 x 32, lr 3e-3, 3 warm-up steps, 30 steps; the last loss below
# 0.9 x the first).  The card is held to the host on the float32 smoke
# model at test_torch_train_step.py's trajectory tolerance.  Full width:
# minicpm-2b at its published widths and depth, a global batch of 8 x 512
# with its train_accum (4), 2 untimed and 3 timed steps.  The checkpoint
# round trip runs the train_lm example at its --m100 scale for 4 steps.
LM_TRAIN_SMOKE = dict(arch="glm4-9b", batch=4, seq=32, lr=3e-3, warmup=3,
                      steps=30)
LM_TRAIN_DROP = 0.9
LM_TRAIN_CHECK_STEPS, LM_TRAIN_CHECK_ACCUM = 5, 2
LM_TRAIN_RTOL = 1e-4
LM_TRAIN_ARCH, LM_TRAIN_BATCH, LM_TRAIN_SEQ = "minicpm-2b", 8, 512
LM_TRAIN_WARM, LM_TRAIN_TIMED = 2, 3
# The full-width run's peak rate (10 warm-up steps of 100).  From random
# weights AdamW's first steps move every weight by about the rate, and at
# 2.7 B parameters 3e-4 overshoots: losses 12.08 -> 14.06 -> 19.92 in the
# first steps (PERF.md, section 6); at 1e-5 they fall, 12.08 -> 8.19 in 8.
LM_TRAIN_FULL_LR = 1e-5
LM_TRAIN_TOP = 12             # kernels and host ops listed from a traced step
LM_TRAIN_CKPT_STEPS = 4
# The sharding phase: the lm_train protocol's steps after one warm-up step,
# and the two cells of the dry-run held against the card.  PyTorch's
# caching allocator hands a tensor a block of its bytes rounded up to 512,
# and leaves a large block unsplit when less than 1 MiB would remain, so
# a tensor holds at most CUDA_ALLOC_SLACK bytes more than its own.
SHARD_STEPS = 3
SHARD_TRAIN_CELL = ShapeCell("shard_train", "train", LM_TRAIN_SEQ,
                             LM_TRAIN_BATCH)
SHARD_SCORE_CELL = ShapeCell("shard_score", "score", LM_PROMPT, LM_BATCH)
CUDA_ALLOC_SLACK = (1 << 20) + 512
# The [shard] family rows: each family phase's serving traffic through
# make_serve_fns on one model object, first without a mesh and then under
# the (1, 1) mesh: (row, architecture, configuration overrides (None: the
# smoke configuration's, float32 with use_flash), weight seed, input
# seed, batch, scoring tokens, prefill tokens, cache slots).  The SSM row
# takes SHARD_SSM_PROMPT tokens, not [ssm]'s 2048: its scan is a Python
# loop of ops a token, each of which DTensor dispatches under the mesh.
SHARD_SSM_PROMPT = 512
SHARD_FAMILIES = (
    ("moe", MOE_ARCH, {"use_flash": True}, 0, 0, LM_BATCH, LM_PROMPT,
     LM_PROMPT, LM_CAPACITY),
    ("audio", AUDIO_ARCH, {"use_flash": True}, 0, 0, AUDIO_BATCH,
     AUDIO_SCORE, AUDIO_PROMPT, AUDIO_PROMPT + LM_GEN),
    ("vlm", VLM_ARCH, {"n_layers": VLM_LAYERS, "use_flash": True}, 0, 0,
     LM_BATCH, LM_PROMPT, LM_PROMPT, VLM_PATCHES + LM_CAPACITY),
    ("ssm", SSM_ARCH, {}, 0, 0, LM_BATCH, SHARD_SSM_PROMPT, SHARD_SSM_PROMPT,
     SHARD_SSM_PROMPT + LM_GEN),
    ("hybrid", HYBRID_ARCH, None, 3, 4, 2, 48, 48, 48 + LM_GEN))


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


def sync_site(stack) -> tuple:
    """(path, line) of the innermost frame of ``stack`` in the port's
    package (``src/repro_torch/...``); else of the innermost frame."""
    for frame in reversed(stack):
        path = Path(frame.filename).as_posix()
        if "/src/repro_torch/" in path:
            rel = path.split("/src/repro_torch/", 1)[1]
            return f"src/repro_torch/{rel}", frame.lineno
    return stack[-1].filename, stack[-1].lineno


def count_syncs(fn, path: str = None):
    """(fn's result, the host synchronisations it made): PyTorch's sync
    debug mode, on only during the call.  With ``path``, the call and
    the site of each synchronisation (``sync_site`` of the stack the
    warning was raised from) are added to ``SYNC_SITES[path]``, which
    the ``[analysis]`` phase holds to the port's TH001/TH002 findings."""
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            sites.append(sync_site(traceback.extract_stack()))

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if path is not None:
        rec = SYNC_SITES.setdefault(path, {"calls": 0, "syncs": 0,
                                           "max_per_call": 0,
                                           "sites": Counter()})
        rec["calls"] += 1
        rec["syncs"] += len(sites)
        rec["max_per_call"] = max(rec["max_per_call"], len(sites))
        rec["sites"].update(sites)
    return out, len(sites)


def device_busy_ms(fn) -> float:
    """Milliseconds the card spent in kernels (summed over every kernel of a
    torch.profiler trace) during one call of ``fn``; set against the call's
    untraced wall time it gives the card's idle share."""
    return device_breakdown(fn)["busy_ms"]


def device_breakdown(fn, top: int = 0) -> dict:
    """One call of ``fn`` under torch.profiler: the card's busy ms (every
    kernel), its kernel launches, and the ``top`` kernels by device time
    and host ops by self host time, each as (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    card = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def rows(evs, key):
        return [(e.key[:90], getattr(e, key) / 1e3, e.count)
                for e in sorted(evs, key=lambda e: -getattr(e, key))[:top]]

    return {"busy_ms": sum(e.self_device_time_total for e in card) / 1e3,
            "kernel_launches": sum(e.count for e in card),
            "top_kernels": rows(card, "self_device_time_total"),
            "top_host_ops": rows(host, "self_cpu_time_total")}


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
    worst, entry, named = 0.0, None, {}
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
        timed = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": lib, "kernel_us": dev,
                 "body": body, "shape": [B, Hq, Hkv, Sq, Skv, D]}
        if FLASH_SHAPES[i] == FLASH_LM_SHAPE:
            entry = timed
        elif FLASH_SHAPES[i] in FLASH_TIMED:
            named[FLASH_TIMED[FLASH_SHAPES[i]]] = timed
        del q, k, v, got, want, want32
    log(f"[kernels] flash_attention == plain version on {len(FLASH_SHAPES)} "
        f"cases (float32 within {FLASH_ATOL[torch.float32]}, bfloat16 and "
        f"float16 within {FLASH_ATOL[torch.bfloat16]} and within a + r|want| "
        f"of the float32 output: {FLASH_SCALED_TOL})")
    return {"max_abs_err": worst, **entry, **named}


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

    def synced(fn):
        """``fn`` with its host syncs recorded under the compile path."""
        return lambda *a, **kw: count_syncs(lambda: fn(*a, **kw),
                                            "compile")[0]

    def segments_seen(F, valid):
        if not largest or F.numel() > largest[0][0].numel():
            largest[:] = [(F.clone(), valid.clone())]
        return seg_orig(F, valid)

    orig = (service_mod.fused_stage_eval, hmooc.pareto_mask_fast,
            hmooc.pareto_masks_fast, pareto_pkg.pareto_filter_segments,
            model.predict_rows, model.embed_many)
    seg_orig = orig[3]
    service_mod.fused_stage_eval = timers.wrap("stage_eval", orig[0])
    hmooc.pareto_mask_fast = timers.wrap("pareto_masks", synced(orig[1]))
    hmooc.pareto_masks_fast = timers.wrap("pareto_masks", synced(orig[2]))
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
        out, syncs = count_syncs(lambda: timed_pick(Fs, weights, **kw),
                                 "runtime")
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
        t0 = time.perf_counter()
        out, syncs = count_syncs(
            lambda: agg_orig(Uc, pool, F_bank, idx_bank, method, **kw),
            "hmooc2")
        agg["host_s"] += time.perf_counter() - t0
        agg["calls"] += 1
        agg["syncs"] += syncs
        if not largest or F_bank.size > largest[0][2].size:
            largest[:] = [(Uc, pool, F_bank, idx_bank)]
        return out

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


def lm_inputs(cfg, batch: int, length: int, device, seed: int = 0):
    """Token ids and, for the VLM and audio families, patch embeddings or
    frames in float32 (else None), made with numpy from ``seed``: the
    tokens first, then the patches, as ``launch/serve`` draws them."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, length)))
    rows = {"vlm": cfg.n_patches, "audio": cfg.enc_seq}.get(cfg.family)
    patches = None if rows is None else torch.from_numpy(rng.normal(
        0, 1, (batch, rows, cfg.d_model)).astype(np.float32)).to(device)
    return tokens.to(device), patches


def prefix_slots(cfg, patches) -> int:
    """Cache slots that ``patches`` take ahead of the tokens: a VLM
    model's patches; an audio model's frames take none."""
    return patches.shape[1] if patches is not None and cfg.family == "vlm" \
        else 0


def generate(model, tokens: torch.Tensor, capacity: int, steps: int,
             patches=None):
    """Prefill ``tokens`` (behind ``patches``, or with the frames) into a
    cache of ``capacity`` slots through the port's serving functions, then
    ``steps`` greedy decode steps.  Returns the prefill logits, the
    generated tokens (B, steps + 1), the prefill and decode wall times (s)
    and the cache."""
    sf = make_serve_fns(model)
    B, S = tokens.shape
    S += prefix_slots(model.cfg, patches)
    cache = model.init_cache(B, capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = sf.prefill(tokens, cache, patches)
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
    if any(c["len"] != S + steps for c in attention_caches(cache)):
        raise AssertionError("a layer's cache holds the wrong length")
    return logits, torch.stack(out, 1), t1 - t0, t2 - t1, cache


def attention_caches(cache) -> list:
    """The KV caches among a model's per-layer caches: every layer's
    (dense, moe, vlm), each group's attention layer's (hybrid), none (ssm),
    every decoder layer's (audio)."""
    if isinstance(cache, dict):
        cache = cache["dec"]
    return [c["attn"] if "attn" in c else c for c in cache
            if "attn" in c or "len" in c]


def flash_layers(cfg) -> int:
    """K4 launches of one cacheless forward: one for each attention layer
    without a window when ``use_flash`` (a hybrid model has one a group;
    an SSM model none; an audio model one an encoder and one a decoder
    layer)."""
    if not cfg.use_flash or cfg.window or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers + (cfg.enc_layers if cfg.family == "audio" else 0)


def flash_prefill_layers(cfg) -> int:
    """K4 launches of a prefill through the cache: an audio model encodes
    the frames (one a windowless encoder layer when ``use_flash``); the
    decoder, and every other family, attends through the cache."""
    if cfg.family != "audio" or not cfg.use_flash or cfg.window:
        return 0
    return cfg.enc_layers


def lm_logit_spread(model, cfg, device, batch: int = LM_BATCH,
                    prompt: int = LM_PROMPT, tag: str = "[lm]") -> dict:
    """The bf16 scoring logits' largest difference from the plain route
    (the cacheless forward with float32 attention, chunked) on the same
    weights, for each of LM_SPREAD_SEEDS' prompts and three attention
    routes in the flash route's place: the tensor-core body, the CUDA-core
    body (on float32 copies of q, k, v, rounded back to bf16: its 16-bit
    D <= 128 builds were removed, so the body cannot be forced on bf16
    inputs), and SDPA; and the share of requests whose next token each
    route picks as the plain route does.  It says whether the tensor-core
    body lies outside the spread that bf16 layers summing in other orders
    give."""
    def simt(q, k, v, causal=True):
        return flash_ops.flash_attention(q.float(), k.float(), v.float(),
                                         causal=causal).to(q.dtype)

    want = flash_layers(cfg)
    routes = {"wgmma": (flash_ops.flash_attention, "wgmma"),
              "simt": (simt, "simt"),
              "sdpa": (lambda q, k, v, causal=True: sdpa(q, k, v, causal),
                       None)}
    orig = arch_blocks.flash_attention
    rows = []
    try:
        for seed in LM_SPREAD_SEEDS:
            tokens, patches = lm_inputs(cfg, batch, prompt, device, seed)
            with torch.no_grad():
                model.cfg = cfg.with_(use_flash=False)
                plain, _ = model(tokens, patches, last_only=True)
                model.cfg = cfg
                row = {"seed": seed,
                       "max_abs_logit": float(plain.float().abs().max())}
                for name, (fn, body) in routes.items():
                    arch_blocks.flash_attention = fn
                    before = dict(flash_ops.LAUNCHES_BY_BODY)
                    got, _ = model(tokens, patches, last_only=True)
                    torch.cuda.synchronize()
                    if body is not None and flash_ops.LAUNCHES_BY_BODY[body] \
                            - before[body] != want:
                        raise AssertionError(f"the {name} route did not take "
                                             f"the {body} body every layer")
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"non-finite {name} logits")
                    row[name] = float((got.float() - plain.float()).abs()
                                      .max())
                    row[f"{name}_agree"] = float(
                        (got[:, -1].argmax(-1) == plain[:, -1].argmax(-1))
                        .float().mean())
            rows.append(row)
            log(f"{tag} logit spread, prompt seed {seed}: bf16 logits minus "
                f"the plain route's, max |d|: tensor-core body "
                f"{row['wgmma']:.6g}, CUDA-core body {row['simt']:.6g}, SDPA "
                f"{row['sdpa']:.6g} (|logit| up to {row['max_abs_logit']:.4g});"
                f" next token as the plain route's: {row['wgmma_agree']:.2f}, "
                f"{row['simt_agree']:.2f}, {row['sdpa_agree']:.2f}")
    finally:
        arch_blocks.flash_attention = orig
        model.cfg = cfg
    others = [r[n] for r in rows for n in ("simt", "sdpa")]
    lo, hi = min(others), max(others)
    inside = all(r["wgmma"] <= hi for r in rows)
    log(f"{tag} logit spread over {len(rows)} prompt seeds: CUDA-core body "
        f"and SDPA {lo:.6g}-{hi:.6g}; tensor-core body "
        f"{min(r['wgmma'] for r in rows):.6g}-"
        f"{max(r['wgmma'] for r in rows):.6g}, "
        f"{'not above' if inside else 'ABOVE'} the largest of the others")
    return {"rows": rows, "others_range": [lo, hi], "wgmma_inside": inside}


def serve_lm(device, cfg, path: str, batch: int = LM_BATCH,
             prompt: int = LM_PROMPT, gen: int = LM_GEN,
             capacity: int = LM_CAPACITY, trace_prompt: int = 0,
             gen_prompt: int = 0, score_all: bool = False) -> dict:
    """Serve ``cfg`` on the card as a user would: weights drawn from a
    seed, an untimed warm-up at 128 tokens, then, with the launch counts
    at 0, one prompt-scoring forward with the flash route (a launch per
    windowless attention layer, ``flash_layers``, all on the body
    ``cfg.dtype`` and the head width call for; the logits of every
    position with ``score_all``, else of the last) and generation through
    the cache on the first ``gen_prompt`` tokens of each prompt (0: all;
    no launch, as in the reference, but an audio model's encoder's,
    ``flash_prefill_layers``).  A VLM model's patches and an audio
    model's frames (``lm_inputs``) go with every call.  Then a
    traced scoring forward and decode step give the card's busy time and
    top kernels; with ``trace_prompt``, the traced forward scores only
    that many tokens of each prompt, beside an untraced forward of the
    same prefix (a trace of an SSM model's full scan, some 200,000
    launches, costs minutes).  Checks every launch rule, finite logits and tokens in
    range; returns the model, its prompts, the scoring and prefill logits
    and the measured row.  ``path`` names the path in the logs and in
    KERNELS."""
    tag = f"[{path}]"
    t0 = time.perf_counter()
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag} {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, "
        + (f"{cfg.d_model // cfg.rwkv_head_dim} RWKV heads of "
           f"{cfg.rwkv_head_dim}" if cfg.family == "ssm" else
           f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.head_dim}")
        + f", d_ff {cfg.d_ff}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}"
           if cfg.family == "moe" else "")
        + f", vocab {cfg.vocab}, {cfg.dtype}, {n_params} parameters drawn "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    tokens, patches = lm_inputs(cfg, batch, prompt, device)
    pre = prefix_slots(cfg, patches)
    gen_tokens = tokens[:, :gen_prompt] if gen_prompt else tokens
    with torch.no_grad():
        model(tokens[:, :128], patches=patches, last_only=True)
    generate(model, tokens[:, :128], 136 + pre, 2, patches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        scores, _ = model(tokens, patches=patches, last_only=not score_all)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    scoring_launches = flash_ops.LAUNCHES
    scoring_bodies = dict(flash_ops.LAUNCHES_BY_BODY)
    want = flash_layers(cfg)
    if scoring_launches != want:
        raise AssertionError(f"prompt scoring launched flash_attention "
                             f"{scoring_launches} times for {want} "
                             "windowless attention layers")
    want_body = flash_ops._body(DTYPES[cfg.dtype], cfg.head_dim)
    if scoring_bodies[want_body] != want:
        raise AssertionError(f"prompt scoring launched the bodies "
                             f"{scoring_bodies}; all {want} launches "
                             f"must take the {want_body} body")
    pre_logits, generated, prefill_s, decode_s, cache = generate(
        model, gen_tokens, capacity, gen - 1, patches)
    launches = read_launches()
    # Device time of one more scoring forward and one more decode step
    # (the cache has a free slot), against the untraced wall times.
    traced = tokens[:, :trace_prompt] if trace_prompt else tokens
    with torch.no_grad():
        def score():
            return model(traced, patches=patches, last_only=not score_all)
        traced_ms = host_ms(score, 1, 1) if trace_prompt else score_s * 1e3
        score_trace = device_breakdown(score, top=LM_TOP)
    pos = torch.full((batch, 1), gen_tokens.shape[1] + pre + gen - 1,
                     device=device)
    # The [lm] path's traced decode step also counts its host syncs.
    step_trace = device_breakdown(lambda: count_syncs(
        lambda: make_serve_fns(model).decode(generated[:, -1:], cache, pos),
        "lm" if path == "lm" else None), top=LM_TOP)
    del cache
    require_launches(path, launches)
    prefill_launches = launches["flash_attention"] - scoring_launches
    if prefill_launches != flash_prefill_layers(cfg):
        raise AssertionError(f"generation launched the flash kernel "
                             f"{prefill_launches} times; "
                             f"{flash_prefill_layers(cfg)} expected")
    peak = torch.cuda.max_memory_allocated()
    score_rows = prompt if score_all else 1
    if scores.shape != (batch, score_rows, cfg.vocab) or \
            not torch.isfinite(scores).all():
        raise AssertionError(f"bad scoring logits {tuple(scores.shape)}")
    if not torch.isfinite(pre_logits).all():
        raise AssertionError("non-finite prefill logits")
    if generated.shape != (batch, gen) or not (
            (generated >= 0) & (generated < cfg.vocab)).all():
        raise AssertionError("generated tokens out of range")
    row = {"n_params": n_params,
           "scoring_tokens_per_s": batch * prompt / score_s,
           "scoring_s": score_s, "prefill_ms": prefill_s * 1e3,
           "decode_steps": gen - 1,
           "decode_tokens_per_s": batch * (gen - 1) / decode_s,
           "decode_s": decode_s, "max_memory_bytes": peak,
           "flash_launches_scoring": scoring_launches,
           "flash_launches_scoring_by_body": scoring_bodies,
           "flash_launches_generation": prefill_launches,
           "scoring_traced_prompt": traced.shape[1],
           "scoring_traced_wall_ms": traced_ms,
           "scoring_device_busy_ms": score_trace["busy_ms"],
           "scoring_kernel_launches": score_trace["kernel_launches"],
           "decode_step_kernel_launches": step_trace["kernel_launches"],
           "decode_step_ms": decode_s / (gen - 1) * 1e3,
           "decode_step_device_busy_ms": step_trace["busy_ms"],
           "scoring_top_kernels": score_trace["top_kernels"],
           "decode_step_top_kernels": step_trace["top_kernels"],
           "max_abs_logit": float(pre_logits.float().abs().max())}
    for what, trace in (("scoring forward", score_trace),
                        ("decode step", step_trace)):
        log(f"{tag} top kernels of a traced {what} ({trace['busy_ms']:.3f} "
            f"ms busy, {trace['kernel_launches']} launches): "
            + "; ".join(f"{n} {ms:.3f} ms x{c}"
                        for n, ms, c in trace["top_kernels"]))
    return {"model": model, "tokens": tokens, "patches": patches,
            "scores": scores, "pre_logits": pre_logits,
            "generated": generated, "launches": launches, "row": row}


def log_served(path: str, row: dict, batch: int, prompt: int, gen: int,
               sample) -> None:
    log(f"[{path}] {json.dumps(row)}")
    log(f"[{path}] scoring {row['scoring_tokens_per_s']:.1f} tokens/s "
        f"({batch} x {prompt}); prefill {row['prefill_ms']:.3f} ms; decode "
        f"{row['decode_tokens_per_s']:.3f} tokens/s ({batch} x {gen - 1} "
        f"steps, {row['decode_step_ms']:.3f} ms a step); peak memory "
        f"{row['max_memory_bytes']} bytes; card busy "
        f"{row['scoring_device_busy_ms']:.3f} ms of a "
        f"{row['scoring_traced_wall_ms']:.3f} ms scoring forward ({batch} x "
        f"{row['scoring_traced_prompt']}) and "
        f"{row['decode_step_device_busy_ms']:.3f} ms of a "
        f"{row['decode_step_ms']:.3f} ms decode step (profiler against "
        f"untraced wall time); sample {sample}")


def check_within_spread(model, cfg, device, scores, plain, batch: int,
                        prompt: int, tag: str) -> dict:
    """K4's bf16 scoring logits (each request's last position; ``scores``
    from the serving run against ``plain``, the plain route's on the same
    inputs, and again over ``lm_logit_spread``'s prompt seeds) within
    LOGIT_SPREAD_GATE times SDPA's largest difference from the plain
    route, and K4's next token the plain route's or within one rounding
    of it in the plain route's logits (bf16 logits tie: the first of two
    equal values is the argmax).  Reported: the LM_BF16_LOGIT_ATOL
    verdict, the next tokens' agreement and, where they differ, the plain
    route's gap between its pick and K4's."""
    last, plain_last = scores[:, -1].float(), plain[:, -1].float()
    diff = float((last - plain_last).abs().max())
    k4_next, plain_next = last.argmax(-1), plain_last.argmax(-1)
    flipped = (k4_next != plain_next).nonzero().flatten().tolist()
    gaps = [float(plain_last[i, plain_next[i]] - plain_last[i, k4_next[i]])
            for i in flipped]
    eps = torch.finfo(scores.dtype).eps
    for i, gap in zip(flipped, gaps):
        if gap > eps * float(plain_last[i, plain_next[i]].abs()):
            raise AssertionError(f"request {i}: K4's next token is "
                                 f"{gap:.4g} below the plain route's pick in "
                                 "its logits, more than one rounding")
    spread = lm_logit_spread(model, cfg, device, batch, prompt, tag)
    sdpa_max = max(r["sdpa"] for r in spread["rows"])
    k4_max = max([diff] + [r["wgmma"] for r in spread["rows"]])
    gate = LOGIT_SPREAD_GATE * sdpa_max
    if not (math.isfinite(k4_max) and k4_max <= gate):
        raise AssertionError(f"K4's scoring logits differ from the plain "
                             f"route's by {k4_max:.4g} > {LOGIT_SPREAD_GATE} "
                             f"x SDPA's {sdpa_max:.4g}")
    row = {"k4_vs_plain_bf16_max_logit_diff": diff,
           "k4_vs_plain_max_over_seeds": k4_max,
           "sdpa_max_logit_diff": sdpa_max, "logit_gate": gate,
           "within_lm_bf16_logit_atol": diff <= LM_BF16_LOGIT_ATOL,
           "next_token_agreement": 1 - len(flipped) / len(k4_next),
           "flipped_requests_plain_gap": gaps, "logit_spread": spread}
    log(f"{tag} K4 against the plain route: max |d| {diff:.4g} at the last "
        f"positions ({'within' if row['within_lm_bf16_logit_atol'] else 'above'}"
        f" LM_BF16_LOGIT_ATOL {LM_BF16_LOGIT_ATOL}; over the spread's seeds "
        f"{k4_max:.4g}) against the gate {gate:.4g} ({LOGIT_SPREAD_GATE} x "
        f"SDPA's {sdpa_max:.4g}); next tokens agree for "
        f"{row['next_token_agreement']:.4f} of the requests; the plain "
        f"route's gap between its pick and K4's where they differ: {gaps}")
    return row


def run_lm_path(device, cfg=None, batch: int = LM_BATCH,
                prompt: int = LM_PROMPT, gen: int = LM_GEN,
                capacity: int = LM_CAPACITY) -> dict:
    """Dense-LM serving at full width (``serve_lm``), its bf16 scoring
    logits (flash route) held to the prefill logits (plain route) within
    LM_BF16_LOGIT_ATOL with the same next tokens, and the logit spread."""
    cfg = cfg or get_config(LM_ARCH, use_flash=True)
    out = serve_lm(device, cfg, "lm", batch, prompt, gen, capacity)
    scores, pre_logits, row = out["scores"], out["pre_logits"], out["row"]
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
    row.update(flash_vs_plain_bf16_max_logit_diff=diff,
               next_token_agreement=agree)
    row["logit_spread"] = lm_logit_spread(out["model"], cfg, device, batch,
                                          prompt)
    log_served("lm", row, batch, prompt, gen, out["generated"][0, :12]
               .tolist())
    log(f"[lm] bfloat16 logits of the flash route (scoring) and the plain "
        f"route (prefill) differ by at most {diff:.4g}")
    return {"launches": out["launches"], "row": row}


def record_routes(fn, replay=None):
    """(fn's result, the MoE routes its layers took, in call order):
    ``archs.blocks.moe_route``, which ``apply_moe`` calls through the
    module, wrapped to keep each route, or, given ``replay``, to hand the
    layers those routes in turn instead of routing."""
    routes, orig = [], arch_blocks.moe_route
    given = iter(replay) if replay is not None else None

    def recording(cfg, p, x):
        r = next(given) if given is not None else orig(cfg, p, x)
        routes.append(r)
        return r

    arch_blocks.moe_route = recording
    try:
        return fn(), routes
    finally:
        arch_blocks.moe_route = orig


def moe_dispatch_split(model, cfg, tokens) -> dict:
    """One MoE layer at the scoring shape: ``apply_moe`` per call (events)
    against its expert products alone (``_expert_ffn`` on a buffer of the
    same (E, G·C, d) shape); the rest is routing, dispatch and combine."""
    p = model.layers[0].mlp
    with torch.no_grad():
        x = rmsnorm(model.embed[tokens], model.layers[0].ln_mlp,
                    cfg.norm_eps)
        C = arch_blocks.moe_capacity(cfg, tokens.shape[1])
        buf = x.reshape(-1, cfg.d_model)[:tokens.shape[0] * C].expand(
            cfg.n_experts, -1, -1).contiguous()
        moe_ms = time_cuda(lambda: arch_blocks.apply_moe(cfg, p, x), 10, 3)
        ffn_ms = time_cuda(lambda: arch_blocks._expert_ffn(p, buf), 10, 3)
    share = 1.0 - ffn_ms / moe_ms
    log(f"[moe] one layer's apply_moe at {tuple(x.shape)}, capacity {C}: "
        f"{moe_ms:.4f} ms a call, its expert products "
        f"{tuple(buf.shape)} {ffn_ms:.4f} ms; routing, dispatch and combine "
        f"{share:.3f} of the layer's MoE")
    return {"apply_moe_ms": moe_ms, "expert_products_ms": ffn_ms,
            "dispatch_combine_share": share}


def moe_drift_by_depth(model, cfg, tokens, depths=MOE_DRIFT_DEPTHS) -> list:
    """The first ``d`` layers of the same weights for each depth: K4's,
    SDPA's and the plain route's bf16 scoring logits free-running, and the
    plain route and SDPA with K4's routing replayed; each pair's largest
    difference and next-token agreement."""
    layers = model.layers
    rows = []

    def sdpa_route(q, k, v, causal=True):
        return sdpa(q, k, v, causal)

    def forward(attention, use_flash, replay=None):
        arch_blocks.flash_attention = attention
        model.cfg = cfg.with_(use_flash=use_flash)
        with torch.no_grad():
            return record_routes(lambda: model(tokens, last_only=True)[0],
                                 replay)

    def pair(a, b):
        return [float((a.float() - b.float()).abs().max()),
                float((a[:, -1].argmax(-1) == b[:, -1].argmax(-1))
                      .float().mean())]

    try:
        for d in depths:
            model.layers = layers[:d]
            k4, routes = forward(flash_ops.flash_attention, True)
            plain, _ = forward(flash_ops.flash_attention, False)
            other, _ = forward(sdpa_route, True)
            plain_r, _ = forward(flash_ops.flash_attention, False, routes)
            other_r, _ = forward(sdpa_route, True, routes)
            rows.append({"depth": d, "k4_plain": pair(k4, plain),
                         "sdpa_plain": pair(other, plain),
                         "k4_plain_replayed": pair(k4, plain_r),
                         "sdpa_plain_replayed": pair(other_r, plain_r)})
    finally:
        model.layers = layers
        model.cfg = cfg
        arch_blocks.flash_attention = flash_ops.flash_attention
    log("[moe] by depth, max |d| / next-token agreement (K4 - plain, SDPA - "
        "plain; routing replayed: K4 - plain, SDPA - plain): " + "; ".join(
            f"{r['depth']}: " + ", ".join(
                f"{r[k][0]:.4g}/{r[k][1]:.2f}" for k in
                ("k4_plain", "sdpa_plain", "k4_plain_replayed",
                 "sdpa_plain_replayed")) for r in rows))
    return rows


def run_moe_path(device, cfg=None, batch: int = LM_BATCH,
                 prompt: int = LM_PROMPT, gen: int = LM_GEN,
                 capacity: int = LM_CAPACITY) -> dict:
    """MoE serving at full width (``serve_lm`` on moonshot-v1-16b-a3b),
    then, on the same prompts, with every layer's routing recorded: a
    second scoring forward, which must equal the first bit for bit; the
    plain route's forward (the share of token-slots capacity drops, and
    of (layer, token) top-k sets the two routes pick differently, layer by
    layer); the plain route and SDPA again with the flash route's routing
    replayed; the logit spread (LOGIT_SPREAD_GATE's gate); one layer's
    dispatch share; and the routes' drift at MOE_DRIFT_DEPTHS."""
    cfg = cfg or get_config(MOE_ARCH, use_flash=True)
    out = serve_lm(device, cfg, "moe", batch, prompt, gen, capacity)
    model, tokens, scores, row = (out["model"], out["tokens"], out["scores"],
                                  out["row"])
    with torch.no_grad():
        again, k4_routes = record_routes(
            lambda: model(tokens, last_only=True)[0])
        model.cfg = cfg.with_(use_flash=False)
        try:
            plain, plain_routes = record_routes(
                lambda: model(tokens, last_only=True)[0])
            replayed, _ = record_routes(
                lambda: model(tokens, last_only=True)[0], replay=k4_routes)
        finally:
            model.cfg = cfg
        arch_blocks.flash_attention = (
            lambda q, k, v, causal=True: sdpa(q, k, v, causal))
        try:
            sdpa_replayed, _ = record_routes(
                lambda: model(tokens, last_only=True)[0], replay=k4_routes)
        finally:
            arch_blocks.flash_attention = flash_ops.flash_attention
    if not torch.equal(again, scores):
        raise AssertionError("two scoring forwards on the card gave "
                             "different logits")
    if len(k4_routes) != cfg.n_layers or len(plain_routes) != cfg.n_layers:
        raise AssertionError("a forward routed other than once a layer")
    dropped = [float((~r.keep).float().mean()) for r in k4_routes]
    differ = [float((a.gidx.sort(-1).values != b.gidx.sort(-1).values)
                    .any(-1).float().mean())
              for a, b in zip(k4_routes, plain_routes)]
    del k4_routes, plain_routes

    def next_agree(a, b):
        return float((a[:, -1].argmax(-1) == b[:, -1].argmax(-1))
                     .float().mean())

    diff = float((scores.float() - plain.float()).abs().max())
    replay_diff = float((scores.float() - replayed.float()).abs().max())
    sdpa_replay_diff = float((sdpa_replayed.float() - replayed.float())
                             .abs().max())
    spread = lm_logit_spread(model, cfg, device, batch, prompt, "[moe]")
    sdpa_max = max(r["sdpa"] for r in spread["rows"])
    k4_max = max([diff] + [r["wgmma"] for r in spread["rows"]])
    gate = LOGIT_SPREAD_GATE * sdpa_max
    if not k4_max <= gate:
        raise AssertionError(f"K4's scoring logits differ from the plain "
                             f"route's by {k4_max:.4g} > {LOGIT_SPREAD_GATE} x "
                             f"SDPA's {sdpa_max:.4g}")
    split = moe_dispatch_split(model, cfg, tokens)
    row["drift_by_depth"] = moe_drift_by_depth(model, cfg, tokens)
    row.update(k4_vs_plain_bf16_max_logit_diff=diff,
               k4_vs_plain_max_over_seeds=k4_max, sdpa_max_logit_diff=sdpa_max,
               logit_gate=gate, next_token_agreement=next_agree(scores, plain),
               replayed_routing_max_logit_diff=replay_diff,
               replayed_routing_next_token_agreement=next_agree(scores,
                                                                replayed),
               replayed_routing_sdpa_max_logit_diff=sdpa_replay_diff,
               scoring_bit_equal_on_repeat=True,
               dropped_share_by_layer=dropped,
               routing_differs_share_by_layer=differ,
               routing_differs_share=float(np.mean(differ)),
               prefill_next_token_agreement=next_agree(scores,
                                                       out["pre_logits"]),
               logit_spread=spread, **split)
    log_served("moe", row, batch, prompt, gen,
               out["generated"][0, :12].tolist())
    marks = sorted({1, 2, 4, 8, 16, 32, cfg.n_layers} & set(
        range(1, cfg.n_layers + 1)))
    log(f"[moe] token-slots dropped by capacity a layer: min "
        f"{min(dropped):.5f}, median {np.median(dropped):.5f}, max "
        f"{max(dropped):.5f}; (layer, token) top-{cfg.top_k} sets on which "
        f"K4's and the plain route pick different experts: "
        f"{row['routing_differs_share']:.5f} over all layers, by layer "
        + ", ".join(f"{i}: {differ[i - 1]:.5f}" for i in marks)
        + f"; scoring logits bit-equal on repeat")
    log(f"[moe] K4 against the plain route: max |d| {diff:.4g} (over the "
        f"spread's seeds {k4_max:.4g}) against the gate {gate:.4g} "
        f"({LOGIT_SPREAD_GATE} x SDPA's {sdpa_max:.4g}); next tokens agree for "
        f"{row['next_token_agreement']:.2f} of the requests; with K4's "
        f"routing replayed into the plain route: max |d| {replay_diff:.4g} "
        f"(SDPA's, replayed the same way, {sdpa_replay_diff:.4g}), next "
        f"tokens agree for "
        f"{row['replayed_routing_next_token_agreement']:.2f}")
    return {"launches": out["launches"], "row": row}


def check_smoke_against_host(device, arch: str = MOE_ARCH,
                             atol: float = MOE_HOST_ATOL,
                             tag: str = "[moe]") -> dict:
    """A smoke model in float32 (TF32 off) on the card and, with the same
    weights, on the host: the flash route's forward logits, prefill and
    MOE_HOST_DECODE decode steps on the same tokens (and patches or
    frames), and one train step's loss and gradient norm (flash route
    off), all within ``atol``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    card = build_model(cfg, device,
                       torch.Generator(device=device).manual_seed(3))
    host = build_model(cfg, "cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    tokens, patches = lm_inputs(cfg, 2, 48, "cpu", seed=4)
    pre = prefix_slots(cfg, patches)

    def on(m, t):
        return None if t is None else t.to(m.device)

    errs = {}
    with torch.no_grad():
        errs["forward"] = float((card(tokens.to(device), on(card, patches))[0]
                                 .cpu() - host(tokens, patches)[0])
                                .abs().max())
    sides = {}
    for name, m in (("card", card), ("host", host)):
        sf = make_serve_fns(m)
        cache = m.init_cache(2, 40 + MOE_HOST_DECODE + pre)
        logits, cache = sf.prefill(tokens[:, :40].to(m.device), cache,
                                   on(m, patches))
        steps = [logits.cpu()]
        for t in range(MOE_HOST_DECODE):
            logits, cache = sf.decode(
                tokens[:, 40 + t:41 + t].to(m.device), cache,
                torch.full((2, 1), 40 + pre + t, device=m.device))
            steps.append(logits.cpu())
        sides[name] = torch.cat(steps, 1)
    errs["prefill_decode"] = float((sides["card"] - sides["host"]).abs()
                                   .max())
    tcfg = cfg.with_(use_flash=False)
    batch = make_lm_batch(tcfg, global_batch=4, seq_len=16, step=0)
    metrics = {}
    for name, dev in (("card", device), ("host", "cpu")):
        m = build_model(tcfg, dev)
        m.load_state_dict(host.state_dict())
        fns = make_lm_train_step(m, OptConfig(lr=1e-3))
        _, _, metrics[name] = fns.step(*fns.init(), batch)
    for k in ("loss", "grad_norm"):
        errs[f"train_{k}"] = abs(float(metrics["card"][k])
                                 - float(metrics["host"][k]))
    if not all(np.isfinite(list(errs.values()))) or \
            max(errs.values()) > atol:
        raise AssertionError(f"the smoke {arch} model on the card differs "
                             f"from the host's: {errs}")
    log(f"{tag} smoke {arch} float32 on the card against the host (max "
        f"|d|, atol {atol}): " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


# ---------------------------------------------------------------------------
# Phase 3a': the recurrent families (RWKV-6 served at full width, the jamba
# smoke model and its Mamba block at full width)
# ---------------------------------------------------------------------------

def run_ssm_path(device, cfg=None, batch: int = LM_BATCH,
                 prompt: int = LM_PROMPT, gen: int = LM_GEN,
                 capacity: int = LM_CAPACITY) -> dict:
    """SSM serving at full width and depth (``serve_lm`` on rwkv6-1.6b: no
    attention, so no K4 launch), then on the same prompts a second scoring
    forward, which must equal the first bit for bit, the scoring logits
    against the prefill logits (the same scan, so the same next tokens),
    and the ``chunked`` route's finite share (reported: the reference's is
    0 at this width).  Then the float32 prefill/decode check, the serving
    CLI at ``--full`` and the smoke model against the host."""
    t_phase = time.perf_counter()
    cfg = cfg or get_config(SSM_ARCH)
    out = serve_lm(device, cfg, "ssm", batch, prompt, gen, capacity,
                   trace_prompt=SSM_TRACE_PROMPT)
    model, tokens, scores, row = (out["model"], out["tokens"], out["scores"],
                                  out["row"])
    pre = out["pre_logits"]
    with torch.no_grad():
        again, _ = model(tokens, last_only=True)
        model.cfg = cfg.with_(rwkv_impl="chunked")
        try:
            chunked, _ = model(tokens, last_only=True)
        finally:
            model.cfg = cfg
    if not torch.equal(again, scores):
        raise AssertionError("two scoring forwards on the card gave "
                             "different logits")
    agree = float((scores[:, -1].argmax(-1) == pre[:, -1].argmax(-1))
                  .float().mean())
    if agree != 1.0:
        raise AssertionError("scoring and prefill pick other next tokens")
    # Bounds: the products of every weight but the embedding (a gather),
    # 2·N·T; a decode step reads those weights and reads and writes the
    # wkv state.
    embed = model.embed
    weights = sum(p.numel() * p.element_size() for p in model.parameters()) \
        - embed.numel() * embed.element_size()
    dh = cfg.rwkv_head_dim
    state = cfg.n_layers * batch * (cfg.d_model // dh) * dh * dh * 4
    flops = 2 * (row["n_params"] - embed.numel()) * batch * prompt
    row.update(scoring_bit_equal_on_repeat=True,
               scoring_vs_prefill_max_logit_diff=float(
                   (scores.float() - pre.float()).abs().max()),
               scoring_vs_prefill_next_token_agreement=agree,
               chunked_finite_share=float(torch.isfinite(chunked).float()
                                          .mean()),
               scoring_bound_ms=bound_ms(0, flops, BF16_OPS_PER_S)[0],
               decode_step_bound_ms=bound_ms(weights + 2 * state, 0)[0])
    log_served("ssm", row, batch, prompt, gen,
               out["generated"][0, :12].tolist())
    launches = out["launches"]
    del model, out, again, chunked, scores, pre
    torch.cuda.empty_cache()
    row["f32_prefill_decode_max_abs_err"] = check_ssm_decode_f32(device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        cli = serve_cli.main(["--arch", SSM_ARCH, "--full"])
    lines = text.getvalue().strip().splitlines()
    if cli.shape != (4, 16) or not ((0 <= cli) & (cli < cfg.vocab)).all():
        raise AssertionError(f"the serving CLI generated {cli.shape} tokens "
                             "or tokens out of range")
    log(f"[ssm] python -m repro_torch.launch.serve --arch {SSM_ARCH} --full "
        f"on the card ({time.perf_counter() - t0:.3f} s with the build): "
        f"{lines[0]}")
    torch.cuda.empty_cache()
    row["host"] = check_smoke_against_host(device, SSM_ARCH, SSM_HOST_ATOL,
                                           "[ssm]")
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[ssm] bounds: scoring {row['scoring_bound_ms']:.3f} ms ({flops:.4g} "
        f"FLOP at {BF16_OPS_PER_S:.3g}/s), measured "
        f"{row['scoring_s'] * 1e3:.3f} ms; a decode step "
        f"{row['decode_step_bound_ms']:.3f} ms ({weights + 2 * state} bytes "
        f"at {HBM_BYTES_PER_S:.3g}/s), measured {row['decode_step_ms']:.3f} "
        f"ms; two scoring forwards bit-equal; scoring against prefill max "
        f"|d| {row['scoring_vs_prefill_max_logit_diff']:.4g}; the chunked "
        f"route's logits finite in a share {row['chunked_finite_share']:.4g}"
        f"; phase {row['phase_s']:.3f} s")
    return {"launches": launches, "row": row}


def check_ssm_decode_f32(device, prompt: int = LM_PROMPT,
                         steps: int = LM_GEN - 1) -> float:
    """rwkv6-1.6b at full width and depth in float32 (TF32 off), one
    request: prefill of ``prompt`` tokens and ``steps`` decode steps on the
    prompt's own next tokens, against one cacheless forward of all of them,
    within SSM_DECODE_ATOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SSM_ARCH, dtype="float32")
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(1))
    tokens, _ = lm_inputs(cfg, 1, prompt + steps, device, seed=5)
    sf = make_serve_fns(model)
    with torch.no_grad():
        full, _ = model(tokens)
    logits, cache = sf.prefill(tokens[:, :prompt],
                               model.init_cache(1, prompt + steps))
    rows = [logits[:, -1]]
    for t in range(steps):
        logits, cache = sf.decode(
            tokens[:, prompt + t:prompt + t + 1], cache,
            torch.full((1, 1), prompt + t, device=device))
        rows.append(logits[:, -1])
    err = float((torch.stack(rows, 1) - full[:, prompt - 1:]).abs().max())
    if not (torch.isfinite(full).all() and err < SSM_DECODE_ATOL):
        raise AssertionError(f"float32 prefill and decode differ from the "
                             f"full forward by {err:.3g}")
    log(f"[ssm] float32 at full width: prefill of {prompt} tokens and "
        f"{steps} decode steps within {err:.3g} of one forward of the "
        f"{prompt + steps} tokens (atol {SSM_DECODE_ATOL}; |logit| up to "
        f"{float(full.abs().max()):.3g})")
    return err


def run_hybrid_path(device) -> dict:
    """The smoke jamba in float32 (TF32 off) with ``use_flash``: with the
    launch counts at 0, one scoring forward on the card, K4 once a group
    (window 0), its logits within LM_F32_ATOL of the plain route's; then
    the card against the host (``check_smoke_against_host``), one
    ``apply_mamba`` at jamba's full width (``mamba_full_width``) and its
    float32 state hand-over (``check_mamba_steps_f32``)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(HYBRID_ARCH, dtype="float32", use_flash=True)
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(3))
    tokens, _ = lm_inputs(cfg, 2, 48, device, seed=4)
    reset_launches()
    with torch.no_grad():
        flash, _ = model(tokens)
    torch.cuda.synchronize()
    launches = read_launches()
    bodies = dict(flash_ops.LAUNCHES_BY_BODY)
    require_launches("hybrid", launches)
    if launches["flash_attention"] != flash_layers(cfg):
        raise AssertionError(f"the hybrid scoring forward launched K4 "
                             f"{launches['flash_attention']} times for "
                             f"{flash_layers(cfg)} groups")
    model.cfg = cfg.with_(use_flash=False)
    with torch.no_grad():
        plain, _ = model(tokens)
    err = float((flash - plain).abs().max())
    if not (torch.isfinite(flash).all() and err <= LM_F32_ATOL):
        raise AssertionError(f"the hybrid flash and plain routes differ by "
                             f"{err:.3g}")
    log(f"[hybrid] smoke {HYBRID_ARCH} float32: {launches['flash_attention']}"
        f" K4 launches in the scoring forward (bodies {bodies}), logits "
        f"within {err:.3g} of the plain route's (atol {LM_F32_ATOL})")
    del model
    row = {"k4_launches_scoring": launches["flash_attention"],
           "k4_launches_by_body": bodies, "flash_vs_plain_max_abs": err,
           "host": check_smoke_against_host(device, HYBRID_ARCH,
                                            MOE_HOST_ATOL, "[hybrid]")}
    torch.cuda.empty_cache()
    row["mamba_full_width"] = mamba_full_width(device)
    torch.cuda.empty_cache()
    row["mamba_f32_steps_max_abs_err"] = check_mamba_steps_f32(device)
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[hybrid] {json.dumps(row)}")
    return {"launches": launches, "row": row}


def mamba_full_width(device, batch: int = MAMBA_BATCH,
                     length: int = LM_PROMPT) -> dict:
    """One ``apply_mamba`` at jamba-1.5-large-398b's width (d_model 8192,
    din 16384, N 16) on (batch, length) bf16 tokens, weights and inputs
    from a seed: ms a call (events, after a warm-up), the card's busy time
    and launches (profiler), peak memory, finite outputs; beside the bound
    of its products and the traffic of the reference's materialised dA,
    dBx and h_all."""
    cfg = get_config(HYBRID_ARCH)
    gen = torch.Generator(device=device).manual_seed(6)
    p = arch_blocks.init_mamba(gen, cfg)
    d, n = cfg.d_model, cfg.d_state
    din, r = cfg.expand * d, max(d // 16, 1)
    x = torch.randn((batch, length, d), generator=gen,
                    device=device).to(torch.bfloat16)

    def call():
        return arch_blocks.apply_mamba(cfg, p, x)

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, st = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if not (torch.isfinite(y).all() and torch.isfinite(st["h"]).all()):
            raise AssertionError("non-finite Mamba outputs at full width")
        del y, st
        ms = time_cuda(call, 3, 1)
        trace = device_breakdown(call, top=LM_TOP)
    T = batch * length
    flops = 2 * T * (d * 2 * din + din * (r + 2 * n) + r * din + din * d)
    weights = sum(t.numel() * t.element_size() for t in p.values())
    io = weights + 2 * x.numel() * x.element_size() \
        + batch * din * (n * 4 + (cfg.d_conv - 1) * 2)
    bound, by = bound_ms(io, flops, BF16_OPS_PER_S)
    scan_bytes = 3 * T * din * n * 4
    row = {"shape": [batch, length, d], "ms": ms,
           "device_busy_ms": trace["busy_ms"],
           "kernel_launches": trace["kernel_launches"],
           "top_kernels": trace["top_kernels"], "max_memory_bytes": peak,
           "memory_before_call_bytes": base, "bound_ms": bound,
           "bound_by": by, "flops": flops,
           "reference_scan_tensor_bytes": scan_bytes,
           "reference_scan_tensor_ms": 2 * scan_bytes / HBM_BYTES_PER_S
           * 1e3}
    log(f"[hybrid] apply_mamba at {HYBRID_ARCH}'s width on {tuple(x.shape)} "
        f"bf16: {ms:.3f} ms a call, the card busy {trace['busy_ms']:.3f} ms "
        f"over {trace['kernel_launches']} launches, peak {peak} bytes "
        f"({base} before the call); bound {bound:.3f} ms ({by}: "
        f"{flops:.4g} FLOP of products); dA, dBx and h_all "
        f"{scan_bytes} bytes, written and read back "
        f"{row['reference_scan_tensor_ms']:.3f} ms at the HBM rate; top "
        "kernels: " + "; ".join(f"{k} {v:.3f} ms x{c}"
                                for k, v, c in trace["top_kernels"]))
    return row


def check_mamba_steps_f32(device, prompt: int = LM_PROMPT,
                          steps: int = LM_GEN - 1) -> float:
    """One Mamba block at jamba's full width in float32 (TF32 off), one
    sequence: ``prompt`` tokens (the chunked route) then ``steps``
    single-token calls through the returned state, against one call on
    all of them (one scan over every token), outputs and final h within
    MAMBA_DECODE_ATOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(HYBRID_ARCH, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(7)
    p = arch_blocks.init_mamba(gen, cfg)
    x = torch.randn((1, prompt + steps, cfg.d_model), generator=gen,
                    device=device)
    with torch.no_grad():
        whole, ws = arch_blocks.apply_mamba(cfg, p, x)
        y, st = arch_blocks.apply_mamba(cfg, p, x[:, :prompt])
        parts = [y]
        for t in range(prompt, prompt + steps):
            y, st = arch_blocks.apply_mamba(cfg, p, x[:, t:t + 1], st)
            parts.append(y)
    err = float((torch.cat(parts, 1) - whole).abs().max())
    h_err = float((st["h"] - ws["h"]).abs().max())
    if not (torch.isfinite(whole).all()
            and max(err, h_err) <= MAMBA_DECODE_ATOL):
        raise AssertionError(f"the Mamba block's steps differ from one call "
                             f"by {err:.3g} (h {h_err:.3g})")
    log(f"[hybrid] apply_mamba float32 at full width: {prompt} tokens then "
        f"{steps} single-token steps within {err:.3g} of one call on "
        f"{prompt + steps} tokens (h within {h_err:.3g}; |y| up to "
        f"{float(whole.abs().max()):.3g}, |h| up to "
        f"{float(ws['h'].abs().max()):.3g}; atol {MAMBA_DECODE_ATOL})")
    return max(err, h_err)


# ---------------------------------------------------------------------------
# Phase 3a'': the audio and VLM families (whisper-base at full width and
# depth, internvl2-76b's patch prefix at full width)
# ---------------------------------------------------------------------------

def audio_bounds(cfg, batch: int, score: int) -> dict:
    """Bounds of the audio model's scoring forward over ``score`` decoder
    tokens and one decode step, ``batch`` requests of ``cfg.enc_seq``
    frames.  Operations, 2 a multiply-add: every weight on its rows (the
    encoder's on the frames, the decoder's and the head's on the tokens,
    the cross-attention's K/V projections on the frames in every decoder
    layer, again at every decode step) and K4's pairs (all Se² in the
    encoder, the causal half in the decoder) at the bf16 tensor-core
    rate; the cross-attention's own products are float32 einsums, at the
    float32 rate.  Scoring: the two times added, as the program runs them
    one after another.  A decode step: its bf16 operations against the
    bytes of the decoder's weights and of the encoder output its
    cross-attention reads in every layer."""
    d, h, dh, Se = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.enc_seq
    attn = 2 * d * h * dh + 2 * d * cfg.n_kv * dh
    mlp = 3 * d * cfg.d_ff
    xattn = 4 * d * h * dh
    enc_w = cfg.enc_layers * (attn + mlp)
    dec_w = cfg.n_layers * (attn + mlp + xattn // 2) + d * cfg.vocab
    xkv = cfg.n_layers * xattn // 2 * batch * Se
    bf16 = (2 * (enc_w * batch * Se + dec_w * batch * score + xkv)
            + 4 * dh * h * batch * (cfg.enc_layers * Se * Se
                                    + cfg.n_layers * score * (score + 1) // 2))
    f32 = 4 * dh * h * batch * cfg.n_layers * score * Se
    step_ops = 2 * (dec_w * batch + xkv)
    step_bytes = 2 * dec_w + cfg.n_layers * batch * Se * d * 2
    return {"scoring_bf16_ops": bf16, "scoring_f32_ops": f32,
            "scoring_bound_ms": (bf16 / BF16_OPS_PER_S
                                 + f32 / FP32_OPS_PER_S) * 1e3,
            "decode_step_bound_ms": bound_ms(step_bytes, step_ops,
                                             BF16_OPS_PER_S)[0]}


def run_audio_path(device, cfg=None, batch: int = AUDIO_BATCH,
                   score: int = AUDIO_SCORE, prompt: int = AUDIO_PROMPT,
                   gen: int = LM_GEN) -> dict:
    """whisper-base at full width and depth served on a batched
    transcription request (``serve_lm``): with the launch counts at 0, one
    teacher-forced scoring forward over ``score`` decoder tokens of each
    clip (K4 once an encoder layer, non-causal, and once a decoder layer,
    causal, all on the tensor-core body), then prefill of ``prompt``
    tokens with the frames (K4 once an encoder layer) and ``gen`` - 1
    decode steps (none).  Then the scoring logits against the plain
    route's on the same inputs (``check_within_spread``; the share of all
    positions whose next token agrees is reported), the encoder alone
    timed, the bounds, the float32 checks at full width and depth (flash
    against plain; prefill and decode against one forward) and the smoke
    model against the host."""
    t_phase = time.perf_counter()
    cfg = cfg or get_config(AUDIO_ARCH, use_flash=True)
    out = serve_lm(device, cfg, "audio", batch, score, gen, prompt + gen,
                   gen_prompt=prompt, score_all=True)
    model, tokens, frames, scores, row = (out["model"], out["tokens"],
                                          out["patches"], out["scores"],
                                          out["row"])
    model.cfg = cfg.with_(use_flash=False)
    try:
        with torch.no_grad():
            plain, _ = model(tokens, frames)
    finally:
        model.cfg = cfg
    every = float((scores.argmax(-1) == plain.argmax(-1)).float().mean())
    every_diff = float((scores.float() - plain.float()).abs().max())
    row.update(check_within_spread(model, cfg, device, scores, plain, batch,
                                   score, "[audio]"))
    with torch.no_grad():
        encoder_ms = time_cuda(lambda: model.encode(frames), 5, 2)
    row.update(every_position_agreement=every,
               every_position_max_logit_diff=every_diff,
               encoder_ms=encoder_ms, **audio_bounds(cfg, batch, score))
    log_served("audio", row, batch, score, gen,
               out["generated"][0, :12].tolist())
    launches = out["launches"]
    del model, out, scores, plain
    torch.cuda.empty_cache()
    row["f32_flash_vs_plain_max_abs"] = check_lm_flash_against_plain(
        device, cfg=get_config(AUDIO_ARCH, dtype="float32", use_flash=True),
        batch=batch, prompt=score)
    torch.cuda.empty_cache()
    row["f32_prefill_decode_max_abs_err"] = check_audio_decode_f32(device)
    torch.cuda.empty_cache()
    row["host"] = check_smoke_against_host(device, AUDIO_ARCH,
                                           AUDIO_HOST_ATOL, "[audio]")
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[audio] encoder {encoder_ms:.4f} ms ({batch} x {cfg.enc_seq} "
        f"frames); scoring {row['scoring_s'] * 1e3:.4f} ms against the bound "
        f"{row['scoring_bound_ms']:.4f} ms ({row['scoring_bf16_ops']:.4g} "
        f"bf16 and {row['scoring_f32_ops']:.4g} float32 operations); a "
        f"decode step {row['decode_step_ms']:.4f} ms against "
        f"{row['decode_step_bound_ms']:.4f} ms; bf16 logits of the flash "
        f"route within {every_diff:.4g} of the plain route's at all "
        f"positions, next tokens agree at {every:.4f} of them; phase "
        f"{row['phase_s']:.3f} s")
    return {"launches": launches, "row": row}


def check_audio_decode_f32(device, prompt: int = AUDIO_PROMPT,
                           steps: int = LM_GEN - 1) -> float:
    """whisper-base at full width and depth in float32 (TF32 off), two
    clips: prefill of ``prompt`` tokens with the frames and ``steps``
    decode steps on the prompts' own next tokens (the encoder output read
    from the cache) against one forward of all of them, within
    AUDIO_DECODE_ATOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(AUDIO_ARCH, dtype="float32")
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(1))
    tokens, frames = lm_inputs(cfg, 2, prompt + steps, device, seed=5)
    sf = make_serve_fns(model)
    with torch.no_grad():
        full, _ = model(tokens, frames)
    logits, cache = sf.prefill(tokens[:, :prompt],
                               model.init_cache(2, prompt + steps), frames)
    rows = [logits[:, -1]]
    for t in range(steps):
        logits, cache = sf.decode(
            tokens[:, prompt + t:prompt + t + 1], cache,
            torch.full((2, 1), prompt + t, device=device))
        rows.append(logits[:, -1])
    err = float((torch.stack(rows, 1) - full[:, prompt - 1:]).abs().max())
    if not (torch.isfinite(full).all() and err < AUDIO_DECODE_ATOL):
        raise AssertionError(f"float32 prefill and decode differ from the "
                             f"full forward by {err:.3g}")
    log(f"[audio] float32 at full width and depth: prefill of {prompt} "
        f"tokens with the frames and {steps} decode steps within {err:.3g} "
        f"of one forward of the {prompt + steps} tokens (atol "
        f"{AUDIO_DECODE_ATOL}; |logit| up to {float(full.abs().max()):.3g})")
    return err


def run_vlm_path(device, cfg=None, batch: int = LM_BATCH,
                 prompt: int = LM_PROMPT, gen: int = LM_GEN) -> dict:
    """internvl2-76b at full width, VLM_LAYERS layers, served as the LM
    path is behind its patches (``serve_lm``): one scoring forward over
    patches + tokens (K4 once a layer, causal, GQA group 8), prefill into
    a cache of n_patches + prompt + gen slots and gen - 1 decode steps from
    position n_patches + prompt.  Gates: the scoring logits against the
    prefill logits (plain route) within the spread
    (``check_within_spread``), peak memory under VLM_MAX_MEMORY,
    VLM_CHECK_LAYERS layers in float32 (flash against plain) and the smoke
    model on the card against the host."""
    t_phase = time.perf_counter()
    cfg = cfg or get_config(VLM_ARCH, n_layers=VLM_LAYERS, use_flash=True)
    out = serve_lm(device, cfg, "vlm", batch, prompt, gen,
                   cfg.n_patches + prompt + gen)
    model, scores, row = out["model"], out["scores"], out["row"]
    if not row["max_memory_bytes"] < VLM_MAX_MEMORY:
        raise AssertionError(f"peak memory {row['max_memory_bytes']} bytes "
                             f"is not under {VLM_MAX_MEMORY:.4g}")
    # Bounds: every weight but the embedding (a gather) on its rows, the
    # layers on patches + tokens, the head on the last; K4's causal pairs.
    # A decode step reads those weights.
    head = cfg.d_model * cfg.vocab
    layer_w = row["n_params"] - 2 * head - cfg.d_model
    rows_ = batch * (cfg.n_patches + prompt)
    S = cfg.n_patches + prompt
    ops = (2 * (layer_w * rows_ + head * batch)
           + 4 * cfg.head_dim * cfg.n_heads * batch * cfg.n_layers
           * S * (S + 1) // 2)
    row.update(check_within_spread(model, cfg, device, scores,
                                   out["pre_logits"], batch, prompt, "[vlm]"))
    row.update(scoring_ops=ops,
               scoring_bound_ms=bound_ms(0, ops, BF16_OPS_PER_S)[0],
               decode_step_bound_ms=bound_ms(2 * (layer_w + head), 0)[0])
    log_served("vlm", row, batch, prompt, gen,
               out["generated"][0, :12].tolist())
    launches = out["launches"]
    del model, out, scores
    torch.cuda.empty_cache()
    row["f32_flash_vs_plain_max_abs"] = check_lm_flash_against_plain(
        device, cfg=get_config(VLM_ARCH, n_layers=VLM_CHECK_LAYERS,
                               dtype="float32", use_flash=True))
    torch.cuda.empty_cache()
    row["host"] = check_smoke_against_host(device, VLM_ARCH, VLM_HOST_ATOL,
                                           "[vlm]")
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[vlm] {cfg.n_layers} of {get_config(VLM_ARCH).n_layers} layers "
        f"behind {cfg.n_patches} patches:"
        f" scoring {row['scoring_s'] * 1e3:.3f} ms against the bound "
        f"{row['scoring_bound_ms']:.3f} ms ({ops:.4g} operations); a decode "
        f"step {row['decode_step_ms']:.3f} ms against "
        f"{row['decode_step_bound_ms']:.3f} ms (the weights' bytes); peak "
        f"memory {row['max_memory_bytes']} bytes; phase "
        f"{row['phase_s']:.3f} s")
    return {"launches": launches, "row": row}


# ---------------------------------------------------------------------------
# Phase 3b: performance-model training, and the optimizer on trained models
# ---------------------------------------------------------------------------

def run_train_path(device) -> dict:
    """Collect TPC-H traces, build the three datasets and train subq, qs
    and lqp on the card at the default widths.  Each ``train_model`` call
    runs inside PyTorch's sync debug mode, which counts its host
    synchronisations: at most TRAIN_MAX_SYNCS, none inside the loop.
    Losses must be finite and fall, the subq model's test-split
    correlations must pass TRAIN_MIN_CORR, and a save/load round trip must
    keep every model's predictions."""
    t_phase = t0 = time.perf_counter()
    queries = default_workload(TRAIN_BENCH, TRAIN_VARIANTS)
    traces = collect_traces(queries, TRAIN_CONFS, seed=0)
    log(f"[train] traces: {len(queries)} queries x {TRAIN_CONFS} "
        f"configurations, {traces.query_idx.shape[0]} stage rows and "
        f"{traces.q_query_idx.shape[0]} query rows in "
        f"{time.perf_counter() - t0:.3f} s (host)")
    models, datasets, rows = {}, {}, []
    reset_launches()
    for kind, (steps, batch) in TRAIN_BUDGET.items():
        ds, cfg = build_dataset(traces, kind, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, syncs = count_syncs(lambda: train_model(
            ds, cfg, steps=steps, batch=batch, seed=0, device=device), "train")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = model.train_losses
        first, last = float(losses[:100].mean()), float(losses[-100:].mean())
        t0 = time.perf_counter()
        met = evaluate(model, ds)
        evaluate_s = time.perf_counter() - t0
        row = {"kind": kind, "rows": ds.n,
               "train_rows": int(ds.masks["train"].sum()),
               "graphs": int(ds.graphs[0].shape[0]),
               "graph_nodes": int(ds.graphs[0].shape[1]),
               "steps": steps, "batch": batch, "wall_s": wall,
               "steps_per_s": steps / wall,
               "rows_per_s": steps * batch / wall,
               "host_syncs": syncs,
               "loss_first_100": first, "loss_last_100": last,
               "test_wmape": met.wmape.tolist(), "test_p50": met.p50.tolist(),
               "test_p90": met.p90.tolist(), "test_corr": met.corr.tolist(),
               "predict_rows_per_s": met.xput, "evaluate_s": evaluate_s}
        rows.append(row)
        log(f"[train] {json.dumps(row)}")
        log(f"[train] {kind}: {steps} steps of {batch} rows in {wall:.3f} s "
            f"({steps / wall:.1f} steps/s, {steps * batch / wall:.0f} "
            f"rows/s), {syncs} host syncs in train_model; loss "
            f"{first:.4f} -> {last:.4f}; test latency {met.row(0)} | IO "
            f"{met.row(1)}; predict {met.xput:.0f} rows/s (8,192 rows, "
            "copies in and out included)")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{kind}: a training loss is not finite")
        if not last < first:
            raise AssertionError(f"{kind}: the loss did not fall ({first:.4g}"
                                 f" -> {last:.4g})")
        if syncs > TRAIN_MAX_SYNCS:
            raise AssertionError(f"{kind}: train_model synchronised with the "
                                 f"host {syncs} times in {steps} steps; at "
                                 f"most {TRAIN_MAX_SYNCS}")
        check_roundtrip(model, traces.queries[0], device)
        models[kind], datasets[kind] = model, (ds, cfg)
    ds, cfg = datasets["subq"]
    batch, busy_steps = TRAIN_BUDGET["subq"][1], 10

    def short():
        return train_model(ds, cfg, steps=busy_steps, batch=batch, seed=1,
                           device=device)

    t0 = time.perf_counter()
    busy = device_busy_ms(short)
    traced_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"[train] subq, {busy_steps} steps of {batch} rows: card busy "
        f"{busy:.3f} ms of {wall_ms:.3f} ms (profiler against untraced wall "
        f"time; idle share {1 - busy / wall_ms:.1%}), "
        f"{busy / busy_steps:.4f} ms a step on the card; traced in "
        f"{traced_s:.3f} s")
    corr = rows[0]["test_corr"]
    if not (corr[0] > TRAIN_MIN_CORR[0] and corr[1] > TRAIN_MIN_CORR[1]):
        raise AssertionError(f"subq test correlations {corr} below "
                             f"{TRAIN_MIN_CORR}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"training launched a kernel: {launches}")
    check_train_against_host(device, *datasets["subq"])
    log(f"[train] phase: {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "rows": rows, "models": models}


def check_roundtrip(model, query, device) -> None:
    """``save`` then ``load`` gives a model with the same predictions."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.npz")
        model.save(path)
        loaded = PerfModel.load(model.cfg, path, device=device)
    sq = 0 if model.cfg.kind != "lqp" else None
    emb = model.embed(query, sq)
    if not np.array_equal(emb, loaded.embed(query, sq)):
        raise AssertionError(f"{model.cfg.kind}: embeddings changed in a "
                             "save/load round trip")
    theta = np.random.default_rng(0).random(
        (64, model.cfg.theta_dim)).astype(np.float32)
    nond = np.zeros(12, np.float32)
    if not np.array_equal(model.predict(emb, theta, nond),
                          loaded.predict(emb, theta, nond)):
        raise AssertionError(f"{model.cfg.kind}: predictions changed in a "
                             "save/load round trip")


def check_train_against_host(device, ds, cfg) -> None:
    """TRAIN_CHECK_STEPS steps from one start on the card and on the host:
    every step's loss within TRAIN_STEP_RTOL."""
    t0 = time.perf_counter()
    start = _Net(cfg, torch.Generator().manual_seed(7)).state_dict()
    steps, batch = TRAIN_CHECK_STEPS, TRAIN_BUDGET[cfg.kind][1]
    card, host = (train_model(ds, cfg, steps=steps, batch=batch, seed=0,
                              init_params=start, device=d).train_losses
                  for d in (device, "cpu"))
    err = float(np.max(np.abs(card - host) / np.abs(host)))
    if not err <= TRAIN_STEP_RTOL:
        raise AssertionError(f"{cfg.kind}: {steps} training steps on the "
                             f"card and the host differ by relative {err:.3g}"
                             f" (card {card}, host {host})")
    log(f"[check] {steps} {cfg.kind} training steps (batch {batch}) on the "
        f"card within relative {err:.3g} of the host's losses (rtol "
        f"{TRAIN_STEP_RTOL}), in {time.perf_counter() - t0:.3f} s")


def run_trained_path(device, models: dict) -> dict:
    """The 22 TPC-H queries through ``TuningService.tune_batch`` with the
    trained subq model, then ``RuntimeSession.run_batch`` with the trained
    subq and qs models, under the main paths' checks and launch gates.
    Prints the simulated total latency and cost under the picks against
    Spark's defaults, and the reduction (not gated)."""
    t_phase = time.perf_counter()
    queries = make_benchmark("tpch")
    svc = TuningService(model=models["subq"], cfg=HMOOCConfig(),
                        device=device)
    sess = RuntimeSession(model_subq=models["subq"], model_qs=models["qs"],
                          weights=WEIGHTS, device=device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cts = svc.tune_batch(queries, WEIGHTS)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check_results(queries, cts)
    check_theta_bounds(queries, cts)
    n_solved = svc.last_batch.n_solved
    k1 = pareto_ops.LAUNCHES
    if k1 > 2 * n_solved:
        raise AssertionError(f"trained: {k1} K1 launches for {n_solved} "
                             "solved queries; at most 2 a query")
    l0 = read_launches()
    t0 = time.perf_counter()
    rts = sess.run_batch(queries, cts)
    torch.cuda.synchronize()
    runtime_s = time.perf_counter() - t0
    check_runtime_results(queries, cts, rts)
    launches = read_launches()
    n = {k: launches[k] - l0[k] for k in launches}
    rounds = sess.last_batch.rounds
    if n["runtime_pick"] != rounds:
        raise AssertionError(f"trained: {n['runtime_pick']} runtime_pick "
                             f"launches in {rounds} rounds; one a round")
    if n["pareto_filter"] or n["ws_reduce"]:
        raise AssertionError(f"trained: the runtime path launched "
                             f"pareto_filter or ws_reduce ({n})")
    require_launches("trained", launches)
    tc, tp, ts = default_theta(1)
    sims = [run_with_aqe(q, tc[0], tp[0], ts[0]).sim for q in queries]
    lat0 = sum(float(sim.actual_latency[0]) for sim in sims)
    cost0 = sum(float(sim.cost[0]) for sim in sims)
    lat = sum(float(r.sim.actual_latency[0]) for r in rts)
    cost = sum(float(r.sim.cost[0]) for r in rts)
    row = {"queries": len(queries), "solved": n_solved,
           "compile_qps": len(queries) / compile_s, "compile_s": compile_s,
           "mean_solve_s": float(np.mean([r.solve_time for r in cts])),
           "pareto_launches": k1, "runtime_s": runtime_s,
           "runtime_rounds": rounds,
           "runtime_pick_launches": n["runtime_pick"],
           "requests_sent": sess.last_batch.requests_sent,
           "total_latency_s": lat, "total_cost": cost,
           "default_total_latency_s": lat0, "default_total_cost": cost0,
           "latency_reduction": 1.0 - lat / lat0,
           "cost_reduction": 1.0 - cost / cost0}
    log(f"[trained] {json.dumps(row)}")
    log(f"[trained] {len(queries)} TPC-H queries: {row['compile_qps']:.2f} "
        f"q/s, mean solve {row['mean_solve_s']:.4f} s, {k1} K1 launches; "
        f"runtime {runtime_s:.4f} s, {rounds} rounds; simulated latency "
        f"{lat:.3f} s against {lat0:.3f} s under Spark's defaults "
        f"({row['latency_reduction']:.1%} less), cost {cost:.5g} against "
        f"{cost0:.5g} ({row['cost_reduction']:.1%} less); phase "
        f"{time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "row": row}


def run_baselines(device, model) -> list:
    """The paper's MOO baselines beside HMOOC3 on BASELINE_QUERIES TPC-H
    queries with the trained subq model on the card (fine-grained flat
    space); every front must be non-dominated."""
    t_phase = time.perf_counter()
    rows = []
    for q in make_benchmark("tpch")[:BASELINE_QUERIES]:
        obj = StageObjectives(q, model=model)
        res = hmooc_solve(obj.stage_eval, obj.m, obj.d_c, obj.d_ps,
                          HMOOCConfig(dag_method="hmooc3", seed=0),
                          snap_c=obj.snap_c, snap_ps=obj.snap_ps,
                          device=device)
        fronts = {"hmooc3": (res.front, res.solve_time, res.n_evals)}
        ev, D = obj.query_eval_fine()
        for name, solve, kw in BASELINE_SOLVERS:
            F, U, dt, n_evals = solve(ev, D, seed=0, **kw)
            if U.shape != (F.shape[0], D) or not ((U >= 0) & (U <= 1)).all():
                raise AssertionError(f"{q.qid} {name}: decisions out of the "
                                     "unit cube")
            fronts[name] = (F, dt, n_evals)
        for name, (F, dt, n_evals) in fronts.items():
            if F.ndim != 2 or F.shape[0] == 0 or not np.isfinite(F).all() \
                    or not pareto_core.pareto_mask_np(F).all():
                raise AssertionError(f"{q.qid} {name}: the front is empty, "
                                     "not finite or dominated")
            row = {"query": q.qid, "subqs": q.n_subqs, "dims": D,
                   "method": name, "solve_s": dt, "evals": int(n_evals),
                   "front_size": int(F.shape[0]),
                   "best_latency": float(F[:, 0].min()),
                   "best_cost": float(F[:, 1].min())}
            rows.append(row)
            log(f"[baselines] {json.dumps(row)}")
    log(f"[baselines] phase: {time.perf_counter() - t_phase:.3f} s")
    return rows


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


def check_lm_flash_against_plain(device, n_layers: int = 4, cfg=None,
                                 batch: int = LM_BATCH,
                                 prompt: int = LM_PROMPT) -> float:
    """glm4-9b (or ``cfg``) at full width, ``n_layers`` layers, float32
    with TF32 off: the scoring logits with ``use_flash`` (the kernel) and
    without it (the einsum route) on the same weights and prompts (and
    patches or frames), within LM_F32_ATOL with the same next tokens.  For
    an MoE configuration the plain route replays the routing the flash
    route took, so no rounding flips an expert."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(LM_ARCH, n_layers=n_layers, dtype="float32",
                            use_flash=True)
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(1))
    tokens, patches = lm_inputs(cfg, batch, prompt, device)
    with torch.no_grad():
        flash, routes = record_routes(
            lambda: model(tokens, patches, last_only=True)[0])
        model.cfg = cfg.with_(use_flash=False)
        plain, _ = record_routes(
            lambda: model(tokens, patches, last_only=True)[0], replay=routes)
    err = float((flash - plain).abs().max())
    agree = bool((flash[:, -1].argmax(-1) == plain[:, -1].argmax(-1)).all())
    if not (torch.isfinite(flash).all() and err <= LM_F32_ATOL and agree):
        raise AssertionError(f"flash and plain routes differ by {err:.3g}; "
                             f"same next tokens: {agree}")
    log(f"[check] {cfg.n_layers}-layer {cfg.name} float32 scoring logits: "
        f"flash route within {err:.3g} of the plain route"
        + (" (its routing replayed)" if routes else "")
        + f" (atol {LM_F32_ATOL}; |logit| up to "
        f"{float(plain.abs().max()):.3g}), the same next tokens")
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
    tokens, _ = lm_inputs(cfg, 1, length, device)
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


# ---------------------------------------------------------------------------
# The streaming layer: the server, scenarios under a calibrated clock, and
# the fleet, on the trained models
# ---------------------------------------------------------------------------

def model_server(device, models, config: ServerConfig, tenants=(),
                 cfg: HMOOCConfig = HMOOCConfig()) -> OptimizerServer:
    """A server whose both halves are model-backed: the subq model compiles,
    subq and qs re-tune at runtime, all on ``device``."""
    return OptimizerServer(
        config=config, tenants=tenants,
        tuning=TuningService(model=models["subq"], cfg=cfg, device=device),
        session=RuntimeSession(model_subq=models["subq"],
                               model_qs=models["qs"], weights=WEIGHTS,
                               device=device))


def results_equal(a, b) -> bool:
    """Two realized plans are the same bits."""
    return all(np.array_equal(x, y) for x, y in (
        (a.theta_p_eff, b.theta_p_eff), (a.theta_s_eff, b.theta_s_eff),
        (a.final_join, b.final_join),
        (a.sim.ana_latency, b.sim.ana_latency),
        (a.sim.actual_latency, b.sim.actual_latency),
        (a.sim.io_gb, b.sim.io_gb), (a.sim.cost, b.sim.cost)))


def results_close(a, b, rtol: float) -> bool:
    return np.array_equal(a.final_join, b.final_join) and all(
        np.allclose(x, y, rtol=rtol, atol=0.0) for x, y in (
            (a.theta_p_eff, b.theta_p_eff), (a.theta_s_eff, b.theta_s_eff),
            (a.sim.actual_latency, b.sim.actual_latency),
            (a.sim.io_gb, b.sim.io_gb), (a.sim.cost, b.sim.cost)))


def timeline(srv: OptimizerServer, served) -> str:
    """Everything a clocked serve decides, as one comparable string."""
    st = srv.last_run
    return repr(([(s.rid, s.status, s.admitted_s, s.compiled_s,
                   s.finished_s, s.joined_running) for s in served],
                 st.flush_windows, st.flush_caps, st.tenant_slots,
                 st.rounds, st.n_micro_batches))


def run_serve_path(device, models: dict) -> dict:
    """``OptimizerServer.serve`` at full width on the trained models:
    bench_server.run()'s 64-request TPC-H Poisson stream at 16 q/s through
    ServerConfig() on measured wall time, after an untimed warm-up serve.
    Gates: at most 2 K1 launches a solved query; one runtime_pick launch
    and one host sync a fusion round, and no K1 or ws_reduce launch inside
    a round; every served plan within SERVE_RTOL of the port's offline
    pipeline on the card (the bit-identical count is printed)."""
    t_phase = time.perf_counter()
    warm = serving_stream("tpch", 8, seed=1, query_seed=1,
                          arrivals=ArrivalModel("poisson", SERVE_RATE_QPS))
    model_server(device, models, ServerConfig()).serve(warm)
    torch.cuda.synchronize()
    reqs = serving_stream("tpch", SERVE_N, seed=0,
                          arrivals=ArrivalModel("poisson", SERVE_RATE_QPS))
    srv = model_server(device, models, ServerConfig())
    picks = {"calls": 0, "syncs": 0}
    in_round = {"pareto_filter": 0, "ws_reduce": 0}

    def weighted_pick(Fs, weights, **kw):
        out, syncs = count_syncs(lambda: pick_orig(Fs, weights, **kw),
                                 "serve")
        picks["calls"] += 1
        picks["syncs"] += syncs
        return out

    def step_round():
        l0 = read_launches()
        try:
            return step_orig()
        finally:
            l1 = read_launches()
            for k in in_round:
                in_round[k] += l1[k] - l0[k]

    timers = Timers()
    orig = (runtime_mod.weighted_pick_batch, service_mod.fused_stage_eval,
            hmooc.pareto_mask_fast, hmooc.pareto_masks_fast,
            runtime_mod.score_requests)
    pick_orig = orig[0]
    step_orig = srv.session.step_round
    runtime_mod.weighted_pick_batch = timers.wrap("weighted_pick_batch",
                                                  weighted_pick)
    service_mod.fused_stage_eval = timers.wrap("stage_eval", orig[1])
    hmooc.pareto_mask_fast = timers.wrap("pareto_masks", orig[2])
    hmooc.pareto_masks_fast = timers.wrap("pareto_masks", orig[3])
    runtime_mod.score_requests = timers.wrap("score_requests", orig[4])
    srv.session.step_round = timers.wrap("step_round", step_round)
    srv.session.realize = timers.wrap("realize", srv.session.realize)
    srv.tuning.tune_batch = timers.wrap("tune_batch", srv.tuning.tune_batch)
    solved0 = srv.tuning.totals.n_solved
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = srv.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (runtime_mod.weighted_pick_batch, service_mod.fused_stage_eval,
         hmooc.pareto_mask_fast, hmooc.pareto_masks_fast,
         runtime_mod.score_requests) = orig
        del srv.session.step_round, srv.session.realize
        del srv.tuning.tune_batch
    launches = read_launches()
    # The card's busy time in the same serve (a fresh server and freshly
    # built queries, so every solve and embedding runs again), traced; set
    # against the untraced wall above it gives the card's idle share.
    busy_ms = device_busy_ms(lambda: model_server(
        device, models, ServerConfig()).serve(serving_stream(
            "tpch", SERVE_N, seed=0,
            arrivals=ArrivalModel("poisson", SERVE_RATE_QPS))))
    st = srv.last_run
    rep = srv.latency_report(served)
    solved = srv.tuning.totals.n_solved - solved0
    queries = [s.request.query for s in served]
    cts = [s.ct for s in served]
    check_results(queries, cts)
    check_theta_bounds(queries, cts)
    check_runtime_results(queries, cts, [s.result for s in served])
    offline_cts = TuningService(model=models["subq"], cfg=HMOOCConfig(),
                                device=device).tune_batch(queries, WEIGHTS)
    offline = RuntimeSession(model_subq=models["subq"],
                             model_qs=models["qs"], weights=WEIGHTS,
                             device=device).run_batch(queries, offline_cts)
    identical = sum(results_equal(s.result, r)
                    for s, r in zip(served, offline))
    far = [s.rid for s, r in zip(served, offline)
           if not results_close(s.result, r, SERVE_RTOL)]
    row = {"requests": len(reqs), "rate_qps": SERVE_RATE_QPS,
           "served": rep["n_finished"], "qps": rep["qps"],
           "makespan_s": rep["makespan_s"], "wall_s": wall,
           "solve_p50_s": rep["solve_latency_s"]["p50"],
           "solve_p99_s": rep["solve_latency_s"]["p99"],
           "plan_p50_s": rep["plan_latency_s"]["p50"],
           "plan_p99_s": rep["plan_latency_s"]["p99"],
           "goodput": rep["goodput"], "micro_batches": st.n_micro_batches,
           "joined_running": st.n_joined_running, "rounds": st.rounds,
           "solved": solved, "pareto_launches": launches["pareto_filter"],
           "runtime_pick_launches": launches["runtime_pick"],
           "host_syncs_per_round": (picks["syncs"] / st.rounds
                                    if st.rounds else None),
           "k1_ws_launches_inside_rounds": in_round,
           "flush_window_s_sum": sum(w for w, _ in st.flush_windows),
           "tune_window_s_sum": sum(w for w, _ in st.tune_windows),
           "host_s": {k: round(v, 6) for k, v in timers.t.items()},
           "card_busy_ms": busy_ms,
           "card_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "bit_identical_to_offline": identical}
    log(f"[serve] {json.dumps(row)}")
    log(f"[serve] {len(reqs)} requests at {SERVE_RATE_QPS} q/s: "
        f"{rep['qps']:.3f} q/s served, plan p50/p99 "
        f"{row['plan_p50_s']:.4f}/{row['plan_p99_s']:.4f} s (budget "
        f"{srv.config.solve_budget_s} s), goodput {rep['goodput']:.3f}, "
        f"{st.n_micro_batches} micro-batches, {st.n_joined_running} joins, "
        f"{st.rounds} rounds; card busy {busy_ms:.3f} ms of a "
        f"{wall * 1e3:.3f} ms serve (profiler against untraced wall time); "
        f"{identical} of {len(served)} plans bit-identical to the offline "
        f"pipeline; phase {time.perf_counter() - t_phase:.3f} s")
    if rep["n_finished"] != len(reqs):
        raise AssertionError(f"serve: {rep['n_finished']} of {len(reqs)} "
                             "requests finished")
    if launches["pareto_filter"] > 2 * solved:
        raise AssertionError(f"serve: {launches['pareto_filter']} K1 "
                             f"launches for {solved} solved queries; at "
                             "most 2 a query")
    if not (launches["runtime_pick"] == picks["calls"] == st.rounds
            == picks["syncs"]):
        raise AssertionError(
            f"serve: {launches['runtime_pick']} runtime_pick launches and "
            f"{picks['syncs']} host syncs for {picks['calls']} picks in "
            f"{st.rounds} rounds; one of each a round")
    if any(in_round.values()):
        raise AssertionError(f"serve: K1 or ws_reduce launched inside a "
                             f"fusion round ({in_round})")
    if far:
        raise AssertionError(f"serve: requests {far} differ from the "
                             f"offline pipeline beyond rtol {SERVE_RTOL}")
    require_launches("serve", launches)
    return {"launches": launches, "row": row}


def unique_burst(n: int, seed: int):
    """``n`` distinct queries arriving at once (no response-cache hit)."""
    base = serving_stream("tpch", 4 * n, seed=seed,
                          arrivals=ArrivalModel(kind="fixed", rate_qps=1e6))
    seen, out = set(), []
    for r in base:
        if r.query.qid not in seen:
            seen.add(r.query.qid)
            out.append(r)
    return [dataclasses.replace(r, rid=i, arrival_s=0.0)
            for i, r in enumerate(out[:n])]


def calibrate_clock(device, models) -> ServiceTimeModel:
    """benchmarks/bench_server.py _calibrate_clock()'s procedure on the
    card: a burst of CALIB_N distinct queries served at each of CALIB_CAPS
    on a fresh server, a first pass discarded and CALIB_PASSES more
    measured; each batch size's lower-quartile flush window is a knot, the
    round cost is the serve walls' remainder over their rounds, and the
    cheap member's cost the median flush of a warm server re-serving the
    burst at cap 1."""
    n, passes = CALIB_N, CALIB_PASSES
    windows, wall_rest, rounds = {}, 0.0, 0
    for cap in CALIB_CAPS:
        for attempt in range(1 + passes):
            srv = model_server(device, models, ServerConfig(
                max_batch=cap, solve_budget_s=math.inf,
                admit_mid_session=False))
            srv.serve(unique_burst(n, 987))
            if attempt == 0:
                continue
            st = srv.last_run
            for w, size in st.flush_windows:
                windows.setdefault(size, []).append(w)
            wall_rest += max(0.0, st.wall_time_s
                             - sum(w for w, _ in st.flush_windows))
            rounds += st.rounds
    srv = model_server(device, models, ServerConfig(
        max_batch=1, solve_budget_s=math.inf, admit_mid_session=False))
    cheap = []
    for attempt in range(1 + passes):
        srv.serve(unique_burst(n, 987))
        if attempt:
            cheap.extend(w for w, _ in srv.last_run.flush_windows)
    return ServiceTimeModel(
        flush_points=tuple((size, float(np.percentile(ws, 25)))
                           for size, ws in sorted(windows.items())),
        round_s=wall_rest / rounds if rounds else 0.0,
        cheap_s=float(np.median(cheap)) if cheap else 0.0)


def clocked_capacity(device, models, clock, n: int, max_batch: int,
                     seed: int) -> float:
    """Queries a second, in the clock's world, of a throwaway server
    draining ``n`` requests that arrive at once (duplicates included)."""
    probe = [dataclasses.replace(r, rid=i, arrival_s=0.0)
             for i, r in enumerate(serving_stream(
                 "tpch", n, seed=seed,
                 arrivals=ArrivalModel(kind="fixed", rate_qps=1e6)))]
    srv = model_server(device, models, ServerConfig(
        max_batch=max_batch, solve_budget_s=math.inf, clock=clock))
    span = max(s.finished_s for s in srv.serve(probe))
    return len(probe) / span if span > 0 else 1.0


class Replay:
    """One-at-a-time offline pipeline on the card, memoised by (query,
    weights): the reference an admitted request's plan is held to."""

    def __init__(self, device, models):
        self.device, self.models = device, models
        self.svc = TuningService(model=models["subq"], cfg=HMOOCConfig(),
                                 device=device)
        self.pools = CandidatePoolCache()
        self.memo = {}

    def __call__(self, query, weights):
        key = (query.qid, query_fingerprint(query), tuple(weights))
        if key not in self.memo:
            ct = self.svc.tune_batch([query], weights)[0]
            sess = RuntimeSession(model_subq=self.models["subq"],
                                  model_qs=self.models["qs"],
                                  weights=weights, pool_cache=self.pools,
                                  device=self.device)
            self.memo[key] = sess.run_batch([query], [ct])[0]
        return self.memo[key]


def run_scenarios_path(device, models: dict, clock) -> dict:
    """The nine-scenario matrix (diurnal, flash-crowd and ramp arrivals
    crossed with steady, preference-shift and churn timelines), each
    served by a static and an elastic server under the calibrated clock,
    the elastic one twice.  Gates: the two elastic serves' timelines are
    identical, and every full-quality survivor of either policy equals the
    one-at-a-time offline pipeline under its stamped weights exactly."""
    t_phase = time.perf_counter()
    elastic_cap = SCENARIO_ELASTIC_CEILING * SCENARIO_MAX_BATCH
    capacity = clocked_capacity(device, models, clock,
                                3 * SCENARIO_N_PER_TENANT,
                                SCENARIO_MAX_BATCH, seed=17)
    rate = SCENARIO_LOAD * capacity / 3.0
    reserve = 2.0 / capacity
    static_cfg = ServerConfig(max_batch=SCENARIO_MAX_BATCH,
                              solve_budget_s=SCENARIO_BUDGET_S,
                              solve_reserve_s=reserve, clock=clock)
    elastic_cfg = dataclasses.replace(static_cfg, elastic=ElasticPolicy(
        min_batch=SCENARIO_MAX_BATCH, max_batch=elastic_cap,
        target_delay_s=0.25 * SCENARIO_BUDGET_S))
    log(f"[scenarios] clock knots {list(clock.flush_points)}, round "
        f"{clock.round_s:.6f} s, cheap {clock.cheap_s:.6f} s; capacity "
        f"{capacity:.3f} q/s in the clock's world, {rate:.3f} q/s a tenant")
    runs = []
    reset_launches()
    t_serve = time.perf_counter()
    for spec in scenario_matrix(n_per_tenant=SCENARIO_N_PER_TENANT,
                                rate_qps=rate):
        sc = spec.build(seed=0)
        out = {}
        for name, cfg in (("static", static_cfg), ("elastic", elastic_cfg),
                          ("elastic again", elastic_cfg)):
            srv = model_server(device, models, cfg, tenants=sc.tenants)
            out[name] = (srv, srv.serve(sc.requests,
                                        capacity_events=sc.capacity_events))
        runs.append((spec, sc, out))
    serve_s = time.perf_counter() - t_serve
    launches = read_launches()
    replay = Replay(device, models)
    rows, bad = [], []
    for spec, sc, out in runs:
        if timeline(*out["elastic"]) != timeline(*out["elastic again"]):
            bad.append(f"{spec.name}: two clocked serves disagree")
        span = (max(r.arrival_s for r in sc.requests)
                - min(r.arrival_s for r in sc.requests))
        row = {"scenario": spec.name, "requests": len(sc.requests)}
        for name in ("static", "elastic"):
            srv, served = out[name]
            n_surv = 0
            for s in served:
                if s.status in REJECTED_STATUSES:
                    if s.result is not None:
                        bad.append(f"{spec.name}/{name}: rejected rid "
                                   f"{s.rid} has a plan")
                    continue
                if s.status != "served":
                    continue
                n_surv += 1
                w = tuple(s.request.weights) if s.request.weights \
                    is not None else WEIGHTS
                if not results_equal(s.result, replay(s.request.query, w)):
                    bad.append(f"{spec.name}/{name}: rid {s.rid} differs "
                               "from its offline replay")
            rep = srv.latency_report(served,
                                     window_s=span / SCENARIO_WINDOWS + 1e-9)
            strict = rep["tenants"]["strict"]
            row[name] = {"goodput": rep["goodput"],
                         "strict_p99_s": strict["plan_latency_s"]["p99"],
                         "plan_p99_s": rep["plan_latency_s"]["p99"],
                         "shed_rate": rep["shed_rate"],
                         "degrade_rate": rep["degrade_rate"],
                         "rate_limited_rate": rep["rate_limited_rate"],
                         "survivors": n_surv,
                         "max_cap": max(srv.last_run.flush_caps, default=0)}
        rows.append(row)
        log(f"[scenarios] {json.dumps(row)}")
    row = {"scenarios": len(rows), "serves": 3 * len(rows),
           "serve_s": serve_s, "replays": len(replay.memo),
           "capacity_qps": capacity, "rate_qps_per_tenant": rate,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[scenarios] {json.dumps(row)}")
    if bad:
        raise AssertionError("scenarios: " + "; ".join(bad[:10]))
    require_launches("scenarios", launches)
    return {"launches": launches, "rows": rows, "row": row}


def overload_specs(rate_qps: float, budget_s: float):
    """bench_server._overload_specs: one tenant per SLO class at a third
    of the rate each, UDAO-style distinct weights; the strict tenant in a
    higher tier, the best-effort tenant's budget soft (10x)."""
    return [TenantSpec(
        name=slo, slo=slo, weights=TENANT_PREFS[i % len(TENANT_PREFS)],
        solve_budget_s=10 * budget_s if slo == "best_effort" else budget_s,
        priority=1 if slo == "strict" else 0,
        arrivals=ArrivalModel(kind="poisson", rate_qps=rate_qps / 3))
        for i, slo in enumerate(("strict", "degrade", "best_effort"))]


def no_torch_in(blob: bytes) -> None:
    """A published snapshot unpickles without torch: it holds no tensor."""
    class Guard(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] == "torch":
                raise AssertionError(f"a snapshot holds {module}.{name}")
            return super().find_class(module, name)
    Guard(io.BytesIO(blob)).load()


def run_fleet_path(device, models: dict, clock) -> dict:
    """``OptimizerFleet`` at 1, 2 and 4 workers on the card, affinity and
    random routing (and everything on worker 0 at the widest), on
    run_fleet()'s overload mix under the calibrated clock.  Gates: a
    request served at full quality at two widths gets the same plan, and
    the widest affinity fleet's published caches round-trip through a
    file into a warm fleet that serves the same plans."""
    t_phase = time.perf_counter()
    capacity = clocked_capacity(device, models, clock, FLEET_N,
                                FLEET_MAX_BATCH, seed=17)
    rate = FLEET_LOAD * capacity
    specs = overload_specs(rate, FLEET_BUDGET_S)
    counts = [FLEET_N // 3 + (1 if i < FLEET_N % 3 else 0) for i in range(3)]
    reqs = multi_tenant_stream("tpch", specs, counts, seed=0)
    cfg = ServerConfig(max_batch=FLEET_MAX_BATCH,
                       solve_budget_s=FLEET_BUDGET_S,
                       solve_reserve_s=2.0 / capacity, clock=clock)
    store = CacheStore()
    fleets = [(n, p) for n in FLEET_WORKERS for p in ("affinity", "random")]
    fleets.append((max(FLEET_WORKERS), "single"))
    out, rows = {}, []
    reset_launches()
    for n, policy in fleets:
        fleet = OptimizerFleet(
            n_workers=n, config=cfg, weights=WEIGHTS, cfg=HMOOCConfig(),
            model=models["subq"], tenants=specs, policy=policy,
            steal_delay_s=FLEET_BUDGET_S, seed=0, device=device,
            cache_store=store if (n, policy) == (max(FLEET_WORKERS),
                                                 "affinity") else None)
        t0 = time.perf_counter()
        served = fleet.serve(reqs)
        wall = time.perf_counter() - t0
        rep = fleet.latency_report(served)
        caches = fleet.cache_report()
        out[(n, policy)] = {s.rid: s for s in served}
        row = {"workers": n, "policy": policy, "qps": rep["qps"],
               "makespan_s": rep["makespan_s"], "goodput": rep["goodput"],
               "strict_p99_s": rep["tenants"]["strict"][
                   "plan_latency_s"]["p99"],
               "shed_rate": rep["shed_rate"],
               "degrade_rate": rep["degrade_rate"],
               "rate_limited_rate": rep["rate_limited_rate"],
               "stolen": rep["n_stolen"],
               "worker_counts": rep["worker_counts"],
               "response_hit_rate": caches["response"]["hit_rate"],
               "eset_warm_rate": caches["effective_set"]["warm_rate"],
               "wall_s": wall}
        rows.append(row)
        log(f"[fleet] {json.dumps(row)}")
    launches = read_launches()
    bad = []
    base = out[fleets[0]]
    for key in fleets[1:]:
        for rid, s in out[key].items():
            if s.status == "served" and base[rid].status == "served" \
                    and not results_equal(s.result, base[rid].result):
                bad.append(f"{key}: rid {rid} differs from 1 worker")
    for kind in store.kinds():
        no_torch_in(store.fetch(kind))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "caches.pkl"
        store.save(path)
        loaded = CacheStore.load(path)
    if loaded.kinds() != store.kinds() or set(store.kinds()) != {
            "eset", "response", "pools"}:
        bad.append(f"cache store kinds {store.kinds()} / {loaded.kinds()}")
    warm = OptimizerFleet(n_workers=1, config=cfg, weights=WEIGHTS,
                          cfg=HMOOCConfig(), model=models["subq"],
                          tenants=specs, cache_store=loaded,
                          publish_on_serve=False, device=device)
    restored = len(warm.workers[0].tuning._results)
    served = warm.serve(reqs)
    hits = warm.cache_report()["response"]["hit_rate"]
    widest = out[(max(FLEET_WORKERS), "affinity")]
    for s in served:
        w = widest[s.rid]
        if s.status == "served" and w.status == "served" \
                and not results_equal(s.result, w.result):
            bad.append(f"warm start: rid {s.rid} differs")
    row = {"capacity_qps": capacity, "rate_qps": rate,
           "requests": len(reqs), "restored_responses": restored,
           "warm_response_hit_rate": hits, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[fleet] {json.dumps(row)}")
    if not restored:
        bad.append("the warm fleet restored no response")
    if bad:
        raise AssertionError("fleet: " + "; ".join(bad[:10]))
    require_launches("fleet", launches)
    return {"launches": launches, "rows": rows, "row": row}


# ---------------------------------------------------------------------------
# Phase 5: the user-facing entry points (examples, cluster autotuner)
# ---------------------------------------------------------------------------

def quiet(fn, *args, **kwargs):
    """(fn's result, what it printed): an example prints its walk-through,
    which the phase logs only the last line of."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def example_plans(out: dict):
    """(compile-time results, AQE runs, solved queries) of one example's
    ``run()``."""
    if "rows" in out:                                   # tpch_tuning
        cts = [r["compile_time"] for r in out["rows"]]
        runs = [x for r in out["rows"] for x in (r["default"], r["tuned"])]
        return cts, runs, len(cts)
    if "batches" in out:                                # serve_tuning
        cts = [r for b in out["batches"] for r in b["results"]]
        return cts, [], sum(b["stats"].n_solved for b in out["batches"])
    return ([out["compile_time"]],                      # quickstart
            [out["default"], out["hmooc3"], out["runtime"]], 1)


def compile_results_equal(a, b) -> bool:
    return a.choice == b.choice and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in (
            "front", "theta_c", "theta_p_sub", "theta_s_sub", "theta_p0",
            "theta_s0"))


def compile_results_close(a, b, rtol: float) -> bool:
    return a.front.shape == b.front.shape and all(
        np.allclose(x, y, rtol=rtol, atol=0.0) for x, y in (
            (a.front, b.front), (a.theta_c, b.theta_c)))


def run_examples_path(device, models: dict) -> dict:
    """The four examples' ``run()`` on the card, then on the host: the
    quickstart, the service demo and the 22 TPC-H queries on the oracle
    backend (plans, simulated latency and cost and runtime requests equal
    to the host's), then the TPC-H loop on the trained subq and qs models
    (within EXAMPLE_MODEL_RTOL of the same weights on the host).  Gates:
    K1 launched in each example, at most twice a solved query; the runtime
    pick launched wherever the example runs AQE."""
    t_phase = time.perf_counter()
    cuda_models = (models["subq"], models["qs"])
    host_models = tuple(host_copy(m) for m in cuda_models)
    cases = [  # name, run(device, models), model-backed, runs AQE
        ("quickstart", lambda d, m: quickstart.run(device=d), False, True),
        ("serve_tuning", lambda d, m: serve_tuning.run(device=d), False,
         False),
        ("tpch_tuning", lambda d, m: tpch_tuning.run(device=d), False,
         True),
        ("tpch_tuning --model",
         lambda d, m: tpch_tuning.run(*m, device=d), True, True)]
    reset_launches()
    rows = []
    for name, run, with_model, aqe in cases:
        l0 = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card, text = quiet(run, device, cuda_models)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: v - l0[k] for k, v in read_launches().items()}
        t0 = time.perf_counter()
        host, _ = quiet(run, "cpu", host_models)
        host_wall = time.perf_counter() - t0
        cts, runs, solved = example_plans(card)
        cts_h, runs_h, solved_h = example_plans(host)
        if (len(cts), len(runs), solved) != (len(cts_h), len(runs_h),
                                            solved_h):
            raise AssertionError(f"{name}: the card and the host solved "
                                 "different query counts")
        for a, b in zip(cts, cts_h):
            ok = (compile_results_close(a, b, EXAMPLE_MODEL_RTOL)
                  if with_model else compile_results_equal(a, b))
            if not ok:
                raise AssertionError(f"{name}: a compile-time plan on the "
                                     "card differs from the host's")
        for a, b in zip(runs, runs_h):
            ok = (results_close(a, b, EXAMPLE_MODEL_RTOL) if with_model
                  else results_equal(a, b))
            if not ok or a.requests_sent != b.requests_sent:
                raise AssertionError(f"{name}: an AQE run on the card "
                                     "differs from the host's")
        rel = max([float(np.max(np.abs(a.front - b.front) / np.abs(b.front)))
                   for a, b in zip(cts, cts_h)]
                  + [float(np.max(np.abs(a.sim.actual_latency
                                         - b.sim.actual_latency)
                                  / b.sim.actual_latency))
                     for a, b in zip(runs, runs_h)])
        k1, picks = n["pareto_filter"], n["runtime_pick"]
        if not 1 <= k1 <= 2 * solved:
            raise AssertionError(f"{name}: {k1} K1 launches for {solved} "
                                 "solved queries; at least 1, at most 2 a "
                                 "query")
        if aqe and picks < 1:
            raise AssertionError(f"{name}: the runtime pick was not "
                                 "launched")
        st = np.array([r.solve_time for r in cts])
        verdict = (f"within relative {rel:.3g} (rtol {EXAMPLE_MODEL_RTOL:g})"
                   " of" if with_model else "equal to")
        row = {"example": name, "wall_s": wall, "host_wall_s": host_wall,
               "solved": solved, "mean_solve_s": float(st.mean()),
               "max_solve_s": float(st.max()), "pareto_launches": k1,
               "runtime_pick_launches": picks,
               "requests_sent": sum(r.requests_sent for r in runs),
               "max_rel_diff_to_host": rel}
        rows.append(row)
        log(f"[examples] {json.dumps(row)}")
        log(f"[examples] {name}: {wall:.3f} s on the card ({host_wall:.3f} "
            f"s on the host); solve mean {st.mean():.4f} s, max "
            f"{st.max():.4f} s against the 1-2 s budget; {k1} K1 launches "
            f"for {solved} solved queries, {picks} runtime picks; "
            f"{verdict} the host; last line: "
            f"{text.splitlines()[-1].strip()}")
    launches = read_launches()
    require_launches("examples", launches)
    log(f"[examples] phase: {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "rows": rows}


def plans_equal(a, b) -> bool:
    return (a.theta_c, a.theta_p, a.theta_s, a.predicted) == \
        (b.theta_c, b.theta_p, b.theta_s, b.predicted) \
        and np.array_equal(a.front, b.front)


def run_cluster_path(device, k1_inputs) -> dict:
    """``autotune`` over the ported configurations × the shape cells each
    supports × the example's weights, on the card and on the host (plans
    equal), with the H100 figures of ``cluster/costmodel.py``.  Gate: at
    most 2 K1 launches a solve, and some.  Then two readings beside the
    cost model: one bf16 product at qwen2-72b's FFN shape against
    ``TC_EFF``, and ``pareto_mask`` on the card against K1 and
    ``pareto_mask_np`` on every bank of the compile-time path's largest
    K1 stack (``k1_inputs``), with its time per call."""
    t_phase = time.perf_counter()
    reset_launches()
    solves, host_s, card_s = 0, 0.0, 0.0
    for arch in CLUSTER_ARCHS:
        for shape in SHAPES:
            if not cell_applicable(get_config(arch), shape):
                continue
            for w in cluster_example.WEIGHTS:
                l0 = pareto_ops.LAUNCHES
                t0 = time.perf_counter()
                plan = autotune(arch, shape, weights=w, device=device)
                card_s += time.perf_counter() - t0
                k1 = pareto_ops.LAUNCHES - l0
                t0 = time.perf_counter()
                host = autotune(arch, shape, weights=w, device="cpu")
                host_s += time.perf_counter() - t0
                if k1 > 2:
                    raise AssertionError(f"{arch}×{shape}: {k1} K1 "
                                         "launches in one solve; at most 2")
                if not plans_equal(plan, host):
                    raise AssertionError(f"{arch}×{shape} w={w}: the plan "
                                         "on the card differs from the "
                                         "host's")
                solves += 1
                log(f"[cluster] w(lat,cost)=({w[0]:.2f},{w[1]:.2f}) → "
                    f"{plan.summary()}; {k1} K1 launches")
    launches = read_launches()
    require_launches("cluster", launches)
    tc = measure_tc_eff(device)
    mask_ms = check_pareto_mask(*k1_inputs)
    row = {"solves": solves, "card_s": card_s, "host_s": host_s,
           "pareto_launches": launches["pareto_filter"], **tc,
           "pareto_mask_ms": mask_ms,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[cluster] {json.dumps(row)}")
    log(f"[cluster] {solves} plans equal to the host's; {card_s:.3f} s of "
        f"solves on the card ({card_s / solves:.4f} s a plan), {host_s:.3f} "
        f"s on the host; {launches['pareto_filter']} K1 launches; phase "
        f"{row['phase_s']:.3f} s")
    return {"launches": launches, "row": row}


def measure_tc_eff(device) -> dict:
    """One bf16 ``torch.matmul`` of CLUSTER_MATMUL_TOKENS rows at
    qwen2-72b's FFN shape, after a warm-up: achieved over peak, beside the
    cost model's ``TC_EFF``."""
    cfg = get_config("qwen2-72b")
    T, d, f = CLUSTER_MATMUL_TOKENS, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(T, d, device=device, dtype=torch.bfloat16, generator=g)
    b = torch.randn(d, f, device=device, dtype=torch.bfloat16, generator=g)
    ms = time_cuda(lambda: torch.matmul(a, b), iters=20, warm=5)
    rate = 2.0 * T * d * f / (ms * 1e-3)
    eff = rate / BF16_OPS_PER_S
    log(f"[cluster] bf16 matmul ({T}, {d}) x ({d}, {f}), qwen2-72b's FFN: "
        f"{ms:.4f} ms, {rate / 1e12:.1f} TFLOP/s = {eff:.3f} of the "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s peak; the cost model's "
        f"TC_EFF {cluster_costmodel.TC_EFF} (card {card_line()})")
    del a, b
    return {"matmul_ms": ms, "matmul_tflops": rate / 1e12,
            "tc_eff_measured": eff, "tc_eff_model": cluster_costmodel.TC_EFF}


def check_pareto_mask(F: torch.Tensor, valid: torch.Tensor) -> float:
    """``pareto_mask`` on the card, bank by bank of an (S, n, k) stack,
    equal to K1's masks of the stack and to ``pareto_mask_np``; returns
    milliseconds per call on one bank."""
    k1 = pareto_pkg.pareto_filter_segments(F, valid).cpu().numpy()
    got = torch.stack([pareto_core.pareto_mask(F[s], valid[s])
                       for s in range(F.shape[0])]).cpu().numpy()
    F_h, v_h = F.double().cpu().numpy(), valid.cpu().numpy()
    want = np.stack([pareto_core.pareto_mask_np(F_h[s], v_h[s])
                     for s in range(F.shape[0])])
    if not (np.array_equal(got, k1) and np.array_equal(got, want)):
        raise AssertionError("pareto_mask on the card differs from K1 or "
                             "pareto_mask_np")
    ms = time_cuda(lambda: pareto_core.pareto_mask(F[0], valid[0]),
                   iters=200)
    log(f"[cluster] pareto_mask on the card equal to K1 and pareto_mask_np "
        f"on {F.shape[0]} banks of {tuple(F.shape[1:])} (the compile-time "
        f"path's largest K1 stack, {int(want.sum())} rows kept); "
        f"{ms:.6f} ms a call on one bank")
    return ms


# ---------------------------------------------------------------------------
# Phase 6: dense-LM training (data pipeline, train step, checkpoints)
# ---------------------------------------------------------------------------

def lm_train_smoke(device) -> dict:
    """The intent of the reference's test_train_loss_decreases on the card:
    the bfloat16 smoke glm4-9b, LM_TRAIN_SMOKE's batch, rate and steps;
    the last loss below LM_TRAIN_DROP x the first, every loss finite."""
    s = LM_TRAIN_SMOKE
    cfg = get_smoke_config(s["arch"])
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0))
    it = data_iterator(cfg, global_batch=s["batch"], seq_len=s["seq"],
                       seed=0)
    opt = OptConfig(lr=s["lr"], total_steps=s["steps"],
                    warmup_steps=s["warmup"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_loop(model, it, steps=s["steps"], opt_cfg=opt, log_every=1)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != s["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"smoke training losses {losses}")
    if not losses[-1] < LM_TRAIN_DROP * losses[0]:
        raise AssertionError(f"smoke training loss {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}: not below {LM_TRAIN_DROP}"
                             " x the first")
    log(f"[lm_train] smoke {cfg.name} ({cfg.dtype}), {s['steps']} steps of "
        f"{s['batch']} x {s['seq']} tokens at lr {s['lr']}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({losses[-1] / losses[0]:.3f} of the first) in {wall:.3f} s")
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "steps": s["steps"], "wall_s": wall}


def check_lm_train_against_host(device, arch: str = "glm4-9b") -> float:
    """LM_TRAIN_CHECK_STEPS steps with accum LM_TRAIN_CHECK_ACCUM of the
    float32 smoke model from one start on the card and on the host: every
    loss, learning rate and gradient norm within LM_TRAIN_RTOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32")
    host = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    card = build_model(cfg, device,
                       torch.Generator(device=device).manual_seed(0))
    card.load_state_dict(host.state_dict())
    it = data_iterator(cfg, global_batch=8, seq_len=32, seed=1)
    batches = [next(it) for _ in range(LM_TRAIN_CHECK_STEPS)]
    opt = OptConfig(lr=1e-3, total_steps=100, warmup_steps=3)
    runs = []
    for model in (card, host):
        fns = make_lm_train_step(model, opt, accum=LM_TRAIN_CHECK_ACCUM)
        params, state = fns.init()
        rows = []
        for b in batches:
            params, state, m = fns.step(params, state, b)
            rows.append([m[k] for k in ("loss", "lr", "grad_norm")])
        runs.append(np.array([[float(x) for x in r] for r in rows]))
    got, want = runs
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    if not err <= LM_TRAIN_RTOL:
        raise AssertionError(f"{arch} training steps on the card differ from "
                             f"the host's by relative {err:.3g}: card {got}, "
                             f"host {want}")
    log(f"[check] {LM_TRAIN_CHECK_STEPS} {arch} float32 training steps "
        f"(accum {LM_TRAIN_CHECK_ACCUM}) on the card: losses, learning rates"
        f" and gradient norms within relative {err:.3g} of the host's (rtol "
        f"{LM_TRAIN_RTOL})")
    return err


def check_lm_train_refuses_flash(device) -> None:
    """use_flash on the training path raises: the train step refuses the
    configuration, and the kernel's wrapper refuses inputs that need a
    gradient; neither launches the kernel."""
    cfg = get_smoke_config("glm4-9b", use_flash=True)
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0))
    batch = make_lm_batch(cfg, global_batch=2, seq_len=16, step=0)
    before = flash_ops.LAUNCHES
    fns = make_lm_train_step(model, OptConfig())
    refused = []
    try:
        fns.step(*fns.init(), batch)
    except RuntimeError as e:
        refused.append(str(e))
    try:
        model.loss(batch)
    except RuntimeError as e:
        refused.append(str(e))
    if len(refused) != 2 or not all("no backward pass" in r
                                    for r in refused):
        raise AssertionError(f"use_flash trained: {refused}")
    if flash_ops.LAUNCHES != before:
        raise AssertionError("a refused training step launched the flash "
                             "kernel")
    log("[check] use_flash on the training path raises in the train step "
        "and in the kernel's wrapper, with no launch")


def lm_train_full_width(device) -> dict:
    """LM_TRAIN_ARCH at full width (bfloat16, float32 moments, remat
    "block"), weights from a seed on the card; LM_TRAIN_WARM untimed steps
    (the second counts host syncs), LM_TRAIN_TIMED timed steps of the
    global batch with the configuration's accumulation, one more traced
    for the card's busy time.  Losses must be finite, the last below the
    first."""
    cfg = get_config(LM_TRAIN_ARCH)
    batch, seq, accum = LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.train_accum
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0
    it = data_iterator(cfg, global_batch=batch, seq_len=seq, seed=0)
    n_steps = LM_TRAIN_WARM + LM_TRAIN_TIMED + 1
    batches = [next(it) for _ in range(n_steps)]
    opt = OptConfig(lr=LM_TRAIN_FULL_LR, total_steps=100, warmup_steps=10,
                    moment_dtype=cfg.moment_dtype)
    torch.cuda.reset_peak_memory_stats()
    fns = make_lm_train_step(model, opt, accum=accum)
    params, state = fns.init()
    losses = []
    syncs = None
    for i in range(LM_TRAIN_WARM):
        def one():
            return fns.step(params, state, batches[i])
        if i == LM_TRAIN_WARM - 1:
            (params, state, m), syncs = count_syncs(one, "lm_train")
        else:
            params, state, m = one()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_TRAIN_WARM, LM_TRAIN_WARM + LM_TRAIN_TIMED):
        params, state, m = fns.step(params, state, batches[i])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LM_TRAIN_TIMED
    prof = device_breakdown(lambda: losses.append(
        fns.step(params, state, batches[-1])[2]["loss"]), top=LM_TRAIN_TOP)
    busy = prof["busy_ms"]
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(device).total_memory
    losses = torch.stack(losses).tolist()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"full-width training losses {losses}: not all "
                             "finite, or the last not below the first")
    tokens = batch * seq
    bound_s = 6 * n_params * tokens / BF16_OPS_PER_S
    state_bytes = sum(t.numel() * t.element_size()
                      for d in (params, state["m"], state["v"])
                      for t in d.values())
    row = {"arch": cfg.name, "n_params": n_params, "dtype": cfg.dtype,
           "moment_dtype": cfg.moment_dtype, "remat": cfg.remat,
           "global_batch": batch, "seq": seq, "accum": accum,
           "build_s": build_s, "step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "bound_6NT_s": bound_s, "share_of_6NT_bound": bound_s / step_s,
           "step_device_busy_ms": busy,
           "step_kernel_launches": prof["kernel_launches"],
           "idle_share": 1 - busy / (step_s * 1e3),
           "max_memory_bytes": peak, "device_memory_bytes": total,
           "state_bytes": state_bytes,
           "host_syncs_per_step": syncs, "losses": losses}
    log(f"[lm_train] {json.dumps(row)}")
    log(f"[lm_train] {cfg.name} full width ({n_params} parameters, "
        f"{cfg.dtype}, {cfg.moment_dtype} moments, remat {cfg.remat}): "
        f"{batch} x {seq} tokens a step, accum {accum}: {step_s:.4f} s a "
        f"step ({tokens / step_s:.1f} tokens/s) over {LM_TRAIN_TIMED} timed "
        f"steps; 6NT bound {bound_s:.4f} s = {bound_s / step_s:.3f} of the "
        f"step; card busy {busy:.1f} ms of a step (profiler against "
        f"untraced wall time); peak memory {peak} of {total} bytes "
        f"(parameters and moments {state_bytes}); {syncs} host syncs in a "
        f"step (sync debug mode); losses {[round(x, 4) for x in losses]}")
    log(f"[lm_train] one traced step: {prof['kernel_launches']} kernel "
        f"launches; top kernels by device ms {prof['top_kernels']}; top host "
        f"ops by self ms {prof['top_host_ops']}")
    return row


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor as integers of its width: bit-equal means equal here."""
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def lm_train_checkpoint(device) -> dict:
    """The train_lm example at its --m100 scale on the card (pipeline,
    train loop, checkpoint, restore), then its checkpoint restored into a
    fresh model and optimizer state: every tensor bit-equal to the live
    state, and the next step's loss from the restored state equal to the
    live state's (gradient norms within LM_TRAIN_RTOL: the embedding's
    backward adds with atomics)."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out = train_lm.run(steps=LM_TRAIN_CKPT_STEPS, batch=8, seq=128,
                           m100=True, device=device)
    run_s = time.perf_counter() - t0
    live, restored = ({"params": out["params"], "opt": out["opt_state"]},
                      out["restored"])
    if out["restored_step"] != LM_TRAIN_CKPT_STEPS:
        raise AssertionError(f"restored step {out['restored_step']}")
    cfg = out["model"].cfg
    fresh = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(1))
    fresh.load_state_dict(restored["params"])
    n = 0
    for group in ("params", "m", "v"):
        a = live["params"] if group == "params" else live["opt"][group]
        b = dict(fresh.named_parameters()) if group == "params" \
            else restored["opt"][group]
        for name, t in a.items():
            if t.dtype != b[name].dtype or \
                    not torch.equal(bits(t), bits(b[name])):
                raise AssertionError(f"{group} {name} changed in the "
                                     "checkpoint round trip")
            n += 1
    if int(restored["opt"]["step"]) != int(live["opt"]["step"]):
        raise AssertionError("the optimizer step changed in the round trip")
    it = data_iterator(cfg, global_batch=8, seq_len=128,
                       start_step=LM_TRAIN_CKPT_STEPS)
    nxt = next(it)
    opt = OptConfig(lr=3e-3, total_steps=2 * LM_TRAIN_CKPT_STEPS)
    a_fns = make_lm_train_step(out["model"], opt)
    b_fns = make_lm_train_step(fresh, opt)
    _, _, ma = a_fns.step(live["params"], live["opt"], nxt)
    _, _, mb = b_fns.step(dict(fresh.named_parameters()), restored["opt"],
                          nxt)
    la, lb = float(ma["loss"]), float(mb["loss"])
    ga, gb = float(ma["grad_norm"]), float(mb["grad_norm"])
    if la != lb or not abs(ga - gb) <= LM_TRAIN_RTOL * ga:
        raise AssertionError(f"the next step from the restored state: loss "
                             f"{lb!r} against {la!r}, gradient norm {gb!r} "
                             f"against {ga!r}")
    n_params = out["n_params"]
    log(f"[lm_train] checkpoint round trip at the --m100 scale ({n_params} "
        f"parameters): the example's {LM_TRAIN_CKPT_STEPS} steps, save and "
        f"restore in {run_s:.3f} s; {n + 1} tensors bit-equal after a fresh "
        f"model and optimizer state load them; next-step loss {lb!r} equal, "
        f"gradient norm within {abs(ga - gb) / ga:.3g}; example output "
        f"{text.getvalue().splitlines()[-1]!r}")
    return {"n_params": n_params, "tensors": n + 1, "next_loss": lb,
            "run_s": run_s}


def family_config(arch: str, over):
    """A [shard] family row's configuration, and the overrides that make it
    from the full configuration (what ``dryrun_cell`` takes): ``over``
    itself, or for ``None`` the smoke configuration's fields in float32
    with use_flash."""
    if over is not None:
        return get_config(arch, **over), over
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    full = get_config(arch)
    return cfg, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(full, f.name)}


def family_decode_cell(name: str, cfg, batch: int, capacity: int
                       ) -> ShapeCell:
    """The dry-run's decode cell whose cache is a [shard] family row's
    (``capacity`` slots; the dry-run adds a VLM's patch slots to the
    cell's length)."""
    pre = cfg.n_patches if cfg.family == "vlm" else 0
    return ShapeCell(f"shard_{name}_decode", "decode", capacity - pre, batch)


def shard_dryrun_rows() -> dict:
    """``launch/dryrun.py``'s rows for the [shard] cells on the (1, 1) mesh
    of a fake one-rank world (meta tensors, no card); run before the NCCL
    world exists, since a process has one default group.  Besides the
    train and scoring cells, each family row's decode cell."""
    rows = {}
    cells = [("train", LM_TRAIN_ARCH, SHARD_TRAIN_CELL, None),
             ("score", LM_ARCH, SHARD_SCORE_CELL, {"use_flash": True})]
    for name, arch, over, _, _, batch, _, _, capacity in SHARD_FAMILIES:
        cfg, over = family_config(arch, over)
        cells.append((name, arch, family_decode_cell(name, cfg, batch,
                                                     capacity), over))
    for key, arch, cell, over in cells:
        with fake_world(1):
            row = dryrun_cell(arch, cell.name, cell=cell, overrides=over,
                              verbose=False)
        if row["status"] != "ok":
            raise AssertionError(f"dry-run of {arch} {cell.name}: "
                                 f"{row.get('error')}\n"
                                 f"{row.get('traceback')}")
        rows[key] = row
    return rows


def state_bytes_on_card(build) -> tuple:
    """(bytes ``build()`` leaves allocated on the card, its result)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before, out


def held_bytes(tensors) -> tuple:
    """(bytes of these tensors' local shards on the card, their count)."""
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    return sum(t.numel() * t.element_size() for t in local), len(local)


def check_state_bytes(what: str, allocated: int, held: tuple,
                      row: dict) -> None:
    """The dry-run's argument bytes equal the bytes the state's tensors
    hold on the card, and the allocator's count exceeds them by at most
    CUDA_ALLOC_SLACK a tensor."""
    want = row["memory"]["argument_bytes"]
    got, n = held
    if got != want or not 0 <= allocated - want <= CUDA_ALLOC_SLACK * n:
        raise AssertionError(f"[shard] {what}: the dry-run's argument bytes "
                             f"{want} against {got} held by {n} tensors "
                             f"and {allocated} allocated on the card")


def shard_train(device, mesh, dry: dict) -> dict:
    """The lm_train protocol's full-width minicpm-2b steps (8 x 512 tokens,
    4 microbatches, LM_TRAIN_FULL_LR) without a mesh and under ``mesh``:
    one warm-up step and SHARD_STEPS timed ones each; every loss bit-equal.
    Under the mesh, the state the dry-run counts (parameters, moments,
    step, one batch) is measured on the card against its argument bytes."""
    cfg = get_config(LM_TRAIN_ARCH)
    it = data_iterator(cfg, global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                       seed=0)
    batches = [next(it) for _ in range(1 + SHARD_STEPS)]
    opt = OptConfig(lr=LM_TRAIN_FULL_LR, total_steps=100, warmup_steps=10,
                    moment_dtype=cfg.moment_dtype)
    runs = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        set_activation_mesh(None)
        torch.cuda.reset_peak_memory_stats()

        def build():
            model = build_model(cfg, device,
                                torch.Generator(device=device).manual_seed(0))
            fns = make_lm_train_step(model, opt, mesh=m, accum=cfg.train_accum)
            params, state = fns.init()
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batches[0].items()}
            return model, fns, params, state, batch
        allocated, (model, fns, params, state, batch) = state_bytes_on_card(
            build)
        held = held_bytes([*params.values(), *state["m"].values(),
                           *state["v"].values(), state["step"],
                           *batch.values()])
        if m is not None:
            check_state_bytes("minicpm-2b train state", allocated, held,
                              dry["train"])
            if not all(isinstance(p, DTensor) for p in params.values()):
                raise AssertionError("[shard] the parameters under the mesh "
                                     "are not DTensors")
        del batch
        losses = []
        params, state, met = fns.step(params, state, batches[0])
        losses.append(met["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[1:]:
            params, state, met = fns.step(params, state, b)
            losses.append(met["loss"])
        torch.cuda.synchronize()
        runs[tag] = {"losses": torch.stack(losses).tolist(),
                     "step_s": (time.perf_counter() - t0) / SHARD_STEPS,
                     "max_memory_bytes": torch.cuda.max_memory_allocated(),
                     "state_bytes_on_card": allocated}
        del model, fns, params, state, met, losses
        gc.collect()
        torch.cuda.empty_cache()
    set_activation_mesh(None)
    if runs["mesh"]["losses"] != runs["plain"]["losses"]:
        raise AssertionError(f"[shard] minicpm-2b losses under the (1, 1) "
                             f"mesh {runs['mesh']['losses']} differ from "
                             f"those without {runs['plain']['losses']}")
    return runs


def shard_score(device, mesh, dry: dict) -> dict:
    """glm4-9b's bf16 scoring forward with K4 (4 x 2048) without a mesh and
    under ``mesh``, through ``make_serve_fns(...).score``: logits bit-equal,
    flash_layers launches under the mesh (the phase's count), all on the
    wgmma body.  The parameters and int32 tokens on the card against the
    dry-run's argument bytes."""
    cfg = get_config(LM_ARCH, use_flash=True)
    tokens, patches = lm_inputs(cfg, LM_BATCH, LM_PROMPT, device)
    allocated, (model, tok32) = state_bytes_on_card(
        lambda: (build_model(cfg, device,
                             torch.Generator(device=device).manual_seed(0)),
                 tokens.to(torch.int32)))
    held = held_bytes([*model.parameters(), tok32])
    check_state_bytes("glm4-9b parameters and tokens", allocated, held,
                      dry["score"])
    del tok32
    out = {"state_bytes_on_card": allocated}
    for tag, m in (("plain", None), ("mesh", mesh)):
        set_activation_mesh(None)
        fns = make_serve_fns(model, mesh=m)
        fns.score(tokens[:, :128], patches)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = fns.score(tokens, patches)
        torch.cuda.synchronize()
        out[tag] = {"logits": logits, "score_s": time.perf_counter() - t0,
                    "launches": read_launches(),
                    "bodies": dict(flash_ops.LAUNCHES_BY_BODY)}
    set_activation_mesh(None)
    want = flash_layers(cfg)
    launches = out["mesh"]["launches"]
    if launches["flash_attention"] != want or \
            out["mesh"]["bodies"].get("wgmma") != want:
        raise AssertionError(f"[shard] scoring under the mesh launched K4 "
                             f"{launches['flash_attention']} times "
                             f"({out['mesh']['bodies']}), {want} expected "
                             "on the wgmma body")
    a, b = out["plain"].pop("logits"), out["mesh"].pop("logits")
    if a.shape != (LM_BATCH, LM_PROMPT, cfg.vocab) or \
            not torch.isfinite(a).all():
        raise AssertionError(f"[shard] bad scoring logits {tuple(a.shape)}")
    if not torch.equal(bits(a), bits(b)):
        raise AssertionError(f"[shard] glm4-9b logits under the (1, 1) mesh "
                             f"differ from the unsharded ones by "
                             f"{float((a.float() - b.float()).abs().max())}")
    del model, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tensor_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


@contextlib.contextmanager
def count_flash_causal():
    """K4's calls by ``causal`` while open: ``archs.blocks`` reaches the
    wrapper through its module global, under a mesh too."""
    counts = Counter()
    orig = arch_blocks.flash_attention

    def counted(q, k, v, causal=True):
        counts["causal" if causal else "non_causal"] += 1
        return orig(q, k, v, causal=causal)
    arch_blocks.flash_attention = counted
    try:
        yield counts
    finally:
        arch_blocks.flash_attention = orig


def serve_family(model, fns, tokens, gen_tokens, patches, capacity: int,
                 steps: int) -> dict:
    """A [shard] family row's calls through ``fns``, with the launch counts
    at 0: a scoring forward over ``tokens`` (every position's logits),
    prefill of ``gen_tokens`` into a fresh cache of ``capacity`` slots
    (behind the patches, or with the frames) and ``steps`` greedy decode
    steps; their outputs, wall times and K4 launches."""
    batch = tokens.shape[0]
    pre = prefix_slots(model.cfg, patches)
    torch.cuda.synchronize()
    reset_launches()
    with count_flash_causal() as causal:
        t0 = time.perf_counter()
        scores = fns.score(tokens, patches)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
    scoring = flash_ops.LAUNCHES
    bodies = {b: n for b, n in flash_ops.LAUNCHES_BY_BODY.items() if n}
    cache = model.init_cache(batch, capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = fns.prefill(gen_tokens, cache, patches)
    nxt = torch.argmax(logits[:, -1], -1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill = flash_ops.LAUNCHES - scoring
    out, generated = [logits], [nxt]
    t0 = time.perf_counter()
    for t in range(steps):
        pos = torch.full((batch, 1), gen_tokens.shape[1] + pre + t,
                         dtype=torch.int64, device=tokens.device)
        logits, cache = fns.decode(nxt[:, None], cache, pos)
        nxt = torch.argmax(logits[:, -1], -1)
        out.append(logits)
        generated.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_launches()
    return {"scores": scores, "serve_logits": torch.cat(out, 1),
            "generated": torch.stack(generated, 1), "score_s": score_s,
            "prefill_s": prefill_s, "decode_step_s": decode_s / steps,
            "launches": launches, "flash_scoring": scoring,
            "flash_scoring_by_body": bodies,
            "flash_scoring_by_causal": dict(causal),
            "flash_prefill": prefill,
            "flash_decode": launches["flash_attention"] - scoring - prefill}


def shard_family(device, mesh, dry: dict, card: str, name: str, arch: str,
                 over, seed: int, input_seed: int, batch: int, score: int,
                 prompt: int, capacity: int) -> dict:
    """One [shard] family row (SHARD_FAMILIES): the model built once from
    ``seed``, its parameters, a cache of ``capacity`` slots and the decode
    inputs measured on the card against the dry-run's decode cell; then
    the row's calls (``serve_family``: a first call at the row's shapes
    with 2 decode steps, which fills DTensor's sharding caches under the
    mesh, and the measured one with LM_GEN - 1) through
    ``make_serve_fns(model)`` and then ``make_serve_fns(model, mesh=)`` on
    the same model.  Logits and greedy tokens bit-equal, K4's launches
    (flash_layers in scoring on the body the dtype and head width call
    for, an audio model's encoder non-causal; flash_prefill_layers in
    prefill; none in decode) in both, and the dry-run's bound at most the
    measured decode step."""
    t_row = time.perf_counter()
    cfg, _ = family_config(arch, over)
    torch.backends.cuda.matmul.allow_tf32 = False
    set_activation_mesh(None)

    def build():
        model = build_model(cfg, device,
                            torch.Generator(device=device).manual_seed(seed))
        return (model, model.init_cache(batch, capacity),
                torch.zeros((batch, 1), dtype=torch.int32, device=device),
                torch.zeros((batch, 1), dtype=torch.int32, device=device))
    allocated, (model, cache, tok, pos) = state_bytes_on_card(build)
    held = held_bytes([*model.parameters(), *tensor_leaves(cache), tok, pos])
    check_state_bytes(f"{name} ({cfg.name}) parameters, cache and decode "
                      "inputs", allocated, held, dry[name])
    del cache, tok, pos
    tokens, patches = lm_inputs(cfg, batch, score, device, seed=input_seed)
    gen_tokens = tokens[:, :prompt]
    runs = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        set_activation_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fns = make_serve_fns(model, mesh=m)
        first = serve_family(model, fns, tokens, gen_tokens, patches,
                             capacity, 2)
        first = {k: first[k] for k in ("score_s", "prefill_s",
                                       "decode_step_s")}
        run = serve_family(model, fns, tokens, gen_tokens, patches,
                           capacity, LM_GEN - 1)
        run["scores"] = run["scores"].cpu()
        run.update(first_call=first,
                   max_memory_bytes=torch.cuda.max_memory_allocated())
        runs[tag] = run
    set_activation_mesh(None)
    plain, sharded = runs["plain"], runs["mesh"]
    vocab = cfg.vocab
    if plain["scores"].shape != (batch, score, vocab) or \
            not torch.isfinite(plain["scores"]).all() or \
            not torch.isfinite(plain["serve_logits"]).all():
        raise AssertionError(f"[shard] {name}: bad logits "
                             f"{tuple(plain['scores'].shape)}")
    gen = plain["generated"]
    if gen.shape != (batch, LM_GEN) or not ((gen >= 0) & (gen < vocab)).all():
        raise AssertionError(f"[shard] {name}: generated tokens out of range")
    for what in ("scores", "serve_logits", "generated"):
        a, b = plain[what], sharded[what]
        if isinstance(b, DTensor) or not torch.equal(bits(a), bits(b)):
            raise AssertionError(
                f"[shard] {name} ({cfg.name}): {what} under the (1, 1) mesh "
                f"differ from those without; max |d| "
                f"{float((a.float() - b.float()).abs().max())}")
    want = flash_layers(cfg)
    body = flash_ops._body(DTYPES[cfg.dtype], cfg.head_dim)
    enc = cfg.enc_layers if cfg.family == "audio" and want else 0
    want_causal = {k: n for k, n in (("causal", want - enc),
                                     ("non_causal", enc)) if n}
    for tag, r in runs.items():
        if r["flash_scoring"] != want or \
                r["flash_scoring_by_body"] != ({body: want} if want else {}) \
                or r["flash_scoring_by_causal"] != want_causal \
                or r["flash_prefill"] != flash_prefill_layers(cfg) \
                or r["flash_decode"] != 0:
            raise AssertionError(
                f"[shard] {name} {tag}: K4 launched {r['flash_scoring']} "
                f"times in scoring ({r['flash_scoring_by_body']}, "
                f"{r['flash_scoring_by_causal']}), {r['flash_prefill']} in "
                f"prefill, {r['flash_decode']} in decode; {want} on the "
                f"{body} body ({want_causal}), "
                f"{flash_prefill_layers(cfg)} and 0 expected")
    row_dry = dry[name]
    bound = row_dry["roofline"]["bound_s"]
    if not 0 < bound <= sharded["decode_step_s"]:
        raise AssertionError(f"[shard] {name}: the dry-run's bound {bound} s "
                             f"a decode step against "
                             f"{sharded['decode_step_s']} s measured")
    keep = ("score_s", "prefill_s", "decode_step_s", "first_call",
            "max_memory_bytes", "launches", "flash_scoring",
            "flash_scoring_by_body", "flash_scoring_by_causal",
            "flash_prefill", "flash_decode")
    row = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "batch": batch, "scoring_tokens": score, "prefill_tokens": prompt,
           "decode_steps": LM_GEN - 1, "cache_slots": capacity,
           "card": card, "bit_equal": True,
           "state_bytes_on_card": allocated,
           "dryrun_argument_bytes": row_dry["memory"]["argument_bytes"],
           "dryrun_decode_bound_s": bound,
           "dryrun_peak_per_device_gb":
               row_dry["memory"]["peak_per_device_gb"],
           **{tag: {k: r[k] for k in keep} for tag, r in runs.items()}}
    if cfg.family == "moe":
        row["moe_capacity"] = {"scoring": arch_blocks.moe_capacity(cfg, score),
                               "prefill": arch_blocks.moe_capacity(cfg,
                                                                   prompt),
                               "decode": arch_blocks.moe_capacity(cfg, 1)}
    row["row_s"] = time.perf_counter() - t_row
    log(f"[shard] {name}: {json.dumps(row)}")
    log(f"[shard] {name} ({cfg.name}, {cfg.n_layers} layers, {cfg.dtype}) on "
        f"{card}: scoring {batch} x {score} {plain['score_s']:.4f} s without "
        f"a mesh, {sharded['score_s']:.4f} s under the (1, 1) mesh; prefill "
        f"{batch} x {prompt} {plain['prefill_s']:.4f} s, "
        f"{sharded['prefill_s']:.4f} s; a decode step "
        f"{plain['decode_step_s'] * 1e3:.3f} ms, "
        f"{sharded['decode_step_s'] * 1e3:.3f} ms ({LM_GEN - 1} steps); "
        f"first calls under the mesh: scoring "
        f"{sharded['first_call']['score_s']:.4f} s, prefill "
        f"{sharded['first_call']['prefill_s']:.4f} s; logits and greedy "
        f"tokens bit-equal; K4 {sharded['flash_scoring']} in scoring "
        f"{sharded['flash_scoring_by_body']} "
        f"{sharded['flash_scoring_by_causal']}, {sharded['flash_prefill']} "
        f"in prefill, 0 in decode; peak memory "
        f"{plain['max_memory_bytes']} bytes without, "
        f"{sharded['max_memory_bytes']} under the mesh; state "
        f"{allocated} bytes on the card, dry-run argument bytes "
        f"{row_dry['memory']['argument_bytes']}, bound "
        f"{bound * 1e3:.4f} ms a decode step; row {row['row_s']:.3f} s")
    launches = sharded["launches"]
    del model, runs, plain, sharded, tokens, patches, gen_tokens
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "row": row}


def run_shard_path(device) -> dict:
    """Sharding on one card: the dry-run's rows first, then a one-rank NCCL
    world and its (1, 1) mesh, the train and scoring comparisons, each
    dry-run row's bound against the measured time; the world is ended."""
    t_phase = time.perf_counter()
    dry = shard_dryrun_rows()
    t_dry = time.perf_counter() - t_phase
    if not init_host_world(device):
        raise AssertionError("[shard] a process group was left over")
    try:
        mesh = make_host_mesh(device=device)
        if mesh.shape != (1, 1) or \
                mesh.mesh_dim_names != ("data", "model") or \
                dist.get_backend() != "nccl":
            raise AssertionError(f"[shard] host mesh {mesh}")
        train = shard_train(device, mesh, dry)
        score = shard_score(device, mesh, dry)
        card = card_line()
        families = {fam[0]: shard_family(device, mesh, dry, card, *fam)
                    for fam in SHARD_FAMILIES}
    finally:
        set_activation_mesh(None)
        dist.destroy_process_group()
    launches = dict(Counter(score["mesh"]["launches"]) + sum(
        (Counter(f["launches"]) for f in families.values()), Counter()))
    launches = {k["name"]: launches.get(k["name"], 0) for k in KERNELS}
    require_launches("shard", launches)
    bounds = {"train": (dry["train"]["roofline"]["bound_s"],
                        train["mesh"]["step_s"]),
              "score": (dry["score"]["roofline"]["bound_s"],
                        score["mesh"]["score_s"])}
    for what, (bound, got) in bounds.items():
        if not 0 < bound <= got:
            raise AssertionError(f"[shard] the dry-run's bound {bound} s for "
                                 f"the {what} cell against {got} s measured")
    row = {"mesh": "1x1", "backend": "nccl",
           "train": {k: {kk: vv for kk, vv in v.items()}
                     for k, v in train.items()},
           "score": {k: {kk: vv for kk, vv in v.items() if kk != "logits"}
                     if isinstance(v, dict) else v
                     for k, v in score.items()},
           "dryrun": {k: {"argument_bytes": r["memory"]["argument_bytes"],
                          "peak_per_device_gb":
                              r["memory"]["peak_per_device_gb"],
                          "roofline": r["roofline"],
                          "flops_per_device": r["flops_per_device"],
                          "bytes_per_device": r["bytes_per_device"],
                          "collective_by_type": r["collective_by_type"],
                          "t_run_s": r["t_run_s"]}
                      for k, r in dry.items() if k in ("train", "score")},
           "dryrun_s": t_dry}
    log(f"[shard] {json.dumps(row)}")
    log(f"[shard] minicpm-2b full width, 8 x 512 tokens, accum 4: "
        f"{train['plain']['step_s']:.4f} s a step without a mesh, "
        f"{train['mesh']['step_s']:.4f} s under the (1, 1) mesh "
        f"(bound {bounds['train'][0]:.4f} s from the dry-run); losses "
        f"bit-equal {train['mesh']['losses']}; peak "
        f"{train['mesh']['max_memory_bytes']} bytes under the mesh "
        f"({train['plain']['max_memory_bytes']} without; dry-run "
        f"{dry['train']['memory']['peak_per_device_gb']} GB); state "
        f"{train['mesh']['state_bytes_on_card']} bytes on the card, "
        f"dry-run argument bytes {dry['train']['memory']['argument_bytes']}")
    log(f"[shard] glm4-9b bf16 scoring 4 x 2048 with K4: "
        f"{score['plain']['score_s']:.4f} s without a mesh, "
        f"{score['mesh']['score_s']:.4f} s under the mesh (bound "
        f"{bounds['score'][0]:.4f} s); logits bit-equal; K4 launches "
        f"{score['mesh']['launches']['flash_attention']}; parameters and "
        f"tokens "
        f"{score['state_bytes_on_card']} bytes on the card, dry-run "
        f"argument bytes {dry['score']['memory']['argument_bytes']}")
    log(f"[shard] phase: {time.perf_counter() - t_phase:.3f} s (dry-run "
        f"rows {t_dry:.3f} s); launches {launches}")
    row["families"] = {k: f["row"] for k, f in families.items()}
    return {"launches": launches, "row": row}


def run_lm_train_path(device) -> dict:
    """Dense-LM training on the card: the training CLI (20 smoke steps),
    the smoke model's loss falling, the card against the host, the refusal
    of use_flash, minicpm-2b at full width, and the train_lm example with
    its checkpoint round trip.  No kernel of the port runs on this path (the flash kernel
    has no backward pass), so every launch count must stay 0."""
    t_phase = time.perf_counter()
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        cli = train_cli.main(["--arch", "minicpm-2b", "--steps", "20",
                              "--batch", "8", "--seq", "128"])
    lines = text.getvalue().strip().splitlines()
    log(f"[lm_train] python -m repro_torch.launch.train --steps 20 on the "
        f"card: {lines[0]}; {lines[-1]}")
    if not np.isfinite([h["loss"] for h in cli["history"]]).all():
        raise AssertionError("the training CLI gave a non-finite loss")
    smoke = lm_train_smoke(device)
    host_err = check_lm_train_against_host(device)
    check_lm_train_refuses_flash(device)
    full = lm_train_full_width(device)
    torch.cuda.empty_cache()
    ckpt = lm_train_checkpoint(device)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"LM training launched a kernel: {launches}")
    log(f"[lm_train] phase: {time.perf_counter() - t_phase:.3f} s; launches "
        f"{launches}")
    return {"launches": launches, "smoke": smoke, "host_err": host_err,
            "full": full, "checkpoint": ckpt}


# ---------------------------------------------------------------------------
# The invariant suite, and the card's host syncs held to it
# ---------------------------------------------------------------------------

def run_analysis_path() -> dict:
    """``python -m repro_torch.analysis --strict --json src/repro_torch``
    on this machine, in a subprocess that must exit 0; then every host
    sync site that count_syncs recorded on the paths of SYNC_BUDGET must
    be a TH001/TH002 finding of that run which a ``repro_torch:`` marker
    suppresses, and each path's syncs a call must stay within its
    budget.  Returns the per-rule counts and the per-path rows."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.analysis", "--strict",
           "--json", "src/repro_torch"]
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         timeout=ANALYSIS_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {out.returncode}:"
                             f"\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    report = json.loads(out.stdout)
    suite_s = time.perf_counter() - t0
    counts = {rule: [c["findings"], c["suppressed"]]
              for rule, c in report["summary"].items()}
    log(f"[analysis] python -m repro_torch.analysis --strict "
        f"src/repro_torch: exit 0 in {suite_s:.3f} s; per rule [found, "
        f"suppressed]: {json.dumps(counts)}")
    allowed = {(f["path"], f["line"]) for f in report["suppressed"]
               if f["rule"] in ("TH001", "TH002")}
    rows, missed, over = {}, set(), []
    for path, budget in SYNC_BUDGET.items():
        rec = SYNC_SITES.get(path)
        if rec is None or not rec["calls"]:
            raise AssertionError(f"no call of the {path} path ran under "
                                 "count_syncs")
        sites = {f"{p}:{ln}": n for (p, ln), n in sorted(rec["sites"].items())}
        rows[path] = {"calls": rec["calls"], "syncs": rec["syncs"],
                      "syncs_per_call": rec["syncs"] / rec["calls"],
                      "max_syncs_in_a_call": rec["max_per_call"],
                      "budget": budget, "sites": sites}
        log(f"[analysis] {path}: {rec['calls']} calls, {rec['syncs']} host "
            f"syncs ({rec['syncs'] / rec['calls']:.4f} a call, at most "
            f"{rec['max_per_call']} in one; budget {budget}); "
            f"{len(sites)} distinct sites {json.dumps(sites)}")
        missed |= {site for site in rec["sites"] if site not in allowed}
        if rec["max_per_call"] > budget:
            over.append(f"{path}: {rec['max_per_call']} syncs in one call, "
                        f"budget {budget}")
    if missed:
        raise AssertionError(
            "host sync sites that are no suppressed TH001/TH002 finding of "
            "the port's analyzer: " + ", ".join(f"{p}:{ln}"
                                                 for p, ln in sorted(missed)))
    if over:
        raise AssertionError("host syncs over the budget: " + "; ".join(over))
    log(f"[analysis] phase: {time.perf_counter() - t0:.3f} s")
    return {"rules": counts, "paths": rows}


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
    train_path = run_train_path(device)
    trained_path = run_trained_path(device, train_path["models"])
    run_baselines(device, train_path["models"]["subq"])
    serve_path = run_serve_path(device, train_path["models"])
    t0 = time.perf_counter()
    clock = calibrate_clock(device, train_path["models"])
    log(f"[scenarios] clock calibrated on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    scenarios_path = run_scenarios_path(device, train_path["models"], clock)
    fleet_path = run_fleet_path(device, train_path["models"], clock)
    examples_path = run_examples_path(device, train_path["models"])
    cluster_path = run_cluster_path(device, compile_path["k1_inputs"])
    lm_path = run_lm_path(device)
    torch.cuda.empty_cache()
    moe_path = run_moe_path(device)
    torch.cuda.empty_cache()
    check_lm_flash_against_plain(device, cfg=get_config(
        MOE_ARCH, n_layers=MOE_CHECK_LAYERS, dtype="float32",
        use_flash=True))
    torch.cuda.empty_cache()
    check_smoke_against_host(device)
    check_lm_flash_against_plain(device)
    torch.cuda.empty_cache()
    check_lm_against_host(device)
    torch.cuda.empty_cache()
    ssm_path = run_ssm_path(device)
    torch.cuda.empty_cache()
    hybrid_path = run_hybrid_path(device)
    torch.cuda.empty_cache()
    audio_path = run_audio_path(device)
    torch.cuda.empty_cache()
    vlm_path = run_vlm_path(device)
    torch.cuda.empty_cache()
    lm_train_path = run_lm_train_path(device)
    torch.cuda.empty_cache()
    shard_path = run_shard_path(device)
    run_analysis_path()
    paths = {"compile": compile_path["launches"],
             "runtime": runtime_path["launches"],
             "hmooc2": hmooc2_path["launches"],
             "train": train_path["launches"],
             "trained": trained_path["launches"],
             "serve": serve_path["launches"],
             "scenarios": scenarios_path["launches"],
             "fleet": fleet_path["launches"],
             "examples": examples_path["launches"],
             "cluster": cluster_path["launches"],
             "lm": lm_path["launches"],
             "moe": moe_path["launches"],
             "ssm": ssm_path["launches"],
             "hybrid": hybrid_path["launches"],
             "audio": audio_path["launches"],
             "vlm": vlm_path["launches"],
             "lm_train": lm_train_path["launches"],
             "shard": shard_path["launches"]}
    kernels = []
    entries["flash_attention"]["lm_launches_by_body"] = \
        lm_path["row"]["flash_launches_scoring_by_body"]
    entries["flash_attention"]["moe_launches_by_body"] = \
        moe_path["row"]["flash_launches_scoring_by_body"]
    entries["flash_attention"]["hybrid_launches_by_body"] = \
        hybrid_path["row"]["k4_launches_by_body"]
    for name, path in (("audio", audio_path), ("vlm", vlm_path)):
        row = path["row"]
        entries["flash_attention"][f"{name}_launches_by_body"] = {
            "scoring": row["flash_launches_scoring_by_body"],
            "generation": row["flash_launches_generation"]}
    entries["flash_attention"]["shard_launches_by_body"] = {
        "glm4-9b": shard_path["row"]["score"]["mesh"]["bodies"],
        **{name: {"scoring": f["mesh"]["flash_scoring_by_body"],
                  "prefill": f["mesh"]["flash_prefill"],
                  "decode": f["mesh"]["flash_decode"]}
           for name, f in shard_path["row"]["families"].items()}}
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
