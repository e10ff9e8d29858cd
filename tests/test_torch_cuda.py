"""The port on a CUDA card: kernels against their plain versions, and the
card's answers against the host's.

Every test here needs a card (``cuda`` marker) and skips without one.  The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import contextlib
import dataclasses
import io
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.archs import blocks as arch_blocks
from repro_torch.archs.act_sharding import set_activation_mesh
from repro_torch.archs.registry import (build_model, get_config,
                                        get_smoke_config)
from repro_torch.data.pipeline import data_iterator as lm_data_iterator
from repro_torch.data.pipeline import make_batch as lm_make_batch
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.core.tuning import runtime as runtime_core
from repro_torch.cluster.autotune import autotune
from repro_torch.core.moo.pareto import (_f32_tie_hazard,
                                         _f32_tie_hazard_tensor,
                                         compact_bank, pareto_mask,
                                         pareto_mask_np, pareto_masks_fast)
from repro_torch.examples import quickstart
from repro_torch.launch.mesh import init_host_world, make_host_mesh
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused_solve import ops as fused_ops
from repro_torch.kernels.fused_solve.ref import fused_ws_front_ref
from repro_torch.kernels.pareto_filter import ops as pareto_ops
from repro_torch.kernels.pareto_filter.ref import (pareto_mask_ref,
                                                   pareto_masks_ref)
from repro_torch.kernels.ws_reduce import ops as ws_ops
from repro_torch.kernels.ws_reduce.ref import runtime_pick_ref, ws_reduce_ref
from repro_torch.core.models.gtn import GTNConfig
from repro_torch.core.models.perf_model import ModelConfig, PerfModel, _Net
from repro_torch.core.models.training import (build_dataset, evaluate,
                                              train_model)
from repro_torch.core.moo import baselines
from repro_torch.core.tuning.objectives import StageObjectives
from repro_torch.queryengine.trace import collect_traces
from repro_torch.queryengine.workloads import (default_workload,
                                               make_benchmark, serving_stream)
from repro_torch.serve import RuntimeSession, TuningService
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import OptConfig as LMOptConfig
from repro_torch.train.serve import make_serve_fns as make_lm_serve_fns
from repro_torch.train.train_loop import make_train_step as make_lm_train_step

from _runtime_pick_cases import (CASES, PICK_THRESHOLDS, budget_round,
                                 case_weights)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # Decided per test, never at import: every worker collects the same set.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(n, k, seed):
    """Tie-free f32 objectives, invalid rows and +inf rows."""
    rng = np.random.default_rng(seed)
    F = (rng.random((n, k)) * 10).astype(np.float32)
    F[rng.random(n) < 0.1] = np.inf
    return F, rng.random(n) > 0.15


@pytest.mark.parametrize("n", [1, 129, 256, 1000, 4096])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_pareto_filter_kernel_matches_plain_version(cuda_device, n, k):
    F, valid = _case(n, k, seed=n + 31 * k)
    Ft = torch.from_numpy(F).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    before = pareto_ops.LAUNCHES
    got = pareto_ops.pareto_filter(Ft, vt)
    torch.cuda.synchronize()
    assert pareto_ops.LAUNCHES == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  pareto_mask_ref(Ft, vt).cpu().numpy())
    # float64 input is cast to float32 before comparing, like the plain one.
    got64 = pareto_ops.pareto_filter(Ft.double(), vt)
    np.testing.assert_array_equal(got64.cpu().numpy(), got.cpu().numpy())


def _front_case(n, k, seed):
    """Rows near the surface sum(F) = 10 with a small jitter: most rows
    survive, so each scans every tile of dominators."""
    rng = np.random.default_rng(seed)
    F = rng.dirichlet(np.ones(k), n) * 10 + rng.random((n, k)) * 1e-3
    F = F.astype(np.float32)
    F[rng.random(n) < 0.05] = np.inf
    return F, rng.random(n) > 0.1


@pytest.mark.parametrize("n", [129, 256, 4096])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_pareto_filter_kernel_matches_plain_version_on_front(cuda_device, n,
                                                             k):
    F, valid = _front_case(n, k, seed=7 * n + k)
    Ft = torch.from_numpy(F).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    want = pareto_mask_ref(Ft, vt).cpu().numpy()
    assert want.sum() > 0.5 * n
    got = pareto_ops.pareto_filter(Ft, vt)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)


# (S, n, k): one Algorithm 1 bank, a phase's banks (5 and 9 representatives
# x 10 subQs), a runtime round's candidate sets, K3's global filter at the
# largest HMOOC2 bank, and two long segments at k = 8.
SEGMENT_SHAPES = [(1, 256, 2), (50, 256, 2), (90, 256, 2), (32, 66, 2),
                  (3, 1408, 2), (2, 4096, 8)]


def _segment_case(S, n, k, seed, layout):
    """f32 objectives, uniform or near one trade-off surface (most rows
    survive); for S > 2 segment 1 is ragged (its tail padded with invalid
    +inf rows), and for S > 1 the last segment is all invalid."""
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
    return F, valid


@pytest.mark.parametrize("layout", ["uniform", "front"])
@pytest.mark.parametrize("S,n,k", SEGMENT_SHAPES)
def test_pareto_filter_segments_kernel_matches_plain_version(
        cuda_device, S, n, k, layout):
    F, valid = _segment_case(S, n, k, seed=S * 1000 + n + k, layout=layout)
    Ft = torch.from_numpy(F).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    before = pareto_ops.LAUNCHES
    got = pareto_ops.pareto_filter_segments(Ft, vt)
    torch.cuda.synchronize()
    assert pareto_ops.LAUNCHES == before + 1
    want = pareto_masks_ref(Ft, vt).cpu().numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if S > 1:
        assert not got[-1].any()


def test_pareto_filter_segments_ragged_unaligned(cuda_device):
    """Segments whose rows times k is not a multiple of 4 (the kernel's
    4-byte copies), padded from ragged banks: each segment equals the
    single-segment launch and the plain version on that bank alone."""
    rng = np.random.default_rng(5)
    sizes, k = [33, 1, 300, 0, 257], 3
    n = max(sizes)
    F = np.full((len(sizes), n, k), np.inf, np.float32)
    valid = np.zeros((len(sizes), n), bool)
    for s, m in enumerate(sizes):
        F[s, :m] = rng.random((m, k)) * 10
        valid[s, :m] = rng.random(m) > 0.1
    Ft = torch.from_numpy(F).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    got = pareto_ops.pareto_filter_segments(Ft, vt).cpu().numpy()
    for s, m in enumerate(sizes):
        one = pareto_ops.pareto_filter(Ft[s, :m], vt[s, :m]).cpu().numpy()
        want = pareto_mask_ref(Ft[s, :m], vt[s, :m]).cpu().numpy()
        np.testing.assert_array_equal(got[s, :m], want)
        np.testing.assert_array_equal(one, want)
        assert not got[s, m:].any()


def test_pareto_masks_fast_one_launch_on_card(cuda_device):
    """A batch of f32-representable, tie-free banks: one launch, and every
    mask equals the float64 numpy mask."""
    rng = np.random.default_rng(9)
    banks = [(rng.random((n, 2)) * 10).astype(np.float32).astype(np.float64)
             for n in (256, 256, 66, 130, 1)]
    banks[1][[3, 8]] = np.inf
    before = pareto_ops.LAUNCHES
    got = pareto_masks_fast(banks, device=cuda_device)
    assert pareto_ops.LAUNCHES == before + 1
    for F, g in zip(banks, got):
        np.testing.assert_array_equal(g, pareto_mask_np(F))


def test_compile_time_solve_two_launches_per_query(cuda_device):
    """Each solved query filters its banks phase in one launch and its DAG
    aggregation in one more."""
    cfg = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                      max_bank=12, seed=3)
    svc = TuningService(cfg=cfg, device=cuda_device)
    before = pareto_ops.LAUNCHES
    svc.tune_batch(serving_stream("tpch", 6, seed=5))
    solved = svc.last_batch.n_solved
    assert 0 < pareto_ops.LAUNCHES - before <= 2 * solved


def test_oracle_service_card_equals_host(cuda_device):
    """Kernel masks in float32 on the card, numpy masks in float64 on the
    host: identical results, because the tie-hazard guard sends every
    float32-ambiguous mask to numpy."""
    cfg = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                      max_bank=12, seed=3)
    queries = serving_stream("tpch", 6, seed=5)
    before = pareto_ops.LAUNCHES
    card = TuningService(cfg=cfg, device=cuda_device).tune_batch(queries)
    assert pareto_ops.LAUNCHES > before
    host = TuningService(cfg=cfg, device="cpu").tune_batch(queries)
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a.front, b.front)
        assert a.choice == b.choice
        np.testing.assert_array_equal(a.theta_c, b.theta_c)
        np.testing.assert_array_equal(a.theta_p_sub, b.theta_p_sub)


def _ws_case(m, B, k, nw, seed):
    rng = np.random.default_rng(seed)
    F = rng.random((m, B, k)).astype(np.float32)
    F[:, -2:] = np.inf                       # padded bank slots
    F[0] = np.inf                            # a bank of padding alone
    if m > 1 and B > 4:
        F[-1, 3] = F[-1, 1] = 0.0            # an exact tie at the minimum
    return F, rng.random((nw, k)).astype(np.float32)


@pytest.mark.parametrize("m,B,k,nw", [(1, 8, 2, 3), (4, 130, 2, 11),
                                      (3, 48, 3, 33), (2, 256, 4, 128),
                                      (32, 66, 2, 1), (1024, 48, 2, 11),
                                      (5, 40, 8, 5)])
def test_ws_reduce_kernel_matches_plain_version(cuda_device, m, B, k, nw):
    F, W = _ws_case(m, B, k, nw, seed=m * 100 + B)
    Ft = torch.from_numpy(F).to(cuda_device)
    Wt = torch.from_numpy(W).to(cuda_device)
    before = ws_ops.LAUNCHES
    v, i = ws_ops.ws_reduce(Ft, Wt)
    torch.cuda.synchronize()
    assert ws_ops.LAUNCHES == before + 1
    vr, ir = ws_reduce_ref(torch.nan_to_num(Ft, posinf=1e30), Wt)
    np.testing.assert_array_equal(i.cpu().numpy(), ir.cpu().numpy())
    np.testing.assert_allclose(v.cpu().numpy(), vr.cpu().numpy(), rtol=1e-5)
    assert (i[:, 0] == 0).all()
    if m > 1 and B > 4:
        assert (i[:, -1] == 1).all()


def _ws_sanitise_case():
    """float64 banks holding NaN, ±inf, ±1e300 (beyond float32) and a bank
    of padding alone: what the kernel's cast and nan_to_num rewrite.  The
    same case as ``test_torch_ws_reduce.py``'s, which this file cannot
    import (that one imports JAX)."""
    rng = np.random.default_rng(11)
    F = rng.random((4, 40, 2))
    F[0, 3, 0] = np.nan
    F[0, 5, 1] = np.inf
    F[1, 2, 0] = -np.inf
    F[1, 7, 1] = 1e300
    F[2, 1, 0] = -1e300
    F[2, 9] = 1e300
    F[3] = np.inf
    return F, rng.random((3, 2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ws_reduce_kernel_sanitises_like_plain_version(cuda_device, dtype):
    """The kernel reads float64 or float32 banks as they are and casts and
    sanitises each element itself: indices exact and values within rtol
    1e-5 of the plain version after the host-side cast and nan_to_num."""
    F, W = _ws_sanitise_case()
    Ft = torch.from_numpy(F).to(cuda_device, dtype)
    Wt = torch.from_numpy(W).to(cuda_device, dtype)
    before = ws_ops.LAUNCHES
    v, i = ws_ops.ws_reduce(Ft, Wt)
    torch.cuda.synchronize()
    assert ws_ops.LAUNCHES == before + 1
    vr, ir = ws_reduce_ref(
        torch.nan_to_num(Ft.to(torch.float32), posinf=1e30),
        Wt.to(torch.float32))
    np.testing.assert_array_equal(i.cpu().numpy(), ir.cpu().numpy())
    np.testing.assert_allclose(v.cpu().numpy(), vr.cpu().numpy(), rtol=1e-5)
    assert (i[:, 3] == 0).all()


def _fused_case(N, m, B, k, nw, seed):
    rng = np.random.default_rng(seed)
    Fb = rng.random((N, m, B, k))
    if B > 2:
        Fb[:, :, -1] = np.inf
        Fb[0, 0, -2] = np.inf
    if N > 2 and m > 1:
        Fb[2, 1] = np.inf                    # a subQ with an empty bank
    finite = np.isfinite(Fb)
    lo = np.min(np.where(finite, Fb, np.inf), axis=(1, 2), keepdims=True)
    hi = np.max(np.where(finite, Fb, -np.inf), axis=(1, 2), keepdims=True)
    Fn = np.where(finite, (Fb - lo) / np.where(hi > lo, hi - lo, 1.0), 1e18)
    W = (np.stack([np.linspace(0.0, 1.0, nw),
                   1.0 - np.linspace(0.0, 1.0, nw)], -1) if k == 2
         else rng.dirichlet(np.ones(k), nw))
    return Fn, Fb, W


@pytest.mark.parametrize("N,m,B,k,nw", [(1, 1, 2, 2, 3), (3, 2, 8, 2, 11),
                                        (7, 3, 16, 2, 6), (33, 5, 4, 2, 4),
                                        (5, 3, 4, 2, 6), (128, 12, 48, 2, 11),
                                        (9, 4, 10, 3, 7)])
def test_fused_solve_kernel_matches_plain_version(cuda_device, N, m, B, k,
                                                  nw):
    Fn, Fb, W = _fused_case(N, m, B, k, nw, seed=N * 1000 + m * 10 + B)
    before = fused_ops.LAUNCHES, pareto_ops.LAUNCHES
    out = fused_ops.fused_ws_front(Fn, Fb, W, device=cuda_device)
    assert (fused_ops.LAUNCHES, pareto_ops.LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert all(t.device.type == "cuda" for t in out)
    jj, P_all, keep = (t.cpu().numpy() for t in out)
    jr, Pr, kr = fused_ws_front_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
          for a in (Fn, Fb, W)))
    np.testing.assert_array_equal(jj, jr.cpu().numpy())
    np.testing.assert_allclose(P_all, Pr.cpu().numpy(), rtol=1e-12)
    np.testing.assert_array_equal(keep, kr.cpu().numpy())
    # The card's answer equals the host's plain version too.
    jh, Ph, kh = fused_ops.fused_ws_front(Fn, Fb, W, device="cpu")
    np.testing.assert_array_equal(jj, jh.numpy())
    np.testing.assert_array_equal(keep, kh.numpy())


def _check_fused_normalising(Fb, W, device):
    """K3 with ``Fn=None`` against the plain version on the host's
    normalised scores: picks and mask exact, sums within rtol 1e-12, one
    launch of each kernel."""
    before = fused_ops.LAUNCHES, pareto_ops.LAUNCHES
    jj, P_all, keep = (t.cpu().numpy() for t in fused_ops.fused_ws_front(
        None, torch.from_numpy(Fb).to(device), W, device=device))
    assert (fused_ops.LAUNCHES, pareto_ops.LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    Fn = fused_ops.hmooc2_scores_ref(torch.from_numpy(Fb))
    jr, Pr, kr = (t.numpy() for t in fused_ws_front_ref(
        Fn, torch.from_numpy(Fb), torch.from_numpy(W)))
    np.testing.assert_array_equal(jj, jr)
    np.testing.assert_array_equal(keep, kr)
    fin = np.isfinite(Pr)
    np.testing.assert_array_equal(np.isfinite(P_all), fin)
    np.testing.assert_allclose(P_all[fin], Pr[fin], rtol=1e-12)
    return keep


@pytest.mark.parametrize("N,m,B,k,nw", [(1, 1, 2, 2, 3), (7, 3, 16, 2, 6),
                                        (126, 12, 48, 2, 11),
                                        (9, 4, 10, 3, 7), (5, 3, 7, 1, 4)])
def test_fused_solve_normalising_kernel_matches_plain_version(
        cuda_device, N, m, B, k, nw):
    """Banks with padding, a candidate without a finite entry and a
    constant objective, normalised in the kernel."""
    _, Fb, W = _fused_case(N, m, B, k, nw, seed=N * 100 + m)
    if N > 3:
        Fb[3] = np.inf
        Fb[1, :, :, 0] = 4.5
        Fb[N - 1, 0, 0, k - 1] = np.nan
    keep = _check_fused_normalising(Fb, W, cuda_device)
    assert N <= 3 or not keep[3].any()


@pytest.mark.parametrize("N,m,B,k,nw", [(4, 40, 64, 2, 11),
                                        (3, 3, 2200, 2, 11),
                                        (3, 5, 900, 8, 6)])
def test_fused_solve_kernel_tiles_banks_over_its_budget(cuda_device, N, m,
                                                        B, k, nw):
    """Banks past the kernel's shared-memory budget stream through in
    tiles of subQs, or of bank rows where one subQ alone is too large,
    with and without given scores."""
    Fn, Fb, W = _fused_case(N, m, B, k, nw, seed=N + m + B)
    _check_fused_normalising(Fb, W, cuda_device)
    jj, P_all, keep = (t.cpu().numpy() for t in fused_ops.fused_ws_front(
        Fn, Fb, W, device=cuda_device))
    jr, Pr, kr = (t.numpy() for t in fused_ws_front_ref(
        *(torch.from_numpy(a) for a in (Fn, Fb, W))))
    np.testing.assert_array_equal(jj, jr)
    np.testing.assert_array_equal(keep, kr)
    np.testing.assert_allclose(P_all, Pr, rtol=1e-12)


@pytest.mark.parametrize("case", ["none", "planted", "overflow",
                                  "nonfinite"])
def test_tie_check_on_card_equals_numpy(cuda_device, case):
    rng = np.random.default_rng(12)
    X = (rng.random((72576, 2)) * 10).astype(np.float32).astype(np.float64)
    X[::7] = np.inf
    if case == "planted":
        X[70001, 1] = X[5, 1] + 1e-12
    elif case == "overflow":
        X[9, 0], X[10, 0] = 1e39, 2e39
    elif case == "nonfinite":
        X[:3, 0] = [np.nan, -np.inf, np.inf]
    want = _f32_tie_hazard(X)
    got = _f32_tie_hazard_tensor(torch.from_numpy(X).to(cuda_device))
    assert bool(got) == want == (case in ("planted", "overflow"))


def _check_runtime_pick(Fs, w, thresholds, device):
    """runtime_pick on the card against its plain version on the same
    tensors and on the host: picks and routes exactly equal, one launch."""
    Fs = [np.asarray(F, np.float64) for F in Fs]
    F, off, gid, W = runtime_core._stage_round(
        Fs, np.asarray(w, np.float64), device)
    kw = dict(kernel_min_n=thresholds[0], ws_min_scores=thresholds[1])
    before = ws_ops.RUNTIME_PICK_LAUNCHES
    got = ws_ops.runtime_pick(F, off, gid, W,
                              max_n=max(len(f) for f in Fs), **kw)
    torch.cuda.synchronize()
    assert ws_ops.RUNTIME_PICK_LAUNCHES == before + 1
    assert got.device.type == "cuda"
    want = runtime_pick_ref(F, off, gid, W, *thresholds)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    host = ws_ops.runtime_pick(*(t.cpu() for t in (F, off, gid, W)), **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), host.numpy())
    return got.cpu().numpy()


@pytest.mark.parametrize("thresholds", PICK_THRESHOLDS)
@pytest.mark.parametrize("per_set", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_runtime_pick_kernel_matches_plain_version(cuda_device, case, per_set,
                                                   thresholds):
    Fs = CASES[case]()
    _check_runtime_pick(Fs, case_weights(case, per_set, len(Fs)), thresholds,
                        cuda_device)


def test_runtime_pick_kernel_counts_kept_rows_after_every_scan(cuda_device):
    """Each set keeps 4 rows, so R_g * B_g = 4 R_g; with the float32 route
    from 4 R_g + 1 scores the route is float64, and a kept count read
    before some row's scan ends would raise B_g and flip it.  The case
    makes the counting threads fast and the scans they race slow; many
    calls, as the race depends on timing."""
    Fs = [np.asarray(f, np.float64) for f in CASES["late_dominators"]()]
    F, off, gid, W = runtime_core._stage_round(Fs, np.array([0.9, 0.1]),
                                               cuda_device)
    ws = 4 * len(Fs) + 1
    want = runtime_pick_ref(F, off, gid, W, 0, ws).cpu()
    assert want[-1] == 0
    for _ in range(200):
        got = ws_ops.runtime_pick(F, off, gid, W, kernel_min_n=0,
                                  ws_min_scores=ws, max_n=85)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("thresholds", PICK_THRESHOLDS[:2])
@pytest.mark.parametrize("k", [2, 8])
def test_runtime_pick_kernel_tiles_sets_over_its_budget(cuda_device, k,
                                                        thresholds):
    """Sets past the kernel's shared-memory budget stream their dominators
    through it in tiles; the picks stay the plain version's."""
    _check_runtime_pick(*budget_round(k), thresholds, cuda_device)


def test_runtime_pick_kernel_other_widths_and_offsets(cuda_device):
    """k = 1, 3, 5 and 8 (numpy's pairwise float64 order), and sets whose
    first row lies off a 16-byte boundary (odd k, odd offsets)."""
    rng = np.random.default_rng(41)
    for k in (1, 3, 5, 8):
        Fs = [rng.standard_normal((n, k)) * 10.0 ** rng.integers(-3, 4,
                                                                  (n, k))
              for n in (3, 33, 80, 1, 7)]
        for thresholds in PICK_THRESHOLDS:
            _check_runtime_pick(Fs, rng.random((5, k)), thresholds,
                                cuda_device)
            _check_runtime_pick(Fs, rng.random(k), thresholds, cuda_device)


def test_weighted_pick_batch_one_launch_one_sync_on_card(cuda_device):
    """On the card a call makes one runtime_pick launch, no pareto_filter
    or ws_reduce launch and one host synchronisation, and decides as the
    host's numpy route with the kernels' plain versions behind it."""
    Fs = CASES["mixed"]()
    w = case_weights("mixed", True, len(Fs))
    before = (ws_ops.RUNTIME_PICK_LAUNCHES, pareto_ops.LAUNCHES,
              ws_ops.LAUNCHES)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = runtime_core.weighted_pick_batch(Fs, w, device=cuda_device)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert sum("called a synchronizing" in str(m.message)
               for m in caught) == 1
    assert (ws_ops.RUNTIME_PICK_LAUNCHES, pareto_ops.LAUNCHES,
            ws_ops.LAUNCHES) == (before[0] + 1, before[1], before[2])
    host = runtime_core._pick_composed(
        [np.asarray(F, np.float64) for F in Fs], w, torch.device("cpu"))
    assert got == host


def test_oracle_runtime_session_card_equals_host(cuda_device):
    """The runtime path on the card (one runtime_pick launch a round:
    prefilter, normalisation and picks on the card, float32 behind the
    tie-hazard guards) decides exactly as the host's float64 numpy routing
    on a 6-query stream, with no pareto_filter or ws_reduce launch."""
    cfg = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                      max_bank=12, seed=3)
    queries = serving_stream("tpch", 6, seed=5)
    cts = TuningService(cfg=cfg, device="cpu").tune_batch(queries)
    before = (pareto_ops.LAUNCHES, ws_ops.LAUNCHES,
              ws_ops.RUNTIME_PICK_LAUNCHES)
    sess = RuntimeSession(device=cuda_device)
    card = sess.run_batch(queries, cts)
    rounds = sess.last_batch.rounds
    assert rounds > 0
    assert (pareto_ops.LAUNCHES, ws_ops.LAUNCHES,
            ws_ops.RUNTIME_PICK_LAUNCHES) == (before[0], before[1],
                                              before[2] + rounds)
    host = RuntimeSession(device="cpu").run_batch(queries, cts)
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a.theta_p_eff, b.theta_p_eff)
        np.testing.assert_array_equal(a.theta_s_eff, b.theta_s_eff)
        np.testing.assert_array_equal(a.final_join, b.final_join)
        assert a.requests_sent == b.requests_sent
        np.testing.assert_array_equal(a.sim.actual_latency,
                                      b.sim.actual_latency)
        np.testing.assert_array_equal(a.sim.cost, b.sim.cost)


# (B, Hq, Hkv, Sq, Skv, D, causal): the reference kernel tests' f32 shapes,
# then the smoke models' head widths (24, 32) and the largest bucket (256).
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64, True), (2, 8, 2, 256, 256, 64, True),
                (1, 4, 1, 100, 100, 128, True), (1, 4, 2, 1, 300, 64, False),
                (1, 8, 4, 96, 480, 64, True), (2, 2, 2, 64, 64, 128, False),
                (2, 4, 1, 70, 70, 24, True), (1, 4, 2, 33, 33, 32, True),
                (1, 2, 1, 130, 130, 256, True)]


def _flash_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device=device, dtype=dtype)
        for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain_version_f32(
        cuda_device, B, Hq, Hkv, Sq, Skv, D, causal):
    """float32 within atol 2e-5 (the reference kernel test's tolerance):
    the online softmax rescales per 64-key tile, the plain version takes
    one softmax, so the sums round differently."""
    q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Skv, D, torch.float32,
                            cuda_device, Sq + Skv)
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    # A query tensor that is not contiguous (as after RoPE) gives the same.
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(
        flash_ops.flash_attention(qt, k, v, causal=causal), got, atol=0,
        rtol=0)


# The tensor-core body's 16-bit outputs against the float32 plain version
# before its rounding: |got - want| <= a + r |want| per element (a, r).
# r is twice the most that rounding to the type moves a value (2^-8
# relative for bfloat16, 2^-11 for float16); a covers the float32 sums
# taken in another order.  Late causal rows have |o| of about 0.03-0.05 on
# unit-normal inputs, so atol 3e-2 alone would let a wrong key/value tile
# through.  The same bound as chip_smoke.py's FLASH_SCALED_TOL.
WGMMA_SCALED_TOL = {torch.bfloat16: (1e-3, 2 ** -7),
                    torch.float16: (1.25e-4, 2 ** -10)}


def _assert_within_scaled_tol(got, q, k, v, causal):
    a, r = WGMMA_SCALED_TOL[got.dtype]
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    excess = ((got.float() - want).abs() - r * want.abs()).max().item()
    assert excess <= a, (f"max(|d| - {r:.3g}|want|) = {excess:.3g} > {a}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_kernel_matches_plain_version_half(cuda_device,
                                                           dtype):
    """16-bit inputs: both sides compute in float32 and round the output
    once, so they differ by about one rounding of the output (atol 3e-2,
    the reference's bf16 tolerance; and a + r|want| of the float32
    output)."""
    q, k, v = _flash_inputs(2, 8, 2, 300, 300, 128, dtype, cuda_device, 0)
    got = flash_ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == dtype
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)
    _assert_within_scaled_tol(got, q, k, v, True)


# (B, Hq, Hkv, Sq, Skv, causal) for the tensor-core body: ragged lengths
# (300, 1000), a causal continuation chunk (96 queries after 384 cached
# keys), non-causal, one query against 300 keys; GQA groups 1, 4 and 16.
WGMMA_CASES = [(1, 4, 4, 300, 300, True), (1, 16, 4, 1000, 1000, True),
               (2, 8, 2, 96, 480, True), (1, 16, 1, 300, 300, False),
               (1, 4, 2, 1, 300, False), (1, 16, 1, 1000, 1000, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [24, 64, 128])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,causal", WGMMA_CASES)
def test_flash_attention_wgmma_body_matches_plain_version(
        cuda_device, dtype, D, B, Hq, Hkv, Sq, Skv, causal):
    """16-bit inputs with D ≤ 128 take the tensor-core body.  It keeps the
    probabilities as a high and a low 16-bit part and rounds the output
    once, so it stays within atol 3e-2 of the plain version (the
    reference's bf16 tolerance) and within a + r|want| of its float32
    output."""
    q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, cuda_device,
                            Sq + Skv + D)
    before = dict(flash_ops.LAUNCHES_BY_BODY)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_BODY == {
        "wgmma": before["wgmma"] + 1, "simt": before["simt"]}
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, D)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)
    _assert_within_scaled_tol(got, q, k, v, causal)
    # q as the layers hand it over (a transposed view of (B, S, H, D)) is
    # read in place through its strides, with the same answer.
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(
        flash_ops.flash_attention(qt, k, v, causal=causal), got, atol=0,
        rtol=0)


@pytest.mark.parametrize("D", [20, 21, 100])
def test_flash_attention_wgmma_body_pads_other_head_dims(cuda_device, D):
    """A head dim that is not a multiple of 8 is zero-padded to one for the
    TMA copies (strides must be multiples of 16 bytes); an odd one is
    stored element by element.  Both within atol 3e-2 and a + r|want|."""
    q, k, v = _flash_inputs(1, 8, 2, 200, 200, D, torch.bfloat16,
                            cuda_device, D)
    before = dict(flash_ops.LAUNCHES_BY_BODY)
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_BODY["wgmma"] == before["wgmma"] + 1
    assert got.shape == (1, 8, 200, D)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)
    _assert_within_scaled_tol(got, q, k, v, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_wgmma_body_takes_expanded_kv(cuda_device, dtype):
    """k and v expanded over the batch (stride 0, which a TMA map cannot
    take) are copied first, and give what their contiguous copies give."""
    q, k, v = _flash_inputs(3, 8, 2, 260, 260, 64, dtype, cuda_device, 5)
    ke, ve = k[:1].expand(3, -1, -1, -1), v[:1].expand(3, -1, -1, -1)
    assert ke.stride(0) == 0
    before = dict(flash_ops.LAUNCHES_BY_BODY)
    got = flash_ops.flash_attention(q, ke, ve, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_BODY["wgmma"] == before["wgmma"] + 1
    torch.testing.assert_close(
        got, flash_ops.flash_attention(q, ke.contiguous(), ve.contiguous(),
                                       causal=True), atol=0, rtol=0)
    _assert_within_scaled_tol(got, q, ke, ve, True)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256)])
def test_flash_attention_simt_body_takes_the_rest(cuda_device, dtype, D):
    """float32 inputs and 16-bit inputs with D > 128 launch the CUDA-core
    body, within its dtype's tolerance (float32 2e-5, 16-bit 3e-2)."""
    q, k, v = _flash_inputs(1, 4, 2, 130, 130, D, dtype, cuda_device, D)
    before = dict(flash_ops.LAUNCHES_BY_BODY)
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_BODY == {
        "wgmma": before["wgmma"], "simt": before["simt"] + 1}
    want = attention_ref(q, k, v, causal=True)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_flash_attention_causal_sq_above_skv_raises(cuda_device):
    q, k, v = _flash_inputs(1, 2, 2, 8, 4, 32, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="no key"):
        flash_ops.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("arch", ["glm4-9b", "minicpm-2b",
                                  "deepseek-coder-33b", "qwen2-72b"])
def test_smoke_lm_flash_card_matches_host(cuda_device, arch):
    """The smoke model with ``use_flash`` on the card (one kernel launch a
    layer) against the same weights on the host, float32 with TF32 off:
    logits within atol 1e-4 (sums in another order on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    card = build_model(cfg, cuda_device)
    host = build_model(cfg, "cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 48))
    before = flash_ops.LAUNCHES
    got, _ = card(tokens)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + cfg.n_layers
    want, _ = host(tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
def test_smoke_moe_card_matches_host(cuda_device, arch):
    """The smoke MoE model with ``use_flash`` on the card against the same
    weights on the host, float32 with TF32 off: the forward's logits, then
    prefill and 4 decode steps on the same tokens, within atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    card = build_model(cfg, cuda_device)
    host = build_model(cfg, "cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 48)))
    before = flash_ops.LAUNCHES
    got, _ = card(tokens)
    assert flash_ops.LAUNCHES == before + cfg.n_layers
    want, _ = host(tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    sides = []
    for m in (card, host):
        sf = make_lm_serve_fns(m)
        cache = m.init_cache(2, 44)
        logits, cache = sf.prefill(tokens[:, :40].to(m.device), cache)
        out = [logits.cpu()]
        for t in range(4):
            logits, cache = sf.decode(tokens[:, 40 + t:41 + t].to(m.device),
                                      cache, torch.full((2, 1), 40 + t,
                                                        device=m.device))
            out.append(logits.cpu())
        sides.append(torch.cat(out, 1))
    torch.testing.assert_close(sides[0], sides[1], atol=1e-4, rtol=0)


def test_moe_scoring_is_bit_reproducible_on_card(cuda_device):
    """Two bfloat16 scoring forwards of the MoE model (flash route, 4 x 512
    tokens, 8 experts top-2) give bit-equal logits: the combine sums each
    token's expert outputs in expert order, without atomics."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b", use_flash=True,
                           d_model=512, n_heads=4, n_kv=4, d_head=128)
    model = build_model(cfg, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 512))).to(cuda_device)
    with torch.no_grad():
        a, _ = model(tokens)
        b, _ = model(tokens)
    assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_attention_at_the_moe_shape(cuda_device):
    """K4 at moonshot-v1-16b-a3b's scoring shape (4 x 2048 tokens, 16 heads
    of 128, Hq = Hkv, bf16) takes the tensor-core body and stays within
    a + r|want| of the float32 plain version (FLASH_SCALED_TOL)."""
    q, k, v = _flash_inputs(4, 16, 16, 2048, 2048, 128, torch.bfloat16,
                            cuda_device, 16)
    before = dict(flash_ops.LAUNCHES_BY_BODY)
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_BODY["wgmma"] == before["wgmma"] + 1
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, causal=True).float(), atol=3e-2, rtol=0)
    _assert_within_scaled_tol(got, q, k, v, True)


# K4 at the audio and VLM paths' shapes (B, Hq, Hkv, Sq, Skv, D, causal):
# whisper-base's encoder (non-causal over 1500 frames, which is not a
# multiple of the 64-key tile), a decoder's 32 queries over those frames
# (apply_attention's xattn_kv route, Sq < Skv), and internvl2-76b's
# scoring forward (256 patches + 2048 tokens, GQA group 8, D 128).
AUDIO_VLM_FLASH_SHAPES = [(16, 8, 8, 1500, 1500, 64, False),
                          (16, 8, 8, 32, 1500, 64, False),
                          (1, 64, 8, 2304, 2304, 128, True)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", AUDIO_VLM_FLASH_SHAPES)
def test_flash_attention_at_the_audio_and_vlm_shapes(cuda_device, B, Hq, Hkv,
                                                     Sq, Skv, D, causal):
    """bf16 at those shapes takes the tensor-core body and stays within
    atol 3e-2 of the plain version and within a + r|want| of its float32
    output (FLASH_SCALED_TOL)."""
    q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Skv, D, torch.bfloat16,
                            cuda_device, Sq + Skv + D)
    before = dict(flash_ops.LAUNCHES_BY_BODY)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_BODY["wgmma"] == before["wgmma"] + 1
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, causal=causal).float(), atol=3e-2, rtol=0)
    _assert_within_scaled_tol(got, q, k, v, causal)


@pytest.mark.parametrize("arch,k4", [("whisper-base", 4),
                                     ("internvl2-76b", 2)])
def test_smoke_audio_vlm_card_matches_host(cuda_device, arch, k4):
    """The smoke audio and VLM models with ``use_flash`` on the card against
    the same weights on the host, float32 with TF32 off: the forward's
    logits with the frames or patches (K4 once an encoder and a decoder
    layer, or once a layer), then prefill with them and 4 decode steps,
    within atol 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    card = build_model(cfg, cuda_device)
    host = build_model(cfg, "cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
    rows = cfg.enc_seq if arch == "whisper-base" else cfg.n_patches
    patches = torch.from_numpy(
        rng.normal(size=(2, rows, cfg.d_model)).astype(np.float32))
    pre = cfg.n_patches if arch == "internvl2-76b" else 0
    before = flash_ops.LAUNCHES
    got, _ = card(tokens, patches.to(cuda_device))
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + k4
    want, _ = host(tokens, patches)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    sides = []
    for m in (card, host):
        sf = make_lm_serve_fns(m)
        cache = m.init_cache(2, pre + 44)
        logits, cache = sf.prefill(tokens[:, :40].to(m.device), cache,
                                   patches.to(m.device))
        out = [logits.cpu()]
        for t in range(4):
            logits, cache = sf.decode(tokens[:, 40 + t:41 + t].to(m.device),
                                      cache, torch.full((2, 1), pre + 40 + t,
                                                        device=m.device))
            out.append(logits.cpu())
        sides.append(torch.cat(out, 1))
    torch.testing.assert_close(sides[0], sides[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,k4", [("rwkv6-1.6b", 0),
                                     ("jamba-1.5-large-398b", 2)])
def test_smoke_recurrent_card_matches_host(cuda_device, arch, k4):
    """The smoke SSM and hybrid models with ``use_flash`` on the card against
    the same weights on the host, float32 with TF32 off: the forward's
    logits (K4 once a windowless attention layer: none for RWKV, one a
    jamba group), then prefill and 4 decode steps, within atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    card = build_model(cfg, cuda_device)
    host = build_model(cfg, "cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 48)))
    before = flash_ops.LAUNCHES
    got, _ = card(tokens)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + k4
    want, _ = host(tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    sides = []
    for m in (card, host):
        sf = make_lm_serve_fns(m)
        cache = m.init_cache(2, 44)
        logits, cache = sf.prefill(tokens[:, :40].to(m.device), cache)
        out = [logits.cpu()]
        for t in range(4):
            logits, cache = sf.decode(tokens[:, 40 + t:41 + t].to(m.device),
                                      cache, torch.full((2, 1), 40 + t,
                                                        device=m.device))
            out.append(logits.cpu())
        sides.append(torch.cat(out, 1))
    torch.testing.assert_close(sides[0], sides[1], atol=1e-4, rtol=0)


def test_rwkv_scoring_is_bit_reproducible_on_card(cuda_device):
    """Two bfloat16 scoring forwards of an RWKV-6 model (d_model 512, 4 x
    256 tokens, the scan route) give bit-equal logits."""
    cfg = get_smoke_config("rwkv6-1.6b", d_model=512)
    model = build_model(cfg, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 256))).to(cuda_device)
    with torch.no_grad():
        a, _ = model(tokens)
        b, _ = model(tokens)
    assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("S", [512, 100, 1])
def test_apply_mamba_on_card_matches_host(cuda_device, S):
    """One Mamba block (d_model 512, din 1024, N 16) in float32 with TF32
    off from a given state: the chunked route (S = 512), one scan (S =
    100) and a decode step on the card against the host, outputs and new
    state within atol 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("jamba-1.5-large-398b", dtype="float32",
                           d_model=512)
    p = arch_blocks.init_mamba(torch.Generator().manual_seed(S), cfg)
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.normal(size=(2, S, 512)).astype(np.float32))
    state = {"h": torch.from_numpy(rng.normal(size=(2, 1024, 16)).astype(
                 np.float32)),
             "conv": torch.from_numpy(rng.normal(size=(2, 3, 1024)).astype(
                 np.float32))}
    want, ws = arch_blocks.apply_mamba(cfg, p, x, state)
    got, gs = arch_blocks.apply_mamba(
        cfg, {k: v.to(cuda_device) for k, v in p.items()}, x.to(cuda_device),
        {k: v.to(cuda_device) for k, v in state.items()})
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    for k in ("h", "conv"):
        torch.testing.assert_close(gs[k].cpu(), ws[k], atol=1e-5, rtol=0)


# Training at the smoke size of the CPU parity tests (8 TPC-H queries, 6
# configurations, GTN d_model 16, 1 layer).  TRAIN_STEP_RTOL is
# test_torch_training.py's TRAJECTORY_LOSS_RTOL, which holds the host's
# trajectory to the reference's.
SMOKE_GTN = GTNConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32)
TRAIN_STEP_RTOL = 2e-6


@pytest.fixture(scope="module")
def smoke_subq_set():
    traces = collect_traces(default_workload("tpch", 2)[:8], 6, seed=0)
    ds, cfg = build_dataset(traces, "subq")
    return traces, ds, dataclasses.replace(cfg, gtn=SMOKE_GTN, hidden=(16,))


def test_training_steps_on_card_match_host(cuda_device, smoke_subq_set):
    """5 steps from one start: every loss within TRAIN_STEP_RTOL of the
    host's, and the trained models' z within rtol 1e-4."""
    _, ds, cfg = smoke_subq_set
    start = _Net(cfg, torch.Generator().manual_seed(3)).state_dict()
    card, host = (train_model(ds, cfg, steps=5, batch=128, seed=0,
                              init_params=start, device=d)
                  for d in (cuda_device, "cpu"))
    np.testing.assert_allclose(card.train_losses, host.train_losses,
                               rtol=TRAIN_STEP_RTOL)
    ii = np.arange(0, ds.n, 5)
    graphs = tuple(g[ds.graph_id[ii]] for g in ds.graphs)
    np.testing.assert_allclose(
        card.apply_rows(graphs, ds.theta[ii], ds.nond[ii]),
        host.apply_rows(graphs, ds.theta[ii], ds.nond[ii]),
        rtol=1e-4, atol=1e-4)


def test_model_trained_on_card(cuda_device, smoke_subq_set, tmp_path):
    """60 steps on the card: parameters stay there, the call synchronises
    with the host once (the losses read back after the loop), the loss
    falls, and a save/load round trip keeps the predictions."""
    traces, ds, cfg = smoke_subq_set
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model = train_model(ds, cfg, steps=60, batch=128, seed=0,
                                device=cuda_device)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    assert syncs <= 1
    assert all(p.device.type == cuda_device.type
               for p in model.net.parameters())
    losses = model.train_losses
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    met = evaluate(model, ds)
    assert np.isfinite(met.wmape).all() and met.xput > 0
    path = str(tmp_path / "model.npz")
    model.save(path)
    loaded = PerfModel.load(cfg, path, device=cuda_device)
    emb = model.embed(traces.queries[0], 0)
    theta = np.random.default_rng(0).random((16, 19)).astype(np.float32)
    nond = np.zeros(12, np.float32)
    np.testing.assert_array_equal(model.predict(emb, theta, nond),
                                  loaded.predict(emb, theta, nond))


@pytest.mark.parametrize("solver", ["ws", "evo", "pf", "so_fw"])
def test_baselines_with_card_model(cuda_device, solver):
    """The baselines over a card model (tests/test_tuning.py's budgets, q9,
    query-level space): non-dominated fronts, the host's decisions and
    evaluation counts, objectives within rtol 1e-4 of the host's."""
    cfg = ModelConfig("subq", 19, gtn=SMOKE_GTN, hidden=(16,))
    card = PerfModel(cfg, seed=0, device=cuda_device)
    host = PerfModel(cfg, seed=0, device="cpu")
    q9 = make_benchmark("tpch")[8]
    run = {"ws": lambda ev, D: baselines.solve_ws(ev, D, n_samples=800),
           "evo": lambda ev, D: baselines.solve_evo(ev, D, pop=24,
                                                    n_evals=96),
           "pf": lambda ev, D: baselines.solve_pf(ev, D, n_points=5,
                                                  n_probe=128),
           "so_fw": lambda ev, D: baselines.solve_so_fw(
               ev, D, np.array([0.9, 0.1]), n_samples=400)}[solver]
    F, U, _, n = run(*StageObjectives(q9, model=card).query_eval_coarse())
    F_h, U_h, _, n_h = run(*StageObjectives(q9,
                                            model=host).query_eval_coarse())
    assert pareto_mask_np(F).all() and np.isfinite(F).all()
    np.testing.assert_array_equal(U, U_h)
    np.testing.assert_allclose(F, F_h, rtol=1e-4)
    assert n == n_h


# ---------------------------------------------------------------------------
# The streaming layer on the card
# ---------------------------------------------------------------------------

def _stream_case(kind):
    from repro_torch.queryengine.workloads import (ArrivalModel, TenantSpec,
                                                   multi_tenant_stream)
    if kind == "single":
        return serving_stream("tpch", 12, seed=1,
                              arrivals=ArrivalModel(rate_qps=40.0)), ()
    specs = [TenantSpec(name="strict", slo="strict", priority=1,
                        solve_budget_s=0.2,
                        arrivals=ArrivalModel(rate_qps=60.0)),
             TenantSpec(name="deg", slo="degrade", weights=(0.5, 0.5),
                        solve_budget_s=0.2,
                        arrivals=ArrivalModel(rate_qps=60.0)),
             TenantSpec(name="be", weights=(0.1, 0.9), rate_limit_qps=20.0,
                        rate_limit_burst=2.0,
                        arrivals=ArrivalModel(rate_qps=60.0))]
    return multi_tenant_stream("tpch", specs, 5, seed=13), specs


def _served_rows(served):
    return repr([(s.rid, s.tenant, s.status, s.admitted_s, s.compiled_s,
                  s.finished_s, s.joined_running, s.worker)
                 for s in served])


def _assert_served_equal(got, want):
    assert _served_rows(got) == _served_rows(want)
    for a, b in zip(got, want):
        assert (a.result is None) == (b.result is None)
        if a.result is None:
            continue
        np.testing.assert_array_equal(a.ct.theta_c, b.ct.theta_c)
        np.testing.assert_array_equal(a.ct.front, b.ct.front)
        np.testing.assert_array_equal(a.result.theta_p_eff,
                                      b.result.theta_p_eff)
        np.testing.assert_array_equal(a.result.theta_s_eff,
                                      b.result.theta_s_eff)
        np.testing.assert_array_equal(a.result.sim.cost, b.result.sim.cost)


STREAM_CFG = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48,
                         n_c_enrich=12, max_bank=12, seed=3)


@pytest.mark.parametrize("kind", ["single", "overload"])
def test_server_on_card_matches_host(cuda_device, kind):
    """The oracle server under a ServiceTimeModel: the card's timeline and
    plans equal the host's exactly (the streams are tie-free in float32)."""
    from repro_torch.serve import (OptimizerServer, ServerConfig,
                                   ServiceTimeModel)
    reqs, specs = _stream_case(kind)
    clock = ServiceTimeModel(flush_points=((1, 0.05), (4, 0.12), (8, 0.2)),
                             round_s=0.005, cheap_s=0.001)
    out = {}
    for dev in ("cpu", cuda_device):
        srv = OptimizerServer(config=ServerConfig(max_batch=4, clock=clock),
                              cfg=STREAM_CFG, tenants=specs, device=dev)
        out[str(dev)] = (srv.serve(reqs), srv.last_run)
    (host, hs), (card, cs) = out["cpu"], out[str(cuda_device)]
    _assert_served_equal(card, host)
    assert (cs.flush_windows, cs.flush_caps, cs.tenant_slots) == \
        (hs.flush_windows, hs.flush_caps, hs.tenant_slots)


def test_fleet_on_card_matches_host(cuda_device, tmp_path):
    from repro_torch.serve import (CacheStore, OptimizerFleet, ServerConfig,
                                   ServiceTimeModel)
    reqs, specs = _stream_case("overload")
    clock = ServiceTimeModel(flush_points=((1, 0.05), (8, 0.2)),
                             round_s=0.005, cheap_s=0.001)
    out = {}
    for dev in ("cpu", cuda_device):
        store = CacheStore()
        fleet = OptimizerFleet(n_workers=2, config=ServerConfig(
            max_batch=4, clock=clock), cfg=STREAM_CFG, tenants=specs,
            cache_store=store, device=dev)
        out[str(dev)] = (fleet.serve(reqs), store)
    (host, _), (card, store) = out["cpu"], out[str(cuda_device)]
    _assert_served_equal(card, host)
    # The card's published caches load and serve on the host.
    store.save(tmp_path / "caches.pkl")
    warm = OptimizerFleet(n_workers=1, config=ServerConfig(max_batch=4),
                          cfg=STREAM_CFG, tenants=specs,
                          cache_store=CacheStore.load(tmp_path / "caches.pkl"),
                          publish_on_serve=False, device="cpu")
    served = warm.serve(reqs)
    assert warm.workers[0].tuning._results.hits > 0
    for a in served:
        if a.status == "served":
            b = {s.rid: s for s in host}[a.rid]
            if b.status == "served":
                np.testing.assert_array_equal(a.result.sim.cost,
                                              b.result.sim.cost)


def _mask_case(n, seed):
    """float32 objectives with +inf rows, a NaN and exact duplicates."""
    rng = np.random.default_rng(seed)
    F = rng.random((n, 2)).astype(np.float32)
    F[rng.choice(n, n // 4, replace=False)] = \
        F[rng.choice(n, n // 4, replace=False)]
    F[rng.random(n) < 0.1, 0] = np.inf
    F[0, 1] = np.nan
    return F, rng.random(n) > 0.2


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("n", [5, 256, 1000])
def test_pareto_mask_on_card_matches_k1_and_numpy(cuda_device, n, chunk):
    F, valid = _mask_case(n, seed=n + chunk)
    Ft = torch.from_numpy(F).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    got = pareto_mask(Ft, vt, chunk=chunk)
    assert got.device.type == "cuda"
    want = pareto_mask_np(F, valid)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    # K1 takes validity as given; its callers fold finiteness into it.
    vk = torch.from_numpy(valid & np.isfinite(F).all(-1)).to(cuda_device)
    np.testing.assert_array_equal(
        got.cpu().numpy(), pareto_ops.pareto_filter(Ft, vk).cpu().numpy())
    inf = torch.full((n, 2), float("inf"), device=cuda_device)
    assert not pareto_mask(inf, chunk=chunk).any()


@pytest.mark.parametrize("p", [3, 40, 1000])
def test_compact_bank_on_card_matches_host(cuda_device, p):
    F, valid = _mask_case(300, seed=p)
    mask = pareto_mask_np(F, valid)
    got = compact_bank(torch.from_numpy(F).to(cuda_device),
                       torch.from_numpy(mask).to(cuda_device), p)
    want = compact_bank(torch.from_numpy(F), torch.from_numpy(mask), p)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    c = min(int(mask.sum()), p)
    np.testing.assert_array_equal(want[2][:c].numpy(),
                                  np.nonzero(mask)[0][:c])


def test_autotune_card_equals_host(cuda_device):
    """One launch plan on the card (K1 on the banks phase and the DAG
    filter) and on the host's float64 numpy route: the same plan."""
    before = pareto_ops.LAUNCHES
    card = autotune("qwen2-72b", "train_4k", weights=(0.5, 0.5),
                    device=cuda_device)
    assert 1 <= pareto_ops.LAUNCHES - before <= 2
    host = autotune("qwen2-72b", "train_4k", weights=(0.5, 0.5),
                    device="cpu")
    assert (card.theta_c, card.theta_p, card.theta_s, card.predicted) == \
        (host.theta_c, host.theta_p, host.theta_s, host.predicted)
    np.testing.assert_array_equal(card.front, host.front)


def test_quickstart_card_equals_host(cuda_device):
    """The quickstart example on the card (K1 for its solve, the runtime
    pick for its AQE requests) prints and plans as on the host."""
    before = (pareto_ops.LAUNCHES, ws_ops.RUNTIME_PICK_LAUNCHES)
    outs, texts = [], []
    for dev in (cuda_device, "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs.append(quickstart.run(device=dev))
        texts.append([ln for ln in buf.getvalue().splitlines()
                      if "solved in" not in ln])
        if dev is cuda_device:
            assert 1 <= pareto_ops.LAUNCHES - before[0] <= 2
            assert ws_ops.RUNTIME_PICK_LAUNCHES > before[1]
    card, host = outs
    assert texts[0] == texts[1]
    a, b = card["compile_time"], host["compile_time"]
    for f in ("front", "theta_c", "theta_p0", "theta_s0", "theta_p_sub",
              "theta_s_sub"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for key in ("default", "hmooc3", "runtime"):
        x, y = card[key], host[key]
        assert x.requests_sent == y.requests_sent
        for f in ("theta_p_eff", "theta_s_eff", "final_join"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        np.testing.assert_array_equal(x.sim.actual_latency,
                                      y.sim.actual_latency)
        np.testing.assert_array_equal(x.sim.cost, y.sim.cost)


# Dense-LM training.  LM_TRAJECTORY_RTOL is test_torch_train_step.py's
# TRAJECTORY_RTOL, which holds the host's steps to the reference's; the
# card's embedding backward adds with atomics, so its gradients are not
# bit-reproducible and card against host needs a tolerance.
LM_TRAJECTORY_RTOL = 1e-4


def _lm_steps(model, batches, accum):
    fns = make_lm_train_step(model, LMOptConfig(lr=1e-3, total_steps=100,
                                                warmup_steps=3), accum=accum)
    params, state = fns.init()
    rows = []
    for b in batches:
        params, state, m = fns.step(params, state, b)
        rows.append([float(m[k]) for k in ("loss", "lr", "grad_norm")])
    return np.array(rows), params, state


@pytest.mark.parametrize("arch", ["glm4-9b", "minicpm-2b",
                                  "moonshot-v1-16b-a3b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_lm_train_steps_on_card_match_host(cuda_device, arch):
    """5 float32 smoke steps with accum 2 from one start: losses, learning
    rates and gradient norms within LM_TRAJECTORY_RTOL of the host's, and
    no flash-attention launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch, dtype="float32")
    host = build_model(cfg, "cpu")
    card = build_model(cfg, cuda_device)
    card.load_state_dict(host.state_dict())
    it = lm_data_iterator(cfg, global_batch=8, seq_len=32, seed=1)
    batches = [next(it) for _ in range(5)]
    before = flash_ops.LAUNCHES
    got, params, _ = _lm_steps(card, batches, 2)
    assert flash_ops.LAUNCHES == before
    assert all(t.device == card.device for t in params.values())
    want, _, _ = _lm_steps(host, batches, 2)
    np.testing.assert_allclose(got, want, rtol=LM_TRAJECTORY_RTOL)


def test_lm_train_full_width_minicpm_step_memory(cuda_device):
    """One step of minicpm-2b at full width (bfloat16, float32 moments,
    remat "block", 8 x 512 tokens in 4 microbatches): a finite loss, no
    host sync, and a peak within the state's bytes plus 12 GB: parameters,
    gradients, the float32 accumulation buffers and both moments are 16
    bytes a parameter (43.5 GB); a layer's activations under remat, the
    loss's float32 logits and the optimizer's float32 temporaries of the
    largest leaf fit in the rest."""
    cfg = get_config("minicpm-2b")
    model = build_model(cfg, cuda_device)
    n = sum(p.numel() for p in model.parameters())
    batch = lm_make_batch(cfg, global_batch=8, seq_len=512, step=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = make_lm_train_step(model, LMOptConfig(moment_dtype=cfg.moment_dtype),
                             accum=cfg.train_accum)
    params, state = fns.init()
    fns.step(params, state, batch)                      # warm-up
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, m = fns.step(params, state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    assert np.isfinite(float(m["loss"]))
    assert syncs == 0
    peak = torch.cuda.max_memory_allocated()
    assert peak <= 16 * n + 12e9, (peak, n)


def test_lm_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """Save after 2 steps, restore into a fresh model and optimizer state on
    the card: every tensor bit-equal, and the next step's loss equal."""
    cfg = get_smoke_config("minicpm-2b")
    model = build_model(cfg, cuda_device)
    it = lm_data_iterator(cfg, global_batch=4, seq_len=32)
    fns = make_lm_train_step(model, LMOptConfig())
    params, state = fns.init()
    for _ in range(2):
        params, state, _ = fns.step(params, state, next(it))
    save_checkpoint(str(tmp_path), 2, params, state)
    fresh = build_model(cfg, cuda_device,
                        torch.Generator(device=cuda_device).manual_seed(5))
    fresh_fns = make_lm_train_step(fresh, LMOptConfig())
    like = dict(zip(("params", "opt"), fresh_fns.init()))
    restored, at = restore_checkpoint(str(tmp_path), like)
    assert at == 2
    fresh.load_state_dict(restored["params"])
    for group, live, back in (("params", params, dict(fresh.named_parameters())),
                              ("m", state["m"], restored["opt"]["m"]),
                              ("v", state["v"], restored["opt"]["v"])):
        for n, t in live.items():
            assert back[n].device == t.device
            assert torch.equal(back[n].detach(), t.detach()), (group, n)
    nxt = next(it)
    _, _, a = fns.step(params, state, nxt)
    _, _, b = fresh_fns.step(dict(fresh.named_parameters()),
                             restored["opt"], nxt)
    assert float(a["loss"]) == float(b["loss"])


def test_lm_train_refuses_flash_on_card(cuda_device):
    """The train step refuses ``use_flash``, and the kernel's wrapper
    refuses inputs that need a gradient; no kernel launch."""
    model = build_model(get_smoke_config("glm4-9b", use_flash=True),
                        cuda_device)
    batch = lm_make_batch(model.cfg, global_batch=2, seq_len=16, step=0)
    fns = make_lm_train_step(model, LMOptConfig())
    before = flash_ops.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward pass"):
        fns.step(*fns.init(), batch)
    with pytest.raises(RuntimeError, match="no backward pass"):
        model.loss(batch)
    assert flash_ops.LAUNCHES == before


# Sharding on one card: make_host_mesh()'s (1, 1) mesh over a one-rank
# NCCL world.  Every DTensor is whole on the one rank, so the sharded
# steps and forwards run the same kernels on the same values.

@pytest.fixture
def host_mesh(cuda_device):
    owns = init_host_world(cuda_device)
    try:
        yield make_host_mesh(device=cuda_device)
    finally:
        set_activation_mesh(None)
        if owns:
            dist.destroy_process_group()


def test_lm_train_steps_under_host_mesh_on_card(cuda_device, host_mesh):
    """3 float32 smoke glm4-9b steps with accum 2 under the (1, 1) NCCL mesh:
    losses, learning rates and gradient norms bit-equal to the same steps
    without a mesh, the parameters DTensors."""
    assert host_mesh.shape == (1, 1) and dist.get_backend() == "nccl"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("glm4-9b", dtype="float32")
    it = lm_data_iterator(cfg, global_batch=8, seq_len=32, seed=1)
    batches = [next(it) for _ in range(3)]
    rows = {}
    for tag, mesh in (("plain", None), ("mesh", host_mesh)):
        set_activation_mesh(None)
        model = build_model(cfg, cuda_device)
        fns = make_lm_train_step(model, LMOptConfig(lr=1e-3, total_steps=100,
                                                    warmup_steps=3),
                                 mesh=mesh, accum=2)
        params, state = fns.init()
        assert all(isinstance(p, DTensor) for p in params.values()) == \
            (mesh is not None)
        got = []
        for b in batches:
            params, state, m = fns.step(params, state, b)
            got.append([float(m[k]) for k in ("loss", "lr", "grad_norm")])
        rows[tag] = got
    assert rows["mesh"] == rows["plain"]


def test_lm_score_under_host_mesh_on_card(cuda_device, host_mesh):
    """The smoke glm4-9b's bf16 scoring forward with K4 under the (1, 1)
    NCCL mesh: one launch a layer, logits bit-equal to the unsharded
    forward's."""
    cfg = get_smoke_config("glm4-9b", use_flash=True)
    model = build_model(cfg, cuda_device)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(
        cuda_device)
    want = make_lm_serve_fns(model).score(tokens)
    before = flash_ops.LAUNCHES
    got = make_lm_serve_fns(model, mesh=host_mesh).score(tokens)
    assert flash_ops.LAUNCHES - before == cfg.n_layers
    assert not isinstance(got, DTensor)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# (architecture, K4 launches of a scoring forward, of a prefill): one a
# windowless attention layer (a jamba group has one; RWKV none); an audio
# model's prefill encodes the frames, one launch an encoder layer.
HOST_MESH_FAMILIES = [("moonshot-v1-16b-a3b", 2, 0), ("rwkv6-1.6b", 0, 0),
                      ("jamba-1.5-large-398b", 2, 0), ("whisper-base", 4, 2),
                      ("internvl2-76b", 2, 0), ("glm4-9b", 2, 0)]


@pytest.mark.parametrize("arch,k4_score,k4_prefill", HOST_MESH_FAMILIES)
def test_family_serving_under_host_mesh_on_card(cuda_device, host_mesh, arch,
                                                k4_score, k4_prefill):
    """Each family's bf16 smoke model with ``use_flash`` served through
    ``make_serve_fns`` without a mesh and then under the (1, 1) NCCL mesh,
    on one model object: the scoring forward (K4 on each rank's heads,
    the counted launches), prefill with the patches or frames and 4
    greedy decode steps (no K4 launch but an audio model's encoder's):
    logits and tokens bit-equal."""
    cfg = get_smoke_config(arch, use_flash=True)
    model = build_model(cfg, cuda_device)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))).to(
        cuda_device)
    rows = {"vlm": cfg.n_patches, "audio": cfg.enc_seq}.get(cfg.family)
    patches = None if rows is None else torch.from_numpy(rng.normal(
        size=(2, rows, cfg.d_model)).astype(np.float32)).to(cuda_device)
    pre = cfg.n_patches if cfg.family == "vlm" else 0
    sides = {}
    for tag, mesh in (("plain", None), ("mesh", host_mesh)):
        set_activation_mesh(None)
        sf = make_lm_serve_fns(model, mesh=mesh)
        before = flash_ops.LAUNCHES
        score = sf.score(tokens, patches)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHES - before == k4_score
        before = flash_ops.LAUNCHES
        logits, cache = sf.prefill(tokens, model.init_cache(2, pre + 44),
                                   patches)
        out, nxt = [logits], logits[:, -1].argmax(-1)
        generated = [nxt]
        for t in range(4):
            logits, cache = sf.decode(nxt[:, None], cache, torch.full(
                (2, 1), pre + 40 + t, device=cuda_device))
            nxt = logits[:, -1].argmax(-1)
            out.append(logits)
            generated.append(nxt)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHES - before == k4_prefill
        sides[tag] = [score, torch.cat(out, 1), torch.stack(generated, 1)]
    set_activation_mesh(None)
    assert cfg.dtype == "bfloat16"
    for a, b in zip(sides["plain"], sides["mesh"]):
        assert not isinstance(b, DTensor)
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)
