"""Port parity: Algorithm 1 and the DAG aggregation (host numpy routes).

The solver's bookkeeping and its numpy RNG streams are the same code in
both packages, so candidates, banks, fronts and θ are exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.moo import clustering as ref_clustering
from repro.core.moo import hmooc as ref_hmooc
from repro.core.moo import pareto as ref_pareto
from repro.core.moo import wun as ref_wun
from repro_torch.core.moo import clustering as port_clustering
from repro_torch.core.moo import hmooc as port_hmooc
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.core.moo import wun as port_wun

CFG_KW = dict(n_c_init=12, n_clusters=3, n_p_pool=32, n_c_enrich=8,
              max_bank=8, seed=1)


def stage_eval(i, Tc, Tps):
    base = 1.0 + i
    f1 = base * ((1 - Tps[:, 0]) ** 2 + 0.1) / (0.2 + Tc[:, 0])
    f2 = base * (0.1 + Tc[:, 0]) * (0.5 + Tps[:, 0])
    return np.stack([f1, f2], -1)


def _assert_results_equal(a, b):
    np.testing.assert_array_equal(a.front, b.front)
    np.testing.assert_array_equal(a.theta_c, b.theta_c)
    np.testing.assert_array_equal(a.theta_ps, b.theta_ps)
    assert a.n_evals == b.n_evals


def test_kmeans_and_wun_equal():
    X = np.random.default_rng(0).random((60, 5))
    km_a, la = ref_clustering.kmeans_fit(X, 6, np.random.default_rng(2))
    km_b, lb = port_clustering.kmeans_fit(X, 6, np.random.default_rng(2))
    np.testing.assert_array_equal(km_a.centers, km_b.centers)
    np.testing.assert_array_equal(la, lb)
    F = np.random.default_rng(1).random((20, 2))
    for w in ([1.0, 0.0], [0.9, 0.1], [0.3, 0.7]):
        ia, fa = ref_wun.wun_select(F, np.asarray(w))
        ib, fb = port_wun.wun_select(F, np.asarray(w))
        assert ia == ib
        np.testing.assert_array_equal(fa, fb)


def test_build_candidates_equal():
    a = ref_hmooc.build_candidates(4, 6, ref_hmooc.HMOOCConfig(**CFG_KW))
    b = port_hmooc.build_candidates(4, 6, port_hmooc.HMOOCConfig(**CFG_KW))
    for f in ("Uc", "labels", "reps", "pool"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("method", ["hmooc1", "hmooc2", "hmooc3"])
def test_hmooc_solve_equal(method):
    ra = ref_hmooc.hmooc_solve(
        stage_eval, m=3, d_c=2, d_ps=2,
        cfg=ref_hmooc.HMOOCConfig(dag_method=method, **CFG_KW))
    rb = port_hmooc.hmooc_solve(
        stage_eval, m=3, d_c=2, d_ps=2,
        cfg=port_hmooc.HMOOCConfig(dag_method=method, **CFG_KW),
        device="cpu")
    _assert_results_equal(ra, rb)


def test_hmoocplan_matches_reference_solve():
    cfg_b = port_hmooc.HMOOCConfig(**CFG_KW)
    plan = port_hmooc.HmoocPlan(3, 2, 2, cfg_b, device="cpu")
    while not plan.done:
        plan.feed([stage_eval(i, Tc, Tps) for i, Tc, Tps in plan.requests()])
    ra = ref_hmooc.hmooc_solve(stage_eval, m=3, d_c=2, d_ps=2,
                               cfg=ref_hmooc.HMOOCConfig(**CFG_KW))
    _assert_results_equal(ra, plan.result)


@pytest.mark.parametrize("method", ["hmooc2", "hmooc3"])
def test_hmoocplan_forced_kernel_routing_matches_reference(method,
                                                           monkeypatch):
    """Every mask on the kernel route (the port's plain version, the
    reference's Pallas kernel in interpret mode): the banks phase makes one
    ``pareto_masks_fast`` call for its C·m banks, HMOOC2 one for its
    per-candidate fronts, and ``opt_idx`` and the results equal the
    reference's per-bank solve."""
    monkeypatch.setattr(ref_pareto, "_KERNEL_MIN_N", 0)
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 0)
    calls = []
    real = port_hmooc.pareto_masks_fast

    def spy(Fs, **kw):
        calls.append(len(Fs))
        return real(Fs, **kw)

    monkeypatch.setattr(port_hmooc, "pareto_masks_fast", spy)
    m = 3
    plan = port_hmooc.HmoocPlan(
        m, 2, 2, port_hmooc.HMOOCConfig(dag_method=method, **CFG_KW),
        device="cpu")
    plan.feed([stage_eval(i, Tc, Tps) for i, Tc, Tps in plan.requests()])
    assert calls == [CFG_KW["n_clusters"] * m]
    plan.feed([stage_eval(i, Tc, Tps) for i, Tc, Tps in plan.requests()])
    assert plan.done
    assert len(calls) == (2 if method == "hmooc2" else 1)
    ra = ref_hmooc.hmooc_solve(
        stage_eval, m=m, d_c=2, d_ps=2,
        cfg=ref_hmooc.HMOOCConfig(dag_method=method, **CFG_KW))
    want, got = ra.effective_set.opt_idx, plan.result.effective_set.opt_idx
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert len(a) == len(b) == m
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _assert_results_equal(ra, plan.result)


@pytest.mark.parametrize("method", ["hmooc1", "hmooc2", "hmooc3"])
def test_dag_aggregate_equal(method):
    rng = np.random.default_rng(2)
    N, m, B, k = 6, 3, 8, 2
    Fb = rng.random((N, m, B, k)) * 10
    Fb[0, 1] = np.inf                             # a subQ with an empty bank
    Fb[3, :, 5:] = np.inf                         # partially padded banks
    Ib = np.tile(np.arange(B), (N, m, 1))
    Uc = rng.random((N, 3))
    pool = rng.random((B, 4))
    got = port_hmooc.dag_aggregate(Uc, pool, Fb, Ib, method, device="cpu")
    want = ref_hmooc.dag_aggregate(Uc, pool, Fb, Ib, method)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_solver_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_hmooc.hmooc_solve(stage_eval, m=2, d_c=2, d_ps=2,
                               cfg=port_hmooc.HMOOCConfig(**CFG_KW))


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_dag_aggregate_staged_fused_route_matches_reference(seed,
                                                            monkeypatch):
    """HMOOC2's card route on the host: the bank and weights staged as one
    float64 buffer, the tie check on the staged tensor, then the fused
    aggregation on the tensors (``Fn=None``), equal to the reference's
    per-candidate float64 numpy route on float32-representable banks."""
    monkeypatch.setattr(ref_pareto, "_KERNEL_MIN_N", 1 << 30)
    monkeypatch.setattr(ref_hmooc, "_WS_MIN_SCORES", 1 << 60)
    rng = np.random.default_rng(seed)
    N, m, B, k = 6, 3, 8, 2
    Fb = (rng.random((N, m, B, k)) * 10).astype(np.float32).astype(
        np.float64)
    Fb[0, 1] = np.inf                             # a subQ with an empty bank
    Fb[3, :, 5:] = np.inf                         # partially padded banks
    Ib = np.tile(np.arange(B), (N, m, 1))
    Uc = rng.random((N, 3))
    pool = rng.random((B, 4))
    W = port_hmooc._ws_weights(11)
    cpu = torch.device("cpu")
    Fb_t, W_t = port_hmooc._hmooc2_stage(Fb, W, cpu)
    np.testing.assert_array_equal(Fb_t.numpy(), Fb)
    np.testing.assert_array_equal(W_t.numpy(), W)
    assert not bool(port_pareto._f32_tie_hazard_tensor(Fb_t.view(-1, k)))
    got = port_hmooc._hmooc2_all_fused(Uc, pool, Fb_t, Ib, W_t, cpu)
    want = ref_hmooc.dag_aggregate(Uc, pool, Fb, Ib, "hmooc2")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
