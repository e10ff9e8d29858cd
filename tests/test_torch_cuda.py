"""The port on a CUDA card: kernels against their plain versions, and the
card's answers against the host's.

Every test here needs a card (``cuda`` marker) and skips without one.  The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.kernels.pareto_filter import ops as pareto_ops
from repro_torch.kernels.pareto_filter.ref import pareto_mask_ref
from repro_torch.queryengine.workloads import serving_stream
from repro_torch.serve import TuningService

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
