"""Port parity: the paper's MOO baselines (MO-WS, NSGA-II, Progressive
Frontier, SO-FW) against the reference's, on the host.

The solvers are host numpy in both packages and draw the same numbers from
the same seed.  Over the oracle objectives (the simulator, float64 numpy)
every front, every decision row and every evaluation count is exactly the
reference's.  Over a model (the reference's trained smoke model carried
across) the objectives are float32 predictions summed in another order
(``test_torch_models.py``: rtol 1e-5 in z-space), so decisions are held
exactly and objectives within rtol 1e-4, the slice's front tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.moo import baselines as ref_baselines
from repro.core.tuning.objectives import StageObjectives as RefObjectives
from repro.queryengine.workloads import make_benchmark as ref_make_benchmark
from repro_torch.core.moo import baselines
from repro_torch.core.moo.pareto import pareto_mask_np
from repro_torch.core.tuning.objectives import StageObjectives
from repro_torch.queryengine.workloads import make_benchmark

from test_torch_models import carry

MODEL_RTOL = 1e-4

# tests/test_tuning.py::test_baselines_nondominated's budgets.
SOLVERS = {
    "ws": lambda m, ev, D: m.solve_ws(ev, D, n_samples=800, seed=0),
    "evo": lambda m, ev, D: m.solve_evo(ev, D, pop=24, n_evals=96, seed=0),
    "pf": lambda m, ev, D: m.solve_pf(ev, D, n_points=5, n_probe=128,
                                      seed=0),
    "so_fw": lambda m, ev, D: m.solve_so_fw(ev, D, np.array([0.9, 0.1]),
                                            n_samples=400, seed=0),
}


@pytest.fixture(scope="module")
def q9_pair():
    return ref_make_benchmark("tpch")[8], make_benchmark("tpch")[8]


def _evals(ref_obj, port_obj, space):
    name = f"query_eval_{space}"
    (ref_ev, ref_D), (ev, D) = getattr(ref_obj, name)(), \
        getattr(port_obj, name)()
    assert ref_D == D
    return ref_ev, ev, D


@pytest.mark.parametrize("space", ["coarse", "fine"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_oracle_baselines_equal(q9_pair, solver, space):
    ref_ev, ev, D = _evals(RefObjectives(q9_pair[0]),
                           StageObjectives(q9_pair[1]), space)
    F_ref, U_ref, _, n_ref = SOLVERS[solver](ref_baselines, ref_ev, D)
    F, U, dt, n = SOLVERS[solver](baselines, ev, D)
    np.testing.assert_array_equal(F, F_ref)
    np.testing.assert_array_equal(U, U_ref)
    assert n == n_ref and dt > 0
    assert F.shape[0] >= 1 and pareto_mask_np(F).all()


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_model_baselines_match(q9_pair, solver, smoke_perf_models):
    ref_model = smoke_perf_models["subq"]
    ref_ev, ev, D = _evals(RefObjectives(q9_pair[0], model=ref_model),
                           StageObjectives(q9_pair[1],
                                           model=carry(ref_model)),
                           "coarse")
    F_ref, U_ref, _, n_ref = SOLVERS[solver](ref_baselines, ref_ev, D)
    F, U, _, n = SOLVERS[solver](baselines, ev, D)
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_allclose(F, F_ref, rtol=MODEL_RTOL)
    assert n == n_ref and pareto_mask_np(F).all()


@pytest.mark.parametrize("n,k", [(1, 2), (17, 2), (60, 3), (200, 2)])
def test_helpers_equal(n, k):
    rng = np.random.default_rng(n + k)
    F = rng.random((n, k))
    F[rng.random(n) < 0.1] = F[0]            # duplicate rows
    np.testing.assert_array_equal(baselines._nd_sort(F),
                                  ref_baselines._nd_sort(F))
    np.testing.assert_array_equal(baselines._crowding(F),
                                  ref_baselines._crowding(F))
    np.testing.assert_array_equal(baselines._normalize(F),
                                  ref_baselines._normalize(F))
    np.testing.assert_array_equal(
        baselines._lhs(np.random.default_rng(3), n, k),
        ref_baselines._lhs(np.random.default_rng(3), n, k))
