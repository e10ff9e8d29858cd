"""Port parity: the fused_solve kernel package and HMOOC2's kernel regime.

The port's plain version (what ``fused_ws_front(..., device="cpu")`` runs)
is held to the reference's numpy oracle ``fused_ws_front_ref``: picks and
the kept mask exactly, the float64 objective sums within rtol 1e-12 (the
same sums, left to right).  With ``Fn=None`` it normalises the bank
itself; its scores are held bit-equal to the reference solver's
``_hmooc2_normalize`` followed by the float32 cast.  The reference's own
jit cannot run on this JAX, so it is not called here.  The port's ``dag_aggregate`` forced onto
the fused route is held to the reference's per-candidate float64 numpy
route on float32-representable, tie-free banks: the fronts are exactly
equal.  The CUDA kernel itself is held to the plain version in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.moo import hmooc as ref_hmooc
from repro.core.moo import pareto as ref_pareto
from repro.kernels.fused_solve.ref import fused_ws_front_ref
from repro_torch.core.moo import hmooc as port_hmooc
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.kernels.fused_solve import ops as port_ops


def _weights(nw):
    return np.stack([np.linspace(0.05, 0.95, nw),
                     1.0 - np.linspace(0.05, 0.95, nw)], -1)


def _normalize(Fb):
    lo = np.nanmin(np.where(np.isfinite(Fb), Fb, np.nan), axis=(1, 2),
                   keepdims=True)
    hi = np.nanmax(np.where(np.isfinite(Fb), Fb, np.nan), axis=(1, 2),
                   keepdims=True)
    return np.where(np.isfinite(Fb), (Fb - lo) / np.where(hi > lo, hi - lo,
                                                          1.0), 1e18)


def _check(Fn, Fb, W):
    before = port_ops.LAUNCHES
    out = port_ops.fused_ws_front(Fn, Fb, W, device="cpu")
    assert port_ops.LAUNCHES == before       # the host launches nothing
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in out)
    jj, P_all, keep = (t.numpy() for t in out)
    if Fn is None:                           # the solver's own scores
        Fn = np.nan_to_num(ref_hmooc._hmooc2_normalize(Fb).astype(
            np.float32), posinf=1e30)
    jr, Pr, kr = fused_ws_front_ref(Fn, Fb, W)
    np.testing.assert_array_equal(jj, jr)
    np.testing.assert_allclose(P_all, Pr, rtol=1e-12)
    np.testing.assert_array_equal(keep, kr)
    return jj, P_all, keep


@pytest.mark.parametrize("N,m,B,k,nw", [(1, 1, 2, 2, 3), (3, 2, 8, 2, 11),
                                        (7, 3, 16, 2, 6), (33, 5, 4, 2, 4)])
def test_plain_version_matches_reference(N, m, B, k, nw):
    """The four cases of the reference's own parity test, padded slots
    included."""
    rng = np.random.default_rng(N * 1000 + m * 10 + B)
    Fb = rng.random((N, m, B, k))
    if B > 2:
        Fb[:, :, -1] = np.inf
        Fb[0, 0, -2] = np.inf
    _check(_normalize(Fb).astype(np.float32), Fb, _weights(nw))


def test_padding_and_invalid_banks_never_reach_the_front():
    rng = np.random.default_rng(1)
    N, m, B, k, nw = 5, 3, 4, 2, 6
    Fb = rng.random((N, m, B, k))
    Fb[2, 1] = np.inf                 # a subQ with an empty bank
    _, P_all, keep = _check(Fb.astype(np.float32), Fb, _weights(nw))
    assert not keep[2].any()
    assert keep.any()
    assert np.isfinite(P_all[keep]).all()


def test_composed_solve_by_hand():
    """Bank 0 strictly dominates bank 1 in every subQ: every weight picks
    it, and each candidate survives with all its rows or none."""
    N, m, B, k, nw = 3, 2, 2, 2, 4
    rng = np.random.default_rng(0)
    Fb = rng.random((N, m, B, k))
    Fb[:, :, 0] = Fb[:, :, 1] - 1.0
    W = np.stack([np.linspace(0.1, 0.9, nw),
                  1.0 - np.linspace(0.1, 0.9, nw)], -1)
    jj, P_all, keep = _check(Fb.astype(np.float32), Fb, W)
    assert (jj == 0).all()
    np.testing.assert_allclose(P_all, np.broadcast_to(
        Fb[:, :, 0].sum(axis=1)[:, None, :], (N, nw, k)), rtol=1e-12)
    cand = ref_pareto.pareto_mask_np(Fb[:, :, 0].sum(axis=1))
    np.testing.assert_array_equal(keep.any(axis=1), cand)
    assert (keep.sum(axis=1)[cand] == nw).all()


def test_wrapper_checks_its_inputs():
    Fb = np.zeros((2, 2, 3, 2))
    with pytest.raises(ValueError):
        port_ops.fused_ws_front(Fb[:, :1], Fb, _weights(3), device="cpu")
    with pytest.raises(ValueError):
        port_ops.fused_ws_front(Fb, Fb, np.zeros((3, 3)), device="cpu")
    with pytest.raises(ValueError):
        port_ops.fused_ws_front(Fb[:, :, :0], Fb[:, :, :0], _weights(3),
                                device="cpu")


def test_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    Fb = np.zeros((1, 1, 2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ops.fused_ws_front(Fb, Fb, _weights(3))


@pytest.fixture
def restore_thresholds():
    saved = (ref_pareto._KERNEL_MIN_N, ref_hmooc._WS_MIN_SCORES,
             port_pareto._KERNEL_MIN_N, port_hmooc._WS_MIN_SCORES)
    yield
    (ref_pareto._KERNEL_MIN_N, ref_hmooc._WS_MIN_SCORES,
     port_pareto._KERNEL_MIN_N, port_hmooc._WS_MIN_SCORES) = saved


def _f32_bank(rng, shape, scale=10.0):
    # float32-representable values: the f32 compares are then exact.
    return (rng.random(shape) * scale).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_dag_aggregate_fused_route_matches_reference_numpy(
        seed, restore_thresholds, monkeypatch):
    rng = np.random.default_rng(seed)
    N, m, B, k = 6, 3, 8, 2
    Fb = _f32_bank(rng, (N, m, B, k))
    Fb[0, 1] = np.inf                             # a subQ with an empty bank
    Fb[3, :, 5:] = np.inf                         # partially padded banks
    Ib = np.tile(np.arange(B), (N, m, 1))
    Uc = rng.random((N, 3))
    pool = rng.random((B, 4))
    ref_pareto._KERNEL_MIN_N = 1 << 30
    ref_hmooc._WS_MIN_SCORES = 1 << 60
    want = ref_hmooc.dag_aggregate(Uc, pool, Fb, Ib, "hmooc2")
    port_hmooc._WS_MIN_SCORES = 0
    port_pareto._KERNEL_MIN_N = 0
    fused = port_hmooc._hmooc2_all_fused
    calls = []
    monkeypatch.setattr(port_hmooc, "_hmooc2_all_fused",
                        lambda *a: calls.append(1) or fused(*a))
    got = port_hmooc.dag_aggregate(Uc, pool, Fb, Ib, "hmooc2", device="cpu")
    assert calls == [1]                           # the fused route ran
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dag_aggregate_tie_hazard_takes_float64_route(restore_thresholds,
                                                      monkeypatch):
    """Banks whose float64-distinct values collide in float32 skip the
    fused route even when forced, exactly as the reference routes them."""
    rng = np.random.default_rng(5)
    Fb = rng.random((4, 2, 6, 2))
    Fb[1, 0, 0, 0] = Fb[0, 0, 0, 0] + 1e-12      # ties only in float32
    Ib = np.tile(np.arange(6), (4, 2, 1))
    Uc, pool = rng.random((4, 3)), rng.random((6, 4))
    port_hmooc._WS_MIN_SCORES = 0
    ref_hmooc._WS_MIN_SCORES = 1 << 60
    monkeypatch.setattr(port_hmooc, "_hmooc2_all_fused", None)  # unused
    got = port_hmooc.dag_aggregate(Uc, pool, Fb, Ib, "hmooc2", device="cpu")
    want = ref_hmooc.dag_aggregate(Uc, pool, Fb, Ib, "hmooc2")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _bank(kind, seed):
    """(N, m, B, 2) float64 banks with the normalisation's edge cases."""
    rng = np.random.default_rng(seed)
    Fb = rng.random((6, 3, 8, 2)) * 10 ** rng.uniform(-3, 3, (1, 1, 1, 2))
    if kind == "padded":                      # partially padded banks
        Fb[:, :, 5:] = np.inf
        Fb[1, 2, 1:] = np.nan
        Fb[4, 0, :3, 1] = -np.inf
    elif kind == "no_finite":                 # a candidate with no finite
        # entry, and an objective with none in another
        Fb[2] = np.inf
        Fb[3, :, :, 0] = np.nan
    elif kind == "constant":                  # hi == lo
        Fb[:, :, :, 1] = 7.25
        Fb[0] = 3.0
    elif kind == "huge":                      # spans that overflow, f32 inf
        with np.errstate(over="ignore"):
            Fb[1, :, :, 0] *= 1e307
        Fb[1, 0, 0, 0] = -1.7e308
        Fb[5, :, :, 1] = rng.random((3, 8)) * 1e300
    return Fb


@pytest.mark.parametrize("kind", ["uniform", "padded", "no_finite",
                                  "constant", "huge"])
def test_scores_bit_equal_reference_normalisation(kind):
    Fb = _bank(kind, seed=len(kind))
    with np.errstate(over="ignore", invalid="ignore"):
        want = np.nan_to_num(ref_hmooc._hmooc2_normalize(Fb).astype(
            np.float32), posinf=1e30)
    got = port_ops.hmooc2_scores_ref(torch.from_numpy(Fb)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kind", ["uniform", "padded", "no_finite",
                                  "constant", "huge"])
def test_plain_version_normalises_like_reference(kind):
    """``Fn=None`` equals the reference's normalise-then-fused_ws_front_ref
    composition."""
    Fb = _bank(kind, seed=10 + len(kind))
    with np.errstate(over="ignore", invalid="ignore"):
        _check(None, Fb, _weights(7))


def test_wrapper_accepts_tensors_and_numpy():
    rng = np.random.default_rng(8)
    Fb = rng.random((4, 3, 6, 2))
    Fb[1, 2, 4:] = np.inf
    W = _weights(5)
    want = [t.numpy() for t in port_ops.fused_ws_front(None, Fb, W,
                                                       device="cpu")]
    for Fn in (None, port_ops.hmooc2_scores_ref(torch.from_numpy(Fb))):
        got = port_ops.fused_ws_front(
            Fn, torch.from_numpy(Fb), torch.from_numpy(W).float(),
            device="cpu")
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("case", ["none", "planted", "straddle", "overflow",
                                  "nonfinite", "signed_zero"])
def test_tie_check_on_a_tensor_equals_numpy(case):
    """The router's tensor tie check (run on the card's staged bank) gives
    ``_f32_tie_hazard``'s answer."""
    rng = np.random.default_rng(11)
    X = (rng.random((300, 2)) * 10).astype(np.float32).astype(np.float64)
    if case == "planted":
        X[7, 1] = X[100, 1] + 1e-12          # distinct, equal in float32
    elif case == "straddle":
        X[3, 0] = np.nextafter(np.float32(2.0), np.float32(3.0)) * 0.5 \
            + 1.0 + 1e-13
        X[4, 0] = X[3, 0] + 1e-14
    elif case == "overflow":                 # both round to +inf in float32
        X[5, 0], X[6, 0] = 1e39, 2e39
    elif case == "nonfinite":                # non-finite values never tie
        X[:4, 0] = [np.inf, -np.inf, np.nan, np.inf]
    elif case == "signed_zero":
        X[0, 1], X[1, 1] = 0.0, -0.0
    want = port_pareto._f32_tie_hazard(X)
    got = port_pareto._f32_tie_hazard_tensor(torch.from_numpy(X))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want
    assert want == (case in ("planted", "straddle", "overflow"))
