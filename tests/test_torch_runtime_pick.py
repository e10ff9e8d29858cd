"""Port parity for a runtime round's pick on the card (``runtime_pick``):
its plain version (``runtime_pick_ref``, which the wrapper runs on CPU
tensors) and the host's ``weighted_pick_batch`` are held to the reference's
``weighted_pick_batch``, picks exactly equal, under the reference's default
routing (float64 numpy) and under forced kernel routing (its Pallas kernels
in interpret mode).  The cases plant what routes a pick elsewhere: float32
ties in a raw set and across two sets' normalised banks, a constant
objective, a set whose mask keeps nothing, a zero weight and non-finite
rows.  The CUDA kernel itself is held to the plain version in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.moo import hmooc as ref_hmooc
from repro.core.moo import pareto as ref_pareto
from repro.core.tuning import runtime as ref_rt
from repro_torch.core.moo import hmooc as port_hmooc
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.core.tuning import runtime as port_rt
from repro_torch.kernels.ws_reduce import ops as ws_ops
from repro_torch.kernels.ws_reduce.ref import (_dominance_mask, _numpy_sum,
                                               kept_normalised)

from _runtime_pick_cases import CASES, SHARED, budget_round, case_weights

CPU = torch.device("cpu")


@pytest.fixture(params=["default", "forced"])
def routing(request, monkeypatch):
    """Both packages' kernel thresholds: their host defaults (float64
    numpy) or 0 (every mask and pick on the kernel route)."""
    if request.param == "forced":
        for mod, name in ((ref_pareto, "_KERNEL_MIN_N"),
                          (ref_hmooc, "_WS_MIN_SCORES"),
                          (port_pareto, "_KERNEL_MIN_N"),
                          (port_hmooc, "_WS_MIN_SCORES")):
            monkeypatch.setattr(mod, name, 0)
    return request.param


def _runtime_pick(Fs, w):
    """The card route's staging and wrapper on the host: (picks, routes)."""
    Fs = [np.asarray(F, np.float64) for F in Fs]
    F, off, gid, W = port_rt._stage_round(Fs, np.asarray(w, np.float64), CPU)
    thr, ws = port_rt._pick_thresholds(CPU)
    before = ws_ops.RUNTIME_PICK_LAUNCHES
    out = ws_ops.runtime_pick(F, off, gid, W, kernel_min_n=thr,
                              ws_min_scores=ws)
    assert ws_ops.RUNTIME_PICK_LAUNCHES == before   # the host launches none
    assert out.dtype == torch.int32 and out.shape == (len(Fs) + W.shape[0],)
    return out[:len(Fs)].tolist(), out[len(Fs):].tolist()


@pytest.mark.parametrize("per_set", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_runtime_pick_matches_reference(case, per_set, routing):
    Fs = CASES[case]()
    w = case_weights(case, per_set, len(Fs))
    with np.errstate(invalid="ignore"):
        want = ref_rt.weighted_pick_batch(Fs, w)
    picks, routes = _runtime_pick(Fs, w)
    assert picks == want
    with np.errstate(invalid="ignore"):
        assert port_rt.weighted_pick_batch(Fs, w, device="cpu") == want
    assert set(routes) <= ({0} if routing == "default" else {1, 2})


@pytest.mark.parametrize("k", [2, 8])
def test_round_past_the_kernel_budget_matches_the_host(k, routing):
    """Sets longer than the kernel stages whole (it tiles them): the plain
    version against the host's route, and against the reference's numpy
    route under its defaults (its Pallas mask of 3,000 rows would take
    minutes in interpret mode)."""
    Fs, w = budget_round(k)
    with np.errstate(invalid="ignore"):
        want = port_rt.weighted_pick_batch(Fs, w, device="cpu")
        if routing == "default":
            assert ref_rt.weighted_pick_batch(Fs, w) == want
    assert _runtime_pick(Fs, w)[0] == want


def test_bank_tie_takes_the_float64_route(monkeypatch):
    """The planted cross-set tie sends its group to float64 (route 2); the
    same sets in separate groups hold no tie and score in float32."""
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 0)
    monkeypatch.setattr(port_hmooc, "_WS_MIN_SCORES", 0)
    Fs = CASES["bank_tie"]()
    assert _runtime_pick(Fs, SHARED)[1] == [2]
    _, routes = _runtime_pick(Fs, [[0.5, 0.5], [0.5, 0.5], [0.4, 0.6]])
    assert routes == [2, 1]
    _, routes = _runtime_pick(Fs, [[0.5, 0.5], [0.4, 0.6], [0.3, 0.7]])
    assert routes == [1, 1, 1]


def test_zero_weight_pick_depends_on_the_prefilter(monkeypatch):
    Fs = CASES["zero_weight"]()
    monkeypatch.setattr(port_hmooc, "_WS_MIN_SCORES", 0)
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 1 << 30)
    assert _runtime_pick(Fs, [1.0, 0.0])[0][0] == 0
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 0)
    assert _runtime_pick(Fs, [1.0, 0.0])[0][0] == 1


@pytest.mark.parametrize("k", [1, 3, 8])
def test_runtime_pick_matches_reference_at_other_widths(k, routing):
    """k = 8 scores its float64 route in numpy's pairwise order."""
    rng = np.random.default_rng(10 + k)
    Fs = [rng.standard_normal((n, k)) * 10.0 ** rng.integers(-3, 4, (n, k))
          for n in (4, 33, 80)]
    w = rng.random((3, k))
    assert _runtime_pick(Fs, w)[0] == ref_rt.weighted_pick_batch(Fs, w)
    assert _runtime_pick(Fs, w[0])[0] == ref_rt.weighted_pick_batch(Fs, w[0])


@pytest.mark.parametrize("k", range(1, 9))
def test_float64_scores_sum_in_numpys_order(k):
    """The plain version's float64 sums equal numpy's ``.sum(-1)`` bit for
    bit: left to right below 8 terms, pairwise at 8."""
    rng = np.random.default_rng(30 + k)
    P = rng.standard_normal((64, 16, k)) * 10.0 ** rng.integers(-8, 8,
                                                                (64, 16, k))
    got = _numpy_sum(torch.from_numpy(P)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64),
                                  P.sum(-1).view(np.uint64))


def _bits(a):
    a = np.asarray(a, np.float64)
    return np.where(np.isnan(a), 0, a).view(np.uint64), np.isnan(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_normalisation_is_bit_equal_to_the_host(case, monkeypatch):
    """kept_normalised (the plain version of the kernel's first phase)
    keeps the host's rows and normalises them to the same float64 bits as
    ``runtime.py``'s ``(F[keep] - lo) / span``."""
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 0)
    Fs = [np.asarray(F, np.float64) for F in CASES[case]()]
    kept = port_rt._prefilter(Fs, CPU)
    for F, keep in zip(Fs, kept):
        got_keep, got = kept_normalised(torch.from_numpy(F), 0)
        assert got_keep == keep.tolist()
        lo, hi = F.min(0), F.max(0)
        span = np.where(hi > lo, hi - lo, 1.0)
        with np.errstate(invalid="ignore"):
            want = (F[keep] - lo) / span
        for x, y in zip(_bits(got.numpy()), _bits(want)):
            np.testing.assert_array_equal(x, y)


def _dominance_cases():
    """Sets for the float64-dominance claim, each tagged with whether the
    float32 tie check routes it to numpy: non-finite rows, values beyond
    float32's range (alone: the kernel route; two that round to one inf:
    the float64 route) and a planted tie."""
    rng = np.random.default_rng(20)
    out = []
    for n, k in ((40, 2), (300, 2), (60, 3)):
        F = (rng.random((n, k)) * 10).astype(np.float32).astype(np.float64)
        F[::7, 0] = np.nan
        F[3::11, k - 1] = np.inf
        F[5] = -np.inf
        out.append(F)
        G = F.copy()
        G[8, 0], G[9, 1] = 1e39, -1e39        # beyond range, no tie
        out.append(G)
        H = G.copy()
        H[10, 0] = 2e39                       # 1e39 and 2e39 both round to inf
        out.append(H)
        T = F.copy()
        T[12, 1] = T[13, 1] + 1e-12
        out.append(T)
    return out


def test_float64_dominance_equals_both_mask_routes(monkeypatch):
    """The kernel prefilters in float64; the host's prefilter is the
    float32 kernel's mask unless the tie check routes it to float64 numpy.
    On every case both routes give the float64 mask, and both routes are
    taken."""
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 0)
    Fs = _dominance_cases()
    hazards = [port_pareto._f32_tie_hazard(F) for F in Fs]
    assert any(hazards) and not all(hazards)
    for F in Fs:
        with np.errstate(over="ignore"):    # 1e39 cast to float32: inf
            mask = port_pareto.pareto_masks_fast([F], device=CPU)[0]
        want = _dominance_mask(torch.from_numpy(F)).numpy()
        np.testing.assert_array_equal(mask, want)
        np.testing.assert_array_equal(port_pareto.pareto_mask_np(F), want)
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(ref_pareto.pareto_mask_fast(F),
                                          want)


def test_runtime_pick_checks_its_inputs():
    F = torch.rand(6, 2, dtype=torch.float64)
    off = torch.tensor([0, 2, 6], dtype=torch.int32)
    gid = torch.zeros(2, dtype=torch.int32)
    W = torch.ones(1, 2, dtype=torch.float64)
    kw = dict(kernel_min_n=0, ws_min_scores=0)
    assert ws_ops.runtime_pick(F, off, gid, W, **kw).shape == (3,)
    with pytest.raises(ValueError, match="float64"):
        ws_ops.runtime_pick(F.float(), off, gid, W, **kw)
    with pytest.raises(ValueError, match="k <= 8"):
        ws_ops.runtime_pick(torch.zeros(6, 9, dtype=torch.float64), off, gid,
                            torch.ones(1, 9, dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="int32"):
        ws_ops.runtime_pick(F, off.long(), gid, W, **kw)
    with pytest.raises(ValueError, match="W must be"):
        ws_ops.runtime_pick(F, off, gid, W[:, :1], **kw)
    with pytest.raises(ValueError, match="nonempty"):
        ws_ops.runtime_pick(F, torch.tensor([0, 6, 6], dtype=torch.int32),
                            gid, W, **kw)
    with pytest.raises(ValueError, match="nonempty"):
        port_rt._stage_round([np.zeros((0, 2)), np.ones((3, 2))], SHARED,
                             CPU)
