"""Port parity: the pareto_filter kernel package and the mask router.

The port's plain version (``ref.py``) is held to the reference Pallas
kernel, run in interpret mode on the host as ``tests/test_kernels.py``
runs it, and to the reference's jnp oracle.  All comparisons are exact:
both sides compare in float32, and the ``pareto_mask_fast`` cases use
float32-representable, tie-free inputs (or the tie-hazard straddle, which
must route to float64 numpy on both sides).  The CUDA kernel itself is
held to the plain version in ``test_torch_cuda.py``, which needs a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.moo import pareto as ref_pareto
from repro.kernels.pareto_filter import ops as ref_ops
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.kernels.pareto_filter import ops as port_ops


def _case(n, k, dtype, seed):
    """Tie-free f32-representable objectives, invalid rows and +inf rows."""
    rng = np.random.default_rng(seed)
    F = (rng.random((n, k)) * 10).astype(np.float32).astype(dtype)
    F[rng.random(n) < 0.1] = np.inf
    valid = rng.random(n) > 0.15
    return F, valid


@pytest.fixture
def restore_threshold():
    saved_ref, saved_port = ref_pareto._KERNEL_MIN_N, port_pareto._KERNEL_MIN_N
    yield
    ref_pareto._KERNEL_MIN_N = saved_ref
    port_pareto._KERNEL_MIN_N = saved_port


@pytest.mark.parametrize("n", [1, 7, 128, 129, 513])
@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_version_matches_reference_kernel(n, k, dtype):
    F, valid = _case(n, k, dtype, seed=n * 10 + k)
    want = np.asarray(ref_ops.pareto_filter(jnp.asarray(F),
                                            jnp.asarray(valid)))
    want_ref = np.asarray(ref_ops.pareto_mask_ref(jnp.asarray(F),
                                                  jnp.asarray(valid)))
    before = port_ops.LAUNCHES
    got = port_ops.pareto_filter(torch.from_numpy(F),
                                 torch.from_numpy(valid)).numpy()
    assert port_ops.LAUNCHES == before     # the host never launches
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_ref)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        port_ops.pareto_filter(torch.zeros(4, 9))
    with pytest.raises(TypeError):
        port_ops.pareto_filter(torch.zeros(4, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        port_ops.pareto_filter(torch.zeros(4, 2), torch.ones(3, dtype=bool))


@pytest.mark.parametrize("threshold", [None, 0])
def test_mask_fast_matches_reference(threshold, restore_threshold):
    """Default routing (f64 numpy) and forced kernel routing (plain f32
    version on the host, Pallas interpret in the reference) agree."""
    ref_pareto._KERNEL_MIN_N = threshold
    port_pareto._KERNEL_MIN_N = threshold
    for n, k in [(1, 2), (5, 3), (64, 2), (200, 3), (513, 4)]:
        F, valid = _case(n, k, np.float64, seed=n + k)
        for v in (None, valid):
            want = ref_pareto.pareto_mask_fast(F, v)
            got = port_pareto.pareto_mask_fast(F, v, device="cpu")
            np.testing.assert_array_equal(got, want)


def test_mask_fast_tie_straddle_takes_f64(restore_threshold):
    ref_pareto._KERNEL_MIN_N = 0
    port_pareto._KERNEL_MIN_N = 0
    F = np.array([[1.0, 2.0], [1.0 + 1e-12, 2.0], [0.5, 3.0]])
    got = port_pareto.pareto_mask_fast(F, device="cpu")
    np.testing.assert_array_equal(got, [True, False, True])
    np.testing.assert_array_equal(got, ref_pareto.pareto_mask_fast(F))
    rng = np.random.default_rng(7)
    G = (rng.random((600, 2)) * 8 + 4).astype(np.float32).astype(np.float64)
    G[17] = (2.0, 2.0)
    G[401] = (2.0 + 4e-13, 2.0)
    got = port_pareto.pareto_mask_fast(G, device="cpu")
    np.testing.assert_array_equal(got, ref_pareto.pareto_mask_fast(G))
    assert got[17] and not got[401]


def test_default_threshold_by_device(monkeypatch):
    monkeypatch.delenv("REPRO_PARETO_KERNEL_MIN_N", raising=False)
    assert port_pareto._default_kernel_min_n(torch.device("cuda")) == 0
    assert port_pareto._default_kernel_min_n(torch.device("cpu")) == 1 << 30
    monkeypatch.setenv("REPRO_PARETO_KERNEL_MIN_N", "77")
    assert port_pareto._default_kernel_min_n(torch.device("cuda")) == 77
    assert port_pareto._default_kernel_min_n(torch.device("cpu")) == 77


def test_mask_fast_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pareto.pareto_mask_fast(np.zeros((3, 2)))


def test_kernel_library_is_content_addressed(tmp_path):
    from repro_torch.kernels import _build
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    a = _build.library_path("k", [src])
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libk-")
    assert _build.library_path("k", [src]) == a
    src.write_text("// v2\n")
    assert _build.library_path("k", [src]) != a


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    if _build.shutil.which("nvcc"):
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// never compiled\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("k", [src])
    assert not (tmp_path / "build").exists()      # nothing left behind


# ---------------------------------------------------------------------------
# Segmented filter: S independent banks in one call
# ---------------------------------------------------------------------------

def _segments(S, n, k, seed):
    """(S, n, k) f32-representable objectives with invalid and +inf rows;
    segment 1 is ragged (its tail padded with invalid +inf rows) and the
    last segment is all invalid."""
    rng = np.random.default_rng(seed)
    F = (rng.random((S, n, k)) * 10).astype(np.float32)
    F[rng.random((S, n)) < 0.1] = np.inf
    valid = rng.random((S, n)) > 0.15
    if S > 2:
        F[1, n // 2:] = np.inf
        valid[1, n // 2:] = False
    valid[-1] = False
    return F, valid


@pytest.mark.parametrize("k", range(1, 9))
def test_segments_plain_version_matches_reference_kernel(k):
    """Each segment of the port's one-call answer equals the reference
    Pallas kernel (interpret mode) on that segment alone."""
    S, n = 4, 70 + 9 * k
    F, valid = _segments(S, n, k, seed=40 + k)
    before = port_ops.LAUNCHES
    got = port_ops.pareto_filter_segments(torch.from_numpy(F),
                                          torch.from_numpy(valid)).numpy()
    assert port_ops.LAUNCHES == before     # the host never launches
    assert got.shape == (S, n) and not got[-1].any()
    for s in range(S):
        want = np.asarray(ref_ops.pareto_filter(jnp.asarray(F[s]),
                                                jnp.asarray(valid[s])))
        np.testing.assert_array_equal(got[s], want)
    np.testing.assert_array_equal(
        got, port_ops.pareto_masks_ref(torch.from_numpy(F),
                                       torch.from_numpy(valid)).numpy())
    # Without ``valid``, the finite rows are the valid ones.
    got_default = port_ops.pareto_filter_segments(torch.from_numpy(F))
    for s in range(S):
        np.testing.assert_array_equal(
            got_default[s].numpy(),
            np.asarray(ref_ops.pareto_filter(jnp.asarray(F[s]))))


def test_segments_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        port_ops.pareto_filter_segments(torch.zeros(4, 2))
    with pytest.raises(ValueError):
        port_ops.pareto_filter_segments(torch.zeros(2, 4, 9))
    with pytest.raises(TypeError):
        port_ops.pareto_filter_segments(torch.zeros(2, 4, 2,
                                                    dtype=torch.int32))
    with pytest.raises(ValueError):
        port_ops.pareto_filter_segments(torch.zeros(2, 4, 2),
                                        torch.ones(2, 3, dtype=bool))


def _tie_hazard_by_unique(F):
    """The per-column definition: float64-distinct finite values that
    collide after the float32 cast."""
    for j in range(F.shape[1]):
        col = F[:, j]
        u = np.unique(col[np.isfinite(col)])
        with np.errstate(over="ignore"):
            if np.unique(u.astype(np.float32)).size < u.size:
                return True
    return False


def test_vectorised_tie_check_matches_definition():
    rng = np.random.default_rng(3)
    X = (rng.random((40, 50, 3)) * 8).astype(np.float32).astype(np.float64)
    X[rng.random((40, 50)) < 0.1] = np.inf
    X[5, 7] = np.nan
    for s in range(0, 40, 3):                # plant float32 collisions
        X[s, 11, s % 3] = X[s, 3, s % 3] + 1e-12
    X[9, 2, 0], X[9, 4, 0] = 1e300, 2e300    # distinct, both inf as float32
    X[12, 1, 1], X[12, 2, 1] = 0.0, -0.0     # equal in float64 too
    got = port_pareto._f32_tie_hazards(X)
    want = [_tie_hazard_by_unique(X[s]) for s in range(40)]
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    assert port_pareto._f32_tie_hazard(X[9]) and \
        not port_pareto._f32_tie_hazard(X[1])


def _banks(seed):
    """Ragged banks of one k: an empty bank, small and large ones, a bank
    with non-finite rows, and the float32 tie straddle."""
    rng = np.random.default_rng(seed)
    banks = [(rng.random((n, 2)) * 10).astype(np.float32).astype(np.float64)
             for n in (0, 1, 9, 66, 256, 300)]
    banks[3][[4, 9]] = np.inf
    banks[3][12, 0] = np.nan
    banks.insert(2, np.array([[1.0, 2.0], [1.0 + 1e-12, 2.0], [0.5, 3.0]]))
    return banks


@pytest.mark.parametrize("with_valid", [False, True])
def test_masks_fast_equals_per_bank_masks(with_valid, restore_threshold):
    """Forced kernel routing on the host: one call over the banks equals
    the port's per-bank ``pareto_mask_fast`` and the reference's (Pallas
    in interpret mode), and the tie straddle takes float64 while its
    neighbours take the kernel route."""
    ref_pareto._KERNEL_MIN_N = 0
    port_pareto._KERNEL_MIN_N = 0
    banks = _banks(seed=11)
    rng = np.random.default_rng(12)
    valid = ([rng.random(F.shape[0]) > 0.2 for F in banks] if with_valid
             else None)
    vs = valid or [None] * len(banks)
    got = port_pareto.pareto_masks_fast(banks, valid, device="cpu")
    assert len(got) == len(banks)
    for F, v, g in zip(banks, vs, got):
        np.testing.assert_array_equal(
            g, port_pareto.pareto_mask_fast(F, v, device="cpu"))
        np.testing.assert_array_equal(g, ref_pareto.pareto_mask_fast(F, v))
    if not with_valid:
        # float64 keeps the strictly dominated twin out; float32 would not.
        np.testing.assert_array_equal(got[2], [True, False, True])


def test_masks_fast_routes_per_bank(monkeypatch, restore_threshold):
    """Banks below the threshold and the tie straddles take float64 numpy;
    the rest go to the segmented wrapper together, in one call."""
    port_pareto._KERNEL_MIN_N = 10
    calls = []
    real = port_ops.pareto_filter_segments

    def spy(F, valid):
        calls.append(tuple(F.shape))
        return real(F, valid)

    monkeypatch.setattr(port_ops, "pareto_filter_segments", spy)
    monkeypatch.setattr("repro_torch.kernels.pareto_filter."
                        "pareto_filter_segments", spy)
    banks = _banks(seed=13)
    G = (np.random.default_rng(7).random((600, 2)) * 8 + 4).astype(
        np.float32).astype(np.float64)
    G[17], G[401] = (2.0, 2.0), (2.0 + 4e-13, 2.0)
    banks.append(G)                          # a straddle above the threshold
    got = port_pareto.pareto_masks_fast(banks, device="cpu")
    assert calls == [(3, 512, 2)]            # 66, 256, 300 rows; bucket 512
    assert got[-1][17] and not got[-1][401]
    for F, g in zip(banks, got):
        np.testing.assert_array_equal(g, port_pareto.pareto_mask_np(F))
    assert port_pareto.pareto_masks_fast([], device="cpu") == []
    with pytest.raises(ValueError, match="validity masks"):
        port_pareto.pareto_masks_fast(banks, [None], device="cpu")
