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
