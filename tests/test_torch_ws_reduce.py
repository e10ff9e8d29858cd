"""Port parity: the ws_reduce kernel package and HMOOC2's weighted pick.

The port's plain version (``ref.py``, which the wrapper runs on a CPU
tensor) is held to the reference Pallas kernel, run in interpret mode on
the host as ``tests/test_kernels.py`` runs it, and to the reference's jnp
oracle on the same ``nan_to_num`` input.  Indices must be exactly equal
(ties resolve to the lowest index on every side); values within rtol 1e-5,
because XLA may sum the k products in another order or fuse them.  The CUDA
kernel itself is held to the plain version in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.moo import hmooc as ref_hmooc
from repro.kernels.ws_reduce.kernel import ws_reduce_pallas
from repro.kernels.ws_reduce.ops import ws_reduce as jax_ws_reduce
from repro.kernels.ws_reduce.ref import ws_reduce_ref as jnp_ws_reduce_ref
from repro_torch.core.moo import hmooc as port_hmooc
from repro_torch.kernels.ws_reduce import ops as port_ops

RTOL = 1e-5


def _case(m, B, k, nw, seed):
    rng = np.random.default_rng(seed)
    F = rng.random((m, B, k)).astype(np.float32)
    F[:, -2:] = np.inf                       # padded bank slots
    W = rng.random((nw, k)).astype(np.float32)
    return F, W


def _tie_case():
    """Exact f32 score ties at the minimum: a duplicated best row, and two
    distinct rows with equal sums under W = (1, 1)."""
    F = np.full((3, 6, 2), 2.0, np.float32)
    F[0, 2] = F[0, 5] = (0.0, 0.0)           # duplicate best row
    F[1, 1] = (0.25, 0.5)                    # 0.75 under (1, 1)
    F[1, 4] = (0.5, 0.25)                    # 0.75 under (1, 1)
    F[2] = np.inf                            # a bank of padding alone
    W = np.array([[1.0, 1.0], [0.5, 0.5], [0.0, 0.0]], np.float32)
    return F, W


def _check(F, W):
    before = port_ops.LAUNCHES
    v, i = port_ops.ws_reduce(torch.from_numpy(F), torch.from_numpy(W))
    assert port_ops.LAUNCHES == before       # the host launches nothing
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(v.shape) == tuple(i.shape) == (W.shape[0], F.shape[0])
    vp, ip = ws_reduce_pallas(jnp.asarray(F), jnp.asarray(W), interpret=True)
    vr, ir = jnp_ws_reduce_ref(jnp.nan_to_num(jnp.asarray(F), posinf=1e30),
                               jnp.asarray(W))
    for want_v, want_i in ((vp, ip), (vr, ir)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=RTOL)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("m,B,k,nw", [(1, 8, 2, 3), (4, 130, 2, 11),
                                      (3, 48, 3, 33), (2, 256, 4, 128),
                                      (32, 66, 2, 1), (64, 48, 2, 11)])
def test_plain_version_matches_reference(m, B, k, nw):
    _check(*_case(m, B, k, nw, seed=m * 100 + B))


def test_ties_and_padding_resolve_like_the_reference():
    _, idx = _check(*_tie_case())
    assert idx[0, 0] == 2 and idx[1, 0] == 2     # first of the duplicates
    assert idx[0, 1] == 1 and idx[1, 1] == 1     # first of the equal sums
    assert (idx[:, 2] == 0).all()                # all padding → index 0
    assert (idx[2] == 0).all()                   # zero weights: all tie


def _sanitise_case():
    """float64 banks with every value ``nan_to_num(F.to(float32),
    posinf=1e30)`` rewrites: NaN (→ 0), ±inf (→ 1e30, −FLT_MAX), values
    beyond the float32 range (1e300 → 1e30, −1e300 → −FLT_MAX), and a bank
    of padding alone (all +inf → index 0)."""
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


def test_float64_banks_sanitise_like_the_reference():
    """The wrapper's cast and nan_to_num (inside the kernel on the card, in
    the wrapper on the host) against the reference's public wrapper, whose
    Pallas kernel runs in interpret mode: indices exact, values within
    RTOL."""
    F, W = _sanitise_case()
    before = port_ops.LAUNCHES
    v, i = port_ops.ws_reduce(torch.from_numpy(F), torch.from_numpy(W))
    assert port_ops.LAUNCHES == before
    with np.errstate(over="ignore"):       # JAX casts to float32: ±1e300 → ±inf
        vj, ij = jax_ws_reduce(jnp.asarray(F), jnp.asarray(W),
                               interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=RTOL)
    assert (i[:, 1] == 2).all() and (i[:, 2] == 1).all()   # −inf, −1e300
    assert (i[:, 3] == 0).all()                            # padding alone
    assert np.isfinite(v.numpy()[:, :3]).all()


def test_wrapper_checks_its_inputs():
    F = torch.zeros(2, 4, 2)
    with pytest.raises(ValueError):
        port_ops.ws_reduce(torch.zeros(2, 4, 9), torch.zeros(1, 9))
    with pytest.raises(ValueError):
        port_ops.ws_reduce(F, torch.zeros(1, 3))
    with pytest.raises(ValueError):
        port_ops.ws_reduce(torch.zeros(2, 0, 2), torch.zeros(1, 2))
    with pytest.raises(TypeError):
        port_ops.ws_reduce(F.to(torch.int32), torch.zeros(1, 2))


@pytest.fixture
def restore_ws_threshold():
    saved = ref_hmooc._WS_MIN_SCORES, port_hmooc._WS_MIN_SCORES
    yield
    ref_hmooc._WS_MIN_SCORES, port_hmooc._WS_MIN_SCORES = saved


@pytest.mark.parametrize("forced", [False, True])
def test_ws_pick_matches_reference(forced, restore_ws_threshold):
    """HMOOC2's weighted pick: the kernel route (the plain version on the
    host) and the float64 einsum agree with the reference's on
    float32-representable, tie-free scores."""
    rng = np.random.default_rng(4)
    Fn = rng.random((5, 3, 16, 2)).astype(np.float32).astype(np.float64)
    W = ref_hmooc._ws_weights(11)
    ref_hmooc._WS_MIN_SCORES = 1 << 60
    want = ref_hmooc._ws_pick(Fn, W)
    port_hmooc._WS_MIN_SCORES = 0 if forced else 1 << 60
    got = port_hmooc._ws_pick(Fn, W, torch.device("cpu"))
    np.testing.assert_array_equal(got, want)
    if forced:                # the reference's own kernel route agrees too
        ref_hmooc._WS_MIN_SCORES = 0
        np.testing.assert_array_equal(got, ref_hmooc._ws_pick(Fn, W))


def test_ws_threshold_resolves_per_call(monkeypatch):
    monkeypatch.setattr(port_hmooc, "_WS_MIN_SCORES", None)
    monkeypatch.delenv("REPRO_WS_KERNEL_MIN_SCORES", raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert port_hmooc._ws_min_scores(cuda) == 0
    assert port_hmooc._ws_min_scores(cpu) == 1 << 60
    monkeypatch.setenv("REPRO_WS_KERNEL_MIN_SCORES", "123")
    assert port_hmooc._ws_min_scores(cpu) == 123
