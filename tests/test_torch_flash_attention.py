"""Port parity: the flash-attention kernel package.

The port's wrapper on CPU tensors (which runs the plain version in
``ref.py``) is held to the reference Pallas kernel, run in interpret mode on
the host as ``tests/test_kernels.py`` runs it, and to the reference's jnp
oracle ``attention_ref``, on the same inputs made with numpy from a seed:
float32 within atol 2e-5 and bfloat16 within atol 3e-2, the tolerances of
the reference's own kernel tests (the Pallas kernel's online softmax sums in
another order; in bfloat16 the output is rounded to 8 bits of mantissa).
The CUDA kernel itself is held to the plain version in
``test_torch_cuda.py``.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import (
    attention_ref as jax_attention_ref, flash_attention as jax_flash)
from repro_torch.kernels.flash_attention import ops as port_ops

SHAPES = [(1, 4, 4, 128, 128, 64, True),
          (2, 8, 2, 256, 256, 64, True),      # GQA
          (1, 4, 1, 100, 100, 128, True),     # ragged + MQA
          (1, 4, 2, 1, 300, 64, False),       # decode
          (1, 8, 4, 96, 480, 64, True),       # continuation chunk
          (2, 2, 2, 64, 64, 128, False)]


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


def _port(q, k, v, causal):
    out = port_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal)
    return out.numpy()


@pytest.fixture
def float32_products():
    """The process-wide settings a float32 product reads, pinned for the
    test: full float32 products in PyTorch (oneDNN may otherwise take
    bfloat16 or TF32 for them) and one intra-op thread, and in JAX
    float32 products; restored afterwards.  A worker of the suite runs
    other files first, and these settings are the process's."""
    saved = (torch.get_num_threads(), torch.get_float32_matmul_precision(),
             torch.backends.mkldnn.matmul.fp32_precision)
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    torch.backends.mkldnn.matmul.fp32_precision = "ieee"
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_num_threads(saved[0])
    torch.set_float32_matmul_precision(saved[1])
    torch.backends.mkldnn.matmul.fp32_precision = saved[2]


def _diffs(got, pallas, oracle):
    """The three outputs' largest pairwise differences, so a failure says
    which side moved."""
    return (f"port-pallas {np.abs(got - pallas).max():.3g}, port-oracle "
            f"{np.abs(got - oracle).max():.3g}, pallas-oracle "
            f"{np.abs(pallas - oracle).max():.3g}")


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", SHAPES)
def test_flash_attention_f32_matches_reference(B, Hq, Hkv, Sq, Skv, D,
                                               causal, float32_products):
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv)
    before = port_ops.LAUNCHES
    got = _port(q, k, v, causal)
    assert port_ops.LAUNCHES == before          # the host launches nothing
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=causal))
    oracle = np.asarray(jax_attention_ref(jq, jk, jv, causal=causal))
    assert got.shape == (B, Hq, Sq, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=0,
                               err_msg=_diffs(got, pallas, oracle))
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=0,
                               err_msg=_diffs(got, pallas, oracle))


def test_flash_attention_bf16_matches_reference():
    q, k, v = _inputs(1, 4, 4, 128, 128, 128, seed=0,
                      dtype=ml_dtypes.bfloat16)
    tq, tk, tv = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                  for a in (q, k, v))
    got = port_ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (jax_flash(jq, jk, jv, causal=True),
                 jax_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=3e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [1, 24, 32, 64, 65, 128, 129, 256])
def test_body_choice(dtype, D):
    """The tensor-core body takes 16-bit inputs with D ≤ 128 (every model
    configuration); float32 and 16-bit D > 128 take the CUDA-core body."""
    want = ("wgmma" if dtype != torch.float32 and D <= 128 else "simt")
    assert port_ops._body(dtype, D) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_launches_no_body(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(1, 4, 2, 16, 16, 64, 0))
    before = port_ops.LAUNCHES, dict(port_ops.LAUNCHES_BY_BODY)
    port_ops.flash_attention(q, k, v, causal=True)
    assert (port_ops.LAUNCHES, port_ops.LAUNCHES_BY_BODY) == before


def test_flash_attention_causal_sq_above_skv_raises():
    """Rows that see no key have no answer both reference versions agree
    on, so the port refuses them on every device."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 4, 32, 0))
    with pytest.raises(ValueError, match="no key"):
        port_ops.flash_attention(q, k, v, causal=True)
    out = port_ops.flash_attention(q, k, v, causal=False)   # non-causal: fine
    assert out.shape == (1, 2, 8, 32)


@pytest.mark.parametrize("bad", ["heads", "dim", "dtype"])
def test_flash_attention_rejects_mismatched_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8, 8, 32, 0))
    if bad == "heads":
        k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
    elif bad == "dim":
        k, v = k[..., :16], v[..., :16]
    else:
        k = k.double()
    with pytest.raises((ValueError, TypeError)):
        port_ops.flash_attention(q, k, v)


def test_flash_attention_no_card_raises():
    """A CUDA tensor cannot be made here; the LM entry points route by
    device and raise without a card instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.archs.registry import build_model, get_smoke_config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("glm4-9b"))
