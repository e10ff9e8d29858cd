"""Port parity: the dense language models (prompt scoring and generation).

The four dense smoke configurations (GQA groups 4 and 2, MHA with tied
embeddings, QKV bias) run through the reference (``repro.archs``) and the
port (``repro_torch.archs``) on the same weights: the reference's
``init`` draws them, the norms and QKV biases are perturbed with numpy so
every parameter matters, and ``params_from_reference`` carries them over.

Tolerances, float32 on the host: forward logits within rtol = atol = 1e-4
(the same algorithm; XLA and PyTorch sum the products in other orders and
fuse differently), the loss within 1e-5, and greedy tokens exactly equal.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.archs import blocks as ref_blocks
from repro.archs.act_sharding import (get_activation_mesh, get_pure_dp,
                                      set_activation_mesh)
from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_smoke_config as ref_smoke
from repro.train.serve import make_serve_fns as ref_serve_fns
from repro_torch.archs import blocks as port_blocks
from repro_torch.archs.lm import params_from_reference
from repro_torch.archs.registry import (build_model, get_config,
                                        get_smoke_config)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as port_launch
from repro_torch.train.serve import make_serve_fns

DENSE = ["glm4-9b", "minicpm-2b", "deepseek-coder-33b", "qwen2-72b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _ref_params(cfg, seed=0):
    """Reference weights as numpy, norms and biases perturbed."""
    tree = jax.tree.map(np.asarray,
                        ref_build(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.startswith(("ln_", "norm_")) or k in ("bq", "bk", "bv"):
                base = 1.0 if k.startswith(("ln_", "norm_")) else 0.0
                node[k] = (base + 0.1 * rng.normal(size=v.shape)).astype(
                    v.dtype)
    perturb(tree)
    return tree


def _pair(arch, seed=0, **over):
    """(reference api, its params as jnp, port model) on one set of
    weights."""
    rcfg = ref_smoke(arch).with_(**over)
    tree = _ref_params(rcfg, seed)
    model = build_model(get_smoke_config(arch, **over), "cpu")
    model.load_state_dict(params_from_reference(tree))
    return ref_build(rcfg), jax.tree.map(jnp.asarray, tree), model


def _tokens(cfg_vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg_vocab, shape)


def check_forward_and_loss(arch):
    """Cacheless forward with the flash route on and off, and the loss."""
    for flash in (False, True):
        api, params, model = _pair(arch, dtype="float32", use_flash=flash)
        toks = _tokens(api.cfg.vocab, (2, 24))
        want, _ = api.forward(params, jnp.asarray(toks))
        before = flash_ops.LAUNCHES
        got, caches = model(toks)
        assert flash_ops.LAUNCHES == before        # host: plain version
        assert len(caches) == api.cfg.n_layers and caches[0]["len"] == 24
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        last, _ = model(toks, last_only=True)
        np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:],
                                   rtol=1e-5, atol=1e-5)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1                            # masked positions
    batch = {"tokens": toks, "labels": labels}
    want = float(api.loss(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    assert abs(float(model.loss(batch)) - want) <= 1e-5


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_reference(arch):
    check_forward_and_loss(arch)


def bf16_position_diffs(arch):
    """(the reference's bfloat16 logits minus its float32 logits, the
    port's bfloat16 logits minus the reference's), each the largest
    difference over the vocabulary at each (request, position)."""
    api, params, model = _pair(arch)                   # bfloat16 default
    api32 = ref_build(ref_smoke(arch).with_(dtype="float32"))
    toks = _tokens(api.cfg.vocab, (2, 24))
    want = np.asarray(api.forward(params, jnp.asarray(toks))[0], np.float32)
    want32 = np.asarray(api32.forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), params),
        jnp.asarray(toks))[0])
    got, _ = model(toks)
    assert got.dtype == torch.bfloat16
    return (np.abs(want - want32).max(-1),
            np.abs(got.float().numpy() - want).max(-1))


def test_bf16_forward_within_reference_rounding():
    """bfloat16: XLA and PyTorch round at other places (fusions, the order
    of the casts around each product), so the two cannot agree bit for
    bit.  The port must stay as close to the reference's bfloat16 logits
    as the reference's own bfloat16 forward is to its float32 forward on
    the same weights (about 1-2 ulp of bfloat16 at these magnitudes)."""
    own, diff = bf16_position_diffs("glm4-9b")
    assert 0 < own.max() < 0.5
    assert diff.max() <= own.max()


@pytest.fixture
def auto_host_mesh():
    """The reference's serving functions under a one-device host mesh.

    ``make_host_mesh()`` builds its mesh with ``jax.make_mesh``'s default
    axis types, which on this JAX are Explicit, and the reference's
    activation constraints then fail to lower; an Auto mesh of the same
    shape and names is what the reference was written for.  The
    activation mesh it registers is restored afterwards.
    """
    saved = get_activation_mesh(), get_pure_dp()
    yield jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
    set_activation_mesh(*saved)


def check_prefill_and_greedy_decode(arch, mesh):
    """Prefill into a cache, then 8 greedy decode steps: tokens equal."""
    B, S, gen = 2, 12, 8
    api, params, model = _pair(arch, dtype="float32", use_flash=True)
    toks = _tokens(api.cfg.vocab, (B, S))
    rsf = ref_serve_fns(api, mesh, batch=B, max_len=S + gen)
    psf = make_serve_fns(model)
    rcache = api.init_cache(B, S + gen)
    pcache = model.init_cache(B, S + gen)
    rl, rcache = rsf.prefill(params, jnp.asarray(toks), rcache, None)
    before = flash_ops.LAUNCHES
    pl, pcache = psf.prefill(toks, pcache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    rn = jnp.argmax(rl[:, -1], -1)
    pn = torch.argmax(pl[:, -1], -1)
    for t in range(gen):
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        rl, rcache = rsf.decode(params, rn[:, None], rcache,
                                jnp.full((B, 1), S + t, jnp.int32))
        pl, pcache = psf.decode(pn[:, None], pcache,
                                torch.full((B, 1), S + t))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        rn = jnp.argmax(rl[:, -1], -1)
        pn = torch.argmax(pl[:, -1], -1)
    assert all(c["len"] == S + gen for c in pcache)
    assert flash_ops.LAUNCHES == before            # generation: no kernel
    assert not pl.requires_grad


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_greedy_decode_match_reference(arch, auto_host_mesh):
    check_prefill_and_greedy_decode(arch, auto_host_mesh)


def test_cache_overflow_raises():
    """``dynamic_update_slice`` would clamp the write; the port refuses."""
    model = build_model(get_smoke_config("glm4-9b", dtype="float32"), "cpu")
    sf = make_serve_fns(model)
    cache = model.init_cache(1, 6)
    _, cache = sf.prefill(_tokens(512, (1, 5)), cache)
    _, cache = sf.decode(torch.tensor([[3]]), cache, torch.tensor([[5]]))
    with pytest.raises(ValueError, match="overflow"):
        sf.decode(torch.tensor([[3]]), cache, torch.tensor([[6]]))


@pytest.mark.parametrize("kv_len,q_start,window", [(None, None, 0),
                                                   (200, 150, 0),
                                                   (None, None, 48)])
def test_attend_chunked_matches_reference(kv_len, q_start, window):
    """The chunked online-softmax route at small chunks (bq 64, bk 128)
    against the reference's, on ragged lengths; and against the port's
    own einsum route."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 4, 200, 32), (2, 2, 260, 32), (2, 2, 260, 32)))
    kw = dict(causal=True, window=window, kv_len=kv_len, q_start=q_start)
    want = ref_blocks._attend_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                      bq=64, bk=128, **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = port_blocks._attend_chunked(tq, tk, tv, bq=64, bk=128, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    einsum = port_blocks._attend(tq, tk, tv, use_flash=False, **kw)
    np.testing.assert_allclose(got.numpy(), einsum.numpy(), atol=1e-5,
                               rtol=0)


def test_sliding_window_forward_matches_reference():
    """``window`` > 0 keeps the einsum route even with ``use_flash``."""
    api, params, model = _pair("deepseek-coder-33b", dtype="float32",
                               use_flash=True, window=8)
    toks = _tokens(api.cfg.vocab, (2, 20))
    want, _ = api.forward(params, jnp.asarray(toks))
    got, _ = model(toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_reference_keeps_bfloat16_bits():
    a = np.random.default_rng(0).normal(size=(3, 4, 5)).astype(
        ml_dtypes.bfloat16)
    sd = params_from_reference({"embed": a[0], "norm_f": np.ones(4),
                                "layers": {"ln_attn": np.ones((3, 4)),
                                           "attn": {"wq": a}}})
    assert sd["embed"].dtype == torch.bfloat16
    for i in range(3):
        t = sd[f"layers.{i}.attn.wq"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                      a[i].view(np.uint16))
    assert sorted(k for k in sd if k.startswith("layers.0.")) == [
        "layers.0.attn.wq", "layers.0.ln_attn"]


def test_non_dense_families_raise():
    """Every family is ported: an unknown family raises ``ValueError``, and
    the audio and VLM families build (an encoder–decoder, a decoder-only
    LM)."""
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_smoke_config("glm4-9b", family="video"), "cpu")
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("whisper-large")
    audio = build_model(get_smoke_config("whisper-base"), "cpu")
    vlm = build_model(get_smoke_config("internvl2-76b"), "cpu")
    assert len(audio.enc_layers) == len(audio.dec_layers) == 2
    assert len(vlm.layers) == 2 and not vlm.layers[0].moe


def test_full_width_config_matches_reference():
    """The configurations carry over field for field."""
    from repro.archs.registry import get_config as ref_config
    for arch in DENSE + ["dbrx-132b", "moonshot-v1-16b-a3b"]:
        assert get_config(arch).__dict__ == ref_config(arch).__dict__
        assert get_smoke_config(arch).__dict__ == ref_smoke(arch).__dict__
    glm = get_config("glm4-9b")
    assert (glm.n_layers, glm.d_model, glm.n_heads, glm.n_kv, glm.head_dim,
            glm.d_ff, glm.vocab) == (40, 4096, 32, 2, 128, 13696, 151552)
    assert glm.n_params_dense == 9_399_435_264      # norms not counted


def test_launch_serve_runs_on_host(capsys):
    gen = port_launch.main(["--arch", "minicpm-2b", "--batch", "2",
                            "--prompt-len", "8", "--gen", "4"],
                           device="cpu")
    assert gen.shape == (2, 4)
    assert ((0 <= gen) & (gen < 512)).all()
    assert "minicpm-2b: prefill(2×8)" in capsys.readouterr().out
