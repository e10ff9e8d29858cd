"""Port parity: the VLM family (internvl2-76b's patch prefix on the dense
LM, its serving, training step and parameter tree).

The smoke internvl2-76b (2 layers, d_model 128, 4/2 heads of 32, 8
patches) runs through the reference (``repro.archs``) and the port
(``repro_torch.archs``) on the same weights: the reference's ``init``
draws them, the norms are perturbed with numpy so every parameter matters
(``test_torch_lm._pair``), patches and tokens are made with numpy from a
seed, and ``params_from_reference`` carries them over.

Tolerances, float32 on the host: the scoring logits and the loss within
rtol 1e-5 (atol 1e-5 for values near 0: XLA and PyTorch sum the products
in other orders), with the flash route off and on (the reference runs
its Pallas kernel in interpret mode, the port the kernel's plain
version); prefill and decode logits within ``test_torch_lm.TOL`` and
greedy tokens exactly equal; one train step's loss and gradient norm
within rtol 1e-5; parameter trees bit for bit.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_config as ref_config
from repro.archs.registry import get_smoke_config as ref_smoke
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro.train.serve import make_serve_fns as ref_serve_fns
from repro_torch.archs import blocks as port_blocks
from repro_torch.archs.lm import LM, params_from_reference, \
    params_to_reference
from repro_torch.archs.registry import (build_model, get_config,
                                        get_smoke_config)
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as port_serve
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.serve import make_serve_fns
from repro_torch.train.train_loop import make_train_step

from test_torch_lm import TOL, _pair, _tokens, auto_host_mesh  # noqa: F401
from test_torch_train_checkpoint import _assert_trees_bit_equal
from test_torch_train_step import (LOSS_RTOL, OPT,  # noqa: F401
                                   _ref_step_fns, one_torch_thread)

ARCH = "internvl2-76b"
CLOSE = dict(rtol=1e-5, atol=1e-5)


def _patches(cfg, B, seed=2):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
def test_vlm_forward_and_loss_match_reference(use_flash):
    """The scoring logits (the token rows only) and the loss with the
    patches ahead of the tokens.  On the host the flash route runs the
    kernel's plain version and counts no launch."""
    api, params, model = _pair(ARCH, dtype="float32", use_flash=use_flash)
    cfg = api.cfg
    toks, patches = _tokens(cfg.vocab, (2, 12)), _patches(cfg, 2)
    want, _ = api.forward(params, jnp.asarray(toks),
                          patches=jnp.asarray(patches))
    before = flash_ops.LAUNCHES
    got, caches = model(toks, patches=patches)
    assert flash_ops.LAUNCHES == before
    assert got.shape == (2, 12, cfg.vocab)
    assert [c["len"] for c in caches] == [12 + cfg.n_patches] * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    last, _ = model(toks, patches=patches, last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:], **CLOSE)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels, "patches": patches}
    want_loss = float(api.loss(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()}))
    assert abs(float(model.loss(batch)) - want_loss) <= 1e-5 * abs(want_loss)


def test_vlm_without_patches_is_the_dense_model():
    """Without patches a VLM model is the dense LM on the same weights, as
    in the reference; the patches change every logit."""
    api, params, model = _pair(ARCH, dtype="float32")
    toks = _tokens(api.cfg.vocab, (2, 10))
    want, _ = api.forward(params, jnp.asarray(toks))
    got, _ = model(toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    dense = build_model(model.cfg.with_(family="dense"), "cpu")
    dense.load_state_dict(model.state_dict())
    np.testing.assert_array_equal(dense(toks)[0].numpy(), got.numpy())
    with_patches, _ = model(toks, patches=_patches(model.cfg, 2))
    assert (with_patches - got).abs().amin() > 0


def test_vlm_flash_route_covers_patches_and_tokens(monkeypatch):
    """With ``use_flash`` the cacheless forward attends through
    ``flash_attention`` once a layer, causal over patches + tokens; the
    cache path (prefill with the patches, decode) never."""
    calls = []

    def counted(q, k, v, causal=True):
        calls.append((causal, q.shape[2], k.shape[2]))
        return flash_ops.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(port_blocks, "flash_attention", counted)
    cfg = get_smoke_config(ARCH, dtype="float32", use_flash=True)
    model = build_model(cfg, "cpu")
    toks, patches = _tokens(cfg.vocab, (2, 10)), _patches(cfg, 2)
    model(toks, patches=patches)
    assert calls == [(True, 18, 18)] * 2
    sf = make_serve_fns(model)
    _, cache = sf.prefill(toks, model.init_cache(2, 20), patches)
    sf.decode(torch.from_numpy(toks[:, :1]), cache, torch.full((2, 1), 18))
    assert len(calls) == 2


def test_vlm_prefill_with_patches_and_greedy_decode_match_reference(
        auto_host_mesh):
    """Prefill of the patches and 6 tokens into a cache of 8 + 6 + 8
    slots, then 8 greedy decode steps from position 8 + 6: logits within
    TOL, tokens equal, the caches' lengths the reference's."""
    B, S, gen = 2, 6, 8
    api, params, model = _pair(ARCH, dtype="float32", use_flash=True)
    cfg = api.cfg
    P = cfg.n_patches
    toks, patches = _tokens(cfg.vocab, (B, S)), _patches(cfg, B)
    rsf = ref_serve_fns(api, auto_host_mesh, batch=B, max_len=P + S + gen)
    psf = make_serve_fns(model)
    rl, rcache = rsf.prefill(params, jnp.asarray(toks),
                             api.init_cache(B, P + S + gen),
                             jnp.asarray(patches))
    pl, pcache = psf.prefill(toks, model.init_cache(B, P + S + gen), patches)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    rn, pn = jnp.argmax(rl[:, -1], -1), torch.argmax(pl[:, -1], -1)
    for t in range(gen):
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        rl, rcache = rsf.decode(params, rn[:, None], rcache,
                                jnp.full((B, 1), P + S + t, jnp.int32))
        pl, pcache = psf.decode(pn[:, None], pcache,
                                torch.full((B, 1), P + S + t))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        rn, pn = jnp.argmax(rl[:, -1], -1), torch.argmax(pl[:, -1], -1)
    assert [c["len"] for c in pcache] == [P + S + gen] * cfg.n_layers
    np.testing.assert_array_equal(np.asarray(rcache["len"]),
                                  [P + S + gen] * cfg.n_layers)


def test_vlm_train_step_matches_reference(auto_host_mesh):
    """One ``make_train_step`` step on a batch with patches: loss and
    gradient norm within rtol 1e-5, the learning rate equal; with two
    microbatches the patches split with the tokens."""
    api, params, model = _pair(ARCH, dtype="float32")
    batch = make_batch(model.cfg, global_batch=4, seq_len=16, step=0)
    assert batch["patches"].shape == (4, 8, 128)
    o = ref_opt_init(params, RefOptConfig(**OPT))
    for accum in (1, 2):
        fns = _ref_step_fns(api, auto_host_mesh, accum)
        _, _, want = fns.step(params, o,
                              {k: jnp.asarray(v) for k, v in batch.items()})
        step = make_train_step(model, OptConfig(**OPT), accum=accum)
        _, _, got = step.step(*step.init(), batch)
        for k in ("loss", "grad_norm"):
            assert abs(float(got[k]) - float(want[k])) <= \
                LOSS_RTOL * abs(float(want[k])), (accum, k)
        model.load_state_dict(params_from_reference(
            jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_params_round_trip(dtype):
    """The reference's tree → the port's state dict → the tree, bit for
    bit (the dense family's layout)."""
    tree = jax.tree.map(np.asarray, ref_build(ref_smoke(ARCH).with_(
        dtype=dtype)).init(jax.random.PRNGKey(0)))
    sd = params_from_reference(tree)
    assert sd["layers.1.attn.wk"].dtype == getattr(torch, dtype)
    model = build_model(get_smoke_config(ARCH, dtype=dtype), "cpu")
    assert isinstance(model, LM)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    _assert_trees_bit_equal(params_to_reference(model.state_dict()), tree)
    if dtype == "bfloat16":
        assert tree["embed"].dtype == ml_dtypes.bfloat16


def test_vlm_config_matches_reference():
    """The configuration field for field, full and smoke."""
    assert get_config(ARCH).__dict__ == ref_config(ARCH).__dict__
    assert get_smoke_config(ARCH).__dict__ == ref_smoke(ARCH).__dict__
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.n_patches) == (
        80, 8192, 64, 8, 128, 28672, 128256, 256)


def test_launch_serve_internvl_on_host(capsys):
    """The CLI sizes the cache for the patches and decodes from position
    prompt + n_patches; its tokens are those of the same steps by hand."""
    gen = port_serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len",
                           "8", "--gen", "4"], device="cpu")
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < 512)).all()
    assert f"{ARCH}: prefill(2×8)" in capsys.readouterr().out
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    patches = rng.normal(0, 1, (2, 8, cfg.d_model)).astype(np.float32)
    sf = make_serve_fns(model)
    logits, cache = sf.prefill(toks, model.init_cache(2, 20), patches)
    out = [torch.argmax(logits[:, -1], -1)]
    for t in range(3):
        logits, cache = sf.decode(out[-1][:, None], cache,
                                  torch.full((2, 1), 16 + t))
        out.append(torch.argmax(logits[:, -1], -1))
    np.testing.assert_array_equal(gen, torch.stack(out, 1).numpy())
