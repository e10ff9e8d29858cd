"""Port parity: the audio family (whisper-base's encoder–decoder, its
cross-attention, serving, training step and parameter tree).

The smoke whisper-base (2 encoder and 2 decoder layers, d_model 64, two
heads of 32, 16 frames) runs through the reference (``repro.archs``) and
the port (``repro_torch.archs``) on the same weights: the reference's
``init`` draws them, the norms are perturbed with numpy so every
parameter matters (``test_torch_lm._pair``), frames and tokens are made
with numpy from a seed, and ``params_from_reference`` carries them over.

Tolerances, float32 on the host: the encoder output, the scoring logits
and the loss within rtol 1e-5 (atol 1e-5 for values near 0: XLA and
PyTorch sum the products in other orders), with the flash route off and
on (the reference runs its Pallas kernel in interpret mode, the port the
kernel's plain version); prefill and decode logits within
``test_torch_lm.TOL`` and greedy tokens exactly equal; one train step's
loss and gradient norm within rtol 1e-5; parameter trees bit for bit.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.archs import blocks as ref_blocks
from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_config as ref_config
from repro.archs.registry import get_smoke_config as ref_smoke
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro.train.serve import make_serve_fns as ref_serve_fns
from repro_torch.archs import blocks as port_blocks
from repro_torch.archs.encdec import EncDec
from repro_torch.archs.lm import (params_from_reference, params_to_reference,
                                  reference_key)
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

ARCH = "whisper-base"
CLOSE = dict(rtol=1e-5, atol=1e-5)


def _frames(cfg, B, seed=2):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
def test_encode_forward_and_loss_match_reference(use_flash):
    """The encoder output (the reference's forward returns it in its
    cache), the teacher-forced scoring logits and the loss.  On the host
    the flash route runs the kernel's plain version and counts no
    launch."""
    api, params, model = _pair(ARCH, dtype="float32", use_flash=use_flash)
    cfg = api.cfg
    toks, frames = _tokens(cfg.vocab, (2, 12)), _frames(cfg, 2)
    want, wcache = api.forward(params, jnp.asarray(toks),
                               patches=jnp.asarray(frames))
    before = flash_ops.LAUNCHES
    enc = model.encode(frames)
    got, cache = model(toks, patches=frames)
    assert flash_ops.LAUNCHES == before
    np.testing.assert_allclose(enc.numpy(), np.asarray(wcache["enc_out"]),
                               **CLOSE)
    np.testing.assert_allclose(cache["enc_out"].numpy(), enc.numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    assert [c["len"] for c in cache["dec"]] == [12] * cfg.n_layers
    last, _ = model(toks, patches=frames, last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:], **CLOSE)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels, "patches": frames}
    want_loss = float(api.loss(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()}))
    assert abs(float(model.loss(batch)) - want_loss) <= 1e-5 * abs(want_loss)


def test_flash_route_runs_on_encoder_and_decoder(monkeypatch):
    """With ``use_flash`` the cacheless forward attends through
    ``flash_attention`` once an encoder layer (non-causal, Sq = Skv =
    enc_seq) and once a decoder layer (causal); prefill with frames only
    in the encoder; decode steps never."""
    calls = []

    def counted(q, k, v, causal=True):
        calls.append((causal, q.shape[2], k.shape[2]))
        return flash_ops.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(port_blocks, "flash_attention", counted)
    cfg = get_smoke_config(ARCH, dtype="float32", use_flash=True)
    model = build_model(cfg, "cpu")
    toks, frames = _tokens(cfg.vocab, (2, 10)), _frames(cfg, 2)
    model(toks, patches=frames)
    assert calls == [(False, 16, 16)] * 2 + [(True, 10, 10)] * 2
    calls.clear()
    sf = make_serve_fns(model)
    _, cache = sf.prefill(toks[:, :8], model.init_cache(2, 10), frames)
    assert calls == [(False, 16, 16)] * 2
    sf.decode(torch.from_numpy(toks[:, 8:9]), cache, torch.full((2, 1), 8))
    assert calls == [(False, 16, 16)] * 2


def test_prefill_with_frames_and_greedy_decode_match_reference(
        auto_host_mesh):
    """Prefill of 6 tokens with the frames into a cache of 14, then 8
    greedy decode steps that read the encoder output from the cache:
    logits within TOL, tokens equal, the cache's lengths and encoder
    output the reference's."""
    B, S, gen = 2, 6, 8
    api, params, model = _pair(ARCH, dtype="float32", use_flash=True)
    cfg = api.cfg
    toks, frames = _tokens(cfg.vocab, (B, S)), _frames(cfg, B)
    rsf = ref_serve_fns(api, auto_host_mesh, batch=B, max_len=S + gen)
    psf = make_serve_fns(model)
    rl, rcache = rsf.prefill(params, jnp.asarray(toks),
                             api.init_cache(B, S + gen), jnp.asarray(frames))
    pl, pcache = psf.prefill(toks, model.init_cache(B, S + gen), frames)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    np.testing.assert_allclose(pcache["enc_out"].numpy(),
                               np.asarray(rcache["enc_out"]), **TOL)
    rn, pn = jnp.argmax(rl[:, -1], -1), torch.argmax(pl[:, -1], -1)
    for t in range(gen):
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        rl, rcache = rsf.decode(params, rn[:, None], rcache,
                                jnp.full((B, 1), S + t, jnp.int32))
        pl, pcache = psf.decode(pn[:, None], pcache, torch.full((B, 1), S + t))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        rn, pn = jnp.argmax(rl[:, -1], -1), torch.argmax(pl[:, -1], -1)
    assert [c["len"] for c in pcache["dec"]] == [S + gen] * cfg.n_layers
    np.testing.assert_array_equal(np.asarray(rcache["dec"]["len"]),
                                  [S + gen] * cfg.n_layers)


def test_prefill_then_decode_equal_one_forward():
    """Inside the port: prefill and decode steps on the prompt's own next
    tokens give the logits of one forward over all of them."""
    cfg = get_smoke_config(ARCH, dtype="float32")
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    toks, frames = _tokens(cfg.vocab, (2, 12), seed=5), _frames(cfg, 2, 6)
    full, _ = model(toks, patches=frames)
    sf = make_serve_fns(model)
    logits, cache = sf.prefill(toks[:, :8], model.init_cache(2, 12), frames)
    rows = [logits[:, -1]]
    for t in range(8, 11):
        logits, cache = sf.decode(torch.from_numpy(toks[:, t:t + 1]), cache,
                                  torch.full((2, 1), t))
        rows.append(logits[:, -1])
    np.testing.assert_allclose(torch.stack(rows, 1).numpy(),
                               full[:, 7:11].numpy(), **CLOSE)


def test_decode_without_frames_or_encoder_output_raises():
    cfg = get_smoke_config(ARCH, dtype="float32")
    model = build_model(cfg, "cpu")
    toks = _tokens(cfg.vocab, (1, 1))
    with pytest.raises(ValueError, match="prefilled cache"):
        model(toks)
    cache = model.init_cache(1, 4)
    del cache["enc_out"]
    with pytest.raises(ValueError, match="prefilled cache"):
        model(toks, caches=cache, positions=torch.zeros((1, 1)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_apply_attention_xattn_kv_matches_reference(use_flash):
    """``apply_attention(xattn_kv=(k, v))``: queries from x (RoPE on
    them), precomputed K/V attended without a mask, the cache returned as
    it came."""
    rcfg = ref_smoke("glm4-9b").with_(dtype="float32", use_flash=use_flash)
    pcfg = get_smoke_config("glm4-9b", dtype="float32", use_flash=use_flash)
    p = jax.tree.map(np.asarray,
                     ref_blocks.init_attention(jax.random.PRNGKey(3), rcfg))
    rng = np.random.default_rng(7)
    B, S, Se = 2, 5, 19
    x = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(B, rcfg.n_kv, Se, rcfg.head_dim))
            .astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S) + 3, (B, S))
    marker = {"len": 11}
    want, wc = ref_blocks.apply_attention(
        rcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos),
        cache=marker, xattn_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, gc = port_blocks.apply_attention(
        pcfg, {n: torch.from_numpy(np.array(a)) for n, a in p.items()},
        torch.from_numpy(x), torch.from_numpy(pos.copy()), cache=marker,
        xattn_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    assert gc is marker and wc is marker
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


def test_encdec_train_step_matches_reference(auto_host_mesh):
    """One ``make_train_step`` step on a batch with frames: loss and
    gradient norm within rtol 1e-5, the learning rate equal, and the
    encoder's and the cross-attention's weights trained."""
    api, params, model = _pair(ARCH, dtype="float32")
    fns = _ref_step_fns(api, auto_host_mesh, 1)
    o = ref_opt_init(params, RefOptConfig(**OPT))
    batch = make_batch(model.cfg, global_batch=4, seq_len=16, step=0)
    assert batch["patches"].shape == (4, 16, 64)
    _, _, want = fns.step(params, o,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, OptConfig(**OPT))
    params_t, _, got = step.step(*step.init(), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_RTOL * abs(float(want[k])), k
    assert float(got["lr"]) == float(want["lr"])
    for n in ("enc_layers.0.attn.wq", "dec_layers.1.xattn.wk", "norm_enc"):
        assert not torch.equal(params_t[n], before[n]), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_params_round_trip(dtype):
    """The reference's tree → the port's state dict → the tree, bit for
    bit; ``dec_layers/xattn/wk`` is (L, d, H·Dh) and becomes
    ``dec_layers.<i>.xattn.wk``."""
    tree = jax.tree.map(np.asarray, ref_build(ref_smoke(ARCH).with_(
        dtype=dtype)).init(jax.random.PRNGKey(0)))
    assert tree["dec_layers"]["xattn"]["wk"].shape == (2, 64, 64)
    sd = params_from_reference(tree)
    np.testing.assert_array_equal(
        sd["dec_layers.1.xattn.wk"].float().numpy(),
        tree["dec_layers"]["xattn"]["wk"][1].astype(np.float32))
    assert sd["enc_layers.0.attn.wq"].dtype == getattr(torch, dtype)
    model = build_model(get_smoke_config(ARCH, dtype=dtype), "cpu")
    assert isinstance(model, EncDec)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    _assert_trees_bit_equal(params_to_reference(model.state_dict()), tree)
    if dtype == "bfloat16":
        assert tree["lm_head"].dtype == ml_dtypes.bfloat16


def test_reference_key_of_encdec_leaves():
    assert reference_key("enc_layers.1.mlp.w_up") == (
        ("enc_layers", "mlp", "w_up"), (1,))
    assert reference_key("dec_layers.0.xattn.wo") == (
        ("dec_layers", "xattn", "wo"), (0,))
    assert reference_key("norm_enc") == (("norm_enc",), ())


def test_encdec_config_matches_reference():
    """The configuration field for field, full and smoke; the full model
    is whisper-base's shape."""
    assert get_config(ARCH).__dict__ == ref_config(ARCH).__dict__
    assert get_smoke_config(ARCH).__dict__ == ref_smoke(ARCH).__dict__
    cfg = get_config(ARCH)
    assert (cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.enc_seq) == (
        6, 6, 512, 8, 64, 2048, 51865, 1500)


def test_full_size_model_builds_on_host():
    """whisper-base at full width and depth: 6 + 6 layers, 0.11 B
    bfloat16 parameters."""
    model = build_model(get_config(ARCH), "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == 109_749_248
    assert len(model.enc_layers) == len(model.dec_layers) == 6
    assert model.dec_layers[5].xattn["wv"].dtype == torch.bfloat16


def test_launch_serve_whisper_on_host(capsys):
    gen = port_serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len",
                           "8", "--gen", "4"], device="cpu")
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < 512)).all()
    assert f"{ARCH}: prefill(2×8)" in capsys.readouterr().out
