"""Port parity: the hybrid family (the Mamba block, jamba-1.5-large-398b's
groups of one attention and seven Mamba layers, their serving, training
step and parameter tree).

The smoke jamba (8 layers in 2 groups of 4: attention with the dense MLP,
then Mamba layers with the MoE MLP at positions 1 and 3 and the dense MLP
at 2; d_model 128, d_state 16, 4 experts top-2) runs through the
reference and the port on the same weights, constants perturbed as in
``test_torch_ssm``.

Tolerances, float32 on the host:

* ``_selective_scan_chunk`` and ``apply_mamba`` (chunked and one-scan
  routes, from zeros or a given state), new state included, within
  rtol = atol = 1e-5: the port's log-depth scan multiplies in another
  tree than ``jax.lax.associative_scan``;
* the LM as ``test_torch_ssm`` holds the SSM family (forward and caches
  1e-4, loss 1e-5, a train step's loss and gradient norm rtol 1e-5);
* parameter trees round-trip bit for bit, bfloat16 included, with the
  Mamba leaves stacked twice, (G, n, ...).
"""
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
from repro_torch.archs import blocks as port_blocks
from repro_torch.archs.lm import (moe_positions, params_from_reference,
                                  params_to_reference, reference_key)
from repro_torch.archs.registry import (build_model, get_config,
                                        get_smoke_config)
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as port_serve
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.serve import make_serve_fns
from repro_torch.train.train_loop import make_train_step

from test_torch_lm import TOL, auto_host_mesh  # noqa: F401
from test_torch_ssm import (BLOCK_TOL, assert_caches_close, block_params,
                            check_prefill_and_decode, recurrent_pair)
from test_torch_train_checkpoint import _assert_trees_bit_equal
from test_torch_train_step import (LOSS_RTOL, OPT,  # noqa: F401
                                   _ref_step_fns, one_torch_thread)

ARCH = "jamba-1.5-large-398b"


@pytest.mark.parametrize("T", [1, 7, 256])
def test_selective_scan_chunk_matches_reference(T):
    rng = np.random.default_rng(T)
    A = rng.uniform(0.5, 1.0, (2, T, 8, 4)).astype(np.float32)
    Bx = rng.normal(size=(2, T, 8, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 8, 4)).astype(np.float32)
    want, wl = ref_blocks._selective_scan_chunk(
        *(jnp.asarray(a) for a in (A, Bx, h0)))
    got, gl = port_blocks._selective_scan_chunk(
        *(torch.from_numpy(a) for a in (A, Bx, h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **BLOCK_TOL)
    # The sequential recurrence it computes.
    h, seq = h0, []
    for t in range(T):
        h = A[:, t] * h + Bx[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), **BLOCK_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [512, 100, 1])
def test_apply_mamba_matches_reference(S, with_state):
    """S = 512: two chunks of 256 with h carried between them; S = 100 one
    scan over all of S; S = 1 a decode step.  Outputs, h and the conv's
    last d_conv − 1 inputs."""
    rcfg, pcfg, rp, tp = block_params("init_mamba", ARCH)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, rcfg.d_model)).astype(np.float32)
    din = rcfg.expand * rcfg.d_model
    state = None
    if with_state:
        state = {"h": rng.normal(size=(2, din, rcfg.d_state)).astype(
                     np.float32),
                 "conv": rng.normal(size=(2, rcfg.d_conv - 1, din)).astype(
                     np.float32)}
    want, ws = ref_blocks.apply_mamba(
        rcfg, rp, jnp.asarray(x),
        None if state is None else jax.tree.map(jnp.asarray, state))
    got, gs = port_blocks.apply_mamba(
        pcfg, tp, torch.from_numpy(x),
        None if state is None else jax.tree.map(torch.from_numpy, state))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   **BLOCK_TOL)


def test_mamba_prefill_then_steps_equal_one_call():
    """The port's own state hand-over: a 256-token prefill and 8 single-token
    steps through the state give the 264-token call's outputs and state."""
    _, pcfg, _, tp = block_params("init_mamba", ARCH)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 264, pcfg.d_model)).astype(np.float32))
    whole, ws = port_blocks.apply_mamba(pcfg, tp, x)
    parts, st = [], None
    y, st = port_blocks.apply_mamba(pcfg, tp, x[:, :256], st)
    parts.append(y)
    for t in range(256, 264):
        y, st = port_blocks.apply_mamba(pcfg, tp, x[:, t:t + 1], st)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), whole.numpy(),
                               **BLOCK_TOL)
    np.testing.assert_allclose(st["h"].numpy(), ws["h"].numpy(), **BLOCK_TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_hybrid_forward_and_loss_match_reference(use_flash):
    """The cacheless forward with the flash route on and off (the host runs
    the plain version: no launch), its caches, and the loss."""
    api, params, model = recurrent_pair(ARCH, dtype="float32",
                                        use_flash=use_flash)
    toks = np.random.default_rng(1).integers(0, api.cfg.vocab, (2, 24))
    want, wcache = api.forward(params, jnp.asarray(toks))
    before = flash_ops.LAUNCHES
    got, caches = model(toks)
    assert flash_ops.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_caches_close(caches, wcache)
    assert len(caches) == 2 and caches[0]["attn"]["len"] == 24
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    want = float(api.loss(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    assert abs(float(model.loss(batch)) - want) <= 1e-5


def test_hybrid_flash_route_calls_the_kernel_once_a_group(monkeypatch):
    """With ``use_flash`` the cacheless forward reaches the flash wrapper in
    each group's attention layer (window 0), and nowhere on the cache
    path."""
    calls = []
    real = port_blocks.flash_attention

    def counted(q, k, v, causal=True):
        calls.append(q.shape)
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(port_blocks, "flash_attention", counted)
    model = build_model(get_smoke_config(ARCH, dtype="float32",
                                         use_flash=True), "cpu")
    toks = np.random.default_rng(3).integers(0, 512, (2, 16))
    model(toks)
    assert len(calls) == model.cfg.n_layers // model.cfg.attn_every == 2
    make_serve_fns(model).prefill(toks, model.init_cache(2, 20))
    assert len(calls) == 2
    model.cfg = model.cfg.with_(window=8)
    model(toks)
    assert len(calls) == 2


def test_hybrid_prefill_and_decode_match_reference(auto_host_mesh):
    model, cache = check_prefill_and_decode(ARCH, auto_host_mesh)
    assert [len(g["moe"]) for g in cache] == [2, 2]
    assert [len(g["dense"]) for g in cache] == [1, 1]
    assert all(g["attn"]["len"] == 18 for g in cache)
    assert cache[0]["moe"][0]["h"].dtype == torch.float32


def test_jamba_windowed_rolling_decode(auto_host_mesh):
    """The counterpart of the reference's windowed decode test: window 8, a
    cache of 8 slots.  A 16-token prefill takes the rolling branch (attend
    in flight, keep the last 8 entries) and matches the reference's logits
    and caches.  The reference then decodes by clamping its write into the
    full buffer; the port refuses that write (its overflow rule).  Within
    the window, prefill and decode match the reference's."""
    api, params, model = recurrent_pair(ARCH, dtype="float32", window=8)
    toks = np.random.default_rng(0).integers(0, api.cfg.vocab, (1, 16))
    want, wcache = api.forward(params, jnp.asarray(toks),
                               caches=api.init_cache(1, 8))
    got, cache = model(toks, caches=model.init_cache(1, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_caches_close(cache, wcache)
    assert all(g["attn"]["len"] == 8 for g in cache)
    with pytest.raises(ValueError, match="overflow"):
        model(toks[:, :1], caches=cache, positions=torch.tensor([[16]]))
    check_prefill_and_decode(ARCH, auto_host_mesh, B=1, S=4, gen=4, window=8)


def test_hybrid_train_step_matches_reference(auto_host_mesh):
    """One ``make_train_step`` step (``use_flash`` off: the train step
    refuses it): loss and gradient norm within rtol 1e-5, the learning rate
    equal, and every Mamba and MoE leaf trained."""
    api, params, model = recurrent_pair(ARCH, dtype="float32")
    fns = _ref_step_fns(api, auto_host_mesh, 1)
    o = ref_opt_init(params, RefOptConfig(**OPT))
    batch = make_batch(model.cfg, global_batch=4, seq_len=16, step=0)
    _, _, want = fns.step(params, o,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, OptConfig(**OPT))
    params_t, _, got = step.step(*step.init(), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_RTOL * abs(float(want[k])), k
    assert float(got["lr"]) == float(want["lr"])
    for n in ("layers.1.mamba_moe.1.mamba.A_log",
              "layers.0.mamba_dense.0.mamba.conv_w",
              "layers.1.mamba_moe.0.mlp.router"):
        assert not torch.equal(params_t[n], before[n]), n
    model.cfg = model.cfg.with_(use_flash=True)
    with pytest.raises(RuntimeError, match="use_flash"):
        step.step(*step.init(), batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_params_round_trip(dtype):
    """The reference's hybrid tree → the port's state dict → the tree, bit
    for bit; ``layers/mamba_moe/mamba/in_proj`` is (G, n_moe, d, 2·din)
    and becomes ``layers.<g>.mamba_moe.<j>.mamba.in_proj``."""
    tree = jax.tree.map(np.asarray, ref_build(ref_smoke(ARCH).with_(
        dtype=dtype)).init(jax.random.PRNGKey(0)))
    assert tree["layers"]["mamba_moe"]["mamba"]["in_proj"].shape == \
        (2, 2, 128, 512)
    sd = params_from_reference(tree)
    np.testing.assert_array_equal(
        sd["layers.1.mamba_moe.0.mamba.in_proj"].float().numpy(),
        tree["layers"]["mamba_moe"]["mamba"]["in_proj"][1, 0].astype(
            np.float32))
    model = build_model(get_smoke_config(ARCH, dtype=dtype), "cpu")
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    _assert_trees_bit_equal(params_to_reference(model.state_dict()), tree)


def test_reference_key_of_nested_leaves():
    assert reference_key("layers.1.mamba_moe.0.mamba.in_proj") == (
        ("layers", "mamba_moe", "mamba", "in_proj"), (1, 0))
    assert reference_key("layers.0.attn_layer.attn.wq") == (
        ("layers", "attn_layer", "attn", "wq"), (0,))
    assert reference_key("embed") == (("embed",), ())
    with pytest.raises(ValueError, match="layers"):
        params_to_reference({"layers.1.ln_attn": torch.ones(2)})


def test_hybrid_config_matches_reference():
    """The configuration field for field; the smoke model's groups put the
    MoE at the reference's positions; layers that do not split into groups
    raise."""
    assert get_config(ARCH).__dict__ == ref_config(ARCH).__dict__
    assert get_smoke_config(ARCH).__dict__ == ref_smoke(ARCH).__dict__
    assert moe_positions(get_config(ARCH)) == [1, 3, 5, 7]
    assert moe_positions(get_smoke_config(ARCH)) == [1, 3]
    model = build_model(get_smoke_config(ARCH), "cpu")
    assert len(model.layers) == 2
    g = model.layers[0]
    assert len(g.mamba_moe) == 2 and len(g.mamba_dense) == 1
    assert g.mamba_moe[0].moe and not g.mamba_dense[0].moe
    assert not g.attn_layer.moe
    with pytest.raises(ValueError, match="groups of 4"):
        build_model(get_smoke_config(ARCH, n_layers=6), "cpu")


def test_launch_serve_jamba_on_host(capsys):
    gen = port_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                           "--prompt-len", "8", "--gen", "4"], device="cpu")
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < 512)).all()
    assert f"{ARCH}: prefill(2×8)" in capsys.readouterr().out
