"""Port parity: the SSM family (RWKV-6 blocks, rwkv6-1.6b's language model,
its serving, training step and parameter tree).

The smoke rwkv6-1.6b (2 layers, d_model 128, two heads of 64) runs through
the reference (``repro.archs``) and the port (``repro_torch.archs``) on the
same weights: the reference's ``init`` draws them, every norm, token-shift
mix, decay bias and (for Mamba) ``D`` and ``A_log`` is perturbed with
numpy so that each parameter matters, inputs are made with numpy from a
seed, and ``params_from_reference`` carries them over.

Tolerances, float32 on the host:

* each block (``apply_rwkv_time`` on both routes, ``apply_rwkv_channel``,
  ``rwkv_wkv_chunked``), new state included, within rtol = atol = 1e-5:
  the same arithmetic, summed in other orders by XLA and PyTorch;
* the LM's forward logits within 1e-4 (``test_torch_lm.TOL``), its loss
  within 1e-5; prefill and decode logits and the caches within 1e-4 (a
  cache holds hidden states after the same layers as the logits); one
  train step's loss and gradient norm within rtol 1e-5;
* one layer at rwkv6-1.6b's full width (d_model 2048) on (1, 128, 2048):
  finite and within 1e-4 on the ``scan`` route, and not finite on the
  ``chunked`` route in either package (``w_proj`` at an absolute scale
  of 0.1 gives decay exponents whose sum over a chunk overflows exp(−L));
* parameter trees round-trip bit for bit, bfloat16 included.
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
from repro_torch.archs.lm import params_from_reference, params_to_reference
from repro_torch.archs.registry import (build_model, get_config,
                                        get_smoke_config)
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import serve as port_serve
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.serve import make_serve_fns
from repro_torch.train.train_loop import make_train_step

from test_torch_lm import TOL, auto_host_mesh  # noqa: F401
from test_torch_train_checkpoint import _assert_trees_bit_equal
from test_torch_train_step import (LOSS_RTOL, OPT,  # noqa: F401
                                   _ref_step_fns, one_torch_thread)

ARCH = "rwkv6-1.6b"
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_TOL = TOL
FULL_TOL = dict(rtol=1e-4, atol=1e-4)

# Leaves drawn as constants by the reference's init, by name prefix, and
# the spread of the normal noise added to each so that it matters.
_PERTURB = {"ln_": 0.1, "norm_": 0.1, "mu_": 0.2, "w_bias": 0.5, "D": 0.2,
            "A_log": 0.2, "bq": 0.1, "bk": 0.1, "bv": 0.1}


def perturbed(tree, seed=0):
    """``tree`` (numpy leaves) with its constant leaves perturbed in place:
    each becomes its value plus a seeded normal of the spread above."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
                continue
            spread = next((s for p, s in _PERTURB.items()
                           if k.startswith(p)), None)
            if spread is not None:
                node[k] = (v.astype(np.float32) + spread * rng.normal(
                    size=v.shape)).astype(v.dtype)
    walk(tree)
    return tree


def recurrent_pair(arch, seed=0, **over):
    """(reference api, its params as jnp, port model) on one set of
    perturbed weights."""
    rcfg = ref_smoke(arch).with_(**over)
    tree = perturbed(jax.tree.map(
        np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(seed))), seed)
    model = build_model(get_smoke_config(arch, **over), "cpu")
    model.load_state_dict(params_from_reference(tree))
    return ref_build(rcfg), jax.tree.map(jnp.asarray, tree), model


def block_params(init, arch, seed=0, **over):
    """(reference cfg, port cfg, params as jnp, as tensors) of one block in
    float32, constants perturbed."""
    rcfg = ref_smoke(arch).with_(dtype="float32", **over)
    pcfg = get_smoke_config(arch, dtype="float32", **over)
    p = perturbed(jax.tree.map(np.asarray, getattr(ref_blocks, init)(
        jax.random.PRNGKey(seed), rcfg)), seed)
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, p),
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def stacked_cache(cache):
    """The port's per-layer cache in the reference's stacked layout, as
    numpy: a list of layers (or a group's Mamba layers) becomes a leading
    axis; an attention cache's ``len`` an int32 array."""
    if isinstance(cache, list):
        parts = [stacked_cache(c) for c in cache]
        return jax.tree.map(lambda *xs: np.stack(xs), *parts)
    if isinstance(cache, dict):
        return {k: stacked_cache(v) for k, v in cache.items()
                if v is not None}
    if isinstance(cache, int):
        return np.asarray(cache, np.int32)
    return cache.detach().float().numpy()


def assert_caches_close(got, want):
    """The port's caches against the reference's stacked caches, leaf for
    leaf (the reference's ``None`` entries are absent from both)."""
    g = jax.tree_util.tree_flatten_with_path(stacked_cache(got))[0]
    w = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), want))[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, err_msg=str(k), **CACHE_TOL)


def state_arrays(rng, B, cfg):
    """A random RWKV state: (S float32, x_prev)."""
    dh = cfg.rwkv_head_dim
    H = cfg.d_model // dh
    return (rng.normal(size=(B, H, dh, dh)).astype(np.float32),
            rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_apply_rwkv_time_matches_reference(impl, with_state):
    """Both routes at S = 128 (two chunks of 64), from zeros or a given
    state: outputs and the new state (S, x_prev)."""
    rcfg, pcfg, rp, tp = block_params("init_rwkv", ARCH, rwkv_impl=impl)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 128, rcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        S0, xp = state_arrays(rng, 2, rcfg)
        state = {"S": S0, "x_prev": xp}
    want, wstate = ref_blocks.apply_rwkv_time(
        rcfg, rp, jnp.asarray(x),
        None if state is None else jax.tree.map(jnp.asarray, state))
    got, gstate = port_blocks.apply_rwkv_time(
        pcfg, tp, torch.from_numpy(x),
        None if state is None else jax.tree.map(torch.from_numpy, state))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("S", "x_prev"):
        np.testing.assert_allclose(gstate[k].numpy(), np.asarray(wstate[k]),
                                   **BLOCK_TOL)


@pytest.mark.parametrize("S", [1, 24, 64])
def test_chunked_route_falls_back_to_scan_as_the_reference(S):
    """``chunked`` takes the chunk form only for S > 1 a multiple of the
    chunk; S = 1 and S = 24 run the scan, and all three agree with the
    reference's and with the port's own scan route."""
    rcfg, pcfg, rp, tp = block_params("init_rwkv", ARCH, rwkv_impl="chunked")
    x = np.random.default_rng(2).normal(
        size=(2, S, rcfg.d_model)).astype(np.float32)
    want, _ = ref_blocks.apply_rwkv_time(rcfg, rp, jnp.asarray(x))
    got, _ = port_blocks.apply_rwkv_time(pcfg, tp, torch.from_numpy(x))
    scan, _ = port_blocks.apply_rwkv_time(pcfg.with_(rwkv_impl="scan"), tp,
                                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(got.numpy(), scan.numpy(), **BLOCK_TOL)


def test_apply_rwkv_channel_matches_reference():
    rcfg, pcfg, rp, tp = block_params("init_rwkv", ARCH)
    x = np.random.default_rng(3).normal(
        size=(2, 24, rcfg.d_model)).astype(np.float32)
    want = ref_blocks.apply_rwkv_channel(rcfg, rp, jnp.asarray(x))
    got = port_blocks.apply_rwkv_channel(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_rwkv_wkv_chunked_matches_reference(chunk):
    """The chunk form alone, on decays in (0.8, 1) and a random state."""
    rng = np.random.default_rng(4)
    B, S, H, Dh = 2, 128, 2, 16
    w = rng.uniform(0.8, 1.0, (B, S, H, Dh)).astype(np.float32)
    k, v, r = (rng.normal(size=(B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    S0 = rng.normal(size=(B, H, Dh, Dh)).astype(np.float32)
    want, wS = ref_blocks.rwkv_wkv_chunked(
        *(jnp.asarray(a) for a in (w, k, v, r, S0)), chunk=chunk)
    got, gS = port_blocks.rwkv_wkv_chunked(
        *(torch.from_numpy(a) for a in (w, k, v, r, S0)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gS.numpy(), np.asarray(wS), **BLOCK_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        port_blocks.rwkv_wkv_chunked(
            *(torch.from_numpy(a[:, :100]) for a in (w, k, v, r)),
            torch.from_numpy(S0), chunk=64)


def test_rwkv_full_width_layer_scan_finite_chunked_not():
    """One time-mix layer at rwkv6-1.6b's width on (1, 128, 2048): the
    ``scan`` route finite in both packages and within 1e-4; the ``chunked``
    route not finite in either (the reference's own property, kept)."""
    rcfg = ref_config(ARCH).with_(dtype="float32")
    p = jax.tree.map(np.asarray,
                     ref_blocks.init_rwkv(jax.random.PRNGKey(0), rcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rp = jax.tree.map(jnp.asarray, p)
    x = np.random.default_rng(5).normal(size=(1, 128, 2048)).astype(
        np.float32)
    finite = {}
    for impl in ("scan", "chunked"):
        want, _ = ref_blocks.apply_rwkv_time(
            rcfg.with_(rwkv_impl=impl), rp, jnp.asarray(x))
        got, _ = port_blocks.apply_rwkv_time(
            get_config(ARCH, dtype="float32", rwkv_impl=impl), tp,
            torch.from_numpy(x))
        want, got = np.asarray(want), got.numpy()
        finite[impl] = (np.isfinite(want).mean(), np.isfinite(got).mean())
        if impl == "scan":
            np.testing.assert_allclose(got, want, **FULL_TOL)
    assert finite["scan"] == (1.0, 1.0)
    assert finite["chunked"][0] < 1.0 and finite["chunked"][1] < 1.0
    assert finite["chunked"][0] == finite["chunked"][1]


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_ssm_forward_and_loss_match_reference(impl):
    """The smoke LM's cacheless forward (S = 64: one chunk of the chunked
    route) and its loss."""
    api, params, model = recurrent_pair(ARCH, dtype="float32",
                                        rwkv_impl=impl, rwkv_chunk=32)
    toks = np.random.default_rng(1).integers(0, api.cfg.vocab, (2, 64))
    want, wcache = api.forward(params, jnp.asarray(toks))
    got, caches = model(toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_caches_close(caches, wcache)
    last, _ = model(toks, last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:],
                               rtol=1e-5, atol=1e-5)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    want = float(api.loss(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    assert abs(float(model.loss(batch)) - want) <= 1e-5


def check_prefill_and_decode(arch, mesh, B=2, S=12, gen=6, **over):
    """Prefill into the cache, then ``gen`` greedy decode steps, through
    both packages' serving functions: logits at every step, tokens equal,
    and the caches after prefill and at the end."""
    api, params, model = recurrent_pair(arch, dtype="float32", **over)
    toks = np.random.default_rng(1).integers(0, api.cfg.vocab, (B, S))
    rsf = ref_serve_fns(api, mesh, batch=B, max_len=S + gen)
    psf = make_serve_fns(model)
    rl, rcache = rsf.prefill(params, jnp.asarray(toks),
                             api.init_cache(B, S + gen), None)
    pl, pcache = psf.prefill(toks, model.init_cache(B, S + gen))
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    assert_caches_close(pcache, rcache)
    rn, pn = jnp.argmax(rl[:, -1], -1), torch.argmax(pl[:, -1], -1)
    for t in range(gen):
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        rl, rcache = rsf.decode(params, rn[:, None], rcache,
                                jnp.full((B, 1), S + t, jnp.int32))
        pl, pcache = psf.decode(pn[:, None], pcache,
                                torch.full((B, 1), S + t))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        rn, pn = jnp.argmax(rl[:, -1], -1), torch.argmax(pl[:, -1], -1)
    assert_caches_close(pcache, rcache)
    assert not pl.requires_grad
    return model, pcache


def test_ssm_prefill_and_decode_match_reference(auto_host_mesh):
    model, cache = check_prefill_and_decode(ARCH, auto_host_mesh)
    assert len(cache) == 2
    assert cache[0]["S"].shape == (2, 2, 64, 64)
    assert cache[0]["x_prev"].shape == (2, 1, 128)


def test_ssm_decode_ignores_positions():
    """RWKV reads no position: a decode step gives the same logits at any
    position, as the reference's."""
    model = build_model(get_smoke_config(ARCH, dtype="float32"), "cpu")
    sf = make_serve_fns(model)
    toks = np.random.default_rng(2).integers(0, 512, (1, 8))
    outs = []
    for pos in (8, 1000):
        _, cache = sf.prefill(toks, model.init_cache(1, 9))
        logits, _ = sf.decode(torch.tensor([[3]]), cache,
                              torch.tensor([[pos]]))
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


def test_ssm_state_dtypes_in_bf16():
    """A bfloat16 model keeps its wkv state in float32 and its token-shift
    state in bfloat16, as the reference's cache."""
    model = build_model(get_smoke_config(ARCH), "cpu")
    cache = model.init_cache(2, 16)
    assert cache[0]["S"].dtype == torch.float32
    assert cache[0]["x_prev"].dtype == torch.bfloat16
    _, cache = make_serve_fns(model).prefill(
        np.random.default_rng(0).integers(0, 512, (2, 5)), cache)
    assert cache[1]["S"].dtype == torch.float32
    assert cache[1]["x_prev"].dtype == torch.bfloat16


def test_ssm_train_step_matches_reference(auto_host_mesh):
    """One ``make_train_step`` step: loss and gradient norm within rtol
    1e-5 of the reference's, the learning rate equal."""
    api, params, model = recurrent_pair(ARCH, dtype="float32")
    fns = _ref_step_fns(api, auto_host_mesh, 1)
    o = ref_opt_init(params, RefOptConfig(**OPT))
    batch = make_batch(model.cfg, global_batch=4, seq_len=16, step=0)
    _, _, want = fns.step(params, o,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(model, OptConfig(**OPT))
    _, _, got = step.step(*step.init(), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_RTOL * abs(float(want[k])), k
    assert float(got["lr"]) == float(want["lr"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_params_round_trip(dtype):
    """The reference's tree → the port's state dict → the reference's tree,
    bit for bit; per-layer leaves become ``layers.<i>.rwkv.<name>``."""
    tree = jax.tree.map(np.asarray, ref_build(ref_smoke(ARCH).with_(
        dtype=dtype)).init(jax.random.PRNGKey(0)))
    sd = params_from_reference(tree)
    assert sd["layers.1.rwkv.w_proj"].dtype == getattr(torch, dtype)
    assert sd["layers.1.rwkv.w_bias"].dtype == torch.float32
    model = build_model(get_smoke_config(ARCH, dtype=dtype), "cpu")
    model.load_state_dict(sd)
    _assert_trees_bit_equal(params_to_reference(model.state_dict()), tree)
    if dtype == "bfloat16":
        assert tree["embed"].dtype == ml_dtypes.bfloat16


def test_ssm_config_matches_reference():
    assert get_config(ARCH).__dict__ == ref_config(ARCH).__dict__
    assert get_smoke_config(ARCH).__dict__ == ref_smoke(ARCH).__dict__
    model = build_model(get_smoke_config(ARCH), "cpu")
    assert len(model.layers) == 2
    assert sorted(model.layers[0].rwkv) == sorted(
        ref_blocks.init_rwkv(jax.random.PRNGKey(0), ref_smoke(ARCH)))


def test_full_width_model_builds_on_host():
    """rwkv6-1.6b at full width and depth: 1.58 B bfloat16 parameters."""
    model = build_model(get_config(ARCH), "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert 1.57e9 < n < 1.59e9
    assert model.layers[23].rwkv["r_proj"].shape == (2048, 2048)
    assert model.layers[0].rwkv["ck_proj"].dtype == torch.bfloat16


def test_launch_serve_rwkv_on_host(capsys):
    gen = port_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                           "--prompt-len", "8", "--gen", "4"], device="cpu")
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < 512)).all()
    assert f"{ARCH}: prefill(2×8)" in capsys.readouterr().out
