"""Port parity: the MoE family (``apply_moe``, the MoE language models,
their training step, checkpoints and entry points).

The two MoE smoke configurations (dbrx-132b: 4 experts top-2, GQA;
moonshot-v1-16b-a3b: 8 experts top-2, MHA) run through the reference
(``repro.archs``) and the port (``repro_torch.archs``) on the same
weights: the reference's ``init`` draws them, inputs are made with numpy
from a seed, and ``params_from_reference`` carries them over.

Tolerances, float32 on the host:

* ``apply_moe`` within 1e-5 of the output's largest magnitude, on both
  dispatch routes: the smoke experts' outputs reach about 40 on
  unit-RMS inputs (the reference's ``init_dense`` scales the stacked
  (E, d, f) weights by 1/√E), where a float32 step is 4e-6, and XLA and
  PyTorch sum the products in other orders;
* which token-slots capacity drops: exactly the reference's;
* the LM forward and loss as ``test_torch_lm`` holds the dense family
  (``TOL``, and the loss within 1e-5), greedy tokens exactly equal;
* one train step's loss and gradient norm within rtol 1e-5;
* checkpoints bit-equal both ways.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.archs import blocks as ref_blocks
from repro.archs.registry import get_config as ref_config
from repro.archs.registry import get_smoke_config as ref_smoke
from repro.train.checkpoint import restore_checkpoint as ref_restore
from repro.train.checkpoint import save_checkpoint as ref_save
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro_torch.archs import blocks as port_blocks
from repro_torch.archs.lm import params_to_reference
from repro_torch.archs.registry import (build_model, get_config,
                                        get_smoke_config)
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import OptConfig, opt_state_to_reference
from repro_torch.train.train_loop import make_train_step

from test_torch_lm import (_pair, auto_host_mesh,  # noqa: F401
                           bf16_position_diffs, check_forward_and_loss,
                           check_prefill_and_greedy_decode)
from test_torch_train_checkpoint import _assert_trees_bit_equal
from test_torch_train_step import (LOSS_RTOL, OPT,  # noqa: F401
                                   _ref_step_fns, one_torch_thread)

MOE = ["dbrx-132b", "moonshot-v1-16b-a3b"]
MOE_RTOL = 1e-5


def _moe_case(arch, seed=0, G=3, S=32, **over):
    """(reference cfg, port cfg, params as numpy, as tensors, x) for one
    MoE block in float32."""
    rcfg = ref_smoke(arch).with_(dtype="float32", **over)
    pcfg = get_smoke_config(arch, dtype="float32", **over)
    p = jax.tree.map(np.asarray,
                     ref_blocks.init_moe(jax.random.PRNGKey(seed), rcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(seed + 1).normal(
        size=(G, S, rcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, p, tp, x


def _assert_scaled_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=MOE_RTOL,
                               rtol=0)


@pytest.mark.parametrize("impl", ["sort", "einsum"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, impl):
    rcfg, pcfg, p, tp, x = _moe_case(arch)
    want = np.asarray(ref_blocks.apply_moe(
        rcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x), impl=impl))
    got = port_blocks.apply_moe(pcfg, tp, torch.from_numpy(x), impl=impl)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_scaled_close(got.numpy(), want)


def _ref_kept(rcfg, p, x):
    """The reference's kept (group, token, expert) triples: token t's output
    depends on expert e's down projection exactly when t's slot at e was
    kept (a dropped slot's output is multiplied by 0), so the Jacobian of
    the reference's ``apply_moe`` tells them apart."""
    pj = jax.tree.map(jnp.asarray, p)

    def out(e_down):
        return ref_blocks.apply_moe(rcfg, dict(pj, e_down=e_down),
                                    jnp.asarray(x)).sum(-1)
    jac = np.asarray(jax.jacrev(out)(pj["e_down"]))      # (G, S, E, f, d)
    return np.abs(jac).reshape(jac.shape[:3] + (-1,)).max(-1) > 0


@pytest.mark.parametrize("arch", MOE)
def test_dropped_slots_equal_reference(arch):
    """capacity_factor 0.5: half the token-slots of each group find no
    room; the port keeps and drops exactly the reference's, and its
    outputs agree."""
    rcfg, pcfg, p, tp, x = _moe_case(arch, seed=3, G=2, S=24,
                                     capacity_factor=0.5)
    route = port_blocks.moe_route(pcfg, tp, torch.from_numpy(x))
    assert route.capacity == 24 * pcfg.top_k // pcfg.n_experts // 2
    keep = route.keep.numpy()
    assert 0 < (~keep).sum() < keep.size
    kept = np.zeros((2, 24, pcfg.n_experts), bool)
    g, s, j = np.nonzero(keep)
    kept[g, s, route.gidx.numpy()[g, s, j]] = True
    np.testing.assert_array_equal(kept, _ref_kept(rcfg, p, x))
    # Each expert takes its first `capacity` slots in token order.
    for gg in range(2):
        for e in range(pcfg.n_experts):
            toks = np.nonzero((route.gidx.numpy()[gg] == e).any(-1))[0]
            np.testing.assert_array_equal(
                np.nonzero(kept[gg, :, e])[0], toks[:route.capacity])
    want = np.asarray(ref_blocks.apply_moe(
        rcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    _assert_scaled_close(port_blocks.apply_moe(
        pcfg, tp, torch.from_numpy(x)).numpy(), want)


def test_capacity_routes_differ_as_the_reference():
    """The sort route's capacity is ⌈S·k/E·cf⌉, the einsum route's at most
    S, as the reference computes them."""
    cfg = get_smoke_config("dbrx-132b", capacity_factor=8.0)
    S = 10
    assert port_blocks.moe_capacity(cfg, S) == 40
    assert port_blocks.moe_capacity(cfg, S, "einsum") == 10
    cfg = get_config("moonshot-v1-16b-a3b")
    assert port_blocks.moe_capacity(cfg, 2048) == 240
    assert port_blocks.moe_capacity(cfg, 1) == 1


@pytest.mark.parametrize("arch", MOE)
def test_sort_equals_einsum_dispatch(arch):
    """The counterpart of the reference's
    ``test_moe_sort_equals_einsum_dispatch``: with capacity_factor E/k no
    slot is dropped on either route, so both give the same outputs."""
    cfg = get_smoke_config(arch, dtype="float32")
    cfg = cfg.with_(capacity_factor=float(cfg.n_experts) / cfg.top_k)
    p = port_blocks.init_moe(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 32, cfg.d_model)).astype(np.float32))
    a = port_blocks.apply_moe(cfg, p, x, impl="sort")
    b = port_blocks.apply_moe(cfg, p, x, impl="einsum")
    assert bool(port_blocks.moe_route(cfg, p, x).keep.all())
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="dispatch"):
        port_blocks.apply_moe(cfg, p, x, impl="scatter")


def test_router_is_float32_in_a_bf16_model():
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    model = build_model(cfg, "cpu")
    mlp = model.layers[0].mlp
    assert mlp["router"].dtype == torch.float32
    assert mlp["e_gate"].dtype == torch.bfloat16
    assert tuple(mlp["e_gate"].shape) == (8, 128, 128)
    assert tuple(mlp["e_down"].shape) == (8, 128, 128)
    x = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(0))
    y = port_blocks.apply_moe(cfg, mlp, x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 5, 128)


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_and_loss_match_reference(arch):
    """Cacheless forward with the flash route on and off (the host runs
    the plain version), and the loss, as the dense family is held."""
    check_forward_and_loss(arch)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_greedy_decode_match_reference(arch,
                                                       auto_host_mesh):
    """Prefill into the dense KV cache, then 8 greedy decode steps (each
    request a group of one token, capacity 1): tokens equal."""
    check_prefill_and_greedy_decode(arch, auto_host_mesh)


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_forward_within_reference_rounding(arch):
    """bfloat16: as the dense family, the port stays as close to the
    reference's bfloat16 logits as the reference's own bfloat16 forward is
    to its float32 forward on the same weights.  A bfloat16 rounding can
    flip an expert near a routing tie, which moves that position's logits
    by O(1) on either side (the reference's own two forwards differ by 3.0
    at 2 of moonshot's 48 positions), so the dense family's sanity bound
    of 0.5 holds for the median position, not for the largest."""
    own, diff = bf16_position_diffs(arch)
    assert 0 < np.median(own) < 0.5
    assert diff.max() <= own.max()
    assert np.median(diff) <= 0.5


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_step_matches_reference(arch, auto_host_mesh):
    """One ``make_train_step`` step: loss and gradient norm within rtol
    1e-5 of the reference's (on a one-device Auto mesh), the learning rate
    equal, and the router trained: the gradient reaches it through the
    renormalised gate values."""
    api, params, model = _pair(arch, dtype="float32")
    tree = jax.tree.map(np.asarray, params)
    fns = _ref_step_fns(api, auto_host_mesh, 1)
    p = jax.tree.map(jnp.asarray, tree)
    o = ref_opt_init(p, RefOptConfig(**OPT))
    batch = make_batch(model.cfg, global_batch=4, seq_len=16, step=0)
    _, _, want = fns.step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
    router = model.layers[0].mlp["router"].detach().clone()
    step = make_train_step(model, OptConfig(**OPT))
    _, _, got = step.step(*step.init(), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_RTOL * abs(float(want[k])), k
    assert float(got["lr"]) == float(want["lr"])
    assert not torch.equal(model.layers[0].mlp["router"], router)


@pytest.mark.parametrize("remat", ["block", "none"])
def test_moe_router_gradient_and_remat(remat):
    """The router's gradient is nonzero, and ``remat="block"`` (the layer
    recomputed in the backward pass, its routing with it) gives the
    gradients of ``"none"``."""
    grads = {}
    for mode in ("block", "none"):
        model = build_model(get_smoke_config(
            "moonshot-v1-16b-a3b", dtype="float32", remat=mode), "cpu")
        model.requires_grad_(True)
        model.loss(make_batch(model.cfg, global_batch=2, seq_len=8,
                              step=0)).backward()
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
    g = grads[remat]
    assert float(g["layers.0.mlp.router"].abs().max()) > 0
    assert float(g["layers.1.mlp.e_gate"].abs().max()) > 0
    other = grads["none" if remat == "block" else "block"]
    for n, t in g.items():
        assert torch.equal(t, other[n]), n


def test_moe_checkpoint_crosses_both_ways(tmp_path, auto_host_mesh):
    """A bfloat16 moonshot tree after one reference step: the port restores
    the reference's checkpoint bit for bit, saves it, and the reference
    restores the port's; expert leaves are (L, E, d, f) stacked."""
    api, params, model = _pair("moonshot-v1-16b-a3b")
    fns = _ref_step_fns(api, auto_host_mesh, 1)
    o = ref_opt_init(params, RefOptConfig(**OPT))
    b = make_batch(api.cfg, global_batch=4, seq_len=16, step=0)
    p, o, _ = fns.step(params, o, {k: jnp.asarray(v) for k, v in b.items()})
    p, o = jax.tree.map(np.asarray, (p, o))
    ref_save(str(tmp_path / "ref"), 1, p, o)
    step = make_train_step(model, OptConfig())
    like = dict(zip(("params", "opt"), step.init()))
    restored, at = restore_checkpoint(str(tmp_path / "ref"), like)
    assert at == 1
    tree = params_to_reference(restored["params"])
    assert tuple(tree["layers"]["mlp"]["e_gate"].shape) == (2, 8, 128, 128)
    assert tree["layers"]["mlp"]["router"].dtype == torch.float32
    _assert_trees_bit_equal(
        {"params": tree, "opt": opt_state_to_reference(restored["opt"])},
        {"params": p, "opt": o})
    save_checkpoint(str(tmp_path / "port"), 1, restored["params"],
                    restored["opt"])
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          {"params": p, "opt": o})
    back, at = ref_restore(str(tmp_path / "port"), shapes)
    assert at == 1
    _assert_trees_bit_equal(
        {"params": tree, "opt": opt_state_to_reference(restored["opt"])},
        back)
    manifests = [json.load(open(tmp_path / d / "step_1" / "manifest.json"))
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]


def test_launch_serve_and_train_moonshot_on_host(tmp_path, capsys):
    gen = port_serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                           "--batch", "2", "--prompt-len", "8", "--gen",
                           "4"], device="cpu")
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < 512)).all()
    assert "moonshot-v1-16b-a3b: prefill(2×8)" in capsys.readouterr().out
    out = port_train.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                           "--steps", "4", "--batch", "4", "--seq", "16",
                           "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
                           "--device", "cpu"])
    assert "moonshot-v1-16b-a3b: 4 steps in" in capsys.readouterr().out
    assert np.isfinite(out["history"][-1]["loss"])
    restored, at = restore_checkpoint(str(tmp_path),
                                      {"params": out["params"]})
    assert at == 4
    for n, t in out["params"].items():
        assert torch.equal(restored["params"][n], t.detach()), n
    assert restored["params"]["layers.1.mlp.e_up"].shape == (8, 128, 128)


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_match_reference(arch):
    """Both configurations carry over field for field; dbrx-132b builds at
    smoke size."""
    assert get_config(arch).__dict__ == ref_config(arch).__dict__
    assert get_smoke_config(arch).__dict__ == ref_smoke(arch).__dict__
    model = build_model(get_smoke_config(arch), "cpu")
    assert model.layers[0].moe and len(model.layers) == 2


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_unported_families_still_raise(arch):
    """The last two families are ported: ``get_config`` and
    ``get_smoke_config`` serve each, field for field the reference's."""
    assert get_config(arch).__dict__ == ref_config(arch).__dict__
    assert get_smoke_config(arch).__dict__ == ref_smoke(arch).__dict__
