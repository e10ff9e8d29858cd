"""Port parity: the language models' train step and loop.

The float32 smoke glm4-9b (GQA, untied head) and minicpm-2b (MHA, tied
embedding) start from the reference's weights, norms perturbed
(``test_torch_lm._ref_params``), carried over by
``params_from_reference``.  The reference's own ``make_train_step`` runs
on a one-device mesh with Auto axes (``make_host_mesh()`` gives Explicit
axes on this JAX, which its sharded indexing refuses: ROADMAP R3).

Tolerances, float32 on the host:

* one step's loss and gradient norm within rtol 1e-5 (the same
  arithmetic; XLA and PyTorch sum the products in other orders), its
  learning rate equal;
* the moments within 1e-5 of each leaf's largest entry (they are linear
  and quadratic in the gradients);
* the parameters within rtol 1e-5 and atol 1e-7 in all but at most 1 in
  1,000 elements of a leaf, and those within 2·lr: AdamW's first steps
  move an element by about ±lr whatever its gradient's size, so an
  element whose gradient sits near ε = 1e-8 moves by an amount its
  gradient's last bits decide;
* a 10-step loss trajectory within rtol 1e-4; the first loss of the
  bfloat16 configuration within 1e-2 relative (XLA and PyTorch round
  bfloat16 at other places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_smoke_config as ref_smoke
from repro.data.pipeline import make_batch as ref_make_batch
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro.train.train_loop import make_train_step as ref_make_train_step
from repro_torch.archs.lm import params_from_reference
from repro_torch.archs.registry import build_model, get_smoke_config
from repro_torch.data.pipeline import data_iterator, make_batch
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import make_train_step, train_loop
from repro_torch.train.serve import make_serve_fns

from test_torch_lm import _ref_params, auto_host_mesh  # noqa: F401

LOSS_RTOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL, PARAM_OUTLIERS = 1e-5, 1e-7, 1e-3
TRAJECTORY_RTOL = 1e-4
BF16_LOSS_RTOL = 1e-2
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for PyTorch while this module runs: the suite
    runs files in parallel worker processes, and each worker's default of
    one thread a core oversubscribes the host many times over (the bf16
    loss-falls test takes 50× longer so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **over):
    """(reference api, its params as numpy, port model) on one start."""
    rcfg = ref_smoke(arch).with_(**over)
    tree = _ref_params(rcfg)
    model = build_model(get_smoke_config(arch, **over), "cpu")
    model.load_state_dict(params_from_reference(tree))
    return ref_build(rcfg), tree, model


def _ref_step_fns(api, mesh, accum, opt=OPT):
    b = ref_make_batch(api.cfg, global_batch=4, seq_len=16, step=0)
    shape = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), b)
    return ref_make_train_step(api, mesh, shape, RefOptConfig(**opt),
                               accum=accum, donate=False)


def assert_state_close(params, opt_state, ref_params, ref_opt, lr):
    """The stated tolerances on every parameter and moment."""
    for key, got, want in (("m", opt_state["m"], ref_opt["m"]),
                           ("v", opt_state["v"], ref_opt["v"])):
        want = params_from_reference(jax.tree.map(np.asarray, want))
        for n, w in want.items():
            w = w.float().numpy()
            d = np.abs(got[n].detach().float().numpy() - w).max()
            assert d <= MOMENT_TOL * np.abs(w).max(), (key, n, d)
    want = params_from_reference(jax.tree.map(np.asarray, ref_params))
    assert sorted(params) == sorted(want)
    for n, w in want.items():
        w = w.float().numpy()
        d = np.abs(params[n].detach().float().numpy() - w)
        off = d > PARAM_RTOL * np.abs(w) + PARAM_ATOL
        assert off.mean() <= PARAM_OUTLIERS, (n, int(off.sum()), w.size)
        assert d.max() <= 2 * lr, (n, d.max())
    assert int(opt_state["step"]) == int(ref_opt["step"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["glm4-9b", "minicpm-2b"])
def test_train_step_matches_reference(arch, accum, auto_host_mesh):
    api, tree, model = _pair(arch, dtype="float32")
    fns = _ref_step_fns(api, auto_host_mesh, accum)
    p = jax.tree.map(jnp.asarray, tree)
    o = ref_opt_init(p, RefOptConfig(**OPT))
    batch = make_batch(model.cfg, global_batch=4, seq_len=16, step=0)
    p, o, want = fns.step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(model, OptConfig(**OPT), accum=accum)
    params, opt_state = step.init()
    params, opt_state, got = step.step(params, opt_state, batch)
    assert abs(float(got["loss"]) - float(want["loss"])) <= \
        LOSS_RTOL * abs(float(want["loss"]))
    assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
        LOSS_RTOL * float(want["grad_norm"])
    assert float(got["lr"]) == float(want["lr"])
    assert_state_close(params, opt_state, p, o, float(want["lr"]))
    assert params["embed"] is model.embed                # updated in place


def test_loss_trajectory_matches_reference(auto_host_mesh):
    """10 steps on the pipeline's batches, with gradient accumulation."""
    api, tree, model = _pair("glm4-9b", dtype="float32")
    fns = _ref_step_fns(api, auto_host_mesh, 2)
    p = jax.tree.map(jnp.asarray, tree)
    o = ref_opt_init(p, RefOptConfig(**OPT))
    it = data_iterator(model.cfg, global_batch=4, seq_len=16, seed=5)
    batches = [next(it) for _ in range(10)]
    want = []
    for b in batches:
        p, o, m = fns.step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        want.append([float(m[k]) for k in ("loss", "lr", "grad_norm")])
    step = make_train_step(model, OptConfig(**OPT), accum=2)
    params, opt_state = step.init()
    got = []
    for b in batches:
        params, opt_state, m = step.step(params, opt_state, b)
        got.append([float(m[k]) for k in ("loss", "lr", "grad_norm")])
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    assert np.asarray(want)[-1, 0] < np.asarray(want)[0, 0]


@pytest.mark.parametrize("arch", ["glm4-9b", "minicpm-2b"])
def test_bf16_first_loss_matches_reference(arch):
    api, tree, model = _pair(arch)                         # bfloat16
    assert model.embed.dtype == torch.bfloat16
    batch = make_batch(model.cfg, global_batch=4, seq_len=32, step=0)
    want = float(api.loss(jax.tree.map(jnp.asarray, tree),
                          {k: jnp.asarray(v) for k, v in batch.items()}))
    step = make_train_step(model, OptConfig(**OPT))
    _, _, got = step.step(*step.init(), batch)
    assert abs(float(got["loss"]) - want) <= BF16_LOSS_RTOL * want


def test_grad_accum_equivalence():
    """The intent of the reference's ``test_grad_accum_equivalence``:
    accum=2 gives (nearly) the update of accum=1 — the embedding's update
    directions within cosine 0.98."""
    cfg = get_smoke_config("glm4-9b")
    batch = make_batch(cfg, global_batch=4, seq_len=16, step=0)
    deltas = []
    for accum in (1, 2):
        model = build_model(cfg, "cpu")
        before = model.embed.detach().float().clone()
        step = make_train_step(model, OptConfig(lr=1e-3), accum=accum)
        step.step(*step.init(), batch)
        deltas.append(model.embed.detach().float() - before)
    d1, d2 = deltas
    cos = float((d1 * d2).sum() / (d1.norm() * d2.norm() + 1e-12))
    assert cos > 0.98


def test_train_loss_decreases():
    """The intent of the reference's ``test_train_loss_decreases`` (which
    fails on this JAX, R3): the bfloat16 smoke glm4-9b, batch 4 × 32,
    lr 3e-3 with 3 warm-up steps, 30 steps; the last loss below 0.9 × the
    first, every loss finite."""
    cfg = get_smoke_config("glm4-9b")
    model = build_model(cfg, "cpu")
    it = data_iterator(cfg, global_batch=4, seq_len=32, seed=0)
    opt = OptConfig(lr=3e-3, total_steps=30, warmup_steps=3)
    out = train_loop(model, it, steps=30, opt_cfg=opt, log_every=1)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9
    assert [h["step"] for h in out["history"]] == list(range(1, 31))


def test_use_flash_refuses_to_train():
    """The flash kernel has no backward pass: the step raises rather than
    taking the einsum route."""
    model = build_model(get_smoke_config("glm4-9b", use_flash=True), "cpu")
    step = make_train_step(model, OptConfig())
    params, opt_state = step.init()
    batch = make_batch(model.cfg, global_batch=2, seq_len=8, step=0)
    before = {n: t.detach().clone() for n, t in params.items()}
    with pytest.raises(RuntimeError, match="no backward pass"):
        step.step(params, opt_state, batch)
    assert all(torch.equal(params[n], t) for n, t in before.items())


@pytest.mark.parametrize("remat", ["block", "none"])
def test_remat_recomputes_each_layer(remat):
    """``remat="block"`` runs each layer's forward again in the backward
    pass, ``"none"`` does not; the gradients are the same."""
    grads = {}
    for mode in (remat, "none" if remat == "block" else "block"):
        model = build_model(get_smoke_config("glm4-9b", dtype="float32",
                                             remat=mode), "cpu")
        model.requires_grad_(True)
        calls = []
        for layer in model.layers:
            layer.register_forward_pre_hook(
                lambda mod, args: calls.append(1))
        batch = make_batch(model.cfg, global_batch=2, seq_len=8, step=0)
        loss = model.loss(batch)
        assert len(calls) == model.cfg.n_layers
        loss.backward()
        assert len(calls) == model.cfg.n_layers * (2 if mode == "block"
                                                   else 1)
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads["block"].items():
        assert torch.equal(g, grads["none"][n]), n


def test_serving_stays_frozen():
    """A model built for serving builds no autograd graph; only the train
    step turns its own model's gradients on."""
    cfg = get_smoke_config("glm4-9b")
    served, trained = build_model(cfg, "cpu"), build_model(cfg, "cpu")
    make_train_step(trained, OptConfig())
    assert all(p.requires_grad for p in trained.parameters())
    assert not any(p.requires_grad for p in served.parameters())
    sf = make_serve_fns(served)
    logits, _ = sf.prefill(np.zeros((1, 4), np.int64),
                           served.init_cache(1, 8))
    assert not logits.requires_grad
    logits, _ = served(np.zeros((1, 4), np.int64))
    assert logits.grad_fn is None
