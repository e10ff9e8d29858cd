"""Port parity: the training inputs — the token pipeline, the WSD schedule,
one AdamW update — and the elastic plans.

The same seeded numpy inputs go through the reference (``repro.data``,
``repro.train``) and the port (``repro_torch.data``, ``repro_torch.train``).

Tolerances: batches, mesh plans and shard assignments exactly equal; the
learning rate within 1 ulp of float32 at every step of two schedules; one
``opt_update`` within rtol 1e-6, bfloat16 moments and parameters too
(float32 arithmetic in the same order; XLA and PyTorch may fuse a product
and a sum).
"""
import itertools

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.data.pipeline as ref_pipeline
import repro.train.checkpoint as ref_checkpoint
import repro.train.elastic as ref_elastic
import repro.train.optimizer as ref_optimizer
import repro.train.train_loop as ref_train_loop
from repro.archs.registry import get_smoke_config as ref_smoke
from repro_torch.archs.lm import params_from_reference
from repro_torch.archs.registry import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.train import checkpoint, elastic, optimizer, train_loop

UPDATE_RTOL = 1e-6


@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_make_batch_bit_equal(family):
    """Every (seed, step, host, n_hosts) of a grid; the vlm and audio
    families draw their patches after the tokens."""
    over = dict(family=family, n_patches=3, enc_seq=5)
    rcfg, cfg = ref_smoke("glm4-9b").with_(**over), \
        get_smoke_config("glm4-9b", **over)
    for seed, step, (host, n_hosts) in itertools.product(
            (0, 7), (0, 3, 1000), ((0, 1), (0, 2), (1, 2), (3, 4))):
        kw = dict(global_batch=8, seq_len=16, step=step, seed=seed,
                  host=host, n_hosts=n_hosts)
        want = ref_pipeline.make_batch(rcfg, **kw)
        got = pipeline.make_batch(cfg, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="split"):
        pipeline.make_batch(cfg, global_batch=6, seq_len=4, step=0,
                            n_hosts=4)


def test_data_iterator_bit_equal():
    kw = dict(global_batch=4, seq_len=32, seed=3, host=1, n_hosts=2,
              start_step=5)
    want = ref_pipeline.data_iterator(ref_smoke("minicpm-2b"), **kw)
    got = pipeline.data_iterator(get_smoke_config("minicpm-2b"), **kw)
    for _ in range(4):
        a, b = next(want), next(got)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("sched", [dict(lr=1e-3, total_steps=100,
                                        warmup_steps=10),
                                   dict(lr=3e-3, total_steps=30,
                                        warmup_steps=3, decay_frac=0.25)])
def test_wsd_schedule_within_one_ulp(sched):
    steps = np.arange(sched["total_steps"] + 2, dtype=np.int32)
    want = np.asarray(ref_optimizer.wsd_schedule(
        ref_optimizer.OptConfig(**sched), jnp.asarray(steps)))
    got = optimizer.wsd_schedule(optimizer.OptConfig(**sched),
                                 torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def _opt_case(moment_dtype, clip_active, seed=0):
    """A small reference-layout tree (a stacked layer leaf in float32 and
    one in bfloat16), its gradients and a state 4 steps in."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (10, 8), "norm_f": (8,),
              "layers": {"ln_attn": (3, 8), "attn": {"wq": (3, 8, 8)}}}

    def tree(fn):
        return jax.tree.map(fn, shapes, is_leaf=lambda s: isinstance(s, tuple))

    params = tree(lambda s: rng.normal(0, 0.3, s).astype(np.float32))
    params["layers"]["attn"]["wq"] = params["layers"]["attn"]["wq"].astype(
        ml_dtypes.bfloat16)
    size = 10.0 if clip_active else 0.01
    grads = tree(lambda s: rng.normal(0, size / 16, s).astype(np.float32))
    mdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[
        moment_dtype]
    m = tree(lambda s: rng.normal(0, 0.01, s).astype(mdt))
    v = tree(lambda s: rng.uniform(0, 1e-3, s).astype(mdt))
    return params, grads, {"m": m, "v": v, "step": np.int32(4)}


@pytest.mark.parametrize("clip_active", [True, False])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_opt_update_matches_reference(moment_dtype, clip_active):
    params, grads, state = _opt_case(moment_dtype, clip_active)
    rcfg = ref_optimizer.OptConfig(lr=1e-2, total_steps=20, warmup_steps=3,
                                   moment_dtype=moment_dtype)
    want_p, want_s, want_m = ref_optimizer.opt_update(
        *jax.tree.map(jnp.asarray, (params, grads, state)), rcfg)
    pp = params_from_reference(params)
    ps = optimizer.opt_state_from_reference(state)
    got_p, got_s, got_m = optimizer.opt_update(
        pp, params_from_reference(grads), ps,
        optimizer.OptConfig(**rcfg.__dict__))
    assert got_p is pp                                   # in place
    gnorm = float(want_m["grad_norm"])
    assert (gnorm > 1.0) == clip_active
    assert abs(float(got_m["grad_norm"]) - gnorm) <= UPDATE_RTOL * gnorm
    assert float(got_m["lr"]) == float(want_m["lr"])
    assert int(got_s["step"]) == int(want_s["step"]) == 5
    want_p, want_s = jax.tree.map(np.asarray, (want_p, want_s))
    for what, got, want in (("params", got_p, want_p),
                            ("m", got_s["m"], want_s["m"]),
                            ("v", got_s["v"], want_s["v"])):
        want = params_from_reference(want)
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].dtype == want[n].dtype, (what, n)
            np.testing.assert_allclose(
                got[n].float().numpy(), want[n].float().numpy(),
                rtol=UPDATE_RTOL, atol=0, err_msg=f"{what} {n}")


def test_opt_state_round_trips_through_reference_layout():
    _, _, state = _opt_case("bfloat16", True)
    port = optimizer.opt_state_from_reference(state)
    back = optimizer.opt_state_to_reference(port)
    again = optimizer.opt_state_from_reference(back)
    for key in ("m", "v"):
        for n, t in port[key].items():
            assert again[key][n].dtype == torch.bfloat16
            assert torch.equal(again[key][n].view(torch.int16),
                               t.view(torch.int16))
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 4


def test_elastic_plans_equal_reference():
    for n, prefer in itertools.product(range(1, 300), (1, 2, 4, 16, 32)):
        assert elastic.plan_elastic_mesh(n, prefer_model=prefer) == \
            ref_elastic.plan_elastic_mesh(n, prefer_model=prefer)
    for n_shards, n_hosts in itertools.product(range(1, 25), range(1, 7)):
        hosts = list(range(n_hosts))
        for k in range(n_hosts):
            for stragglers in itertools.combinations(hosts, k):
                assert elastic.assign_data_shards(
                    n_shards, hosts, stragglers) == \
                    ref_elastic.assign_data_shards(n_shards, hosts,
                                                   stragglers)
    with pytest.raises(ValueError, match="healthy"):
        elastic.assign_data_shards(4, [0, 1], [0, 1])


@pytest.mark.parametrize("port,ref", [
    (pipeline, ref_pipeline), (optimizer, ref_optimizer),
    (train_loop, ref_train_loop), (checkpoint, ref_checkpoint),
    (elastic, ref_elastic)])
def test_public_names_are_the_reference(port, ref):
    """Every public name of the reference's module; ``reshard_state``
    needs a mesh and comes with sharding across cards."""
    want = set(ref.__all__) - {"reshard_state"}
    assert want <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
