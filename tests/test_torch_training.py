"""Port parity: performance-model training (paper §6.1) against the
reference, on the host (``device="cpu"``), at the smoke size of
``conftest.build_smoke_perf_models`` (8 TPC-H queries, 6 configurations,
GTN d_model 16, 1 layer).

Seeded inits differ between ``jax.random`` and ``torch.Generator``, so
every model comparison starts from the reference's initial parameters
carried across (``train_model(init_params=...)``).  Tolerances, each set
from what this host measured:

* workloads, traces, splits and datasets: exactly equal (the same numpy);
* one batch's loss: rtol 1e-6 (measured ≤ 7.4e-8); its gradients: per
  leaf within 1e-5 of the leaf's largest |g| (measured ≤ 1.4e-6): float32
  sums in another order in XLA and ATen;
* AdamW: within rtol 2e-6 / atol 1e-7 after each of 3 updates (measured
  ≤ 6.7e-7 / 2.4e-7): torch takes the bias corrections in Python floats,
  the reference in float32;
* a 20-step trajectory (the subQ graphs and the padded L̄QP plans): every
  step's loss within rtol 2e-6 (measured ≤ 7.0e-7, growing about 3.5e-8 a
  step) and the final predictions within rtol 1e-4 in z-space
  (``TRAJECTORY_Z_RTOL``);
* ``evaluate``'s accuracy metrics on a carried model: within rtol 1e-5
  (``EVAL_RTOL``), throughput not compared;
* the Huber loss at and around |r| = 1: value and gradient exactly equal.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core.models import training as ref_training
from repro.core.models.nn import adamw_init, adamw_update
from repro.core.models.perf_model import PerfModel as RefPerfModel
from repro.queryengine import trace as ref_trace
from repro.queryengine import workloads as ref_workloads
from repro_torch.core.models import training
from repro_torch.core.models.nn import adamw
from repro_torch.core.models.perf_model import (TARGET_EPS, PerfModel, _Net,
                                                params_from_reference)
from repro_torch.queryengine import trace
from repro_torch.queryengine import workloads

from test_torch_models import carry, port_config

KINDS = ("subq", "qs", "lqp")
SMOKE_GTN = dict(d_model=16, n_heads=2, n_layers=1, d_ff=32)
LOSS_RTOL = 1e-6
GRAD_REL_TO_LEAF_MAX = 1e-5
ADAMW_RTOL, ADAMW_ATOL = 2e-6, 1e-7
TRAJECTORY_LOSS_RTOL = 2e-6
TRAJECTORY_Z_RTOL = 1e-4
EVAL_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def traces():
    """(reference traces, port traces) at the smoke size."""
    return (ref_trace.collect_traces(
                ref_workloads.default_workload("tpch", 2)[:8], 6, seed=0),
            trace.collect_traces(
                workloads.default_workload("tpch", 2)[:8], 6, seed=0))


def _smoke(ref_cfg):
    """(reference, port) configs cut to the smoke widths."""
    ref_cfg = dataclasses.replace(
        ref_cfg, gtn=dataclasses.replace(ref_cfg.gtn, **SMOKE_GTN),
        hidden=(16,))
    return ref_cfg, port_config(ref_cfg)


def _datasets(traces, kind):
    ref_ds, ref_cfg = ref_training.build_dataset(traces[0], kind)
    ds, cfg = training.build_dataset(traces[1], kind)
    assert cfg == port_config(ref_cfg)
    return ref_ds, ds, ref_cfg


def _carried_start(ref_cfg, seed):
    """The reference's seeded initial parameters, as port module state."""
    return params_from_reference(jax.tree_util.tree_map(
        np.asarray, RefPerfModel(ref_cfg, seed=seed).params))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bench,n", [("tpch", 2), ("tpcds", 1)])
def test_default_workload_equal(bench, n):
    a = ref_workloads.default_workload(bench, n, seed=1)
    b = workloads.default_workload(bench, n, seed=1)
    assert len(a) == len(b) == (22 if bench == "tpch" else 102) * n
    assert [dataclasses.asdict(q) for q in a] == \
        [dataclasses.asdict(q) for q in b]


def test_traces_and_splits_equal(traces):
    a, b = traces
    for f in dataclasses.fields(a):
        if f.name == "queries":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert (trace.ALPHA_DIM, trace.GAMMA_DIM) == \
        (ref_trace.ALPHA_DIM, ref_trace.GAMMA_DIM)
    for seed in (0, 3):
        sa, sb = a.split(seed=seed), b.split(seed=seed)
        assert sa.keys() == sb.keys()
        for k in sa:
            for x, y in zip(sa[k], sb[k]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_build_dataset_equal(traces, kind):
    ref_ds, ds, _ = _datasets(traces, kind)
    assert training._lqp_pad(traces[1]) == ref_training._lqp_pad(traces[0])
    for x, y in zip(ref_ds.graphs + (ref_ds.graph_id, ref_ds.theta,
                                     ref_ds.nond, ref_ds.y),
                    ds.graphs + (ds.graph_id, ds.theta, ds.nond, ds.y)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert ref_ds.masks.keys() == ds.masks.keys()
    for k in ds.masks:
        np.testing.assert_array_equal(ds.masks[k], ref_ds.masks[k])
        sub, ref_sub = ds.subset(k), ref_ds.subset(k)
        assert sub.n == ref_sub.n
        np.testing.assert_array_equal(sub.y, ref_sub.y)


@pytest.mark.parametrize("kind", KINDS)
def test_batch_loss_and_gradients_match(traces, kind):
    ref_ds, ds, ref_cfg = _datasets(traces, kind)
    ref_cfg, cfg = _smoke(ref_cfg)
    ref_model = RefPerfModel(ref_cfg, seed=0)
    ii = np.random.default_rng(0).choice(ds.n, 64)
    graphs = tuple(g[ds.graph_id[ii]] for g in ds.graphs)
    logy = np.log(np.maximum(ds.y, 0.0) + TARGET_EPS)
    stats = np.stack([logy.mean(0), np.maximum(logy.std(0), 1e-3)])
    z_mu, z_sd = jnp.asarray(stats[0]), jnp.asarray(stats[1])

    def ref_loss(p):        # the reference train_model's loss_fn
        pred = ref_model.apply_rows(p, graphs, ds.theta[ii], ds.nond[ii])
        z = (jnp.log(jnp.maximum(ds.y[ii], 0.0) + TARGET_EPS) - z_mu) / z_sd
        return ref_training._huber(pred - z).mean()

    want, grads = jax.jit(jax.value_and_grad(ref_loss))(ref_model.params)
    want_g = params_from_reference(jax.tree_util.tree_map(np.asarray, grads))
    net = _Net(cfg, torch.Generator().manual_seed(0))
    net.load_state_dict(_carried_start(ref_cfg, 0))
    loss = training._loss(net, tuple(_t(g) for g in graphs),
                          _t(ds.theta[ii]), _t(ds.nond[ii]),
                          training._z_targets(_t(ds.y[ii]),
                                              _t(stats.astype(np.float32))))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    names = dict(net.named_parameters())
    assert names.keys() == want_g.keys()
    for k, p in names.items():
        g = want_g[k].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=0,
            atol=GRAD_REL_TO_LEAF_MAX * np.abs(g).max(), err_msg=k)


def test_adamw_updates_match():
    rng = np.random.default_rng(0)
    P = {"a": {"w": rng.normal(size=(5, 3)), "b": rng.normal(size=3)},
         "c": rng.normal(size=4)}
    P = jax.tree_util.tree_map(lambda x: x.astype(np.float32), P)
    # Gradients over eight decades, the regime where Adam's first steps
    # are close to sign(g).
    G = [jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape)
                   * 10.0 ** rng.integers(-8, 1, size=x.shape)
                   ).astype(np.float32), P) for _ in range(3)]
    lrs = np.array([1e-3, 2e-3, 5e-4], np.float32)
    ref_p = jax.tree_util.tree_map(jnp.asarray, P)
    ref_state = adamw_init(ref_p)
    params = {k: torch.nn.Parameter(v) for k, v in
              params_from_reference(P).items()}
    opt = adamw(list(params.values()))
    for g, lr in zip(G, lrs):
        ref_p, ref_state = adamw_update(ref_p, g, ref_state, lr)
        grads = params_from_reference(g)
        for k, p in params.items():
            p.grad = grads[k]
        opt.param_groups[0]["lr"] = float(lr)
        opt.step()
        want = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                            ref_p))
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=ADAMW_RTOL, atol=ADAMW_ATOL)


class _RecordingJax:
    """``jax`` for the reference's training module, with a ``jit`` that
    records each step's loss, so its unmodified ``train_model`` reports
    the trajectory."""

    def __init__(self, losses):
        self.losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        step = jax.jit(fn)

        def recorded(*args):
            out = step(*args)
            self.losses.append(float(out[2]))
            return out
        return recorded


@pytest.mark.parametrize("kind,seed", [("subq", 0), ("lqp", 1)])
def test_trajectory_from_carried_start(traces, kind, seed, monkeypatch):
    ref_ds, ds, ref_cfg = _datasets(traces, kind)
    ref_cfg, cfg = _smoke(ref_cfg)
    ref_losses = []
    monkeypatch.setattr(ref_training, "jax", _RecordingJax(ref_losses))
    ref_model = ref_training.train_model(ref_ds, ref_cfg, steps=20,
                                         batch=128, seed=seed)
    monkeypatch.undo()
    model = training.train_model(ds, cfg, steps=20, batch=128, seed=seed,
                                 init_params=_carried_start(ref_cfg, seed),
                                 device="cpu")
    assert model.device.type == "cpu" and len(ref_losses) == 20
    np.testing.assert_array_equal(model.target_stats, ref_model.target_stats)
    np.testing.assert_allclose(model.train_losses, ref_losses,
                               rtol=TRAJECTORY_LOSS_RTOL)
    ii = np.arange(0, ds.n, 3)
    graphs = tuple(g[ds.graph_id[ii]] for g in ds.graphs)
    want = np.asarray(ref_model.apply_rows(ref_model.params, graphs,
                                           ds.theta[ii], ds.nond[ii]))
    got = model.apply_rows(graphs, ds.theta[ii], ds.nond[ii])
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_Z_RTOL,
                               atol=TRAJECTORY_Z_RTOL)


@pytest.mark.parametrize("kind", ["subq", "qs"])
def test_evaluate_on_carried_model(traces, kind, smoke_perf_models):
    ref_model = smoke_perf_models[kind]
    ref_ds, ds, _ = _datasets(traces, kind)
    want = ref_training.evaluate(ref_model, ref_ds)
    got = training.evaluate(carry(ref_model), ds)
    for f in ("wmape", "p50", "p90", "corr"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=EVAL_RTOL, err_msg=f)
    assert got.xput > 0 and got.row(0).startswith("WMAPE=")


def test_train_all_models_trains_each_kind(traces):
    out = training.train_all_models(traces[1], steps=4, lqp_steps=2,
                                    device="cpu")
    assert list(out) == list(KINDS)
    for kind, (model, ds, met) in out.items():
        assert model.cfg.kind == kind and model.device.type == "cpu"
        assert model.train_losses.shape == ((2,) if kind == "lqp" else (4,))
        assert met.wmape.shape == met.corr.shape == (2,)
        assert ds.n == (traces[1].q_query_idx.size if kind == "lqp"
                        else traces[1].query_idx.size)


def test_evaluate_caps_rows(traces, smoke_perf_models):
    ref_model = smoke_perf_models["subq"]
    ref_ds, ds, _ = _datasets(traces, "subq")
    want = ref_training.evaluate(ref_model, ref_ds, split="train",
                                 max_rows=50)
    got = training.evaluate(carry(ref_model), ds, split="train", max_rows=50)
    for f in ("wmape", "p50", "p90", "corr"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=EVAL_RTOL, err_msg=f)


@pytest.mark.parametrize("r", [-1.5, -1.0, -np.nextafter(1, 0), -0.25, 0.0,
                               0.25, np.nextafter(1, 0), 1.0,
                               np.nextafter(1, 2), 1.5])
def test_huber_edge_matches_reference(r):
    pred = torch.tensor([[r]], dtype=torch.float32, requires_grad=True)
    loss = training._loss(lambda *a: pred, (), None, None,
                          torch.zeros((1, 1)))
    loss.backward()
    x = jnp.float32(r)
    want, want_g = jax.value_and_grad(
        lambda v: ref_training._huber(v).mean())(x)
    assert loss.item() == float(want)
    assert pred.grad.item() == float(want_g)


def test_compile_stats_keys(smoke_perf_models):
    model = carry(smoke_perf_models["subq"])
    want = smoke_perf_models["subq"].compile_stats()
    model.predict_rows(np.zeros((3, 16), np.float32),
                       np.zeros((3, 19), np.float32),
                       np.zeros((3, 12), np.float32))
    got = model.compile_stats()
    assert got.keys() == want.keys()
    assert got["head_buckets"] == [(64, 19)]
    assert got["head_compiles"] == got["embed_compiles"] == -1


# Run in a process where importing JAX or the reference package fails: the
# port collects traces, trains its own smoke models and serves with them.
_PORT_ONLY = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.core.models.gtn import GTNConfig
from repro_torch.core.models.training import build_dataset, train_model
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.core.tuning.spark_space import (theta_c_space,
                                                 theta_p_space, theta_s_space)
from repro_torch.queryengine.trace import collect_traces
from repro_torch.queryengine.workloads import default_workload, serving_stream
from repro_torch.serve import RuntimeSession, TuningService
import dataclasses
traces = collect_traces(default_workload("tpch", 2)[:8], 6, seed=0)
models, losses = {}, {}
for kind, seed in (("subq", 0), ("qs", 1)):
    ds, cfg = build_dataset(traces, kind)
    cfg = dataclasses.replace(cfg, gtn=GTNConfig(d_model=16, n_heads=2,
                              n_layers=1, d_ff=32), hidden=(16,))
    models[kind] = train_model(ds, cfg, steps=40, batch=128, seed=seed,
                               device="cpu")
    losses[kind] = models[kind].train_losses.tolist()
queries = serving_stream("tpch", 4, seed=2)
cfg = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                  max_bank=12, seed=3)
cts = TuningService(model=models["subq"], cfg=cfg,
                    device="cpu").tune_batch(queries, (0.9, 0.1))
rts = RuntimeSession(model_subq=models["subq"], model_qs=models["qs"],
                     weights=(0.9, 0.1), device="cpu").run_batch(queries, cts)
spaces = (theta_c_space(), theta_p_space(), theta_s_space())
def inside(space, raw):
    lo = np.array([p.lo for p in space.params])
    hi = np.array([p.hi for p in space.params])
    return bool(np.isfinite(raw).all() and (raw >= lo).all()
                and (raw <= hi).all())
out = {"losses": losses, "ct": [], "rt": []}
for q, ct, rt in zip(queries, cts, rts):
    out["ct"].append({
        "m": q.n_subqs, "front": ct.front.tolist(), "choice": ct.choice,
        "rows": [ct.theta_p_sub.shape[0], ct.theta_s_sub.shape[0]],
        "inside": [inside(s, r) for s, r in zip(
            spaces, (ct.theta_c[None], ct.theta_p_sub, ct.theta_s_sub))]})
    out["rt"].append({
        "shapes": [list(rt.theta_p_eff.shape), list(rt.theta_s_eff.shape)],
        "inside": [inside(spaces[1], rt.theta_p_eff),
                   inside(spaces[2], rt.theta_s_eff)],
        "latency": rt.sim.actual_latency.tolist()})
print(json.dumps(out))
"""


def test_port_trains_its_own_models_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PORT_ONLY], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for kind, losses in out["losses"].items():
        losses = np.array(losses)
        assert losses.shape == (40,) and np.isfinite(losses).all(), kind
        assert losses[-10:].mean() < losses[:10].mean(), kind
    for ct in out["ct"]:
        front = np.array(ct["front"])
        assert front.ndim == 2 and front.shape[0] >= 1 \
            and front.shape[1] == 2 and np.isfinite(front).all()
        assert 0 <= ct["choice"] < front.shape[0]
        assert ct["rows"] == [ct["m"], ct["m"]] and all(ct["inside"])
    for ct, rt in zip(out["ct"], out["rt"]):
        assert rt["shapes"] == [[ct["m"], 9], [ct["m"], 2]]
        assert all(rt["inside"])
        assert np.isfinite(rt["latency"]).all() and rt["latency"][0] > 0


@pytest.mark.slow
def test_model_trains_and_roundtrips(tmp_path):
    queries = workloads.default_workload("tpch", 2)[:24]
    traces = trace.collect_traces(queries, 12, seed=0)
    ds, cfg = training.build_dataset(traces, "subq")
    m = training.train_model(ds, cfg, steps=150, batch=256, seed=0,
                             device="cpu")
    assert m.train_losses[-20:].mean() < m.train_losses[:20].mean()
    met = training.evaluate(m, ds, split="test")
    assert met.corr[0] > 0.5          # latency correlates after brief training
    assert met.corr[1] > 0.8          # IO is easier (paper Table 3)
    assert met.xput > 1e4
    path = str(tmp_path / "model.npz")
    m.save(path)
    m2 = PerfModel.load(cfg, path, device="cpu")
    emb = m.embed(traces.queries[0], 0)
    theta = np.random.default_rng(0).random((8, cfg.theta_dim),
                                            ).astype(np.float32)
    nond = np.zeros(12, np.float32)
    np.testing.assert_allclose(m.predict(emb, theta, nond),
                               m2.predict(emb, theta, nond), rtol=1e-5)
