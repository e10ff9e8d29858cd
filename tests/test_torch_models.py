"""Port parity: the performance model (GTN embedder + MLP head).

Seeded inits differ between ``jax.random`` and ``torch.Generator``, so
every comparison carries the reference's weights across, by
``params_from_reference`` and by the reference's ``save`` npz read with
the port's ``PerfModel.load``.  Tolerance: rtol 1e-5 and atol 1e-5 in
z-space (the regressor's output space), because float32 sums run in
another order in XLA and ATen.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core.models.perf_model import ModelConfig as RefModelConfig
from repro.core.models.perf_model import PerfModel as RefPerfModel
from repro.queryengine.workloads import make_benchmark as ref_make_benchmark
from repro_torch.core.models.gtn import GTNConfig
from repro_torch.core.models.perf_model import (ModelConfig, PerfModel,
                                                params_from_reference,
                                                pow2_bucket)
from repro_torch.queryengine.workloads import make_benchmark

RTOL = ATOL = 1e-5


def port_config(cfg) -> ModelConfig:
    return ModelConfig(cfg.kind, cfg.theta_dim,
                       gtn=GTNConfig(**dataclasses.asdict(cfg.gtn)),
                       hidden=tuple(cfg.hidden), n_targets=cfg.n_targets)


def carry(ref_model, device="cpu") -> PerfModel:
    """The reference model's weights in a port model."""
    tree = jax.tree_util.tree_map(np.asarray, ref_model.params)
    return PerfModel(port_config(ref_model.cfg),
                     params=params_from_reference(tree),
                     target_stats=ref_model.target_stats, device=device)


def carry_npz(ref_model, path, device="cpu") -> PerfModel:
    ref_model.save(str(path))
    return PerfModel.load(port_config(ref_model.cfg), str(path),
                          device=device)


@pytest.fixture(scope="module", params=["subq", "qs", "smoke_subq",
                                        "smoke_qs"])
def ref_model(request):
    name = request.param
    if name.startswith("smoke_"):
        models = request.getfixturevalue("smoke_perf_models")
        return models[name[len("smoke_"):]]
    theta_dim = 19 if name == "subq" else 10
    return RefPerfModel(RefModelConfig(name, theta_dim), seed=7)


def _z(model, y):
    return model.to_z(np.asarray(y, np.float64))


def _rows(n, theta_dim, emb_pool, seed):
    rng = np.random.default_rng(seed)
    theta = rng.random((n, theta_dim)).astype(np.float32)
    nond = rng.random((n, 12)).astype(np.float32)
    emb = emb_pool[rng.integers(0, len(emb_pool), n)]
    return emb, theta, nond


@pytest.mark.parametrize("route", ["params", "npz"])
def test_model_matches_reference(ref_model, route, tmp_path):
    port = carry(ref_model) if route == "params" \
        else carry_npz(ref_model, tmp_path / "m.npz")
    # Identical weights in the reference's leaf order → identical hash.
    assert port.fingerprint() == ref_model.fingerprint()
    rq = ref_make_benchmark("tpch")[:5]
    pq = make_benchmark("tpch")[:5]
    pairs_r = [(q, i) for q in rq for i in range(q.n_subqs)]
    pairs_p = [(q, i) for q in pq for i in range(q.n_subqs)]
    # embed (one graph per dispatch) and embed_many (one padded batch).
    ref_e = np.stack([ref_model.embed(q, i) for q, i in pairs_r])
    port_e = np.stack([port.embed(q, i) for q, i in pairs_p])
    np.testing.assert_allclose(port_e, ref_e, rtol=RTOL, atol=ATOL)
    fresh = carry(ref_model)
    fresh.embed_many(pairs_p)
    many = np.stack([fresh.embed(q, i) for q, i in pairs_p])
    np.testing.assert_allclose(many, ref_e, rtol=RTOL, atol=ATOL)
    # predict (one broadcast embedding) and predict_rows (per-row, padded).
    emb, theta, nond = _rows(37, ref_model.cfg.theta_dim, ref_e, seed=1)
    np.testing.assert_allclose(
        _z(port, port.predict(emb[0], theta, nond[0])),
        _z(ref_model, ref_model.predict(emb[0], theta, nond[0])),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _z(port, port.predict_rows(emb, theta, nond)),
        _z(ref_model, ref_model.predict_rows(emb, theta, nond)),
        rtol=RTOL, atol=ATOL)


def test_predict_rows_chunked_matches_reference(ref_model, monkeypatch):
    """Calls above REPRO_HEAD_MAX_BUCKET split into capped chunks."""
    monkeypatch.setenv("REPRO_HEAD_MAX_BUCKET", "64")
    port = carry(ref_model)
    pool = np.random.default_rng(4).random((5, ref_model.cfg.gtn.d_model))
    emb, theta, nond = _rows(150, ref_model.cfg.theta_dim,
                             pool.astype(np.float32), seed=2)
    got = port.predict_rows(emb, theta, nond)
    np.testing.assert_allclose(
        _z(port, got), _z(ref_model, ref_model.predict_rows(emb, theta, nond)),
        rtol=RTOL, atol=ATOL)
    assert port.head_buckets == {(64, ref_model.cfg.theta_dim)}


def test_predict_rows_padding_is_row_independent():
    """Inside the port: a row's output does not depend on the bucket it was
    padded into (the reference is not bit-equal here on its XLA build)."""
    port = PerfModel(ModelConfig("subq", 19), seed=5, device="cpu")
    pool = np.random.default_rng(6).random((4, 48)).astype(np.float32)
    emb, theta, nond = _rows(100, 19, pool, seed=3)
    full = port.predict_rows(emb, theta, nond)           # bucket 128
    for lo, hi in [(0, 1), (3, 67), (90, 100)]:
        part = port.predict_rows(emb[lo:hi], theta[lo:hi], nond[lo:hi])
        np.testing.assert_allclose(_z(port, part), _z(port, full[lo:hi]),
                                   rtol=RTOL, atol=ATOL)
    assert {b for b, _ in port.head_buckets} == {128, 64}
    assert pow2_bucket(67) == 128 and pow2_bucket(1) == 64


def test_port_save_load_roundtrip(tmp_path):
    a = PerfModel(ModelConfig("qs", 10), seed=2, device="cpu")
    a.save(str(tmp_path / "q.npz"))
    b = PerfModel.load(ModelConfig("qs", 10), str(tmp_path / "q.npz"),
                       device="cpu")
    assert a.fingerprint() == b.fingerprint()
    c = PerfModel(ModelConfig("qs", 10), seed=3, device="cpu")
    assert a.fingerprint() != c.fingerprint()


def test_model_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerfModel(ModelConfig("subq", 19))
