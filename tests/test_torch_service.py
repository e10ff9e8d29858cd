"""Port parity for the slice as a whole: batched compile-time serving.

``tune_batch`` of the port (on the host, ``device="cpu"``) is held to the
reference's on a few TPC-H queries:

* oracle backend — fronts, θ, the WUN pick, batch statistics and the
  cache-hit taxonomy are exactly equal (same numpy arithmetic);
* model backend with the reference's trained smoke model carried across —
  fronts within rtol 1e-4 (float32 predictions summed in another order,
  see ``test_torch_models.py``), with any near-tie flip named;
* forced kernel routing (threshold 0) — equal to the reference's
  forced-kernel run, since both compare in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.moo import pareto as ref_pareto
from repro.core.moo.hmooc import HMOOCConfig as RefHMOOCConfig
from repro.queryengine.workloads import serving_stream as ref_stream
from repro.serve import ResponseCache as RefResponseCache
from repro.serve import TuningService as RefTuningService
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.queryengine.workloads import serving_stream
from repro_torch.serve import (EffectiveSetCache, ResponseCache,
                               TuningService, tune_batch)
from repro_torch.serve.cache import model_fingerprint

from test_torch_models import carry

CFG_KW = dict(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
              max_bank=12, seed=3)
FRONT_RTOL = 1e-4


def _streams(n=6, seed=5):
    return ref_stream("tpch", n, seed=seed), serving_stream("tpch", n,
                                                            seed=seed)


def _stats(svc):
    s = svc.last_batch
    return (s.n_queries, s.n_solved, s.n_deduped, s.n_cheap,
            s.n_default_theta)


def _assert_results_equal(a, b):
    np.testing.assert_array_equal(a.front, b.front)
    assert a.choice == b.choice
    for f in ("theta_c", "theta_p_sub", "theta_s_sub", "theta_p0",
              "theta_s0"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.n_evals == b.n_evals


@pytest.fixture
def restore_threshold():
    saved = ref_pareto._KERNEL_MIN_N, port_pareto._KERNEL_MIN_N
    yield
    ref_pareto._KERNEL_MIN_N, port_pareto._KERNEL_MIN_N = saved


@pytest.mark.parametrize("forced_kernel", [False, True])
def test_oracle_tune_batch_equal(forced_kernel, restore_threshold):
    if forced_kernel:
        ref_pareto._KERNEL_MIN_N = 0
        port_pareto._KERNEL_MIN_N = 0
    rq, pq = _streams()
    ref = RefTuningService(cfg=RefHMOOCConfig(**CFG_KW))
    port = TuningService(cfg=HMOOCConfig(**CFG_KW), device="cpu")
    degraded = [False, False, True, False, True, False]
    for kw in ({}, {"degraded": degraded}, {}):
        ra = ref.tune_batch(rq, (0.9, 0.1), **kw)
        rb = port.tune_batch(pq, (0.9, 0.1), **kw)
        for a, b in zip(ra, rb):
            _assert_results_equal(a, b)
        assert _stats(ref) == _stats(port)
        assert ref.cache.stats() == port.cache.stats()
        assert ref._results.stats() == port._results.stats()


def _model_tune_batch_close(smoke_perf_models, svc_kw, call_kw):
    ref_model = smoke_perf_models["subq"]
    port_model = carry(ref_model)
    assert model_fingerprint(port_model) == model_fingerprint(ref_model)
    rq, pq = _streams(6, seed=11)
    ref = RefTuningService(model=ref_model, cfg=RefHMOOCConfig(**CFG_KW),
                           **svc_kw)
    port = TuningService(model=port_model, cfg=HMOOCConfig(**CFG_KW),
                         device="cpu", **svc_kw)
    ra = ref.tune_batch(rq, (0.9, 0.1), **call_kw)
    rb = port.tune_batch(pq, (0.9, 0.1), **call_kw)
    assert _stats(ref) == _stats(port)
    assert ref.cache.stats() == port.cache.stats()
    assert ref._results.stats() == port._results.stats()
    for q, a, b in zip(pq, ra, rb):
        if a.front.shape != b.front.shape:
            pytest.fail(f"{q.qid}: front shape {b.front.shape} vs reference "
                        f"{a.front.shape} (a near-tie in float32 predictions "
                        "flipped a bank member)")
        margin = np.max(np.abs(a.front - b.front) / np.abs(a.front))
        assert margin <= FRONT_RTOL, \
            f"{q.qid}: fronts differ by relative {margin:.3g}"


def test_model_tune_batch_close(smoke_perf_models):
    _model_tune_batch_close(smoke_perf_models, {}, {})


# Service and call options, each held to the reference on both backends.
# Both streams hold one template in several parametric variants, so
# cross-variant bank reuse takes effect (within a batch on the model
# backend's lockstep path, across queries on the oracle backend's loop);
# the tenant ids split a repeated request across tenants and keep another
# within one.
OPTIONS = {
    "tenants": ({}, {"tenants": ["a", "b", "a", "a", "b", None]}),
    "reuse_banks_across_variants": (
        {"reuse_banks_across_variants": True}, {}),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_oracle_tune_batch_options_equal(option):
    svc_kw, call_kw = OPTIONS[option]
    rq, pq = _streams()
    ref = RefTuningService(cfg=RefHMOOCConfig(**CFG_KW), **svc_kw)
    port = TuningService(cfg=HMOOCConfig(**CFG_KW), device="cpu", **svc_kw)
    degraded = [False, True, False, False, True, False]
    for kw in (call_kw, {**call_kw, "degraded": degraded}, call_kw):
        ra = ref.tune_batch(rq, (0.9, 0.1), **kw)
        rb = port.tune_batch(pq, (0.9, 0.1), **kw)
        for a, b in zip(ra, rb):
            _assert_results_equal(a, b)
        assert _stats(ref) == _stats(port)
        assert ref.cache.stats() == port.cache.stats()
        assert ref._results.stats() == port._results.stats()


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_model_tune_batch_options_close(option, smoke_perf_models):
    svc_kw, call_kw = OPTIONS[option]
    _model_tune_batch_close(smoke_perf_models, svc_kw, call_kw)


def test_oracle_shared_response_cache_equal():
    """A response cache passed to two services serves the second from the
    first's solves, with the reference's hit counts."""
    rq, pq = _streams()
    sides = []
    for svc_cls, cfg_cls, cache_cls, kw, qs in (
            (RefTuningService, RefHMOOCConfig, RefResponseCache, {}, rq),
            (TuningService, HMOOCConfig, ResponseCache, {"device": "cpu"},
             pq)):
        shared = cache_cls()
        first = svc_cls(cfg=cfg_cls(**CFG_KW), response_cache=shared, **kw)
        second = svc_cls(cfg=cfg_cls(**CFG_KW), response_cache=shared, **kw)
        out = first.tune_batch(qs) + second.tune_batch(qs)
        assert second.last_batch.n_solved == 0
        sides.append((out, shared.stats(), _stats(first), _stats(second)))
    (ra, *ref_stats), (rb, *port_stats) = sides
    for a, b in zip(ra, rb):
        _assert_results_equal(a, b)
    assert ref_stats == port_stats


def test_tune_batch_function_and_device_errors():
    qs = serving_stream("tpch", 3, seed=1)
    res = tune_batch(qs, (0.5, 0.5), HMOOCConfig(**CFG_KW), device="cpu")
    assert [r.front.shape[1] for r in res] == [2, 2, 2]
    assert all(np.isfinite(r.front).all() for r in res)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TuningService(cfg=HMOOCConfig(**CFG_KW))


def test_cache_snapshot_restore_refreezes():
    qs = serving_stream("tpch", 4, seed=2)
    svc = TuningService(cfg=HMOOCConfig(**CFG_KW), device="cpu")
    svc.tune_batch(qs)
    blob = svc.cache.snapshot()
    fresh = EffectiveSetCache()
    assert fresh.restore(blob) == len(svc.cache)
    for entry in fresh._entries.values():
        assert not entry.eset.Uc.flags.writeable
        assert not entry.eset.pool.flags.writeable
        assert all(not idx.flags.writeable
                   for bank in entry.eset.opt_idx for idx in bank)
    svc2 = TuningService(cfg=HMOOCConfig(**CFG_KW), device="cpu",
                         cache=fresh, dedupe=False)
    warm = svc2.tune_batch(qs)
    cold = TuningService(cfg=HMOOCConfig(**CFG_KW), device="cpu",
                         dedupe=False).tune_batch(qs)
    for a, b in zip(warm, cold):
        np.testing.assert_array_equal(a.front, b.front)
    assert fresh.stats()["hits"] >= 1
