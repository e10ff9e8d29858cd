"""Port parity for the streaming server: ``OptimizerServer.serve``.

* Oracle backend under a ``ServiceTimeModel``: the admission timeline is
  a pure function of the stream and the config, so the port's serve must
  equal the reference's exactly — statuses, every lifecycle time, the
  charged flush windows and caps, per-tenant slots, the scheduler's
  reserves, θ and the objectives, and the latency report — on a
  single-tenant stream, a multi-tenant one, an overloaded one with all
  three SLO classes and a token bucket, and an elastic scenario with
  capacity events.
* The golden invariant inside the port: served plans equal the port's own
  offline ``tune_batch`` → ``RuntimeSession.run_batch`` pipeline exactly,
  however the stream is sliced (one at a time, micro-batches, shuffled,
  joining a running session), on every scenario of the matrix and under
  overload.
* Model backend: the reference's trained smoke models carried into the
  port; served plans equal the port's offline pipeline exactly, and the
  reference's served plans within rtol 1e-4 (float32 sums in another
  order in XLA and ATen).
* Port alone: a subprocess where ``import jax`` and ``import repro`` fail
  serves a short multi-tenant stream on the host.
"""
import dataclasses
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as ref_serve
from repro.core.moo.hmooc import HMOOCConfig as RefHMOOCConfig
from repro.queryengine import scenarios as ref_sc
from repro.queryengine import workloads as ref_wl
import repro_torch.serve as port_serve
from repro_torch.core.moo import hmooc as port_hmooc
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.queryengine import scenarios as port_sc
from repro_torch.queryengine import workloads as port_wl
from repro_torch.serve import (CandidatePoolCache, OptimizerServer,
                               RuntimeSession, ServerConfig,
                               ServiceTimeModel, TuningService, jain_index)

from test_torch_models import carry

CFG_KW = dict(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
              max_bank=12, seed=3)
CFG = HMOOCConfig(**CFG_KW)
WEIGHTS = (0.9, 0.1)
CPU = "cpu"
CLOCK_KW = dict(flush_points=((1, 0.05), (4, 0.12), (8, 0.2)),
                round_s=0.005, cheap_s=0.001)
MODEL_RTOL = 1e-4

REF = types.SimpleNamespace(wl=ref_wl, sc=ref_sc, serve=ref_serve,
                            cfg=RefHMOOCConfig(**CFG_KW), kw={})
PORT = types.SimpleNamespace(wl=port_wl, sc=port_sc, serve=port_serve,
                             cfg=CFG, kw={"device": CPU})


# ---------------------------------------------------------------------------
# Streams of each kind, built in either package from the same seeds
# ---------------------------------------------------------------------------

def _single(m):
    reqs = m.wl.serving_stream("tpch", 14, seed=1,
                               arrivals=m.wl.ArrivalModel(rate_qps=40.0))
    return reqs, (), dict(max_batch=4), ()


def _multi_tenant(m):
    A = m.wl.ArrivalModel
    specs = [m.wl.TenantSpec(name="lat", weights=(0.9, 0.1), share=2.0,
                             arrivals=A(kind="poisson", rate_qps=30.0)),
             m.wl.TenantSpec(name="bal", weights=(0.5, 0.5), priority=1,
                             arrivals=A(kind="poisson", rate_qps=20.0)),
             m.wl.TenantSpec(name="cost", weights=(0.1, 0.9),
                             solve_budget_s=0.5,
                             arrivals=A(kind="uniform", rate_qps=10.0))]
    reqs = m.wl.multi_tenant_stream("tpch", specs, 4, seed=8)
    return reqs, specs, dict(max_batch=4), ()


def _overload(m):
    A = m.wl.ArrivalModel
    specs = [m.wl.TenantSpec(name="strict", slo="strict", priority=1,
                             solve_budget_s=0.2,
                             arrivals=A(kind="poisson", rate_qps=60.0)),
             m.wl.TenantSpec(name="deg", slo="degrade", weights=(0.5, 0.5),
                             solve_budget_s=0.2,
                             arrivals=A(kind="poisson", rate_qps=60.0)),
             m.wl.TenantSpec(name="be", weights=(0.1, 0.9),
                             rate_limit_qps=20.0, rate_limit_burst=2.0,
                             arrivals=A(kind="poisson", rate_qps=60.0))]
    reqs = m.wl.multi_tenant_stream("tpch", specs, 6, seed=13)
    return reqs, specs, dict(max_batch=4), ()


def _elastic(m):
    spec = [s for s in m.sc.scenario_matrix(n_per_tenant=4, rate_qps=40.0)
            if s.name == "flash_crowd-churn"][0]
    sc = spec.build(seed=9)
    # A faster clock than the other streams', so flushes land inside the
    # capacity dip of the churn timeline.
    clock = m.serve.ServiceTimeModel(
        flush_points=((1, 0.01), (4, 0.03), (16, 0.1)), round_s=0.002,
        cheap_s=0.0005)
    cfg = dict(max_batch=4, solve_budget_s=0.5, clock=clock,
               elastic=m.serve.ElasticPolicy(min_batch=1, max_batch=16,
                                             target_delay_s=0.1))
    return sc.requests, sc.tenants, cfg, sc.capacity_events


STREAMS = {"single": _single, "multi_tenant": _multi_tenant,
           "overload": _overload, "elastic": _elastic}


def _clocked_serve(m, kind):
    reqs, tenants, cfg, cap_events = STREAMS[kind](m)
    cfg.setdefault("clock", m.serve.ServiceTimeModel(**CLOCK_KW))
    srv = m.serve.OptimizerServer(
        config=m.serve.ServerConfig(**cfg), weights=WEIGHTS, cfg=m.cfg,
        tenants=tenants, **m.kw)
    served = srv.serve(reqs, capacity_events=cap_events)
    return srv, served


def _timeline(srv, served):
    st = srv.last_run
    rows = [(s.rid, s.tenant, s.status, s.arrival_s, s.admitted_s,
             s.compiled_s, s.finished_s, s.joined_running, s.worker)
            for s in served]
    # ``trace`` is the port's own (spans on the wall clock; None here).
    stats = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
             if f.name not in ("wall_time_s", "tune_windows", "trace")}
    reserves = [(t.name, t.reserve_q_s, t.deficit, t.slots_granted,
                 t.n_shed, t.n_degraded, t.n_rate_limited)
                for t in srv.scheduler.states()]
    return repr((rows, stats, reserves, srv.scheduler.default_reserve_q_s))


def _assert_ct_equal(a, b):
    np.testing.assert_array_equal(a.front, b.front)
    assert a.choice == b.choice
    for f in ("theta_c", "theta_p_sub", "theta_s_sub", "theta_p0",
              "theta_s0"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _assert_result_equal(got, ref):
    np.testing.assert_array_equal(got.theta_p_eff, ref.theta_p_eff)
    np.testing.assert_array_equal(got.theta_s_eff, ref.theta_s_eff)
    np.testing.assert_array_equal(got.final_join, ref.final_join)
    for f in ("ana_latency", "actual_latency", "io_gb", "cost"):
        np.testing.assert_array_equal(getattr(got.sim, f),
                                      getattr(ref.sim, f))
    assert (got.requests_sent, got.requests_total) == \
        (ref.requests_sent, ref.requests_total)


@pytest.fixture(scope="module", params=sorted(STREAMS))
def clocked(request):
    """(kind, reference server and served, port server and served)."""
    return (request.param, *_clocked_serve(REF, request.param),
            *_clocked_serve(PORT, request.param))


def test_clocked_serve_equal(clocked):
    kind, rsrv, rserved, psrv, pserved = clocked
    assert _timeline(psrv, pserved) == _timeline(rsrv, rserved)
    for a, b in zip(rserved, pserved):
        assert (a.ct is None) == (b.ct is None)
        assert (a.result is None) == (b.result is None)
        if b.ct is not None:
            _assert_ct_equal(b.ct, a.ct)
        if b.result is not None:
            _assert_result_equal(b.result, a.result)
    statuses = {s.status for s in pserved}
    want = {"single": {"served"}, "multi_tenant": {"served"},
            "overload": {"served", "shed", "degraded", "rate_limited"},
            "elastic": {"served", "shed", "degraded"}}
    assert statuses == want[kind]
    if kind == "elastic":
        assert max(psrv.last_run.flush_caps) > 4       # the controller scaled
        assert min(psrv.last_run.flush_caps) < 4       # the capacity dip


def test_clocked_latency_report_equal(clocked):
    _, rsrv, rserved, psrv, pserved = clocked
    span = max(s.arrival_s for s in pserved) - min(s.arrival_s
                                                   for s in pserved)
    for kw in ({}, {"window_s": span / 3 + 1e-9}):
        rep = psrv.latency_report(pserved, **kw)
        assert repr(rep) == repr(rsrv.latency_report(rserved, **kw))
    # A report over one tenant's slice is the reference's too.
    t = pserved[0].tenant
    assert repr(psrv.latency_report([s for s in pserved if s.tenant == t])) \
        == repr(rsrv.latency_report([s for s in rserved if s.tenant == t]))


def test_clocked_serve_replays_identically(clocked):
    """Two clocked serves of one stream agree on every timestamp."""
    kind, _, _, psrv, pserved = clocked
    again, served2 = _clocked_serve(PORT, kind)
    assert _timeline(again, served2) == _timeline(psrv, pserved)
    for w, n in psrv.last_run.flush_windows:
        assert any(w == psrv.config.clock.flush_s(n, k)
                   for k in range(n + 1))


# ---------------------------------------------------------------------------
# The golden invariant inside the port (oracle backend, measured wall time)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def timed_stream():
    return port_wl.serving_stream("tpch", 14, seed=1,
                                  arrivals=port_wl.ArrivalModel(
                                      kind="poisson", rate_qps=40.0))


def _offline(queries, weights=WEIGHTS, model=None, model_qs=None):
    cts = TuningService(model=model, cfg=CFG, device=CPU).tune_batch(
        queries, weights)
    return RuntimeSession(model_subq=model, model_qs=model_qs,
                          weights=weights, device=CPU).run_batch(queries,
                                                                 cts)


@pytest.fixture(scope="module")
def offline(timed_stream):
    return _offline([r.query for r in timed_stream])


def _shuffled(stream, seed):
    rng = np.random.default_rng(seed)
    times = np.sort([r.arrival_s for r in stream])
    perm = rng.permutation(len(stream))
    return sorted((dataclasses.replace(r, arrival_s=float(times[perm[i]]))
                   for i, r in enumerate(stream)),
                  key=lambda r: r.arrival_s)


SLICINGS = {
    "one_at_a_time": (dict(max_batch=1), lambda s: s),
    "micro_batches": (dict(max_batch=4), lambda s: s),
    "shuffled": (dict(max_batch=5), lambda s: _shuffled(s, 7)),
    "mid_session": (dict(max_batch=10, solve_reserve_s=0.0),
                    lambda s: [dataclasses.replace(
                        r, arrival_s=0.0 if r.rid < 10 else 1e-4)
                        for r in s]),
}


@pytest.mark.parametrize("slicing", sorted(SLICINGS))
def test_golden_invariant(slicing, timed_stream, offline):
    cfg_kw, make = SLICINGS[slicing]
    srv = OptimizerServer(config=ServerConfig(**cfg_kw), weights=WEIGHTS,
                          cfg=CFG, device=CPU)
    served = {s.rid: s for s in srv.serve(make(timed_stream))}
    for r, ref in zip(timed_stream, offline):
        _assert_result_equal(served[r.rid].result, ref)
    for s in served.values():
        assert s.arrival_s <= s.admitted_s <= s.compiled_s <= s.finished_s
    if slicing == "mid_session":
        assert srv.last_run.n_joined_running >= 1
    if slicing == "one_at_a_time":
        assert srv.last_run.n_micro_batches == len(timed_stream)


def test_repeat_serve_shares_caches(timed_stream, offline):
    srv = OptimizerServer(config=ServerConfig(max_batch=4), weights=WEIGHTS,
                          cfg=CFG, device=CPU)
    first = srv.serve(timed_stream)
    misses = srv.tuning._results.misses
    second = srv.serve(timed_stream)
    for a, b, ref in zip(first, second, offline):
        _assert_result_equal(a.result, ref)
        _assert_result_equal(b.result, ref)
    assert srv.tuning._results.misses == misses
    assert srv.session.pool_cache.misses == 1


def test_overload_survivors_and_cheap_path(monkeypatch):
    """Under overload the survivors equal the offline pipeline under their
    tenant's weights, and the degraded requests never run Algorithm 1."""
    reqs, specs, cfg, _ = _overload(PORT)
    calls = []
    orig = port_hmooc._optimize_rep_banks
    srv = OptimizerServer(
        config=ServerConfig(clock=ServiceTimeModel(**CLOCK_KW), **cfg),
        weights=WEIGHTS, cfg=CFG, tenants=specs, device=CPU)
    monkeypatch.setattr(port_hmooc, "_optimize_rep_banks",
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    served = srv.serve(reqs)
    n_full = sum(s.status == "served" for s in served)
    # Algorithm 1 ran for full solves only (the cheap path reuses banks).
    assert 0 < len(calls) <= n_full
    for spec in specs:
        sub = [s for s in served if s.tenant == spec.name
               and s.status == "served"]
        if not sub:
            continue
        w = spec.weights if spec.weights is not None else WEIGHTS
        ref = _offline([s.request.query for s in sub], w)
        for s, r in zip(sub, ref):
            _assert_result_equal(s.result, r)
    for s in served:
        if s.status in port_serve.REJECTED_STATUSES:
            assert s.ct is None and s.result is None
            assert math.isfinite(s.finished_s)
        else:
            assert s.result is not None


def _replay(served):
    """One-at-a-time offline replay of each full-quality survivor under its
    stamped weights (shared exact caches)."""
    svc = TuningService(cfg=CFG, device=CPU)
    pools = CandidatePoolCache()
    out = {}
    for s in served:
        if s.status != "served":
            continue
        w = tuple(s.request.weights) if s.request.weights is not None \
            else WEIGHTS
        ct = svc.tune_batch([s.request.query], w)[0]
        sess = RuntimeSession(weights=w, pool_cache=pools, device=CPU)
        out[s.rid] = sess.run_batch([s.request.query], [ct])[0]
    return out


MATRIX = port_sc.scenario_matrix(n_per_tenant=4, rate_qps=40.0)


@pytest.mark.parametrize("spec", MATRIX, ids=[m.name for m in MATRIX])
def test_scenario_survivors_replay(spec):
    """Elastic capacity, capacity events, rate limits and SLO triage all
    armed: surviving outputs equal the offline replay, across preference
    shifts and churn."""
    sc = spec.build(seed=2)
    srv = OptimizerServer(
        config=ServerConfig(max_batch=4,
                            elastic=port_serve.ElasticPolicy(max_batch=16)),
        weights=WEIGHTS, cfg=CFG, tenants=sc.tenants, device=CPU)
    served = srv.serve(sc.requests, capacity_events=sc.capacity_events)
    assert len(served) == len(sc.requests)
    ref = _replay(served)
    assert ref, "scenario served nothing at full quality"
    for rid, r in ref.items():
        _assert_result_equal(served[rid].result, r)


def test_weight_shift_never_serves_stale_theta():
    q = port_wl.make_query("tpch", 8, variant=1)
    reqs = [port_wl.StreamRequest(rid=0, query=q, arrival_s=0.0, tenant="t",
                                  weights=(0.99, 0.01)),
            port_wl.StreamRequest(rid=1, query=q, arrival_s=0.05, tenant="t",
                                  weights=(0.01, 0.99))]
    srv = OptimizerServer(
        config=ServerConfig(max_batch=1), weights=WEIGHTS, cfg=CFG,
        tenants=[port_wl.TenantSpec(name="t", weights=(0.99, 0.01))],
        device=CPU)
    pre, post = srv.serve(reqs)
    assert (srv.tuning._results.misses, srv.tuning._results.hits) == (2, 0)
    assert pre.ct.choice != post.ct.choice or not np.array_equal(
        pre.ct.theta_c, post.ct.theta_c)
    for s, w in ((pre, (0.99, 0.01)), (post, (0.01, 0.99))):
        _assert_ct_equal(s.ct, TuningService(cfg=CFG, device=CPU).tune_batch(
            [q], w)[0])
    srv.serve(reqs)
    assert srv.tuning._results.hits == 2


def test_makespan_and_qps_ignore_rejection_timestamps():
    """A late rejection must not stretch the makespan: a shed request's
    finished_s is a rejection timestamp, not service."""
    def run(m):
        reqs = [m.wl.StreamRequest(rid=i,
                                   query=m.wl.make_query("tpch", i,
                                                         variant=1),
                                   arrival_s=0.0, tenant="be")
                for i in range(4)]
        reqs.append(m.wl.StreamRequest(
            rid=4, query=m.wl.make_query("tpch", 4, variant=1),
            arrival_s=1000.0, tenant="strict"))
        specs = [m.wl.TenantSpec(name="strict", slo="strict",
                                 solve_budget_s=0.0),
                 m.wl.TenantSpec(name="be")]
        srv = m.serve.OptimizerServer(
            config=m.serve.ServerConfig(
                max_batch=4, clock=m.serve.ServiceTimeModel(**CLOCK_KW)),
            weights=WEIGHTS, cfg=m.cfg, tenants=specs, **m.kw)
        return srv, srv.serve(reqs)

    rsrv, rserved = run(REF)
    srv, served = run(PORT)
    assert _timeline(srv, served) == _timeline(rsrv, rserved)
    assert [s.status for s in served] == ["served"] * 4 + ["shed"]
    assert served[-1].finished_s >= 1000.0
    st = srv.last_run
    assert st.makespan_s == max(s.finished_s for s in served[:4])
    assert st.makespan_s < 100.0
    assert st.qps == 4 / st.makespan_s == srv.latency_report(served)["qps"]


# ---------------------------------------------------------------------------
# ServiceTimeModel and helpers, held to the reference
# ---------------------------------------------------------------------------

CLOCKS = {
    "three_knots": dict(flush_points=((8, 0.08), (2, 0.02), (4, 0.04)),
                        round_s=0.001, cheap_s=0.0005),
    "one_knot": dict(flush_points=((4, 0.1),)),
    "clamped": dict(flush_points=((4, 0.01), (8, 0.5))),
    "workers": dict(flush_points=((1, 0.1), (8, 0.4)), round_s=0.01,
                    cheap_s=0.002, worker_scale=((1, 1.0), (4, 1.25))),
}


@pytest.mark.parametrize("name", sorted(CLOCKS))
def test_service_time_model_equal(name):
    kw = CLOCKS[name]
    for n_workers in (1, 2, 4, 8):
        a = ref_serve.ServiceTimeModel(**kw).with_workers(n_workers)
        b = ServiceTimeModel(**kw).with_workers(n_workers)
        assert b.flush_points == a.flush_points
        assert b.worker_scale == a.worker_scale
        assert (b.worker_mult(), b.round_cost_s()) == \
            (a.worker_mult(), a.round_cost_s())
        for n in range(0, 20):
            for k in (-3, 0, 1, n, n + 5):
                assert b.flush_s(n, k) == a.flush_s(n, k)


BAD_CLOCKS = {
    "empty": dict(flush_points=()),
    "duplicate": dict(flush_points=((2, 0.1), (2, 0.2))),
    "zero": dict(flush_points=((0, 0.1),)),
    "nan": dict(flush_points=((1, math.nan),)),
    "round": dict(flush_points=((1, 0.1),), round_s=-1.0),
    "cheap": dict(flush_points=((1, 0.1),), cheap_s=-0.1),
    "workers": dict(flush_points=((1, 0.1),), n_workers=0),
    "worker_knots": dict(flush_points=((1, 0.1),),
                         worker_scale=((1, 1.0), (1, 2.0))),
    "multiplier": dict(flush_points=((1, 0.1),), worker_scale=((1, 0.0),)),
}


@pytest.mark.parametrize("name", sorted(BAD_CLOCKS))
def test_service_time_model_validation_equal(name):
    with pytest.raises(ValueError) as a:
        ref_serve.ServiceTimeModel(**BAD_CLOCKS[name])
    with pytest.raises(ValueError) as b:
        ServiceTimeModel(**BAD_CLOCKS[name])
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("x", [[1.0, 1.0, math.nan], [2.0, math.inf, 2.0],
                               [math.nan], [], [1.0, 3.0], [0.0, 0.0],
                               [0.3, 0.7, 1.9, 0.05]])
def test_jain_index_equal(x):
    assert repr(jain_index(x)) == repr(ref_serve.jain_index(x))


def test_statuses_and_config_defaults_equal():
    assert port_serve.REJECTED_STATUSES == ref_serve.REJECTED_STATUSES
    ref_cfg, cfg = ref_serve.ServerConfig(), ServerConfig()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name)


# ---------------------------------------------------------------------------
# Construction, devices and refusals
# ---------------------------------------------------------------------------

def test_construction_rules(timed_stream):
    sess = RuntimeSession(weights=(0.9, 0.1), device=CPU)
    with pytest.raises(ValueError, match="conflicts"):
        OptimizerServer(session=sess, weights=(0.5, 0.5))
    with pytest.raises(ValueError, match="not both"):
        OptimizerServer(tuning=TuningService(cfg=CFG, device=CPU), cfg=CFG)
    # device=None takes the prebuilt objects' device.
    srv = OptimizerServer(session=sess, weights=(0.9, 0.1),
                          tuning=TuningService(cfg=CFG, device=CPU))
    assert srv.device.type == "cpu" and srv.tuning.device.type == "cpu"
    srv = OptimizerServer(session=sess, cfg=CFG, device="cpu")
    assert srv.tuning.device.type == "cpu"
    assert srv.session is sess
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OptimizerServer()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OptimizerServer(session=sess, device="cuda")


def test_device_conflict_rejected():
    class OnCard:
        device = torch.device("cuda", 0)
        weights = WEIGHTS

    with pytest.raises(ValueError, match="conflicts"):
        OptimizerServer(session=OnCard(),
                        tuning=TuningService(cfg=CFG, device=CPU))
    with pytest.raises(ValueError, match="conflicts"):
        OptimizerServer(tuning=OnCard(), device="cpu")


def test_serve_refusals(timed_stream):
    srv = OptimizerServer(config=ServerConfig(max_batch=4), weights=WEIGHTS,
                          cfg=CFG, device=CPU)
    with pytest.raises(ValueError, match="duplicate rids"):
        srv.serve(list(timed_stream) + [timed_stream[0]])
    assert srv.serve([]) == []
    rep = srv.latency_report([])
    assert rep["n_queries"] == 0 and math.isnan(rep["plan_latency_s"]["p99"])
    srv.scheduler.enqueue("default", "stray", 0.0)
    with pytest.raises(RuntimeError, match="admission queue"):
        srv.serve(timed_stream)
    srv2 = OptimizerServer(config=ServerConfig(max_batch=4),
                           weights=WEIGHTS, cfg=CFG, device=CPU)
    ct = srv2.tuning.tune_batch([timed_stream[0].query], WEIGHTS)[0]
    srv2.session.admit(timed_stream[0].query, ct)
    with pytest.raises(RuntimeError, match="idle session"):
        srv2.serve(timed_stream)


# ---------------------------------------------------------------------------
# Model backend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(smoke_perf_models):
    ref = smoke_perf_models["subq"], smoke_perf_models["qs"]
    return ref, (carry(ref[0]), carry(ref[1]))


def _model_server(m, msub, mqs, tenants=(), **cfg_kw):
    return m.serve.OptimizerServer(
        config=m.serve.ServerConfig(**cfg_kw),
        tuning=m.serve.TuningService(model=msub, cfg=m.cfg, **m.kw),
        session=m.serve.RuntimeSession(model_subq=msub, model_qs=mqs,
                                       weights=WEIGHTS, **m.kw),
        tenants=tenants)


def _assert_result_close(got, ref, rtol=MODEL_RTOL):
    np.testing.assert_array_equal(got.final_join, ref.final_join)
    for f in ("theta_p_eff", "theta_s_eff"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=rtol)
    for f in ("ana_latency", "actual_latency", "io_gb", "cost"):
        np.testing.assert_allclose(getattr(got.sim, f), getattr(ref.sim, f),
                                   rtol=rtol)


@pytest.fixture(scope="module")
def model_stream():
    return port_wl.serving_stream("tpch", 8, seed=11,
                                  arrivals=port_wl.ArrivalModel(
                                      kind="poisson", rate_qps=40.0))


@pytest.fixture(scope="module")
def model_offline(models, model_stream):
    _, (msub, mqs) = models
    return _offline([r.query for r in model_stream], model=msub,
                    model_qs=mqs)


@pytest.mark.parametrize("slicing", ["one_at_a_time", "micro_batches",
                                     "shuffled"])
def test_model_golden_invariant(slicing, models, model_stream,
                                model_offline):
    _, (msub, mqs) = models
    cfg_kw, make = {"one_at_a_time": (dict(max_batch=1), lambda s: s),
                    "micro_batches": (dict(max_batch=3), lambda s: s),
                    "shuffled": (dict(max_batch=3),
                                 lambda s: _shuffled(s, 5))}[slicing]
    served = {s.rid: s for s in _model_server(PORT, msub, mqs, **cfg_kw)
              .serve(make(model_stream))}
    for r, ref in zip(model_stream, model_offline):
        _assert_result_equal(served[r.rid].result, ref)


def test_model_multi_tenant_overload(models):
    """Model backend under overload, under a ``ServiceTimeModel`` (so the
    batches are the reference's: a degraded request's cheap answer depends
    on which templates its batch found warm): the timeline equals the
    reference's, survivors equal the port's offline pipeline exactly per
    tenant, and every plan is the reference's within rtol 1e-4."""
    (rsub, rqs), (msub, mqs) = models

    def run(m, sub, qs):
        A = m.wl.ArrivalModel
        specs = [m.wl.TenantSpec(name="strict", slo="strict",
                                 solve_budget_s=0.0,
                                 arrivals=A(rate_qps=40.0)),
                 m.wl.TenantSpec(name="deg", slo="degrade",
                                 solve_budget_s=0.0,
                                 arrivals=A(rate_qps=40.0)),
                 m.wl.TenantSpec(name="lat", weights=(0.9, 0.1),
                                 arrivals=A(rate_qps=40.0)),
                 m.wl.TenantSpec(name="cost", weights=(0.2, 0.8),
                                 priority=1, arrivals=A(rate_qps=40.0))]
        reqs = m.wl.multi_tenant_stream("tpch", specs, 4, seed=17)
        srv = _model_server(m, sub, qs, tenants=specs, max_batch=3,
                            clock=m.serve.ServiceTimeModel(**CLOCK_KW))
        return srv, srv.serve(reqs)

    rsrv, ref = run(REF, rsub, rqs)
    srv, got = run(PORT, msub, mqs)
    assert _timeline(srv, got) == _timeline(rsrv, ref)
    by = {n: [s for s in got if s.tenant == n]
          for n in ("strict", "deg", "lat", "cost")}
    assert [s.status for s in by["strict"]] == ["shed"] * 4
    assert [s.status for s in by["deg"]] == ["degraded"] * 4
    for name, w in (("lat", (0.9, 0.1)), ("cost", (0.2, 0.8))):
        sub = by[name]
        assert [s.status for s in sub] == ["served"] * 4
        offline = _offline([s.request.query for s in sub], w, msub, mqs)
        for s, r in zip(sub, offline):
            _assert_result_equal(s.result, r)
    for a, b in zip(ref, got):
        if b.result is not None:
            _assert_result_close(b.result, a.result)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

PORT_ONLY = r"""
import sys
sys.modules["jax"] = None          # `import jax` now raises ImportError
sys.modules["repro"] = None
import numpy as np
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.queryengine.workloads import (ArrivalModel, TenantSpec,
                                               multi_tenant_stream)
from repro_torch.serve import OptimizerServer, ServerConfig
specs = [TenantSpec(name="a", weights=(0.9, 0.1),
                    arrivals=ArrivalModel(rate_qps=30.0)),
         TenantSpec(name="b", weights=(0.2, 0.8), slo="strict",
                    arrivals=ArrivalModel(kind="uniform", rate_qps=20.0))]
reqs = multi_tenant_stream("tpch", specs, 3, seed=4)
srv = OptimizerServer(config=ServerConfig(max_batch=3), tenants=specs,
                      cfg=HMOOCConfig(n_c_init=16, n_clusters=4,
                                      n_p_pool=48, n_c_enrich=12,
                                      max_bank=12, seed=3), device="cpu")
served = srv.serve(reqs)
ok = [s for s in served if s.result is not None]
assert ok and all(np.isfinite(s.result.sim.cost).all() for s in ok)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("served", len(ok), srv.last_run.n_micro_batches)
"""


def test_port_serves_without_jax_or_reference():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", PORT_ONLY], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served ")
