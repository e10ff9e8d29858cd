"""Port parity for the streaming layer's inputs: arrival models, timed
and multi-tenant streams, and nonstationary scenarios.

Every stream of the port is held to the reference's on the same seeds,
exactly: arrival times bit-equal (the same ``SeedSequence`` draws, in the
same order, including the thinning loop of the nonstationary kinds),
queries equal by id and by the statistics fingerprint the caches key on,
and tenants, rids, stamped weights and capacity events equal.  Any
reordering of a draw would move every request after it.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.queryengine import scenarios as ref_sc
from repro.queryengine import workloads as ref_wl
from repro.serve.cache import query_fingerprint as ref_fingerprint
from repro_torch.queryengine import scenarios as port_sc
from repro_torch.queryengine import workloads as port_wl
from repro_torch.serve.cache import query_fingerprint

KINDS = ("poisson", "uniform", "fixed", "diurnal", "spike", "ramp")
# Non-default shape knobs, so every field of the model reaches the draw.
KIND_KW = {"diurnal": dict(period_s=3.0, amplitude=0.6),
           "spike": dict(spike_at_s=0.5, spike_dur_s=0.75, spike_factor=6.0),
           "ramp": dict(ramp_to_qps=48.0, ramp_dur_s=1.5)}


def _model(wl, kind, **kw):
    return wl.ArrivalModel(kind=kind, rate_qps=20.0, start_s=0.25,
                           **KIND_KW.get(kind, {}), **kw)


def _requests(reqs, fp):
    return [(r.rid, r.tenant, r.arrival_s, r.query.qid, fp(r.query),
             r.weights) for r in reqs]


def _raises_alike(ref_fn, port_fn, exc=ValueError):
    with pytest.raises(exc) as a:
        ref_fn()
    with pytest.raises(exc) as b:
        port_fn()
    assert str(a.value) == str(b.value)


# ---------------------------------------------------------------------------
# Arrival models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kind", KINDS)
def test_arrival_draw_equal(kind, seed):
    ref = _model(ref_wl, kind).draw(96, seed=seed)
    got = _model(port_wl, kind).draw(96, seed=seed)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float64 and got.shape == (96,)
    assert (np.diff(got) >= 0).all() and got[0] >= 0.25
    for t in np.linspace(0.0, 6.0, 25):
        assert _model(port_wl, kind).rate_at(float(t)) == \
            _model(ref_wl, kind).rate_at(float(t))
    assert _model(port_wl, kind)._max_rate() == \
        _model(ref_wl, kind)._max_rate()


BAD_MODELS = {
    "kind": dict(kind="bogus"),
    "rate": dict(rate_qps=0.0),
    "amplitude": dict(kind="diurnal", amplitude=1.0),
    "period": dict(kind="diurnal", period_s=0.0),
    "spike_factor": dict(kind="spike", spike_factor=0.0),
    "spike_dur": dict(kind="spike", spike_dur_s=-1.0),
    "ramp": dict(kind="ramp", ramp_to_qps=-1.0),
    "ramp_dur": dict(kind="ramp", ramp_dur_s=0.0),
}


@pytest.mark.parametrize("case", sorted(BAD_MODELS))
def test_arrival_validation_equal(case):
    kw = BAD_MODELS[case]
    _raises_alike(lambda: ref_wl.ArrivalModel(**kw).draw(3),
                  lambda: port_wl.ArrivalModel(**kw).draw(3))
    _raises_alike(lambda: ref_wl.ArrivalModel(**kw).rate_at(0.0),
                  lambda: port_wl.ArrivalModel(**kw).rate_at(0.0))


# ---------------------------------------------------------------------------
# Timed and multi-tenant streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,seed,query_seed", [
    ("poisson", 1, 0), ("uniform", 5, 0), ("spike", 2, 9), ("ramp", 3, 0)])
def test_serving_stream_arrivals_equal(kind, seed, query_seed):
    ref = ref_wl.serving_stream("tpch", 24, seed=seed, query_seed=query_seed,
                                arrivals=_model(ref_wl, kind))
    got = port_wl.serving_stream("tpch", 24, seed=seed,
                                 query_seed=query_seed,
                                 arrivals=_model(port_wl, kind))
    assert all(isinstance(r, port_wl.StreamRequest) for r in got)
    assert _requests(got, query_fingerprint) == \
        _requests(ref, ref_fingerprint)
    assert [r.rid for r in got] == list(range(24))
    # The untimed stream is the same queries in the same order.
    plain = port_wl.serving_stream("tpch", 24, seed=seed,
                                   query_seed=query_seed)
    assert [q.qid for q in plain] == [r.query.qid for r in got]


def _specs(wl):
    return [wl.TenantSpec(name="lat", weights=(0.9, 0.1), share=2.0,
                          arrivals=wl.ArrivalModel(kind="poisson",
                                                   rate_qps=30.0)),
            wl.TenantSpec(name="bal", weights=(0.5, 0.5), priority=1,
                          arrivals=wl.ArrivalModel(kind="spike",
                                                   rate_qps=20.0)),
            wl.TenantSpec(name="cost", weights=(0.1, 0.9),
                          arrivals=wl.ArrivalModel(kind="uniform",
                                                   rate_qps=10.0))]


@pytest.mark.parametrize("counts,seed", [(4, 8), ([5, 3, 6], 6)])
def test_multi_tenant_stream_equal(counts, seed):
    ref = ref_wl.multi_tenant_stream("tpch", _specs(ref_wl), counts,
                                     seed=seed)
    got = port_wl.multi_tenant_stream("tpch", _specs(port_wl), counts,
                                      seed=seed)
    assert _requests(got, query_fingerprint) == \
        _requests(ref, ref_fingerprint)
    times = [r.arrival_s for r in got]
    assert times == sorted(times)
    assert [r.rid for r in got] == list(range(len(got)))
    n = [counts] * 3 if isinstance(counts, int) else counts
    for spec, k in zip(_specs(port_wl), n):
        assert sum(r.tenant == spec.name for r in got) == k


@pytest.mark.parametrize("name", ["a", "strict", "tenant-with-a-long-name",
                                  "ünïcode"])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_tenant_seed_equal(name, seed):
    assert port_wl._tenant_seed(seed, name) == ref_wl._tenant_seed(seed, name)


BAD_STREAMS = {
    "duplicate": lambda wl: wl.multi_tenant_stream(
        "tpch", [wl.TenantSpec(name="x"), wl.TenantSpec(name="x")], 2),
    "counts": lambda wl: wl.multi_tenant_stream(
        "tpch", [wl.TenantSpec(name="x")], [1, 2]),
    "share": lambda wl: wl.TenantSpec(name="x", share=0.0),
    "name": lambda wl: wl.TenantSpec(name=""),
    "slo": lambda wl: wl.TenantSpec(name="x", slo="bogus"),
    "rate_limit": lambda wl: wl.TenantSpec(name="x", rate_limit_qps=0.0),
    "burst": lambda wl: wl.TenantSpec(name="x", rate_limit_qps=1.0,
                                      rate_limit_burst=0.5),
}


@pytest.mark.parametrize("case", sorted(BAD_STREAMS))
def test_stream_validation_equal(case):
    fn = BAD_STREAMS[case]
    _raises_alike(lambda: fn(ref_wl), lambda: fn(port_wl))


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

MATRIX = {n_per: (ref_sc.scenario_matrix(n_per_tenant=n_per, rate_qps=rate),
                  port_sc.scenario_matrix(n_per_tenant=n_per, rate_qps=rate))
          for n_per, rate in ((4, 40.0), (24, 12.5))}
NAMES = [s.name for s in MATRIX[4][1]]


def _scenario(sc, fp):
    return (_requests(sc.requests, fp), tuple(sc.capacity_events),
            [(t.name, t.weights, t.slo, t.priority, t.share,
              t.rate_limit_qps, t.arrivals.kind) for t in sc.tenants])


@pytest.mark.parametrize("n_per", sorted(MATRIX))
@pytest.mark.parametrize("name", NAMES)
def test_scenario_build_equal(name, n_per):
    ref_specs, port_specs = MATRIX[n_per]
    assert [s.name for s in ref_specs] == [s.name for s in port_specs]
    i = NAMES.index(name)
    for seed in (2, 9):
        ref = ref_specs[i].build(seed=seed)
        got = port_specs[i].build(seed=seed)
        assert _scenario(got, query_fingerprint) == \
            _scenario(ref, ref_fingerprint)
        assert all(isinstance(c, port_sc.CapacityEvent)
                   for c in got.capacity_events)
    # Weights are stamped per request at build time: the shift's weights
    # from its instant on, the tenant's own before it.
    spec = port_specs[i]
    sc = spec.build(seed=2)
    own = {t.name: t.weights for t in sc.tenants}
    for r in sc.requests:
        want = own[r.tenant]
        for ev in sorted((e for e in spec.events
                          if e.kind == "weights" and e.tenant == r.tenant),
                         key=lambda e: e.at_s):
            if ev.at_s <= r.arrival_s:
                want = ev.weights
        assert r.weights == want


def test_scenario_constants_equal():
    assert port_sc.EVENT_KINDS == ref_sc.EVENT_KINDS
    assert port_sc.ARRIVAL_SHAPES == ref_sc.ARRIVAL_SHAPES
    assert port_sc.TIMELINES == ref_sc.TIMELINES
    assert port_wl.SLO_CLASSES == ref_wl.SLO_CLASSES
    assert port_wl._STATIONARY_KINDS + port_wl._NONSTATIONARY_KINDS == KINDS
    for shape in port_sc.ARRIVAL_SHAPES:
        a = port_sc._shape_arrivals(shape, 30.0, 2.0)
        b = ref_sc._shape_arrivals(shape, 30.0, 2.0)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


BAD_SCENARIOS = {
    "kind": lambda sc, wl: sc.ScenarioEvent(at_s=0.0, kind="bogus"),
    "weights": lambda sc, wl: sc.ScenarioEvent(at_s=0.0, kind="weights",
                                               tenant="a"),
    "pair": lambda sc, wl: sc.ScenarioEvent(at_s=0.0, kind="weights",
                                            tenant="a",
                                            weights=(0.1, 0.2, 0.7)),
    "join": lambda sc, wl: sc.ScenarioEvent(at_s=0.0, kind="join"),
    "join_name": lambda sc, wl: sc.ScenarioEvent(
        at_s=0.0, kind="join", tenant="b", spec=wl.TenantSpec(name="a")),
    "leave": lambda sc, wl: sc.ScenarioEvent(at_s=0.0, kind="leave"),
    "capacity": lambda sc, wl: sc.ScenarioEvent(at_s=0.0, kind="capacity",
                                                max_batch=0),
    "at_s": lambda sc, wl: sc.ScenarioEvent(at_s=math.inf, kind="leave",
                                            tenant="a"),
    "no_tenant": lambda sc, wl: sc.ScenarioSpec(name="x"),
    "no_name": lambda sc, wl: sc.ScenarioSpec(
        name="", tenants=(wl.TenantSpec(name="a"),)),
    "n_per": lambda sc, wl: sc.ScenarioSpec(
        name="x", tenants=(wl.TenantSpec(name="a"),), n_per_tenant=0),
    "duplicate": lambda sc, wl: sc.ScenarioSpec(
        name="x", tenants=(wl.TenantSpec(name="a"),),
        events=(sc.ScenarioEvent(at_s=0.0, kind="join",
                                 spec=wl.TenantSpec(name="a")),)),
    "unknown": lambda sc, wl: sc.ScenarioSpec(
        name="x", tenants=(wl.TenantSpec(name="a"),),
        events=(sc.ScenarioEvent(at_s=0.0, kind="leave", tenant="ghost"),)),
    "shape": lambda sc, wl: sc._shape_arrivals("bogus", 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(BAD_SCENARIOS))
def test_scenario_validation_equal(case):
    fn = BAD_SCENARIOS[case]
    _raises_alike(lambda: fn(ref_sc, ref_wl), lambda: fn(port_sc, port_wl))
