"""Port parity for the fleet: routing, sharded serving and cache stores.

* ``route_key``, ``HashRing.worker_for`` and ``FleetRouter.assign`` equal
  the reference's for every policy, with and without work stealing.
* ``OptimizerFleet.serve`` at 1, 2 and 4 workers under a
  ``ServiceTimeModel`` (oracle backend): the worker of each request, its
  status and lifecycle times and its plan equal the reference's; the
  per-tenant outputs are equal across widths and to the offline pipeline.
* ``CacheStore`` round trips through a file, a warm start keeps the
  served outputs, and no published blob holds a ``torch.Tensor``.
"""
import dataclasses
import io
import math
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as ref_serve
from repro.core.moo.hmooc import HMOOCConfig as RefHMOOCConfig
from repro.queryengine import workloads as ref_wl
from repro.serve import fleet as ref_fleet
import repro_torch.serve as port_serve
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.queryengine import workloads as port_wl
from repro_torch.serve import (CacheStore, OptimizerFleet, RuntimeSession,
                               ServerConfig, ServiceTimeModel, TuningService)
from repro_torch.serve import fleet as port_fleet

CFG_KW = dict(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
              max_bank=12, seed=3)
CFG = HMOOCConfig(**CFG_KW)
WEIGHTS = (0.9, 0.1)
CPU = "cpu"
CLOCK_KW = dict(flush_points=((1, 0.05), (8, 0.2)), round_s=0.005,
                cheap_s=0.001, worker_scale=((1, 1.0), (4, 1.25)))

REF = types.SimpleNamespace(wl=ref_wl, serve=ref_serve, fleet=ref_fleet,
                            cfg=RefHMOOCConfig(**CFG_KW), kw={})
PORT = types.SimpleNamespace(wl=port_wl, serve=port_serve, fleet=port_fleet,
                             cfg=CFG, kw={"device": CPU})


def _specs(m):
    A = m.wl.ArrivalModel
    return [m.wl.TenantSpec(name="lat", weights=(0.9, 0.1), priority=1,
                            slo="strict", solve_budget_s=0.5,
                            arrivals=A(kind="poisson", rate_qps=30.0)),
            m.wl.TenantSpec(name="cost", weights=(0.1, 0.9), slo="degrade",
                            solve_budget_s=0.5,
                            arrivals=A(kind="uniform", rate_qps=20.0)),
            m.wl.TenantSpec(name="be", weights=(0.5, 0.5),
                            rate_limit_qps=10.0, rate_limit_burst=2.0,
                            arrivals=A(kind="poisson", rate_qps=30.0))]


def _stream(m):
    return m.wl.multi_tenant_stream("tpch", _specs(m), 6, seed=8)


def _fleet(m, n_workers, policy, **kw):
    return m.serve.OptimizerFleet(
        n_workers=n_workers,
        config=m.serve.ServerConfig(max_batch=4,
                                    clock=m.serve.ServiceTimeModel(
                                        **CLOCK_KW)),
        weights=WEIGHTS, cfg=m.cfg, tenants=_specs(m), policy=policy,
        **m.kw, **kw)


def _rows(served):
    return repr([(s.rid, s.tenant, s.worker, s.status, s.admitted_s,
                  s.compiled_s, s.finished_s, s.joined_running)
                 for s in served])


def _assert_result_equal(got, ref):
    np.testing.assert_array_equal(got.theta_p_eff, ref.theta_p_eff)
    np.testing.assert_array_equal(got.theta_s_eff, ref.theta_s_eff)
    np.testing.assert_array_equal(got.final_join, ref.final_join)
    for f in ("ana_latency", "actual_latency", "io_gb", "cost"):
        np.testing.assert_array_equal(getattr(got.sim, f),
                                      getattr(ref.sim, f))


def _fleet_stats(st):
    return repr({f.name: getattr(st, f.name) for f in dataclasses.fields(st)
                 if f.name != "per_worker"}) + repr(
        [(w.n_micro_batches, w.rounds, w.flush_windows, w.flush_caps,
          w.makespan_s, w.tenant_slots) for w in st.per_worker])


# ---------------------------------------------------------------------------
# Router and ring mechanics
# ---------------------------------------------------------------------------

def test_route_key_and_ring_equal():
    keys = [(b, t) for b in ("tpch", "tpcds") for t in range(100)]
    for n, replicas, salt in ((1, 64, 0), (3, 64, 0), (4, 8, 5), (5, 64, 0)):
        a = ref_fleet.HashRing(n, replicas=replicas, salt=salt)
        b = port_fleet.HashRing(n, replicas=replicas, salt=salt)
        assert [b.worker_for(k) for k in keys] == \
            [a.worker_for(k) for k in keys]
    for i in range(12):
        q = port_wl.make_query("tpch", i, variant=i % 3)
        rq = ref_wl.make_query("tpch", i, variant=i % 3)
        assert port_fleet.route_key(q) == ref_fleet.route_key(rq)
        assert port_fleet._h32("x", i, q.qid) == ref_fleet._h32("x", i,
                                                                rq.qid)
    for bad in (dict(n_workers=0), dict(n_workers=2, replicas=0)):
        with pytest.raises(ValueError) as ea:
            ref_fleet.HashRing(**bad)
        with pytest.raises(ValueError) as eb:
            port_fleet.HashRing(**bad)
        assert str(ea.value) == str(eb.value)


def _router_requests(m, simultaneous):
    return [m.wl.StreamRequest(rid=i,
                               query=m.wl.make_query("tpch", i % 4,
                                                     variant=i),
                               arrival_s=0.0 if simultaneous
                               else 0.02 * (i % 5),
                               tenant="ab"[i % 2])
            for i in range(16)]


@pytest.mark.parametrize("simultaneous", [False, True])
@pytest.mark.parametrize("policy,steal", [
    ("single", None), ("random", None), ("affinity", None),
    ("affinity", 0.0), ("affinity", 0.1)])
def test_router_assign_equal(policy, steal, simultaneous):
    def run(m):
        router = m.fleet.FleetRouter(3, policy=policy, seed=5,
                                     steal_delay_s=steal, est_full_s=0.25)
        reqs = _router_requests(m, simultaneous)
        # Routing runs in (arrival, rid) order whatever the list order.
        out = router.assign(list(reversed(reqs)))[::-1]
        return out, router.n_stolen, router.worker_counts

    got = run(PORT)
    assert got == run(REF)
    assert sum(got[2]) == 16
    if policy == "single":
        assert got[0] == [0] * 16
    if policy == "affinity" and steal == 0.0 and simultaneous:
        assert got[1] > 0 and len(set(got[0])) == 3


def test_router_validation_equal():
    for kw in (dict(policy="bogus"), dict(steal_delay_s=-1.0),
               dict(steal_delay_s=math.inf)):
        with pytest.raises(ValueError) as ea:
            ref_fleet.FleetRouter(2, **kw)
        with pytest.raises(ValueError) as eb:
            port_fleet.FleetRouter(2, **kw)
        assert str(ea.value) == str(eb.value)
    assert port_fleet.ROUTING_POLICIES == ref_fleet.ROUTING_POLICIES
    assert port_fleet.CACHE_KINDS == ref_fleet.CACHE_KINDS


# ---------------------------------------------------------------------------
# Sharded serving, held to the reference
# ---------------------------------------------------------------------------

WIDTHS = [(1, "affinity"), (2, "affinity"), (2, "random"), (4, "affinity"),
          (4, "random")]


@pytest.fixture(scope="module")
def fleets():
    out = {}
    for n, policy in WIDTHS:
        rf = _fleet(REF, n, policy)
        pf = _fleet(PORT, n, policy)
        out[(n, policy)] = (rf, rf.serve(_stream(REF)), pf,
                            pf.serve(_stream(PORT)))
    return out


@pytest.mark.parametrize("width", WIDTHS, ids=[f"{n}-{p}" for n, p in WIDTHS])
def test_fleet_serve_equal(width, fleets):
    rf, rserved, pf, pserved = fleets[width]
    assert _rows(pserved) == _rows(rserved)
    assert _fleet_stats(pf.last_run) == _fleet_stats(rf.last_run)
    for a, b in zip(rserved, pserved):
        assert (a.result is None) == (b.result is None)
        if b.result is not None:
            _assert_result_equal(b.result, a.result)
    assert repr(pf.latency_report(pserved)) == \
        repr(rf.latency_report(rserved))
    assert repr(pf.cache_report()) == repr(rf.cache_report())
    assert pf.config.clock.n_workers == width[0]
    assert "served" in {s.status for s in pserved}


def test_fleet_outputs_equal_across_widths(fleets):
    """A request served at full quality at two widths gets one plan, and
    every full-quality plan equals the offline pipeline under its
    tenant's weights."""
    by_width = {w: {s.rid: s for s in fleets[w][3]} for w in WIDTHS}
    assert {s.status for w in WIDTHS for s in by_width[w].values()} == \
        {"served", "shed", "degraded", "rate_limited"}
    base = by_width[WIDTHS[0]]
    for w in WIDTHS[1:]:
        both = [rid for rid, s in by_width[w].items()
                if s.status == "served" and base[rid].status == "served"]
        assert both
        for rid in both:
            _assert_result_equal(by_width[w][rid].result, base[rid].result)
    for spec in _specs(PORT):
        sub = [s for s in fleets[(4, "random")][3]
               if s.tenant == spec.name and s.status == "served"]
        if not sub:
            continue
        queries = [s.request.query for s in sub]
        cts = TuningService(cfg=CFG, device=CPU).tune_batch(queries,
                                                            spec.weights)
        ref = RuntimeSession(weights=spec.weights, device=CPU).run_batch(
            queries, cts)
        for s, r in zip(sub, ref):
            _assert_result_equal(s.result, r)


def test_fleet_work_stealing_preserves_outputs(fleets):
    reqs = [dataclasses.replace(r, arrival_s=0.0) for r in _stream(PORT)]
    fleet = _fleet(PORT, 4, "affinity", steal_delay_s=0.0)
    served = fleet.serve(reqs)
    assert fleet.last_run.n_stolen > 0
    assert sum(1 for c in fleet.last_run.worker_counts if c) > 1
    ref = _fleet(REF, 4, "affinity", steal_delay_s=0.0)
    assert _rows(served) == _rows(ref.serve(
        [dataclasses.replace(r, arrival_s=0.0) for r in _stream(REF)]))


# ---------------------------------------------------------------------------
# Cache store
# ---------------------------------------------------------------------------

def _tensors_in(obj, seen=None):
    """Every torch.Tensor reachable from ``obj`` (containers, dataclasses
    and plain objects)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (np.ndarray, str, bytes, int, float, type(None))):
        return []
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    elif hasattr(obj, "__slots__"):
        items = [getattr(obj, k) for k in obj.__slots__ if hasattr(obj, k)]
    else:
        items = []
    return [t for it in items for t in _tensors_in(it, seen)]


class _NoTorch(pickle.Unpickler):
    """Refuses any torch class: a blob that needs torch to load would
    carry device storage across processes."""

    def find_class(self, module, name):
        if module.split(".")[0] == "torch":
            raise pickle.UnpicklingError(f"blob holds {module}.{name}")
        return super().find_class(module, name)


def test_cache_store_round_trip(tmp_path):
    stream = port_wl.serving_stream("tpch", 10, seed=1,
                                    arrivals=port_wl.ArrivalModel(
                                        rate_qps=40.0))
    store = CacheStore()
    cold = OptimizerFleet(n_workers=2,
                          config=ServerConfig(max_batch=4,
                                              clock=ServiceTimeModel(
                                                  **CLOCK_KW)),
                          weights=WEIGHTS, cfg=CFG, cache_store=store,
                          device=CPU)
    first = cold.serve(stream)
    assert set(store.kinds()) == {"eset", "response", "pools"}
    for kind in store.kinds():
        blob = store.fetch(kind)
        assert not _tensors_in(_NoTorch(io.BytesIO(blob)).load())
    path = tmp_path / "caches.pkl"
    store.save(path)
    loaded = CacheStore.load(path)
    assert loaded.kinds() == store.kinds()
    assert all(loaded.fetch(k) == store.fetch(k) for k in store.kinds())

    warm = OptimizerFleet(n_workers=1,
                          config=ServerConfig(max_batch=4,
                                              clock=ServiceTimeModel(
                                                  **CLOCK_KW)),
                          weights=WEIGHTS, cfg=CFG, cache_store=loaded,
                          publish_on_serve=False, device=CPU)
    srv = warm.workers[0]
    assert len(srv.tuning._results) > 0
    third = warm.serve(stream)
    for a, b in zip(first, third):
        _assert_result_equal(b.result, a.result)
    assert srv.tuning._results.misses == 0
    assert srv.tuning._results.hits == len(stream)
    assert srv.session.pool_cache.misses == 0
    assert warm.cache_report()["response"]["hit_rate"] == pytest.approx(1.0)
    # A warm fleet serves what a cold one serves.
    cold2 = OptimizerFleet(n_workers=1, config=ServerConfig(max_batch=4),
                           weights=WEIGHTS, cfg=CFG, device=CPU)
    for a, b in zip(cold2.serve(stream), third):
        _assert_result_equal(b.result, a.result)


def test_cache_store_validation(tmp_path):
    store = CacheStore()
    with pytest.raises(ValueError, match="unknown cache kind"):
        store.publish("bogus", b"x")
    with pytest.raises(TypeError, match="bytes"):
        store.publish("eset", "not-bytes")
    assert store.fetch("eset") is None and store.kinds() == ()
    p = tmp_path / "foreign.pkl"
    with open(p, "wb") as f:
        pickle.dump({"format": "something-else"}, f)
    with pytest.raises(ValueError, match="not a cache-store"):
        CacheStore.load(p)
    p2 = tmp_path / "skewed.pkl"
    with open(p2, "wb") as f:
        pickle.dump({"format": "repro-cache-store", "version": 99,
                     "blobs": {}}, f)
    with pytest.raises(ValueError, match="version"):
        CacheStore.load(p2)


def test_fleet_construction_validation():
    with pytest.raises(ValueError, match="n_workers"):
        OptimizerFleet(n_workers=0, cfg=CFG, device=CPU)
    with pytest.raises(ValueError, match="routing policy"):
        OptimizerFleet(n_workers=2, cfg=CFG, policy="bogus", device=CPU)
    fleet = _fleet(PORT, 4, "affinity")
    assert all(w.device.type == "cpu" for w in fleet.workers)
    assert all(w.config.clock.n_workers == 4 for w in fleet.workers)
    with pytest.raises(RuntimeError, match="no cache store"):
        fleet.publish()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OptimizerFleet(n_workers=2, cfg=CFG)
