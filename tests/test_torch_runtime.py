"""Port parity for the runtime (AQE) half: ``run_with_aqe`` with the
runtime optimizers, ``RuntimeSession``, ``weighted_pick_batch`` and the
candidate-pool cache, held to the reference on the host (``device="cpu"``).

* Oracle backend: θ_eff, final joins, request counts and the simulated
  latency, IO and cost are exactly equal (the same numpy arithmetic), on
  TPC-H and TPC-DS streams, under the default (float64 numpy) routing and
  under forced kernel routing (the reference's Pallas kernels in interpret
  mode against the port's plain versions, both in float32).
* Model backend with the reference's weights carried across: objectives
  within rtol 1e-4 (float32 sums in another order in XLA and ATen).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.models.gtn import GTNConfig as RefGTNConfig
from repro.core.models.perf_model import ModelConfig as RefModelConfig
from repro.core.models.perf_model import PerfModel as RefPerfModel
from repro.core.moo import hmooc as ref_hmooc
from repro.core.moo import pareto as ref_pareto
from repro.core.moo.hmooc import HMOOCConfig as RefHMOOCConfig
from repro.core.tuning import runtime as ref_rt
from repro.queryengine.aqe import run_with_aqe as ref_run_with_aqe
from repro.queryengine.workloads import serving_stream as ref_stream
from repro.serve import CandidatePoolCache as RefPoolCache
from repro.serve import RuntimeSession as RefRuntimeSession
from repro.serve import TuningService as RefTuningService
from repro_torch.core.moo import hmooc as port_hmooc
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.core.tuning import runtime as port_rt
from repro_torch.queryengine.aqe import run_with_aqe
from repro_torch.queryengine.workloads import serving_stream
from repro_torch.serve import CandidatePoolCache, RuntimeSession
from repro_torch.serve import TuningService

from test_torch_models import carry

CFG_KW = dict(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
              max_bank=12, seed=3)
WEIGHTS = (0.9, 0.1)
STREAMS = {"tpch": (8, 1), "tpcds": (6, 2)}      # (queries, seed)
CPU = "cpu"


@pytest.fixture(scope="module", params=sorted(STREAMS))
def streams(request):
    """(reference queries, reference compile results, port queries, port
    compile results) for one benchmark."""
    n, seed = STREAMS[request.param]
    rq = ref_stream(request.param, n, seed=seed)
    pq = serving_stream(request.param, n, seed=seed)
    rc = RefTuningService(cfg=RefHMOOCConfig(**CFG_KW)).tune_batch(rq,
                                                                   WEIGHTS)
    pc = TuningService(cfg=HMOOCConfig(**CFG_KW), device=CPU).tune_batch(
        pq, WEIGHTS)
    return rq, rc, pq, pc


@pytest.fixture(params=["default", "forced"])
def routing(request, monkeypatch):
    if request.param == "forced":
        for mod, name in ((ref_pareto, "_KERNEL_MIN_N"),
                          (ref_hmooc, "_WS_MIN_SCORES"),
                          (port_pareto, "_KERNEL_MIN_N"),
                          (port_hmooc, "_WS_MIN_SCORES")):
            monkeypatch.setattr(mod, name, 0)
    return request.param


def _assert_aqe_equal(a, b):
    np.testing.assert_array_equal(a.theta_p_eff, b.theta_p_eff)
    np.testing.assert_array_equal(a.theta_s_eff, b.theta_s_eff)
    np.testing.assert_array_equal(a.final_join, b.final_join)
    assert (a.lqp_requests_sent, a.qs_requests_sent, a.requests_total) == \
        (b.lqp_requests_sent, b.qs_requests_sent, b.requests_total)
    for f in ("ana_latency", "actual_latency", "io_gb", "cost"):
        np.testing.assert_array_equal(getattr(a.sim, f), getattr(b.sim, f))


def _per_query(run, make, queries, cts, **kw):
    out = []
    for q, ct in zip(queries, cts):
        lqp_o, qs_o = make(q, ct.theta_c, seed_theta_p=ct.theta_p_sub,
                           seed_theta_s=ct.theta_s_sub, weights=WEIGHTS,
                           **kw)
        out.append(run(q, ct.theta_c, ct.theta_p0, ct.theta_s0,
                       lqp_optimizer=lqp_o, qs_optimizer=qs_o))
    return out


def test_compile_seeds_equal(streams):
    _, rc, _, pc = streams
    for a, b in zip(rc, pc):
        for f in ("theta_c", "theta_p_sub", "theta_s_sub", "theta_p0",
                  "theta_s0"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_run_with_aqe_equal(streams, routing):
    rq, rc, pq, pc = streams
    ref = _per_query(ref_run_with_aqe, ref_rt.make_runtime_optimizers, rq,
                     rc)
    got = _per_query(run_with_aqe, port_rt.make_runtime_optimizers, pq, pc,
                     device=CPU)
    assert sum(r.requests_sent for r in got) > 0
    for a, b in zip(ref, got):
        _assert_aqe_equal(a, b)


def test_run_batch_equal(streams, routing):
    rq, rc, pq, pc = streams
    ref_s = RefRuntimeSession(weights=WEIGHTS)
    port_s = RuntimeSession(weights=WEIGHTS, device=CPU)
    for a, b in zip(ref_s.run_batch(rq, rc), port_s.run_batch(pq, pc)):
        _assert_aqe_equal(a, b)
    ra, pb = ref_s.last_batch, port_s.last_batch
    assert (ra.n_queries, ra.rounds, ra.fused_calls, ra.requests_sent,
            ra.requests_total) == (pb.n_queries, pb.rounds, pb.fused_calls,
                                   pb.requests_sent, pb.requests_total)
    assert ref_s.pool_cache.stats() == port_s.pool_cache.stats()


def test_run_batch_equals_per_query_loop(streams, monkeypatch):
    """The fused session and the per-query loop agree inside the port,
    under the kernel routing the card takes by default (here on the plain
    versions, which round like the kernels)."""
    _, _, pq, pc = streams
    monkeypatch.setattr(port_pareto, "_KERNEL_MIN_N", 0)
    monkeypatch.setattr(port_hmooc, "_WS_MIN_SCORES", 0)
    loop = _per_query(run_with_aqe, port_rt.make_runtime_optimizers, pq, pc,
                      device=CPU)
    fused = RuntimeSession(weights=WEIGHTS, device=CPU).run_batch(pq, pc)
    for a, b in zip(loop, fused):
        _assert_aqe_equal(a, b)


@pytest.mark.parametrize("gamma_mode", ["off", "structural", "live"])
def test_model_session_decisions_equal(streams, gamma_mode):
    """The model-backed session under each γ option, with the reference's
    weights carried across: the same candidate rows are chosen (no pick of
    these streams is a near tie, so float32 sums in another order do not
    flip one)."""
    rq, rc, pq, pc = streams
    ref_sub, ref_qs = _ref_models()
    port_sub, port_qs = carry(ref_sub), carry(ref_qs)
    ref = RefRuntimeSession(model_subq=ref_sub, model_qs=ref_qs,
                            weights=WEIGHTS, gamma_mode=gamma_mode
                            ).run_batch(rq[:4], rc[:4])
    got = RuntimeSession(model_subq=port_sub, model_qs=port_qs,
                         weights=WEIGHTS, gamma_mode=gamma_mode,
                         device=CPU).run_batch(pq[:4], pc[:4])
    for a, b in zip(ref, got):
        assert a.requests_sent == b.requests_sent
        np.testing.assert_allclose(a.theta_p_eff, b.theta_p_eff, rtol=1e-12)
        np.testing.assert_allclose(a.theta_s_eff, b.theta_s_eff, rtol=1e-12)
        np.testing.assert_array_equal(a.final_join, b.final_join)


def test_bad_gamma_mode_and_batch_size_raise():
    with pytest.raises(ValueError, match="gamma_mode"):
        RuntimeSession(gamma_mode="sometimes", device=CPU)
    with pytest.raises(ValueError, match="compile results"):
        RuntimeSession(device=CPU).run_batch(serving_stream("tpch", 2), [])


# ---------------------------------------------------------------------------
# weighted_pick_batch
# ---------------------------------------------------------------------------

def _sets(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((n, 2)) * 10).astype(np.float32).astype(np.float64)
            for n in (5, 66, 130, 257)]


@pytest.mark.parametrize("per_set", [False, True])
def test_weighted_pick_batch_equal(per_set, routing):
    Fs = _sets()
    w = (np.array([[0.9, 0.1], [0.5, 0.5], [0.9, 0.1], [0.2, 0.8]])
         if per_set else WEIGHTS)
    want = ref_rt.weighted_pick_batch(Fs, w)
    got = port_rt.weighted_pick_batch(Fs, w, device=CPU)
    assert got == want
    if per_set:               # each set picks as it would alone
        assert got == [port_rt.weighted_pick_batch([F], row, device=CPU)[0]
                       for F, row in zip(Fs, w)]


def test_weighted_pick_batch_one_mask_call_forced(monkeypatch):
    """Forced kernel routing: every set clears the threshold, and one
    ``pareto_masks_fast`` call filters all of them, whatever the weight
    groups; the picks equal the reference's per-set masks (Pallas in
    interpret mode)."""
    for mod, name in ((ref_pareto, "_KERNEL_MIN_N"),
                      (port_pareto, "_KERNEL_MIN_N")):
        monkeypatch.setattr(mod, name, 0)
    calls = []
    real = port_rt.pareto_masks_fast

    def spy(Fs, **kw):
        calls.append(len(Fs))
        return real(Fs, **kw)

    monkeypatch.setattr(port_rt, "pareto_masks_fast", spy)
    Fs = _sets(seed=4) + _sets(seed=5)
    w = np.array([[0.9, 0.1], [0.5, 0.5], [0.2, 0.8], [0.9, 0.1]] * 2)
    for weights in (WEIGHTS, w):
        calls.clear()
        got = port_rt.weighted_pick_batch(Fs, weights, device=CPU)
        assert calls == [len(Fs)]
        assert got == ref_rt.weighted_pick_batch(Fs, weights)


def test_weighted_pick_batch_rejects_misaligned_weights():
    with pytest.raises(ValueError, match="weight rows"):
        port_rt.weighted_pick_batch(_sets(), np.ones((3, 2)), device=CPU)


# ---------------------------------------------------------------------------
# Model backend
# ---------------------------------------------------------------------------

def _ref_models():
    gtn = RefGTNConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32)
    msub = RefPerfModel(RefModelConfig("subq", 19, gtn=gtn, hidden=(16,)),
                        seed=0)
    mqs = RefPerfModel(RefModelConfig("qs", 10, gtn=gtn, hidden=(16,)),
                       seed=1)
    return msub, mqs


def test_model_backend_objectives_close(streams):
    """Every (join, decision) request of the stream scored by the
    reference's models and by the port's with the same weights."""
    rq, rc, pq, pc = streams
    ref_sub, ref_qs = _ref_models()
    port_sub, port_qs = carry(ref_sub), carry(ref_qs)
    ref_reqs, port_reqs = [], []
    for qa, ca, qb, cb in zip(rq, rc, pq, pc):
        ba = ref_rt.RuntimeOptimizerBackend(
            qa, ca.theta_c, seed_theta_p=ca.theta_p_sub,
            seed_theta_s=ca.theta_s_sub, model_subq=ref_sub,
            model_qs=ref_qs, n_candidates=16)
        bb = port_rt.RuntimeOptimizerBackend(
            qb, cb.theta_c, seed_theta_p=cb.theta_p_sub,
            seed_theta_s=cb.theta_s_sub, model_subq=port_sub,
            model_qs=port_qs, n_candidates=16, device=CPU)
        np.testing.assert_array_equal(ba.gamma_by_stage, bb.gamma_by_stage)
        for sa, sb in zip(qa.subqs, qb.subqs):
            tp, ts = ba.lqp_candidates(sa, ca.theta_p0)
            ref_reqs.append(ref_rt.ScoreRequest(ba, sa, tp, ts, "lqp"))
            port_reqs.append(port_rt.ScoreRequest(bb, sb, tp, ts, "lqp"))
            tp, ts = ba.qs_candidates(sa, ca.theta_s0)
            ref_reqs.append(ref_rt.ScoreRequest(ba, sa, tp, ts, "qs"))
            port_reqs.append(port_rt.ScoreRequest(bb, sb, tp, ts, "qs"))
    want = ref_rt.score_requests(ref_reqs)
    got = port_rt.score_requests(port_reqs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4)


# ---------------------------------------------------------------------------
# Candidate pools, device selection
# ---------------------------------------------------------------------------

def test_candidate_pool_cache_equal_and_frozen():
    ref, port = RefPoolCache(max_entries=2), CandidatePoolCache(max_entries=2)
    for seed, n, scope in ((0, 64, None), (0, 64, "a"), (1, 8, None),
                           (0, 64, None)):
        for a, b in zip(ref.get(seed, n, scope=scope),
                        port.get(seed, n, scope=scope)):
            np.testing.assert_array_equal(a, b)
            assert not b.flags.writeable
    assert ref.stats() == port.stats()
    fresh = CandidatePoolCache()
    assert fresh.restore(port.snapshot()) == len(port)
    for a, b in zip(fresh.get(0, 64), port.get(0, 64)):
        np.testing.assert_array_equal(a, b)
        assert not a.flags.writeable
    assert fresh.misses == 0


def test_without_card_entry_points_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RuntimeSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rt.weighted_pick_batch(_sets(), WEIGHTS)
    q = serving_stream("tpch", 1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rt.make_runtime_optimizers(q, np.zeros(8))
