"""The port's in-memory tracer (``repro_torch.tracing``) on the streaming
server's paths, on the host.

* Off by default: ``ServerStats.trace`` is None, and a traced serve
  answers bit-equal to an untraced one.
* On: every span lies inside its parent, every served rid sits in one
  ``flush`` span, the counter deltas of the ``flush`` and ``round`` spans
  add up to what the kernels and models counted over the call, a round's
  embedding misses take one GTN dispatch a model, and the embedding memo
  counts every miss.
* A ``torch.profiler`` turns tracing on for the ``serve`` call it records
  and no longer, and ``Trace.offset_ns`` puts the spans on its clock; a
  caller's ``tracing.recording()`` gets the call's spans in its trace.

Random-weight models at small widths and a ``ServiceTimeModel`` clock, so
two serves of one stream compose the same batches.
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.models.gtn import GTNConfig
from repro_torch.core.models.perf_model import ModelConfig, PerfModel
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.queryengine.workloads import (ArrivalModel, TenantSpec,
                                               multi_tenant_stream,
                                               serving_stream)
from repro_torch.serve import (OptimizerServer, RuntimeSession, ServerConfig,
                               ServiceTimeModel, TuningService)

GTN = GTNConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32)
CFG = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                  max_bank=12, seed=3)
CLOCK = ServiceTimeModel(flush_points=((1, 0.05), (4, 0.12), (8, 0.2)),
                         round_s=0.005, cheap_s=0.001)
# Each span's parent; a degraded request's solve (``_tune_cheap``) runs
# its stage evaluation and embeds its stages straight under ``tune``.
PARENTS = {"flush": "serve", "round": "serve", "tune": "flush",
           "session_admit": "flush", "tune.responses": "tune",
           "tune.embed": "tune", "tune.esets": "tune", "tune.phase": "tune",
           "tune.finalize": "tune", "stage_eval": "tune.phase tune",
           "hmooc.feed": "tune.phase", "stage_eval.assemble": "stage_eval",
           "stage_eval.dollars": "stage_eval",
           "model.predict_rows": "stage_eval", "round.score": "round",
           "model.embed": "round.score tune.embed tune.esets tune",
           "round.pick": "round", "round.retire": "round"}


def _stream(kind):
    if kind == "single":
        return serving_stream("tpch", 10, seed=11,
                              arrivals=ArrivalModel(rate_qps=40.0)), ()
    specs = [TenantSpec(name="strict", slo="strict", solve_budget_s=0.0,
                        arrivals=ArrivalModel(rate_qps=40.0)),
             TenantSpec(name="deg", slo="degrade", solve_budget_s=0.0,
                        arrivals=ArrivalModel(rate_qps=40.0)),
             TenantSpec(name="lat", weights=(0.9, 0.1),
                        arrivals=ArrivalModel(rate_qps=40.0))]
    return multi_tenant_stream("tpch", specs, 4, seed=17), specs


def _server(specs):
    subq = PerfModel(ModelConfig("subq", 19, GTN, (16,)), seed=0,
                     device="cpu")
    qs = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device="cpu")
    return OptimizerServer(
        config=ServerConfig(max_batch=3, clock=CLOCK),
        tuning=TuningService(model=subq, cfg=CFG, device="cpu"),
        session=RuntimeSession(model_subq=subq, model_qs=qs,
                               weights=(0.9, 0.1), device="cpu"),
        tenants=specs)


@pytest.fixture(scope="module", params=["single", "overload"])
def traced(request):
    """(untraced served, traced server, its served, its counters before
    and after the traced call)."""
    reqs, specs = _stream(request.param)
    plain = _server(specs).serve(reqs)
    srv = _server(specs)
    before = srv.counters()
    tracing.enable()
    try:
        served = srv.serve(reqs)
    finally:
        tracing.disable()
    return plain, srv, served, before, srv.counters()


def _spans(srv, name):
    return [sp for sp in srv.last_run.trace.spans if sp.name == name]


def _under(srv, sp, name):
    """Whether ``sp`` lies under a span called ``name``."""
    spans = srv.last_run.trace.spans
    while sp.parent >= 0:
        sp = spans[sp.parent]
        if sp.name == name:
            return True
    return False


def test_off_by_default():
    assert not tracing.enabled() and tracing.TRACE is None
    reqs, specs = _stream("single")
    srv = _server(specs)
    srv.serve(reqs[:3])
    assert srv.last_run.trace is None


def test_traced_serve_answers_bit_equal(traced):
    plain, srv, served, _, _ = traced
    assert srv.last_run.trace is not None and tracing.TRACE is None
    rows = lambda out: [(s.rid, s.tenant, s.status, s.admitted_s,  # noqa
                         s.compiled_s, s.finished_s) for s in out]
    assert rows(served) == rows(plain)
    for a, b in zip(served, plain):
        assert (a.result is None) == (b.result is None)
        if a.result is None:
            continue
        np.testing.assert_array_equal(a.ct.theta_c, b.ct.theta_c)
        np.testing.assert_array_equal(a.ct.front, b.ct.front)
        for f in ("theta_p_eff", "theta_s_eff", "final_join"):
            np.testing.assert_array_equal(getattr(a.result, f),
                                          getattr(b.result, f))
        np.testing.assert_array_equal(a.result.sim.cost, b.result.sim.cost)


def test_every_span_lies_inside_its_parent(traced):
    _, srv, _, _, _ = traced
    spans = srv.last_run.trace.spans
    assert spans[0].name == "serve" and spans[0].parent == -1
    for i, sp in enumerate(spans):
        assert sp.t0_ns <= sp.t1_ns
        if i == 0:
            continue
        assert 0 <= sp.parent < i
        par = spans[sp.parent]
        assert par.t0_ns <= sp.t0_ns and sp.t1_ns <= par.t1_ns
        if sp.name in PARENTS:
            assert par.name in PARENTS[sp.name].split(), (sp.name, par.name)
    names = {sp.name for sp in spans}
    assert {"flush", "round", "tune", "stage_eval", "model.predict_rows",
            "hmooc.feed", "session_admit", "round.score"} <= names


def test_every_served_rid_in_one_flush(traced):
    _, srv, served, _, _ = traced
    rids = [r for sp in _spans(srv, "flush") for r in sp.attrs["rids"]]
    assert sorted(rids) == sorted(s.rid for s in served
                                  if s.status in ("served", "degraded"))
    assert len(rids) == len(set(rids))
    feeds = _spans(srv, "hmooc.feed")
    assert feeds and all(sp.attrs["phase"] in ("banks", "assign")
                         for sp in feeds)
    for sp in feeds:
        flush = srv.last_run.trace.spans[sp.parent]
        while flush.name != "flush":
            flush = srv.last_run.trace.spans[flush.parent]
        assert 0 <= sp.attrs["pos"] < len(flush.attrs["rids"])


def test_counter_deltas_add_up(traced):
    _, srv, _, before, after = traced
    flushes, rounds = _spans(srv, "flush"), _spans(srv, "round")
    assert set(after) == {"k1_launches", "emb_misses", "emb_wide_misses",
                          "emb_dispatches", "h2d_copies", "rows_predicted",
                          "theta_rows_sent"}
    for name in after:
        assert sum(sp.attrs["counters"][name]
                   for sp in flushes + rounds) == \
            after[name] - before[name], name
    solved = sum(sp.attrs["n_solved"] for sp in flushes)
    assert solved == sum(sp.attrs["n_solved"] for sp in _spans(srv, "tune"))
    assert solved > 0
    # K1 launches on the card only (the CUDA tests count it); on the host
    # every model call copies its three arrays.
    assert after["emb_misses"] > before["emb_misses"]
    assert sum(sp.attrs["counters"]["emb_misses"] for sp in rounds) > 0
    # A round's misses take one GTN dispatch a model with misses (two
    # models here), each a ``model.embed`` span that counts its graphs.
    for sp in rounds:
        c = sp.attrs["counters"]
        assert (c["emb_misses"] > 0) <= (c["emb_dispatches"] > 0)
        assert c["emb_dispatches"] <= min(2, c["emb_misses"])
    embeds = [sp for sp in _spans(srv, "model.embed")
              if _under(srv, sp, "round")]
    assert sum(sp.attrs["counters"]["emb_misses"] for sp in rounds) == \
        sum(sp.attrs["graphs"] for sp in embeds)
    assert sum(sp.attrs["counters"]["emb_dispatches"] for sp in rounds) == \
        len(embeds)
    # The stage evaluation's fused call copies its inputs in once.
    assert sum(sp.attrs["counters"]["h2d_copies"] for sp in flushes) >= \
        len(_spans(srv, "model.predict_rows"))


def test_flush_spans_count_rows_and_theta_rows(traced):
    """Every ``flush`` span carries the ``rows_predicted`` and
    ``theta_rows_sent`` deltas: the rows its ``model.predict_rows`` spans
    scored, and the θ rows copied for them, fewer wherever a plan's subQs
    shared one θ block (the banks phase); rounds score none."""
    _, srv, _, _, _ = traced
    flushes, rounds = _spans(srv, "flush"), _spans(srv, "round")
    spans = srv.last_run.trace.spans
    for sp in rounds:
        c = sp.attrs["counters"]
        assert c["rows_predicted"] == c["theta_rows_sent"] == 0
    rows = {i: 0 for i, sp in enumerate(spans) if sp.name == "flush"}
    for sp in _spans(srv, "model.predict_rows"):
        up = sp
        while up.name != "flush":
            up = spans[up.parent]
        rows[spans.index(up)] += sp.attrs["rows"]
    for i, n in rows.items():
        c = spans[i].attrs["counters"]
        assert c["rows_predicted"] == n
        assert 0 <= c["theta_rows_sent"] <= n
        assert (c["theta_rows_sent"] > 0) == (n > 0)
    sent = sum(sp.attrs["counters"]["theta_rows_sent"] for sp in flushes)
    scored = sum(sp.attrs["counters"]["rows_predicted"] for sp in flushes)
    assert 0 < sent < scored


def test_embedding_memo_counts_every_lookup():
    m = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device="cpu")
    queries = serving_stream("tpch", 3, seed=2)
    pairs = [(q, i) for q in queries for i in range(q.n_subqs)]
    m.embed_many(pairs + pairs[:2])
    assert m.emb_misses == len(m._emb_cache) == len(pairs)
    for q, i in pairs[:3]:
        m.embed(q, i)
    assert m.emb_misses == len(pairs)
    extra = serving_stream("tpch", 1, seed=9)[0]
    m.embed(extra, 0)
    m.embed(extra, 0)
    assert m.emb_misses == len(m._emb_cache) == len(pairs) + 1


def test_padded_rows_and_copies_counted():
    m = PerfModel(ModelConfig("subq", 19, GTN, (16,)), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    emb = rng.random((70, GTN.d_model), np.float32)
    theta = rng.random((70, 19), np.float32)
    nond = rng.random((70, 12), np.float32)
    m.predict_rows(emb, theta, nond)
    assert (m.rows_predicted, m.h2d_copies) == (70, 3)
    m.predict(emb[0], theta[:5], nond[:5])
    assert (m.rows_predicted, m.h2d_copies) == (70, 6)


def test_profiler_helper_reads_torchs_flag():
    assert not tracing.profiler_recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.profiler_recording()
    assert not tracing.profiler_recording()
    with torch.autograd.profiler.profile():
        assert tracing.profiler_recording()
    assert not tracing.profiler_recording()


def test_profiler_traces_one_serve_on_its_clock(monkeypatch):
    reqs, specs = _stream("single")
    srv = _server(specs)
    model = srv.tuning.model
    head = model.net.head

    def head_marked(*a):
        with torch.autograd.profiler.record_function("head_probe"):
            return head(*a)
    monkeypatch.setattr(model.net, "head", head_marked)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        srv.serve(reqs[:6])
    trace = srv.last_run.trace
    assert trace is not None and tracing.TRACE is None
    marks = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == "head_probe"]
    assert marks
    windows = [(sp.t0_ns + trace.offset_ns, sp.t1_ns + trace.offset_ns,
                sp.name) for sp in trace.spans
               if sp.name in ("model.predict_rows", "model.predict")]
    inside = [next((name for a, b, name in windows if a <= t0 and t1 <= b),
                   None) for t0, t1 in marks]
    assert None not in inside and "model.predict_rows" in inside
    srv.serve(reqs[6:])
    assert srv.last_run.trace is None


def test_close_ends_spans_left_open_inside():
    with tracing.recording() as tr:
        outer = tr.open("outer")
        tr.open("inner")                    # an exception's path
        tr.close(outer, n=1)
        tr.open("left")
    assert [sp.parent for sp in tr.spans] == [-1, 0, -1]
    assert tr.spans[1].t1_ns == tr.spans[0].t1_ns
    assert tr.spans[0].attrs == {"n": 1} and tr.spans[1].attrs is None
    assert tr.spans[2].t1_ns >= tr.spans[2].t0_ns > 0
    assert tracing.TRACE is None


def test_recording_nests_and_restores():
    with tracing.recording() as outer:
        sp = outer.open("a")
        with tracing.recording() as inner:
            assert tracing.TRACE is inner
            inner.close(inner.open("b"))
        assert tracing.TRACE is outer
        outer.close(sp)
    assert tracing.TRACE is None
    assert [s.name for s in outer.spans] == ["a"]
    assert [s.name for s in inner.spans] == ["b"]
    assert tracing.seconds_by_name(outer)["a"] >= 0.0


def test_serve_records_into_a_callers_trace():
    reqs, specs = _stream("single")
    srv = _server(specs)
    with tracing.recording() as tr:
        outer = tr.open("caller")
        srv.serve(reqs[:4])
        tr.close(outer)
    assert srv.last_run.trace is tr and not tracing.enabled()
    assert [sp.name for sp in tr.spans[:2]] == ["caller", "serve"]
    assert tr.spans[1].parent == 0
    names = {sp.name for sp in tr.spans}
    assert {"flush", "tune", "stage_eval", "round"} <= names
    srv.serve(reqs[4:])
    assert srv.last_run.trace is None
