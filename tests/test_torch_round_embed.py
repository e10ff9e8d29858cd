"""A runtime round's GTN embeddings (``PerfModel.embed_round``), on the host.

* ``step_round`` over model-backed entries resolves a round's k QS-model
  misses in exactly one dispatch and counts k ``emb_misses``; the L̄QP
  stages the compile-time solve embedded cost a lookup; a round without
  misses makes no dispatch.
* A round's embeddings, and a flush's (``embed_many``, the same
  function), are bit-equal to a fresh model's one-at-a-time ``embed`` of
  the same graphs, in any company and in chunks.
* A model-backed ``OptimizerServer.serve`` answers bit-equal to one whose
  rounds embed one graph a dispatch.

Random-weight models at small widths, as in ``test_torch_tracing.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.models.gtn import GTNConfig
from repro_torch.core.models.perf_model import (ROUND_WIDTH, ModelConfig,
                                                PerfModel)
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.queryengine.workloads import ArrivalModel, serving_stream
from repro_torch.serve import (OptimizerServer, RuntimeSession, ServerConfig,
                               ServiceTimeModel, TuningService)

GTN = GTNConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32)
CFG = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                  max_bank=12, seed=3)
CLOCK = ServiceTimeModel(flush_points=((1, 0.05), (4, 0.12), (8, 0.2)),
                         round_s=0.005, cheap_s=0.001)
WEIGHTS = (0.9, 0.1)
CPU = "cpu"
STREAMS = {"tpch": (8, 1), "tpcds": (5, 2)}      # (queries, seed)


def _models():
    subq = PerfModel(ModelConfig("subq", 19, GTN, (16,)), seed=0, device=CPU)
    qs = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device=CPU)
    return subq, qs


def _qs_misses(session, qs):
    """Distinct (query, stage) pairs the next round's QS requests need
    and the QS model's memo lacks."""
    keys = {(id(e.query), e.query.qid, e.pending.subq.sq_id, "qs")
            for e in session._active
            if e.pending is not None and e.pending.kind == "qs"}
    return len(keys - set(qs._emb_cache))


def _run_rounds(session, subq, qs):
    """Step the session to idle; per round (expected QS misses, QS
    dispatches, QS misses counted, subQ dispatches)."""
    rows = []
    while session.has_pending():
        k = _qs_misses(session, qs)
        d0, m0, s0 = qs.emb_dispatches, qs.emb_misses, subq.emb_dispatches
        session.step_round()
        rows.append((k, qs.emb_dispatches - d0, qs.emb_misses - m0,
                     subq.emb_dispatches - s0))
        session.retire_ready()
    return rows


@pytest.fixture(scope="module", params=sorted(STREAMS))
def compiled(request):
    n, seed = STREAMS[request.param]
    queries = serving_stream(request.param, n, seed=seed)
    subq, qs = _models()
    cts = TuningService(model=subq, cfg=CFG, device=CPU).tune_batch(
        queries, WEIGHTS)
    return queries, cts, subq


def _session(compiled):
    """A session over the compiled queries with a fresh QS model."""
    queries, cts, subq = compiled
    qs = _models()[1]
    session = RuntimeSession(model_subq=subq, model_qs=qs, weights=WEIGHTS,
                             device=CPU)
    for q, ct in zip(queries, cts):
        session.admit(q, ct)
    return session, subq, qs


def test_round_resolves_its_misses_in_one_dispatch(compiled):
    session, subq, qs = _session(compiled)
    rows = _run_rounds(session, subq, qs)
    assert max(k for k, _, _, _ in rows) >= 2
    for k, dispatches, misses, subq_dispatches in rows:
        assert misses == k
        assert dispatches == (1 if k else 0)
        # The L̄QP stages are the ones the compile-time solve embedded.
        assert subq_dispatches == 0


def test_round_without_misses_makes_no_dispatch(compiled):
    session, subq, qs = _session(compiled)
    _run_rounds(session, subq, qs)
    # The same Query objects again: every embedding is in the memo.
    queries, cts, _ = compiled
    for q, ct in zip(queries, cts):
        session.admit(q, ct)
    rows = _run_rounds(session, subq, qs)
    assert rows and all(r == (0, 0, 0, 0) for r in rows)


def _pairs(bench, n, seed):
    """The distinct (query, stage) pairs of a stream (it repeats
    queries)."""
    queries = {id(q): q for q in serving_stream(bench, n, seed=seed)}
    return [(q, i) for q in queries.values() for i in range(q.n_subqs)]


@pytest.mark.parametrize("entry", ["embed_many", "embed_round"])
@pytest.mark.parametrize("bench", sorted(STREAMS))
@pytest.mark.parametrize("width", [None, 4])
def test_round_embeddings_bit_equal_to_one_at_a_time(bench, width, entry,
                                                     monkeypatch):
    """Rounds of 1 to all of the graphs, in shuffled company, through
    either entry; ``width`` 4 chunks them as the card's fixed width does,
    here at 4 graphs."""
    if width is not None:
        monkeypatch.setattr(PerfModel, "_embed_width", lambda self, n: width)
    pairs = _pairs(bench, 10, 5)
    alone = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device=CPU)
    want = [alone.embed(q, i) for q, i in pairs]
    assert alone.emb_dispatches == len(pairs)
    rng = np.random.default_rng(0)
    for size in (1, 2, 3, 7, len(pairs)):
        m = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device=CPU)
        order = rng.permutation(len(pairs))
        chunks = [len(order[lo:lo + size])
                  for lo in range(0, len(pairs), size)]
        for lo in range(0, len(pairs), size):
            getattr(m, entry)([pairs[j] for j in order[lo:lo + size]])
        assert m.emb_misses == len(pairs)
        assert m.emb_dispatches == sum(-(-c // (width or c)) for c in chunks)
        for (q, i), w in zip(pairs, want):
            np.testing.assert_array_equal(m.embed(q, i), w)
        assert m.emb_misses == len(pairs)


def test_round_width_is_fixed_on_the_card():
    m = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device=CPU)
    assert [m._embed_width(n) for n in (1, 2, 3, 5, 64)] == [1, 2, 4, 8, 64]
    m.device = torch.device("cuda")
    assert {m._embed_width(n) for n in (1, 5, 38, 200)} == {ROUND_WIDTH}


def _serve(bench):
    n, seed = STREAMS[bench]
    reqs = serving_stream(bench, 2 * n, seed=seed,
                          arrivals=ArrivalModel(rate_qps=40.0))
    subq, qs = _models()
    srv = OptimizerServer(
        config=ServerConfig(max_batch=3, clock=CLOCK),
        tuning=TuningService(model=subq, cfg=CFG, device=CPU),
        session=RuntimeSession(model_subq=subq, model_qs=qs,
                               weights=WEIGHTS, device=CPU))
    return srv.serve(reqs), qs


@pytest.mark.parametrize("bench", sorted(STREAMS))
def test_serve_equal_to_one_graph_a_dispatch(bench, monkeypatch):
    fused, qs_fused = _serve(bench)

    def one_at_a_time(self, pairs):
        for q, i in pairs:
            self.embed(q, i)
    monkeypatch.setattr(PerfModel, "embed_round", one_at_a_time)
    alone, qs_alone = _serve(bench)
    assert qs_fused.emb_misses == qs_alone.emb_misses > 0
    assert qs_fused.emb_dispatches < qs_alone.emb_dispatches
    assert [(s.rid, s.status) for s in fused] == \
        [(s.rid, s.status) for s in alone]
    for a, b in zip(fused, alone):
        assert (a.result is None) == (b.result is None)
        if a.result is None:
            continue
        np.testing.assert_array_equal(a.ct.theta_c, b.ct.theta_c)
        np.testing.assert_array_equal(a.ct.front, b.ct.front)
        for f in ("theta_p_eff", "theta_s_eff", "final_join"):
            np.testing.assert_array_equal(getattr(a.result, f),
                                          getattr(b.result, f))
        np.testing.assert_array_equal(a.result.sim.cost, b.result.sim.cost)
