"""Stages wider than four operators through the port's performance model,
on the host.

TPC-H's own queries, as Spark stages them (``portbench/queries/
tpch_spec.py``), hold stages of five to seven operators; the synthetic
generators' stages hold one to three.  ``PerfModel._graph`` pads a stage
of ``n`` operators to ``max(4, next power of two ≥ n)`` nodes, and
``_fill`` makes one GTN dispatch a node width (and a batch of misses).

* Every stage of the 22 queries, two variants each, embeds and scores as
  the benchmark's plain reference (``portbench/reference/model.py``) does.
* A stage of four operators or fewer keeps the arrays and the bits it had
  when every stage was padded to four.
* A call that mixes widths gives each graph the bits it has alone, and
  makes one dispatch a width; ``model.embed`` spans carry the width and
  ``emb_wide_misses`` counts the wide misses on the ``flush`` and
  ``round`` spans.
* A graph larger than its width is refused; training pads to the widest
  stage of its set.

Seeded random weights: the benchmark's own draw, or small models.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import bench as bench_mod  # noqa: E402
from portbench.harness import cell  # noqa: E402
from portbench.reference import model as rm  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core.models import features as pf  # noqa: E402
from repro_torch.core.models import training  # noqa: E402
from repro_torch.core.models.gtn import GTNConfig  # noqa: E402
from repro_torch.core.models.perf_model import (ModelConfig,  # noqa: E402
                                                PerfModel)
from repro_torch.core.moo.hmooc import HMOOCConfig  # noqa: E402
from repro_torch.queryengine import trace  # noqa: E402
from repro_torch.queryengine.plan import Operator, Query, SubQ  # noqa: E402
from repro_torch.queryengine.workloads import (StreamRequest,  # noqa: E402
                                               serving_stream)
from repro_torch.serve import (OptimizerServer, RuntimeSession,  # noqa: E402
                               ServerConfig, ServiceTimeModel, TuningService)

SPEC = bench_mod.query_module("tpch_spec")
SPEC_QUERIES = [SPEC.make_query(t, variant=v, seed=2 ** 31 + 11)
                for t in range(SPEC.N_TEMPLATES) for v in (0, 3)]
GTN = GTNConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32)
CPU = "cpu"


def _bench_models():
    """The benchmark's configuration models at its widths and weights: the
    port's on the host and the reference's float64 networks."""
    cfg = bench_mod.Benchmark().config("tpch_spec")
    cfgs = cell.model_configs(cfg)
    dev_w, host_w = cell.make_weights(cfgs, cfg["models"]["model_seed"], CPU)
    port = {k: PerfModel(c, params=dev_w[k], device=CPU)
            for k, c in cfgs.items()}
    ref = {k: rm.Net(host_w[k], cfgs[k].gtn.n_heads, cfgs[k].gtn.n_layers)
           for k in cfgs}
    return cfgs, port, ref


@pytest.mark.parametrize("kind", ["subq", "qs"])
def test_spec_stages_match_the_reference(kind):
    """Embeddings and head outputs of every stage of the 22 queries (two
    variants) against the reference, which embeds each stage at its own
    operator count.  The port runs float32 with TF32 off and the reference
    float64, so the bounds are float32 rounding through the network: the
    ones ``portbench/tests/test_portbench_reference.py`` holds the
    synthetic plans to (1e-5 on embeddings, 2e-5 relative on targets)."""
    cfgs, port, ref = _bench_models()
    model, net = port[kind], ref[kind]
    est = kind == "subq"
    pairs = [(q, i) for q in SPEC_QUERIES for i in range(q.n_subqs)]
    sizes = {len(q.subqs[i].op_ids) for q, i in pairs}
    assert max(sizes) >= 5 and min(sizes) <= 4
    model.embed_many(pairs)
    assert model.emb_misses == len(pairs)
    assert model.emb_wide_misses == sum(len(q.subqs[i].op_ids) > 4
                                        for q, i in pairs) > 0
    E = rm.embeddings(net, [(q, i, est) for q, i in pairs])
    rng = np.random.default_rng(7)
    for q, i in pairs:
        got, want = model.embed(q, i), E[(id(q), i, est)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{q.qid} stage {i}")
        theta = rng.random((5, cfgs[kind].theta_dim)).astype(np.float32)
        nond = rm.nondecision(rm.alpha(q.subqs[i].input_rows,
                                       q.subqs[i].input_bytes))
        np.testing.assert_allclose(
            model.predict(got, theta, nond),
            net.head(np.broadcast_to(want, (5, want.size)), theta,
                     np.broadcast_to(nond, (5, nond.size))),
            rtol=2e-5, atol=1e-7, err_msg=f"{q.qid} stage {i}")


def _narrow_graph(self, query, sq_id):
    """``PerfModel._graph`` as it was: every stage padded to four."""
    return pf.featurize_subq(query, sq_id, use_est=self.cfg.use_est,
                             n_pad=4)


@pytest.mark.parametrize("bench", ["tpch", "tpcds"])
@pytest.mark.parametrize("kind,theta_dim", [("subq", 19), ("qs", 10)])
def test_narrow_stages_keep_their_arrays_and_bits(bench, kind, theta_dim,
                                                  monkeypatch):
    queries = {id(q): q for q in serving_stream(bench, 12, seed=3)}
    pairs = [(q, i) for q in queries.values() for i in range(q.n_subqs)]
    assert max(len(q.subqs[i].op_ids) for q, i in pairs) <= 4
    m = PerfModel(ModelConfig(kind, theta_dim, GTN, (16,)), seed=1,
                  device=CPU)
    for q, i in pairs:
        for a, b in zip(m._graph(q, i), _narrow_graph(m, q, i)):
            assert a.shape == b.shape and np.array_equal(a, b)
    m.embed_many(pairs)
    assert m.emb_wide_misses == 0 and m.emb_dispatches == 1
    monkeypatch.setattr(PerfModel, "_graph", _narrow_graph)
    old = PerfModel(ModelConfig(kind, theta_dim, GTN, (16,)), seed=1,
                    device=CPU)
    old.embed_many(pairs)
    for q, i in pairs:
        np.testing.assert_array_equal(m.embed(q, i), old.embed(q, i))


def _chain_query(qid: str, sizes) -> Query:
    """A query of one stage a size, each a chain of that many operators
    (scan, then filters), the stages joined in a chain."""
    ops, subqs = [], []
    rng = np.random.default_rng(len(qid))
    for s, n in enumerate(sizes):
        ids = []
        for j in range(n):
            kind = "scan" if j == 0 else ("join" if j == 1 and s else
                                          "filter")
            ch = [ids[-1]] if ids else []
            if kind == "join":
                ch.append(subqs[-1].root_op)
            rows = float(rng.uniform(1e3, 1e8))
            ops.append(Operator(len(ops), kind, ch, rows, rows * 40,
                                rows * 1.3, rows * 52, ("tok", str(j))))
            ids.append(len(ops) - 1)
        subqs.append(SubQ(sq_id=s, op_ids=ids, children=[s - 1] if s else [],
                          kind="join" if s else "scan", root_op=ids[-1],
                          input_rows=(1e6, 1e5), input_bytes=(4e7, 4e6),
                          est_input_rows=(1e6, 1e5),
                          est_input_bytes=(4e7, 4e6), depth=s))
    return Query(qid=qid, ops=ops, subqs=subqs, benchmark="chain")


def _mixed_pairs():
    qs = [_chain_query(f"mixed-{k}", sizes) for k, sizes in
          enumerate([(3, 7, 9), (9, 2, 7), (7, 3), (4, 9, 3, 7)])]
    return [(q, i) for q in qs for i in range(q.n_subqs)]


@pytest.mark.parametrize("entry", ["embed_many", "embed_round"])
@pytest.mark.parametrize("width", [None, 2])
def test_mixed_widths_embed_as_alone(entry, width, monkeypatch):
    """A call of 3-, 7- and 9-operator stages (node widths 4, 8 and 16)
    gives every graph the bits of its lone ``embed``, in any order and
    company; one dispatch a width, or ``width`` graphs a dispatch as the
    card's fixed batch width chunks them."""
    if width is not None:
        monkeypatch.setattr(PerfModel, "_embed_width", lambda self, n: width)
    pairs = _mixed_pairs()
    alone = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=2, device=CPU)
    want = [alone.embed(q, i) for q, i in pairs]
    pads = [alone._graph(q, i)[0].shape[0] for q, i in pairs]
    assert sorted(set(pads)) == [4, 8, 16]
    rng = np.random.default_rng(0)
    for _ in range(3):
        m = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=2, device=CPU)
        order = rng.permutation(len(pairs))
        with tracing.recording() as tr:
            getattr(m, entry)([pairs[j] for j in order])
        embeds = [sp for sp in tr.spans if sp.name == "model.embed"]
        counts = {p: pads.count(p) for p in set(pads)}
        assert m.emb_dispatches == len(embeds) == sum(
            -(-c // (width or c)) for c in counts.values())
        # Widths in the order they first occur in the call.
        seen = list(dict.fromkeys(pads[j] for j in order))
        assert list(dict.fromkeys(sp.attrs["node_pad"]
                                  for sp in embeds)) == seen
        for p, c in counts.items():
            assert sum(sp.attrs["graphs"] for sp in embeds
                       if sp.attrs["node_pad"] == p) == c
        assert m.emb_wide_misses == counts[8] + counts[16]
        for (q, i), w in zip(pairs, want):
            np.testing.assert_array_equal(m.embed(q, i), w)


def test_build_graph_refuses_a_larger_graph():
    q19 = SPEC_QUERIES[2 * 18]
    wide = max(range(q19.n_subqs), key=lambda i: len(q19.subqs[i].op_ids))
    assert len(q19.subqs[wide].op_ids) == 7
    with pytest.raises(ValueError, match="7 operators.*width of 4"):
        pf.featurize_subq(q19, wide, use_est=True, n_pad=4)
    X = pf.featurize_subq(q19, wide, use_est=True, n_pad=8)[0]
    assert X.shape[0] == 8
    m = PerfModel(ModelConfig("subq", 19, GTN, (16,)), device=CPU)
    assert m._graph(q19, wide)[0].shape[0] == 8


CLOCK = ServiceTimeModel(flush_points=((1, 0.05), (4, 0.12), (8, 0.2)),
                         round_s=0.005, cheap_s=0.001)
SOLVER = HMOOCConfig(n_c_init=16, n_clusters=4, n_p_pool=48, n_c_enrich=12,
                     max_bank=12, seed=3)


def test_spans_carry_node_pad_and_wide_miss_deltas():
    """A traced serve of the 22 queries: each ``model.embed`` span names
    its node width, the ``emb_wide_misses`` deltas of the ``flush`` and
    ``round`` spans add up to the models' count over the call, and the
    wide spans hold exactly those misses."""
    subq = PerfModel(ModelConfig("subq", 19, GTN, (16,)), seed=0,
                     device=CPU)
    qs = PerfModel(ModelConfig("qs", 10, GTN, (16,)), seed=1, device=CPU)
    srv = OptimizerServer(
        config=ServerConfig(max_batch=4, clock=CLOCK),
        tuning=TuningService(model=subq, cfg=SOLVER, device=CPU),
        session=RuntimeSession(model_subq=subq, model_qs=qs, device=CPU))
    reqs = [StreamRequest(rid=t, query=SPEC.make_query(t, variant=1, seed=5),
                          arrival_s=0.05 * t) for t in range(22)]
    before = subq.emb_wide_misses + qs.emb_wide_misses
    tracing.enable()
    try:
        srv.serve(reqs)
    finally:
        tracing.disable()
    spans = srv.last_run.trace.spans
    delta = subq.emb_wide_misses + qs.emb_wide_misses - before
    assert delta > 0
    counted = sum(sp.attrs["counters"]["emb_wide_misses"] for sp in spans
                  if sp.name in ("flush", "round"))
    assert counted == delta
    embeds = [sp for sp in spans if sp.name == "model.embed"]
    assert {sp.attrs["node_pad"] for sp in embeds} == {4, 8}
    assert sum(sp.attrs["graphs"] for sp in embeds
               if sp.attrs["node_pad"] > 4) == delta
    flush_wide = sum(sp.attrs["counters"]["emb_wide_misses"] for sp in spans
                     if sp.name == "flush")
    assert 0 < flush_wide <= delta


@pytest.mark.parametrize("kind", ["subq", "qs"])
def test_training_pads_to_the_widest_stage(kind):
    """A set with a seven-operator stage pads every stage to eight nodes,
    and a short ``train_model`` on it runs; a set of narrow stages keeps
    four."""
    traces = trace.collect_traces(SPEC_QUERIES[:12] + SPEC_QUERIES[36:],
                                  3, seed=0)
    assert max(len(sq.op_ids) for q in traces.queries
               for sq in q.subqs) == 7
    ds, cfg = training.build_dataset(traces, kind)
    assert ds.graphs[0].shape[1] == 8
    m = training.train_model(ds, cfg, steps=12, batch=32, seed=0,
                             device=CPU)
    assert m.train_losses.shape == (12,)
    assert np.isfinite(m.train_losses).all()
    narrow = trace.collect_traces(serving_stream("tpch", 6, seed=2), 2,
                                  seed=0)
    assert training.build_dataset(narrow, kind)[0].graphs[0].shape[1] == 4
