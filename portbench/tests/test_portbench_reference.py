"""The plain reference against the port on the host: the same features,
the same network (float64 against the port's float32), the same
decisions."""
import numpy as np
import pytest

from portbench.harness import bench as bench_mod
from portbench.harness import cell, frozen
from portbench.reference import decisions as rd
from portbench.reference import model as rm
from repro_torch.core.models import features as pf
from repro_torch.core.models.perf_model import PerfModel, make_nondecision
from repro_torch.core.moo.pareto import pareto_mask_np
from repro_torch.core.moo.wun import wun_select
from repro_torch.core.tuning import runtime as prt
from repro_torch.core.tuning.spark_space import (theta_c_space,
                                                 theta_p_space,
                                                 theta_s_space)
from repro_torch.queryengine.trace import _alpha_stats

QUERIES = [frozen.make_query(b, t, variant=v)
           for b, n in (("tpch", 22), ("tpcds", 102))
           for t in range(0, n, 9) for v in (0, 5)]
TEST_QUERIES = bench_mod.ROOT / "portbench" / "tests" / "queries"
SPEC = bench_mod.query_module("spec_shapes", TEST_QUERIES)
SPEC_QUERIES = [SPEC.make_query(t, variant=v, seed=2 ** 31 + 11)
                for t in range(SPEC.N_TEMPLATES) for v in (0, 3)]


@pytest.mark.parametrize("use_est", [True, False])
def test_subq_graph_matches_port(use_est):
    for q in QUERIES:
        for i in range(q.n_subqs):
            got = rm.subq_graph(q, i, use_est, n_pad=4)
            want = pf.featurize_subq(q, i, use_est=use_est, n_pad=4)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)


def _local_adjacency(q, i):
    """The port's rule: an edge child -> parent inside the stage."""
    ops = q.subq_ops(i)
    local = {op.op_id: j for j, op in enumerate(ops)}
    A = np.zeros((len(ops), len(ops)), np.float32)
    for op in ops:
        for c in op.children:
            if c in local:
                A[local[c], local[op.op_id]] = 1.0
    return A


def test_spec_shapes_have_the_spec_plans_shapes():
    """The fixture holds what Spark's plans of Q19, Q15 and Q18 hold and
    the synthetic generators do not."""
    q19, q15, q18 = SPEC_QUERIES[0], SPEC_QUERIES[2], SPEC_QUERIES[4]
    assert max(len(sq.op_ids) for sq in q19.subqs) == 7
    consumers = [sum(s in sq.children for sq in q15.subqs)
                 for s in range(q15.n_subqs)]
    assert max(consumers) == 2
    kinds = [op.op_type for op in q18.ops]
    assert kinds.count("scan") == 4 and kinds[-2:] == ["sort", "limit"]
    assert any("semi" in op.pred_tokens for op in q18.ops)
    mid = [op for op in q18.ops if op.op_type == "filter"
           and q18.ops[op.children[0]].op_type == "agg"]
    assert mid and any(sq.children for sq in q18.subqs
                       if mid[0].op_id in sq.op_ids)
    assert all(q.benchmark == "spec_shapes" for q in SPEC_QUERIES)


@pytest.mark.parametrize("use_est", [True, False])
def test_features_at_any_size(use_est):
    """Every subQ of the spec-shaped plans, 1 to 7 operators, at its own
    size: the port's size-agnostic encoding and PE, the edge flags, no
    padding; padded on request, never below its size."""
    sizes = set()
    for q in SPEC_QUERIES:
        for i in range(q.n_subqs):
            X, pe, bias, mask = rm.subq_graph(q, i, use_est)
            n = len(q.subqs[i].op_ids)
            sizes.add(n)
            A = _local_adjacency(q, i)
            assert np.array_equal(
                X, pf.encode_ops(q.subq_ops(i), use_est=use_est))
            assert np.array_equal(pe, pf.lap_positional_encoding(A))
            assert np.array_equal(bias[..., 0], A)
            assert np.array_equal(bias[..., 1], A.T)
            assert np.array_equal(bias[..., 2], np.eye(n))
            assert mask.shape == (n,) and mask.all()
            Xp, pep, biasp, maskp = rm.subq_graph(q, i, use_est, n_pad=n + 2)
            assert np.array_equal(Xp[:n], X) and not Xp[n:].any()
            assert np.array_equal(pep[:n], pe) and not pep[n:].any()
            assert np.array_equal(biasp[:n, :n], bias)
            assert maskp.sum() == n and maskp[:n].all()
            if n > 1:
                with pytest.raises(ValueError, match="more than n_pad"):
                    rm.subq_graph(q, i, use_est, n_pad=n - 1)
    assert {1, 7} <= sizes


def _net(kind="subq"):
    cfg = cell.model_configs(_cfg())
    _, host_w = cell.make_weights(cfg, 0, "cpu")
    return rm.Net(host_w[kind], 4, 2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_padding_does_not_change_an_embedding():
    """A block that mixes 1- and 7-operator graphs gives each graph the
    embedding it has alone at its own size, but for summation order; the
    same block with its padding left unmasked does not."""
    net = _net()
    keys = [(q, i) for q in SPEC_QUERIES for i in range(q.n_subqs)]
    graphs = [rm.subq_graph(q, i, True) for q, i in keys]
    assert {g[0].shape[0] for g in graphs} >= {1, 7}
    mixed = net.embed(graphs).numpy()
    N = max(g[0].shape[0] for g in graphs)
    unmasked = [rm.subq_graph(q, i, True, n_pad=N) for q, i in keys]
    for g in unmasked:
        g[3][:] = True
    fault = net.embed(unmasked).numpy()
    worst_fault = 0.0
    for j, g in enumerate(graphs):
        alone = net.embed([g]).numpy()[0]
        assert _rel(mixed[j], alone) <= 1e-12, keys[j][0].qid
        if g[0].shape[0] < N:
            worst_fault = max(worst_fault, _rel(fault[j], alone))
    assert worst_fault > 1e-3
    # ``embeddings`` in blocks of three, sorted by size: the same rows.
    E = rm.embeddings(net, [(q, i, True) for q, i in keys], block=3)
    for j, (q, i) in enumerate(keys):
        assert _rel(E[(id(q), i, True)], mixed[j]) <= 1e-12


@pytest.mark.parametrize("kind", ["subq", "qs"])
def test_existing_cells_embeddings_equal_padded_to_four(kind):
    """On the frozen TPC-H and TPC-DS plans (stages of 1 to 3 operators)
    the size-agnostic embeddings equal those of graphs padded to four, as
    the reference computed them before."""
    net = _net(kind)
    est = kind == "subq"
    keys = [(q, i, est) for q in QUERIES for i in range(q.n_subqs)]
    assert max(len(q.subqs[i].op_ids) for q, i, _ in keys) <= 4
    E = rm.embeddings(net, keys)
    four = net.embed([rm.subq_graph(q, i, est, n_pad=4)
                      for q, i, _ in keys]).numpy()
    for j, (q, i, _) in enumerate(keys):
        assert _rel(E[(id(q), i, est)], four[j]) <= 1e-12


@pytest.mark.parametrize("template", [0, 1, 2], ids=["q19", "q15", "q18"])
def test_structure_matches_port_on_spec_shapes(template):
    """Depths and γ on the spec-shaped DAGs, Q15's two-consumer stage
    among them."""
    for q in SPEC_QUERIES[2 * template:2 * template + 2]:
        d = prt.structural_pressure(q)[1]
        assert rm._depths(q) == q.subq_depths() == [int(x) for x in d]
        assert np.array_equal(rm.structural_gamma(q),
                              prt.structural_gamma(q))


def test_alpha_and_gamma_match_port():
    for q in QUERIES:
        assert np.array_equal(rm.structural_gamma(q),
                              prt.structural_gamma(q))
        for sq in q.subqs:
            a = rm.alpha(sq.input_rows, sq.input_bytes)
            assert np.array_equal(a, _alpha_stats(sq.input_rows,
                                                  sq.input_bytes))
            assert np.array_equal(rm.nondecision(a),
                                  make_nondecision(a))


@pytest.mark.parametrize("space,ref", [(theta_c_space, rm.THETA_C),
                                       (theta_p_space, rm.THETA_P),
                                       (theta_s_space, rm.THETA_S)])
def test_spaces_match_port(space, ref):
    sp = space()
    u = np.random.default_rng(0).random((200, sp.dim))
    raw = sp.to_raw(u)
    assert np.array_equal(rm.to_raw(ref, u), raw)
    assert np.array_equal(rm.to_unit(ref, raw), sp.to_unit(raw))


@pytest.mark.parametrize("kind", ["subq", "qs"])
def test_network_matches_port(kind):
    cfg = cell.model_configs(_cfg())
    dev_w, host_w = cell.make_weights(cfg, 0, "cpu")
    port = PerfModel(cfg[kind], params=dev_w[kind], device="cpu")
    net = rm.Net(host_w[kind], 4, 2)
    est = kind == "subq"
    keys = [(q, i, est) for q in QUERIES[:6] for i in range(q.n_subqs)]
    E = rm.embeddings(net, keys)
    rng = np.random.default_rng(1)
    for q, i, _ in keys:
        emb_port = port._embed_batch([port._graph(q, i)])[0]
        emb_ref = E[(id(q), i, est)]
        assert np.allclose(emb_port, emb_ref, rtol=1e-5, atol=1e-5)
        theta = rng.random((5, cfg[kind].theta_dim)).astype(np.float32)
        nond = rm.nondecision(rm.alpha(q.subqs[i].input_rows,
                                       q.subqs[i].input_bytes))
        got = port.predict(emb_port, theta, nond)
        want = net.head(np.broadcast_to(emb_ref, (5, emb_ref.size)), theta,
                        np.broadcast_to(nond, (5, nond.size)))
        assert np.allclose(got, want, rtol=2e-5, atol=1e-7)


def _cfg():
    from portbench.harness.bench import Benchmark
    return Benchmark().config("tpch")


def test_pareto_mask_matches_port():
    rng = np.random.default_rng(3)
    for n in (1, 5, 64, 65, 300):
        F = rng.integers(0, 6, size=(n, 2)).astype(np.float64)
        F[rng.random(n) < 0.1, 1] = np.inf
        assert np.array_equal(rd.pareto_mask(F), pareto_mask_np(F))
        G = rng.random((n, 3))
        assert np.array_equal(rd.pareto_mask(G), pareto_mask_np(G))


def test_wun_pick_matches_port():
    rng = np.random.default_rng(4)
    for n in (1, 2, 17, 80):
        F = rng.random((n, 2))
        for w in ((0.9, 0.1), (0.5, 0.5), (0.0, 1.0)):
            assert rd.wun_pick(F, w) == wun_select(F, np.asarray(w))[0]


def test_runtime_picks_have_no_gap_on_the_host():
    rng = np.random.default_rng(5)
    Fs = [rng.random((66, 2)) * [3.0, 0.01] for _ in range(40)]
    w = np.tile([0.9, 0.1], (40, 1))
    picks = prt.weighted_pick_batch(Fs, w, device="cpu")
    assert max(rd.pick_gap(F, w[0], j) for F, j in zip(Fs, picks)) == 0.0
    worst = [int(np.argmax(rd.pick_scores(F, w[0]))) for F in Fs]
    assert max(rd.pick_gap(F, w[0], j) for F, j in zip(Fs, worst)) > 0.1


@pytest.mark.parametrize("kind", ["subq", "qs"])
def test_the_model_seed_alone_draws_the_weights(kind):
    """One model a configuration: the same ``model_seed`` gives the same
    arrays on every call, another gives other arrays."""
    cfg = cell.model_configs(_cfg())
    _, a = cell.make_weights(cfg, 0, "cpu")
    _, b = cell.make_weights(cfg, 0, "cpu")
    _, c = cell.make_weights(cfg, 1, "cpu")
    assert a[kind].keys() == b[kind].keys() == c[kind].keys()
    assert all(np.array_equal(a[kind][k], b[kind][k]) for k in a[kind])
    assert all(not np.array_equal(a[kind][k], c[kind][k]) for k in a[kind])
