"""The plain reference against the port on the host: the same features,
the same network (float64 against the port's float32), the same
decisions."""
import numpy as np
import pytest

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


@pytest.mark.parametrize("use_est", [True, False])
def test_subq_graph_matches_port(use_est):
    for q in QUERIES:
        for i in range(q.n_subqs):
            got = rm.subq_graph(q, i, use_est)
            want = pf.featurize_subq(q, i, use_est=use_est, n_pad=4)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)


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
