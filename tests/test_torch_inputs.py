"""Port parity: the main path's host inputs (numpy code carried across).

Query plans, workloads, features, parameter spaces and the oracle
simulator are the same numpy code in both packages, so every comparison
here is exact equality.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.models import features as ref_features
from repro.core.tuning import spark_space as ref_space
from repro.queryengine import simulator as ref_sim
from repro.queryengine import workloads as ref_wl
from repro_torch.core.models import features as port_features
from repro_torch.core.tuning import spark_space as port_space
from repro_torch.queryengine import simulator as port_sim
from repro_torch.queryengine import workloads as port_wl


@pytest.fixture(scope="module", params=["tpch", "tpcds"])
def both_benchmarks(request):
    b = request.param
    return b, ref_wl.make_benchmark(b), port_wl.make_benchmark(b)


def test_make_benchmark_queries_equal(both_benchmarks):
    bench, ref_qs, port_qs = both_benchmarks
    assert len(ref_qs) == len(port_qs) == (22 if bench == "tpch" else 102)
    for a, b in zip(ref_qs, port_qs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_parametric_variants_equal():
    a = ref_wl.parametric_variants("tpcds", 7, 3, seed=2)
    b = port_wl.parametric_variants("tpcds", 7, 3, seed=2)
    assert [dataclasses.asdict(q) for q in a] == \
        [dataclasses.asdict(q) for q in b]


def test_serving_stream_sequence_equal():
    a = ref_wl.serving_stream("tpch", 24, seed=5)
    b = port_wl.serving_stream("tpch", 24, seed=5)
    assert [(q.qid, q.template) for q in a] == \
        [(q.qid, q.template) for q in b]
    assert [dataclasses.asdict(q) for q in a] == \
        [dataclasses.asdict(q) for q in b]


def test_featurize_equal(both_benchmarks):
    _, ref_qs, port_qs = both_benchmarks
    for a, b in list(zip(ref_qs, port_qs))[::7]:
        for sq in range(a.n_subqs):
            for use_est in (True, False):
                ga = ref_features.featurize_subq(a, sq, use_est=use_est)
                gb = port_features.featurize_subq(b, sq, use_est=use_est)
                for x, y in zip(ga, gb):
                    np.testing.assert_array_equal(x, y)
        for x, y in zip(ref_features.featurize_plan(a, use_est=True),
                        port_features.featurize_plan(b, use_est=True)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("space", ["theta_c_space", "theta_p_space",
                                   "theta_s_space"])
def test_spaces_to_raw_and_snap_equal(space):
    rs, ps = getattr(ref_space, space)(), getattr(port_space, space)()
    u = np.random.default_rng(3).random((257, rs.dim))
    np.testing.assert_array_equal(rs.to_raw(u), ps.to_raw(u))
    np.testing.assert_array_equal(rs.snap_unit(u), ps.snap_unit(u))
    np.testing.assert_array_equal(rs.default_unit(), ps.default_unit())


def test_simulate_subq_equal():
    ref_q = ref_wl.make_benchmark("tpch")[8]
    port_q = port_wl.make_benchmark("tpch")[8]
    rng = np.random.default_rng(11)
    cs, pps, ss = (port_space.theta_c_space(), port_space.theta_p_space(),
                   port_space.theta_s_space())
    tc = cs.to_raw(rng.random((64, cs.dim)))
    tp = pps.to_raw(rng.random((64, pps.dim)))
    ts = ss.to_raw(rng.random((64, ss.dim)))
    for sa, sb in zip(ref_q.subqs, port_q.subqs):
        for est in (True, False):
            a = ref_sim.simulate_subq(sa, tc, tp, ts, use_est_inputs=est)
            b = port_sim.simulate_subq(sb, tc, tp, ts, use_est_inputs=est)
            for f in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, f.name),
                                              getattr(b, f.name))
    for x, y in zip(ref_sim.default_theta(3), port_sim.default_theta(3)):
        np.testing.assert_array_equal(x, y)
