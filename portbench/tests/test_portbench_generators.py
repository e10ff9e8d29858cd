"""The frozen generator copies against the port's generators today, and
the traffic the harness builds from them."""
import numpy as np
import pytest

from portbench.harness import frozen, traffic
from portbench.harness.bench import Benchmark
from repro_torch.queryengine import workloads as wl

SEEDS = (0, 7, 2 ** 31 + 11)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("benchmark", ["tpch", "tpcds"])
def test_make_query_matches_port(benchmark, seed):
    for t in range(0, frozen.N_TEMPLATES[benchmark], 7):
        for v in (0, 3, 10 ** 6 * (seed + 1) + t):
            assert frozen.make_query(benchmark, t, variant=v, seed=seed) \
                == wl.make_query(benchmark, t, variant=v, seed=seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_arrivals_match_port(seed):
    got = frozen.poisson_arrivals(22.4, 300, seed)
    want = wl.ArrivalModel("poisson", 22.4).draw(300, seed)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("benchmark", ["tpch", "tpcds"])
def test_zipf_stream_matches_serving_stream(benchmark, seed):
    pairs = frozen.zipf_draws(benchmark, 120, seed)
    got = frozen.build_queries(benchmark, pairs)
    want = wl.serving_stream(benchmark, 120, seed=seed)
    assert [q.qid for q in got] == [q.qid for q in want]
    assert all(a == b for a, b in zip(got, want))


def _mix(name):
    return Benchmark.traffic(name)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_fresh_traffic_never_repeats_a_variant(seed):
    tr = traffic.build(_mix("tpch.fresh.steady"), "tpch", seed, 4.0)
    qids = [r.query.qid for r in tr.window] + \
        [r.query.qid for r in tr.warmup] + [q.qid for q in tr.setup]
    assert len(qids) == len(set(qids))
    rate = _mix("tpch.fresh.steady")["arrivals"]["rate_qps"]
    assert len(tr.window) == round(rate * 4.0)
    assert sorted({q.template for q in tr.setup}) == list(range(22))
    times = [r.arrival_s for r in tr.window]
    assert times == sorted(times)


def test_traffic_is_a_function_of_the_seed():
    a = traffic.build(_mix("tpcds.fresh.steady"), "tpcds", 9, 3.0)
    b = traffic.build(_mix("tpcds.fresh.steady"), "tpcds", 9, 3.0)
    c = traffic.build(_mix("tpcds.fresh.steady"), "tpcds", 10, 3.0)
    key = [(r.query.qid, r.arrival_s) for r in a.window]
    assert key == [(r.query.qid, r.arrival_s) for r in b.window]
    assert key != [(r.query.qid, r.arrival_s) for r in c.window]
    # Every seed: the same templates and the same gaps, in another order.
    assert sorted(r.query.template for r in a.window) == \
        sorted(r.query.template for r in c.window)
    gaps = [np.sort(np.diff([0.0] + [r.arrival_s for r in t.window]))
            for t in (a, c)]
    assert np.allclose(gaps[0], gaps[1])


def test_zipf_mix_is_serving_streams_own():
    mix = _mix("tpch.zipf.steady")
    tr = traffic.build(mix, "tpch", 5, 4.0)
    n = len(tr.window)
    want = wl.serving_stream("tpch", n, seed=0, arrivals=wl.ArrivalModel(
        "poisson", mix["arrivals"]["rate_qps"]))
    assert sorted(r.query.qid for r in tr.window) == \
        sorted(r.query.qid for r in want)
    assert np.allclose(np.sort(np.diff([0.0] + [r.arrival_s
                                                for r in tr.window])),
                       np.sort(np.diff([0.0] + [r.arrival_s
                                                for r in want])))
    solved = {q.qid for q in tr.setup}
    assert {r.query.qid for r in tr.window} <= solved


def _frozen_traffic(mix, benchmark, seed, seconds, query_seed):
    """A cell's traffic built straight from the frozen generator's public
    functions: ``traffic.build`` as it stood before a configuration could
    name its own query source."""
    seed = int(seed) % (1 << 63)
    rate = float(mix["arrivals"]["rate_qps"])
    zipf_a = float(mix["templates"]["zipf_a"])
    var = mix["variants"]
    n = max(1, int(round(rate * seconds)))
    base = traffic._SPAN * (seed + 1)
    order = np.random.default_rng(np.random.SeedSequence(
        [seed, 0x0D3E])).permutation(n)
    if var["policy"] == "fresh":
        draws = frozen.zipf_draws(benchmark, n, mix["templates"]["seed"],
                                  zipf_a)
        pairs = [(draws[j][0], base + i) for i, j in enumerate(order)]
    else:
        draws = frozen.zipf_draws(benchmark, n, mix["templates"]["seed"],
                                  zipf_a, var["n_variants"])
        pairs = [draws[j] for j in order]
    gaps = np.diff(frozen.poisson_arrivals(rate, n, mix["arrivals"]["seed"]),
                   prepend=0.0)
    gap_order = np.random.default_rng(np.random.SeedSequence(
        [seed, 0x6A95])).permutation(n)
    window = (frozen.build_queries(benchmark, pairs, query_seed),
              np.cumsum(gaps[gap_order]))
    w_seed = traffic._sub_seed(seed, 0x3A11)
    n_w = mix["setup"]["warmup_requests"]
    w_draws = frozen.zipf_draws(benchmark, n_w, w_seed, zipf_a)
    warmup = (frozen.build_queries(
        benchmark, [(t, base + traffic._WARM + j)
                    for j, (t, _) in enumerate(w_draws)], query_seed),
        frozen.poisson_arrivals(rate, n_w, w_seed))
    n_t = frozen.N_TEMPLATES[benchmark]
    if mix["setup"]["solve"] == "templates":
        solve = [(t, base + traffic._SETUP + t) for t in range(n_t)]
    else:
        solve = [(t, v) for t in range(n_t)
                 for v in range(var["n_variants"])]
    return window, warmup, frozen.build_queries(benchmark, solve, query_seed)


_BENCH = Benchmark()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(_BENCH.cells))
def test_cells_offer_the_frozen_generators_traffic(cell, seed):
    """Every cell, through its configuration's query source, offers the
    requests, arrival times and set-up solves that the frozen generator's
    own functions give, at the benchmark's run length."""
    cfg = _BENCH.config(_BENCH.cells[cell]["config"])
    mix = _BENCH.traffic(_BENCH.cells[cell]["traffic"])
    seconds = _BENCH.spec["run_seconds"]
    got = traffic.build(mix, _BENCH.queries(cfg), seed, seconds,
                        cfg["query_seed"])
    window, warmup, setup = _frozen_traffic(mix, cfg["benchmark"], seed,
                                            seconds, cfg["query_seed"])
    for stream, (queries, times) in ((got.window, window),
                                     (got.warmup, warmup)):
        assert [r.query.qid for r in stream] == [q.qid for q in queries]
        assert all(r.query == q for r, q in zip(stream, queries))
        assert [r.arrival_s for r in stream] == [float(t) for t in times]
    assert [q.qid for q in got.setup] == [q.qid for q in setup]
    assert got.setup == setup
