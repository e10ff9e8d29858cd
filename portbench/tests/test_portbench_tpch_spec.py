"""The ``tpch_spec`` configuration's generator (TPC-H's own 22 queries as
Spark stages them) against its contract and the shapes of the
specification's plans, and a host run of its cell."""
import dataclasses
import time

import pytest

from portbench.harness import bench as bench_mod
from portbench.harness import cell

GEN = bench_mod.query_module("tpch_spec")
SEED = 2 ** 31 + 17
QUERIES = {t + 1: GEN.make_query(t, variant=4, seed=SEED)
           for t in range(GEN.N_TEMPLATES)}


def _shape(q):
    return ([(o.op_type, o.children, o.pred_tokens[:1]) for o in q.ops],
            [(s.op_ids, s.children, s.kind, s.table) for s in q.subqs])


def test_contract():
    src = bench_mod.Benchmark().queries(
        bench_mod.Benchmark().config("tpch_spec"))
    assert (GEN.NAME, GEN.N_TEMPLATES, src.n_templates) == (
        "tpch_spec", 22, 22)
    assert 0 < len(GEN.SOURCE) <= 200
    for t in range(GEN.N_TEMPLATES):
        q = src.make(t, variant=4, seed=SEED)
        assert (q.benchmark, q.template) == ("tpch_spec", t)
        again = GEN.make_query(t, variant=4, seed=SEED)
        assert [dataclasses.asdict(o) for o in q.ops] == \
            [dataclasses.asdict(o) for o in again.ops]
        assert [dataclasses.asdict(s) for s in q.subqs] == \
            [dataclasses.asdict(s) for s in again.subqs]
        # A variant redraws the parameters and estimates, never the
        # staging.
        other = GEN.make_query(t, variant=5, seed=SEED + 1)
        assert _shape(other)[1] == _shape(q)[1]
        assert [(o.rows, o.est_rows, o.pred_tokens) for o in other.ops] != \
            [(o.rows, o.est_rows, o.pred_tokens) for o in q.ops]
    with pytest.raises(ValueError):
        GEN.make_query(22, variant=0, seed=0)


@pytest.mark.parametrize("t", range(1, 23), ids=lambda t: f"q{t}")
def test_plan_is_a_staged_dag(t):
    """Every operator in one stage, a stage's last operator its output, an
    edge into a stage from a child stage's output, children before their
    parents, and a join stage with two inputs or more."""
    q = QUERIES[t]
    q.topo_subqs()
    owner = {i: s for s in q.subqs for i in s.op_ids}
    assert sorted(owner) == list(range(len(q.ops)))
    for s in q.subqs:
        assert s.root_op == s.op_ids[-1]
        assert len(s.input_rows) == len(s.children) + (s.table is not None)
        if s.kind == "join":
            assert len(s.input_rows) >= 2
        for i in s.op_ids:
            for c in q.ops[i].children:
                assert c < i
                if owner[c] is not s:
                    assert owner[c].sq_id in s.children
                    assert c == owner[c].root_op


def _scans(q, table):
    return sum(o.op_type == "scan" and o.pred_tokens[0] == table
               for o in q.ops)


def _joins(q, tok):
    return [o for o in q.ops if o.op_type == "join" and tok in o.pred_tokens]


def test_the_specifications_shapes():
    widest = max(len(s.op_ids) for q in QUERIES.values() for s in q.subqs)
    assert widest >= 5
    assert max(len(s.op_ids) for s in QUERIES[19].subqs) == 7
    q15 = QUERIES[15]
    consumers = [sum(s.sq_id in o.children for o in q15.subqs)
                 for s in q15.subqs]
    assert max(consumers) == 2
    assert _scans(QUERIES[21], "lineitem") == 3
    assert _scans(QUERIES[7], "nation") == 2
    assert _scans(QUERIES[8], "nation") == 2
    assert max(len(s.input_rows) for s in QUERIES[21].subqs) == 4
    for t in (4, 18, 20, 21):
        assert _joins(QUERIES[t], "semi"), t
    for t in (16, 21, 22):
        assert _joins(QUERIES[t], "anti"), t
    for t in (2, 3, 10, 18, 21):
        assert QUERIES[t].ops[-1].op_type == "limit", t
    # Aggregates inside the DAG: a join reads an aggregate's output,
    # through filters and projections.
    for t in (2, 11, 15, 17, 18, 20, 22):
        q = QUERIES[t]

        def source(i):
            while q.ops[i].op_type in ("filter", "project"):
                i = q.ops[i].children[0]
            return q.ops[i].op_type
        assert any(source(c) == "agg" for j in _joins(q, "eq") + _joins(
            q, "scalar") for c in j.children), t
    assert max(q.n_subqs for q in QUERIES.values()) == QUERIES[2].n_subqs


def test_host_run_of_the_cell(tiny):
    out, rec = cell.run(bench_mod.Benchmark(), "tpch_spec.fresh.steady",
                        SEED, 3.0, False, "cpu", time.perf_counter(),
                        overrides=tiny)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {s.request.query.benchmark for s in rec.served} == {"tpch_spec"}
    assert "setup_s" in out["metrics"] and "solve_p95_s" in out["metrics"]
