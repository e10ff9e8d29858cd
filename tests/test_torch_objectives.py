"""``fused_stage_eval``'s staged call against the per-request assembly.

The fused call sends each request's embedding and nondecision row once and
each distinct θ block once (a request whose ``Tc`` and ``Tps`` are the
previous request's arrays shares its block), builds the regressor rows on
the device by gather, and converts only the three θc columns the dollars
read, once a distinct block.  Each case here holds it bit for bit to the
assembly it replaced, written out in :func:`_per_request_assembly`:
per-request ``split_raw`` and ``theta_rows``, one plain ``predict_rows``
over the concatenated rows, then the dollars request by request.  Port
only, on the CPU, with a port ``PerfModel`` on its seeded random weights.
"""
import types
import zlib

import numpy as np
import pytest

from repro_torch import tracing
from repro_torch.core.models.perf_model import ModelConfig, PerfModel
from repro_torch.core.moo.hmooc import _rep_bank_requests
from repro_torch.core.tuning.objectives import (StageObjectives,
                                                fused_stage_eval,
                                                resource_rate)
from repro_torch.queryengine.simulator import CostModel
from repro_torch.queryengine.workloads import make_benchmark

# 8,193 rows a request cross predict_rows' 8,192-row chunk.
LENGTHS = (1, 3, 8193)
# (benchmark, template) pairs: two queries of each, so a call spans queries.
QUERIES = {"tpch": (1, 5), "tpcds": (3, 40)}


@pytest.fixture(scope="module")
def model():
    return PerfModel(ModelConfig("subq", 19), device="cpu")


@pytest.fixture(scope="module")
def objectives(model):
    out = {}
    for bench, templates in QUERIES.items():
        qs = make_benchmark(bench)
        out[bench] = [StageObjectives(qs[t], model=model) for t in templates]
    return out


def _per_request_assembly(items):
    """The fused call's assembly as it was: per-request raw θc and θ rows,
    one dispatch, per-request dollars."""
    model = items[0][0].model
    thetas, metas = [], []
    for obj, i, Tc, Tps in items:
        tc_raw, _, _ = obj.split_raw(Tc, Tps)
        theta = obj.theta_rows(Tc, Tps)
        thetas.append(theta)
        metas.append((obj, theta.shape[0], tc_raw))
    emb = np.concatenate([np.repeat(obj._embs[i][None], Tc.shape[0], 0)
                          for obj, i, Tc, _ in items]).astype(np.float32)
    nond = np.concatenate([np.repeat(obj._nond[i][None], Tc.shape[0], 0)
                           for obj, i, Tc, _ in items]).astype(np.float32)
    pred = model.predict_rows(emb, np.concatenate(thetas, 0), nond)
    out, off = [], 0
    for obj, n, tc_raw in metas:
        p = pred[off:off + n]
        off += n
        lat, io = p[:, 0], p[:, 1]
        dollars = lat * resource_rate(tc_raw, obj.cost) \
            + io * obj.cost.price_io_gb
        out.append(np.stack([lat, dollars], -1))
    return out


def _half_steps(space, rng, n):
    """Unit rows whose int parameters sit on raw k + 0.5 (the rounding's
    ties); other parameters uniform."""
    u = rng.random((n, space.dim))
    for j, p in enumerate(space.params):
        if p.kind != "int":
            continue
        raw = rng.integers(int(p.lo), int(p.hi), n) + 0.5
        if p.log:
            lo, hi = np.log(p.lo), np.log(p.hi)
            u[:, j] = (np.log(raw) - lo) / (hi - lo)
        else:
            u[:, j] = (raw - p.lo) / (p.hi - p.lo)
    return u


def _units(obj, values, rng, n, ps=True):
    """n unit rows of θc (ps=False) or θp⊕θs (ps=True)."""
    spaces = (obj.ps, obj.ss) if ps else (obj.cs,)
    if values == "inside":
        return rng.random((n, sum(s.dim for s in spaces)))
    if values == "outside":
        return rng.uniform(-0.75, 1.75, (n, sum(s.dim for s in spaces)))
    return np.concatenate([_half_steps(s, rng, n) for s in spaces], -1)


def _requests(objs, shape, n, values, rng):
    """Stage requests of every objective, shaped like one solver phase.

    banks: one shared (np.repeat θc, np.tile θp⊕θs) pair for every subQ;
    assign: each subQ's own rows gathered from a candidate set and a pool.
    """
    items = []
    for obj in objs:
        subqs = range(min(obj.m, 3))
        if shape == "banks":
            C = 3 if n % 3 == 0 else 1
            P = n // C
            reps = _units(obj, values, rng, C, ps=False)
            pool = _units(obj, values, rng, P)
            Tc, Tp = np.repeat(reps, P, axis=0), np.tile(pool, (C, 1))
            items.extend((obj, i, Tc, Tp) for i in subqs)
        else:
            Uc = _units(obj, values, rng, 16, ps=False)
            pool = _units(obj, values, rng, 24)
            for i in subqs:
                items.append((obj, i, Uc[rng.integers(0, 16, n)],
                              pool[rng.integers(0, 24, n)]))
    return items


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("values", ["inside", "outside", "half_steps"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("shape", ["banks", "assign"])
@pytest.mark.parametrize("bench", sorted(QUERIES))
def test_fused_matches_per_request_assembly(objectives, bench, shape, n,
                                            values):
    key = f"{bench}.{shape}.{n}.{values}".encode()
    rng = np.random.default_rng(zlib.crc32(key))
    items = _requests(objectives[bench], shape, n, values, rng)
    _assert_equal(fused_stage_eval(items), _per_request_assembly(items))


def test_fused_matches_per_request_stage_eval(objectives):
    """The fused rows are those of ``obj.stage_eval`` request by request."""
    rng = np.random.default_rng(7)
    items = _requests(objectives["tpch"] + objectives["tpcds"], "assign",
                      5, "inside", rng)
    got = fused_stage_eval(items)
    for g, (obj, i, Tc, Tps) in zip(got, items):
        np.testing.assert_array_equal(g, obj.stage_eval(i, Tc, Tps))


def test_fused_mixed_cost_models(model):
    """Requests priced by two cost models in one call keep their own."""
    q = make_benchmark("tpch")[5]
    dear = CostModel(price_core_h=0.9, price_mem_gb_h=0.05, price_io_gb=0.01)
    objs = [StageObjectives(q, model=model),
            StageObjectives(q, model=model, cost=dear)]
    rng = np.random.default_rng(11)
    items = [it for k in (0, 1, 0) for it in
             _requests([objs[k]], "assign", 17, "outside", rng)]
    got = fused_stage_eval(items)
    _assert_equal(got, _per_request_assembly(items))
    # The same rows priced by the other cost model differ in dollars only.
    same = fused_stage_eval([(objs[1], i, Tc, Tps)
                             for _, i, Tc, Tps in items[:1]])[0]
    np.testing.assert_array_equal(same[:, 0], got[0][:, 0])
    assert (same[:, 1] != got[0][:, 1]).all()


def test_fused_assemble_span_counts_rows(objectives):
    """Under tracing, ``stage_eval.assemble``'s ``rows`` is the call's
    total, inside ``stage_eval`` beside ``stage_eval.dollars``."""
    rng = np.random.default_rng(13)
    items = _requests(objectives["tpcds"], "banks", 3, "inside", rng)
    items += _requests(objectives["tpch"], "assign", 1, "half_steps", rng)
    total = sum(Tc.shape[0] for _, _, Tc, _ in items)
    with tracing.recording() as tr:
        got = fused_stage_eval(items)
    _assert_equal(got, _per_request_assembly(items))
    names = [sp.name for sp in tr.spans]
    assert names == ["stage_eval", "stage_eval.assemble",
                     "model.predict_rows", "stage_eval.dollars"]
    outer, assemble = tr.spans[0], tr.spans[1]
    assert assemble.attrs == {"rows": total}
    assert outer.attrs == {"requests": len(items)}
    assert assemble.parent == 0 and tr.spans[3].parent == 0


def _distinct_theta_rows(items):
    """θ rows the fused call stages: a request's rows unless its (Tc, Tps)
    are the previous request's arrays."""
    n, prev = 0, (None, None)
    for _, _, Tc, Tps in items:
        if Tc is not prev[0] or Tps is not prev[1]:
            n += Tc.shape[0]
            prev = (Tc, Tps)
    return n


def _plan_banks(obj, rng, C, P):
    """A plan's banks-phase requests as ``_rep_bank_requests`` makes them:
    every subQ gets the same (Tc, Tps) arrays."""
    eset = types.SimpleNamespace(reps=_units(obj, "inside", rng, C, False),
                                 pool=_units(obj, "inside", rng, P))
    return [(obj, i, Tc, Tp) for i, Tc, Tp in _rep_bank_requests(obj.m, eset)]


def _dedup_case(objectives, model, case, rng):
    tpch, tpcds = objectives["tpch"], objectives["tpcds"]
    if case == "rep_banks":
        return _plan_banks(tpcds[1], rng, 3, 40)
    if case == "two_plans":
        # Adjacent plans: equal shapes, their own arrays, so two blocks.
        return _plan_banks(tpcds[0], rng, 2, 24) \
            + _plan_banks(tpcds[1], rng, 2, 24)
    if case == "mixed":
        # Shared banks, distinct assign rows, banks again, then the first
        # request once more: only the previous request's arrays are shared,
        # so its block is staged again.
        items = _plan_banks(tpch[0], rng, 3, 16)
        items += _requests(tpcds[:1], "assign", 37, "outside", rng)
        items += _plan_banks(tpch[1], rng, 1, 5)
        return items + items[:1]
    if case == "shared_tc":
        # One θc array, a θp⊕θs slice a subQ (the set-up default solve).
        obj = tpcds[0]
        tc = _units(obj, "inside", rng, 1, False)
        tps = _units(obj, "inside", rng, obj.m)
        return [(obj, i, tc, tps[i:i + 1]) for i in range(obj.m)]
    if case == "mixed_cost":
        q = make_benchmark("tpcds")[QUERIES["tpcds"][0]]
        dear = CostModel(price_core_h=0.9, price_mem_gb_h=0.05,
                         price_io_gb=0.01)
        cheap = StageObjectives(q, model=model)
        costly = StageObjectives(q, model=model, cost=dear)
        banks = _plan_banks(cheap, rng, 2, 12)
        # The same arrays priced by two cost models: one block, two prices.
        return banks + [(costly, i, Tc, Tp) for _, i, Tc, Tp in banks] \
            + _requests([costly], "assign", 9, "half_steps", rng)
    # "chunked": past the chunk cap, which the test sets to 64 rows.
    return _plan_banks(tpch[1], rng, 3, 50) \
        + _requests(tpch[:1], "assign", 70, "inside", rng)


@pytest.mark.parametrize("case", ["rep_banks", "two_plans", "mixed",
                                  "shared_tc", "mixed_cost", "chunked"])
def test_fused_dedup_matches_per_request_assembly(objectives, model, case,
                                                  monkeypatch):
    """Calls whose requests share θ arrays, as a plan's banks phase makes
    them, stay bit-equal to the per-request assembly; the model copies each
    distinct θ row once (``theta_rows_sent``), scores every row
    (``rows_predicted``) and makes one copy to the device a call, however
    many chunks the rows take."""
    if case == "chunked":
        monkeypatch.setenv("REPRO_HEAD_MAX_BUCKET", "64")
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    items = _dedup_case(objectives, model, case, rng)
    total = sum(Tc.shape[0] for _, _, Tc, _ in items)
    distinct = _distinct_theta_rows(items)
    assert distinct < total or case == "shared_tc"
    before = (model.rows_predicted, model.theta_rows_sent, model.h2d_copies)
    got = fused_stage_eval(items)
    after = (model.rows_predicted, model.theta_rows_sent, model.h2d_copies)
    assert np.subtract(after, before).tolist() == [total, distinct, 1]
    if case == "chunked":
        assert total > 4 * 64
        assert model.head_buckets >= {(64, 19)}
    _assert_equal(got, _per_request_assembly(items))
