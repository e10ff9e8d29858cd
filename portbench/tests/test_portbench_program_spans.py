"""The readers of the program's own spans (``portbench/harness/spans.py``
and the six metrics on it), each on a record built by hand, and each
silent on a record whose server left no trace; and a traced run of a
small cell on the host, where they read the server's own trace."""
import time
import types

import pytest

from portbench.harness import bench as bench_mod
from portbench.harness import cell

READERS = ["stage_eval_host_ms_per_solve.steady",
           "hmooc_feed_ms_per_solve.steady",
           "session_admit_ms_per_query.steady",
           "model_h2d_copies_per_solve.steady",
           "k1_launches_per_solve.steady",
           "round_embed_misses_per_round.steady"]
MS = 1_000_000


def _span(name, t0_ms, t1_ms, parent=-1, **attrs):
    return types.SimpleNamespace(name=name, t0_ns=t0_ms * MS,
                                 t1_ns=t1_ms * MS, parent=parent,
                                 attrs=attrs or None)


def _counters(**kw):
    base = dict.fromkeys(("h2d_copies", "k1_launches", "emb_misses"), 0)
    return {**base, **kw}


def _record():
    """Two flushes (3 and 2 requests, 2 and 1 solved) and two rounds."""
    spans = [
        _span("serve", 0, 1000),
        _span("flush", 0, 100, 0, rids=[4, 5, 6], n_solved=2,
              counters=_counters(h2d_copies=12, k1_launches=4)),
        _span("tune", 1, 90, 1),
        _span("tune.phase", 2, 60, 2),
        _span("stage_eval", 3, 33, 3),
        _span("model.predict_rows", 10, 20, 4),
        _span("hmooc.feed", 33, 40, 3),
        _span("hmooc.feed", 40, 45, 3),
        _span("session_admit", 90, 96, 1),
        _span("round", 100, 110, 0, rids=[4, 5, 6],
              counters=_counters(emb_misses=5, h2d_copies=10)),
        _span("flush", 110, 200, 0, rids=[7, 8], n_solved=1,
              counters=_counters(h2d_copies=6, k1_launches=2)),
        _span("tune", 111, 190, 10),
        _span("tune.phase", 112, 150, 11),
        _span("stage_eval", 113, 125, 12),
        _span("model.predict_rows", 115, 119, 13),
        _span("hmooc.feed", 125, 128, 12),
        _span("session_admit", 190, 194, 10),
        _span("round", 200, 204, 0, rids=[7, 8],
              counters=_counters(emb_misses=1)),
        # A predict_rows call outside a stage evaluation counts for nothing.
        _span("model.predict_rows", 204, 300, 0),
    ]
    trace = types.SimpleNamespace(spans=spans, offset_ns=0)
    return types.SimpleNamespace(stats=types.SimpleNamespace(trace=trace))


WANT = {
    # ((30 - 10) + (12 - 4)) ms over 3 solved
    "stage_eval_host_ms_per_solve.steady": 28.0 / 3,
    # (7 + 5 + 3) ms over 3 solved
    "hmooc_feed_ms_per_solve.steady": 5.0,
    # (6 + 4) ms over 5 admitted
    "session_admit_ms_per_query.steady": 2.0,
    # flush copies (12 + 6) over 3 solved; the round's 10 are not counted
    "model_h2d_copies_per_solve.steady": 6.0,
    # (4 + 2) over 3 solved
    "k1_launches_per_solve.steady": 2.0,
    # (5 + 1) misses over 2 rounds
    "round_embed_misses_per_round.steady": 3.0,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_trace(name):
    assert bench_mod.metric_module(name).read(_record()) == \
        pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_silent_without_a_trace(name):
    """Tracing off (``trace`` None) and a program whose ``ServerStats``
    has no ``trace`` at all: nothing read, nothing raised."""
    mod = bench_mod.metric_module(name)
    assert mod.read(types.SimpleNamespace(
        stats=types.SimpleNamespace(trace=None))) is None
    assert mod.read(types.SimpleNamespace(
        stats=types.SimpleNamespace(tune_windows=[]))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_silent_when_nothing_was_solved(name):
    """A window of cache hits alone (``zipf``) solves nothing: the
    per-solve readers give nothing; admission and rounds still read."""
    rec = _record()
    for sp in rec.stats.trace.spans:
        if sp.name == "flush":
            sp.attrs["n_solved"] = 0
    got = bench_mod.metric_module(name).read(rec)
    if name.endswith(("per_query.steady", "per_round.steady")):
        assert got == pytest.approx(WANT[name], rel=1e-12)
    else:
        assert got is None


@pytest.mark.parametrize("cell_name", ["tpch.fresh.steady",
                                       "tpch.zipf.steady"])
def test_traced_host_run_reports_the_readers(tiny, cell_name):
    """A traced run of a small cell on the host: the profiler turns the
    program's tracer on, and every reader whose ``workloads`` names the
    cell reports; an untraced run leaves ``ServerStats.trace`` None."""
    b = bench_mod.Benchmark()
    out, rec = cell.run(b, cell_name, 2**31 + 7, 3.0, True, "cpu",
                        time.perf_counter(), overrides=tiny)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in b.metrics(cell_name, True)} & set(READERS)
    assert listed and listed <= set(out["metrics"])
    spans = rec.stats.trace.spans
    rids = sorted(r for sp in spans if sp.name == "flush"
                  for r in sp.attrs["rids"])
    assert rids == sorted(s.rid for s in rec.served)
    _, rec = cell.run(b, cell_name, 2**31 + 7, 3.0, False, "cpu",
                      time.perf_counter(), overrides=tiny)
    assert rec.stats.trace is None
