"""Port parity: the user-facing examples (``repro_torch/examples/``).

Each oracle example runs whole, at its default size, twice: the
reference's script from ``examples/`` under ``runpy`` with the library
calls it makes recorded, and the port's ``main`` on the host
(``--device cpu``).  Their standard output is equal line for line once
wall times and rates are masked, and their results are exactly equal:
compile-time results, AQE runs (plans, simulated latency and cost,
requests), service results and launch plans.  The cluster example runs
with the reference's hardware figures pinned into the port's cost model.

The model-backed TPC-H loop carries random-weight reference models
across (``params_from_reference``) and holds fronts, the simulated
latency under the tuned plan and the runtime's requests within rtol 1e-4
(float32 sums in another order).  The reference's own ``--model`` path
passes its subQ model as the QS model and fails at the first query-stage
request on a width mismatch, so the loop is the reference's with the QS
model in that place, as the port's example has it.

A port-only test runs ``python -m repro_torch.examples.quickstart`` in a
process where ``import jax`` and ``import repro`` fail.
"""
import contextlib
import io
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.autotune as ref_autotune_mod
import repro.core.tuning.compile_time as ref_compile_time
import repro.queryengine.aqe as ref_aqe
from repro.core.models.perf_model import ModelConfig as RefModelConfig
from repro.core.models.perf_model import PerfModel as RefPerfModel
from repro.core.moo.hmooc import HMOOCConfig as RefHMOOCConfig
from repro.core.tuning.runtime import \
    make_runtime_optimizers as ref_make_runtime_optimizers
from repro.queryengine.simulator import default_theta as ref_default_theta
from repro.queryengine.workloads import make_benchmark as ref_make_benchmark
from repro.serve import TuningService as RefTuningService
from repro_torch.examples import (cluster_autotune, quickstart, serve_tuning,
                                  tpch_tuning)

from test_torch_cluster import _assert_plans_equal, pin_reference_figures
from test_torch_models import carry
from test_torch_runtime import _assert_aqe_equal
from test_torch_service import _assert_results_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_RTOL = 1e-4

# Wall times and rates, the only words the two outputs may differ in.
WALL = [(re.compile(p), r) for p, r in (
    (r"solved in \d+\.\d+s", "solved in <t>s"),
    (r"in \d+\.\d+s = \d+\.\d+ q/s", "in <t>s = <r> q/s"),
    (r"solve \d+\.\d+s", "solve <t>s"),
    (r"avg \d+\.\d+s max \d+\.\d+s", "avg <t>s max <t>s"),
    (r"\d+\.\d+s solve\)", "<t>s solve)"))]


def _masked(text: str):
    lines = text.splitlines()
    for pat, rep in WALL:
        lines = [pat.sub(rep, ln) for ln in lines]
    return lines


def _record(monkeypatch, owner, name, calls):
    """Replace ``owner.name`` with a wrapper that appends each result to
    ``calls``; the reference's scripts import it by name when run."""
    orig = getattr(owner, name)

    def recorded(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(owner, name, recorded)


def _run_reference(script, argv, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [script] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "examples", script),
                       run_name="__main__")
    return buf.getvalue()


def _run_port(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(argv + ["--device", "cpu"])
    return buf.getvalue(), out


def _compare_quickstart(rec, out):
    _assert_results_equal(rec["compile_time_optimize"][0],
                          out["compile_time"])
    for want, key in zip(rec["run_with_aqe"],
                         ("default", "hmooc3", "runtime")):
        _assert_aqe_equal(want, out[key])


def _compare_tpch(rec, out):
    cts, runs = rec["compile_time_optimize"], rec["run_with_aqe"]
    assert len(out["rows"]) == len(cts) == 22
    for i, row in enumerate(out["rows"]):
        _assert_results_equal(cts[i], row["compile_time"])
        _assert_aqe_equal(runs[2 * i], row["default"])
        _assert_aqe_equal(runs[2 * i + 1], row["tuned"])


def _compare_serve(rec, out):
    assert len(out["batches"]) == len(rec["tune_batch"]) == 3
    for want, got in zip(rec["tune_batch"], out["batches"]):
        assert len(want) == len(got["results"])
        for a, b in zip(want, got["results"]):
            _assert_results_equal(a, b)


def _compare_cluster(rec, out):
    plans = rec["autotune"]
    assert len(plans) == len(out["plans"]) + 1 == 6
    for want, (_, got) in zip(plans, out["plans"]):
        _assert_plans_equal(got, want)
    np.testing.assert_array_equal(
        out["front"], plans[-1].front[np.argsort(plans[-1].front[:, 0])])


# name: (port module, the reference's calls to record, comparison); the
# reference's script is examples/<name>.py.
EXAMPLES = {
    "quickstart": (quickstart, [(ref_compile_time, "compile_time_optimize"),
                                (ref_aqe, "run_with_aqe")],
                   _compare_quickstart),
    "serve_tuning": (serve_tuning, [(RefTuningService, "tune_batch")],
                     _compare_serve),
    "tpch_tuning": (tpch_tuning, [(ref_compile_time, "compile_time_optimize"),
                                  (ref_aqe, "run_with_aqe")], _compare_tpch),
    "cluster_autotune": (cluster_autotune, [(ref_autotune_mod, "autotune")],
                         _compare_cluster),
}


# Each example at its defaults, then with the reference's flags set.
CASES = [(name, []) for name in sorted(EXAMPLES)] + [
    ("serve_tuning", ["--bench", "tpcds", "--n-requests", "12", "--batch",
                      "5", "--seed", "2"]),
    ("tpch_tuning", ["--weights", "0.5,0.5"]),
    ("cluster_autotune", ["--arch", "glm4-9b", "--shape", "decode_32k"])]


@pytest.mark.parametrize("name,argv", CASES,
                         ids=[" ".join([n] + a) for n, a in CASES])
def test_oracle_example_matches_reference(name, argv, monkeypatch):
    module, recorded, compare = EXAMPLES[name]
    if name == "cluster_autotune":
        pin_reference_figures(monkeypatch)
    rec = {}
    with monkeypatch.context() as m:
        for owner, fn in recorded:
            _record(m, owner, fn, rec.setdefault(fn, []))
        want = _run_reference(f"{name}.py", argv, m)
    text, out = _run_port(module, argv)
    assert _masked(text) == _masked(want)
    assert len(text.splitlines()) > 3
    compare(rec, out)


def _ref_model_loop(model_subq, model_qs, weights=(0.9, 0.1)):
    """The reference's ``tpch_tuning.py`` loop on the given models."""
    rows = []
    for q in ref_make_benchmark("tpch"):
        tc, tp, ts = ref_default_theta(1)
        base = ref_aqe.run_with_aqe(q, tc[0], tp[0], ts[0])
        ct = ref_compile_time.compile_time_optimize(
            q, model=model_subq, weights=weights,
            cfg=RefHMOOCConfig(dag_method="hmooc3"))
        lqp_o, qs_o = ref_make_runtime_optimizers(
            q, ct.theta_c, seed_theta_p=ct.theta_p_sub,
            seed_theta_s=ct.theta_s_sub, model_subq=model_subq,
            model_qs=model_qs, weights=weights)
        opt = ref_aqe.run_with_aqe(q, ct.theta_c, ct.theta_p0, ct.theta_s0,
                                   lqp_optimizer=lqp_o, qs_optimizer=qs_o)
        rows.append((base, ct, opt))
    return rows


def test_model_tpch_tuning_close_to_reference():
    ref_subq = RefPerfModel(RefModelConfig("subq", 19), seed=7)
    ref_qs = RefPerfModel(RefModelConfig("qs", 10), seed=8)
    want = _ref_model_loop(ref_subq, ref_qs)
    with contextlib.redirect_stdout(io.StringIO()):
        out = tpch_tuning.run(carry(ref_subq), carry(ref_qs), device="cpu")
    n_sent = 0
    for (base, ct, opt), row in zip(want, out["rows"]):
        qid = row["query"].qid
        _assert_aqe_equal(base, row["default"])
        got = row["compile_time"]
        assert got.front.shape == ct.front.shape, qid
        np.testing.assert_allclose(got.front, ct.front, rtol=MODEL_RTOL,
                                   err_msg=qid)
        np.testing.assert_allclose(got.theta_c, ct.theta_c,
                                   rtol=MODEL_RTOL, err_msg=qid)
        tuned = row["tuned"]
        assert tuned.requests_sent == opt.requests_sent, qid
        np.testing.assert_allclose(tuned.sim.actual_latency,
                                   opt.sim.actual_latency, rtol=MODEL_RTOL,
                                   err_msg=qid)
        np.testing.assert_allclose(tuned.sim.cost, opt.sim.cost,
                                   rtol=MODEL_RTOL, err_msg=qid)
        n_sent += opt.requests_sent
    assert n_sent > 0                     # the runtime models were asked


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name][0].run()


def test_quickstart_runs_as_module_without_jax(tmp_path):
    """``python -m repro_torch.examples.quickstart --device cpu`` where the
    packages ``jax`` and ``repro`` found first raise on import."""
    for pkg in ("jax", "repro"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is not available here')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), os.path.join(ROOT, "src")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("query tpch-")
    assert any(ln.startswith("HMOOC3+:") for ln in lines)
    assert lines[-1].startswith("latency reduction vs default: ")
    blocked = subprocess.run(
        [sys.executable, "-c", "import jax"], env=env, capture_output=True,
        text=True, timeout=60, cwd=tmp_path)
    assert blocked.returncode != 0 and "not available here" in blocked.stderr
