"""The harness: BENCHMARK.json against its files, the metric arithmetic,
the trace reading, the command without a card, and no JAX anywhere."""
import json
import math
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from portbench.harness import bench as bench_mod
from portbench.harness import cell, devtrace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_entry_has_its_file():
    b = bench_mod.Benchmark()
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert b.config(c["name"])["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        b.traffic(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        mod = bench_mod.metric_module(m["name"])
        assert (mod.NAME, mod.UNIT) == (m["name"], m["unit"])


@pytest.mark.parametrize("cell_name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_its_layers_move(cell_name):
    b = bench_mod.Benchmark()
    e2e = {m["name"] for m in b.metrics(cell_name, False)}
    layer = b.metrics(cell_name, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


def _served(arrival, compiled, status="served", admitted=None):
    return types.SimpleNamespace(
        arrival_s=arrival, compiled_s=compiled, finished_s=compiled + 0.1,
        status=status, admitted_s=arrival if admitted is None else admitted,
        solve_latency_s=compiled - arrival)


def test_tails_count_a_rejection_as_a_miss():
    served = [_served(0.0, 0.01 * i) for i in range(1, 101)]
    rec = types.SimpleNamespace(served=served)
    p95 = bench_mod.metric_module("solve_p95_s")
    assert p95.read(rec) == pytest.approx(0.95)
    served[0].status = "shed"
    served[0].compiled_s = math.nan
    assert p95.read(rec) == pytest.approx(0.96)
    for s in served[:6]:
        s.status = "shed"
    assert p95.read(rec) == math.inf


def test_throughput_spans_first_arrival_to_last_finish():
    served = [_served(float(i), float(i) + 0.5) for i in range(10)]
    rec = types.SimpleNamespace(served=served)
    assert bench_mod.metric_module("tuned_qps").read(rec) == \
        pytest.approx(10 / 9.6)


def test_trace_busy_union_and_idle_labels():
    dev = [("k1", 200, 300), ("k2", 250, 400), ("k1", 900, 950),
           ("k3", 1100, 1200)]
    host = [(50, 700, "tune_batch"), (80, 150, "stage_eval")]
    s = devtrace.summarize(dev, (0, 1000), host)
    assert s.busy_s == pytest.approx(250e-9)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.outside_s == pytest.approx(100e-9)
    assert dict(s.device_ops) == pytest.approx(
        {"k1": 150e-9, "k2": 150e-9, "k3": 100e-9})
    gaps = dict(s.idle_gaps)
    assert gaps["stage_eval"] == pytest.approx(200e-9)
    assert gaps["tune_batch"] == pytest.approx(500e-9)
    assert gaps["serve (outside the spans)"] == pytest.approx(50e-9)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType(
        "repro_torch_extra"))
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert cell.forbidden_modules() == ["repro"]


def test_nothing_the_benchmark_loads_is_jax_or_repro():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.argv = ["run.py"]
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "pb_run", {str(ROOT / 'portbench' / 'run.py')!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._environment()
        from portbench.harness import cell, bench, correct
        import portbench.reference.model, portbench.reference.decisions
        b = bench.Benchmark()
        for m in b.spec["end_to_end"] + b.spec["per_layer"]:
            bench.metric_module(m["name"])
        bad = sorted({{n.split(".")[0] for n in sys.modules}}
                     & {{"jax", "jaxlib", "flax", "repro"}})
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_reference_imports_nothing_of_the_program():
    import ast
    allowed = {"__future__", "functools", "math", "zlib", "typing", "numpy",
               "torch"}
    for p in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (p, names)


def test_command_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tpch.fresh.steady", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_needs_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    exits non-zero with no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tpch.fresh.steady", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
