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
        for p in sorted(bench.QUERIES.glob("*.py")):
            bench.query_module(p.stem)
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


TEST_QUERIES = ROOT / "portbench" / "tests" / "queries"


def _generators():
    return sorted((ROOT / "portbench" / "queries").glob("*.py")) + \
        sorted(TEST_QUERIES.glob("*.py"))


@pytest.mark.parametrize("path", _generators(), ids=lambda p: p.stem)
def test_query_generators_import_numpy_stdlib_and_plan_only(path):
    import ast
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert (n.split(".")[0] in sys.stdlib_module_names
                    or n.split(".")[0] == "numpy"
                    or n == "repro_torch.queryengine.plan"), (path, n)


def _bench_with(tmp_path, **cfg_changes):
    """BENCHMARK.json with one more configuration, ``toy`` (the TPC-H
    configuration with ``cfg_changes``), and its cell ``toy.fresh.steady``
    on the fresh TPC-H mix; generators come from ``tests/queries``."""
    cfg = json.loads((ROOT / "portbench/configs/tpch.json").read_text())
    del cfg["benchmark"]
    cfg.update(name="toy", **cfg_changes)
    (tmp_path / "toy.json").write_text(json.dumps(cfg))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "toy", "source": "a test",
                            "file": str(tmp_path / "toy.json"),
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy.fresh.steady", "config": "toy",
                              "traffic": "tpch.fresh.steady", "chips": 1,
                              "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench_mod.Benchmark(tmp_path / "BENCHMARK.json",
                               query_dir=TEST_QUERIES)


def test_configuration_brings_its_own_queries(tmp_path, tiny):
    import time
    b = _bench_with(tmp_path, queries="toy_star", n_templates=4)
    out, rec = cell.run(b, "toy.fresh.steady", 2 ** 31 + 3, 3.0, False,
                        "cpu", time.perf_counter(), overrides=tiny)
    assert out["correct"], out["checks"]
    assert out["attempted"] == round(14.0 * 3.0) and out["failed"] == 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert {s.request.query.benchmark for s in rec.served} == {"toy_star"}
    assert {s.request.query.template for s in rec.served} <= set(range(4))


def test_unknown_query_generator_is_refused(tmp_path):
    b = _bench_with(tmp_path, queries="no_such_generator", n_templates=4)
    with pytest.raises(FileNotFoundError, match="portbench/queries/"):
        b.queries(b.config("toy"))


def test_template_count_must_match_the_generator(tmp_path):
    b = _bench_with(tmp_path, queries="toy_star", n_templates=5)
    with pytest.raises(ValueError, match="n_templates 5.* have 4"):
        b.queries(b.config("toy"))
    b = bench_mod.Benchmark()
    cfg = dict(b.config("tpch"), n_templates=21)
    with pytest.raises(ValueError, match="n_templates 21.* have 22"):
        b.queries(cfg)


def test_generator_name_must_be_its_file_name(tmp_path):
    (tmp_path / "other_star.py").write_text(
        (TEST_QUERIES / "toy_star.py").read_text())
    with pytest.raises(ValueError, match="declares NAME 'toy_star'"):
        bench_mod.query_module("other_star", tmp_path)


def test_a_query_tagged_otherwise_is_refused():
    mod = bench_mod.query_module("toy_star", TEST_QUERIES)
    src = bench_mod.QuerySource("tpch", mod.N_TEMPLATES, mod.make_query)
    with pytest.raises(ValueError, match="tagged 'toy_star'"):
        src.make(0, variant=0, seed=0)
