"""The port's invariant suite (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and its PyTorch rules on their own
golden fixtures.

* Rules whose meaning the port keeps (CK, DT, RP, SN, KP001, KP003 and
  the suppression rules SUP) give the reference's findings on every file
  and folder of ``tests/fixtures/analysis/`` and on ``src/repro_torch``:
  path, line, rule and message, verbatim (the port words these messages
  exactly as the reference does), and the same suppressed set.
* The recast rules (TH001–TH005, torch's global generator under DT002
  and RP003, KP002 over the port's tests, KP004 over the CUDA entries)
  and both suppression markers are pinned on
  ``tests/fixtures/analysis_torch/``.
* The gates: the port's tree is clean under ``--strict`` with JAX and the
  reference unimportable, and the suppressed host syncs each hot root
  reaches are pinned by file and function (the budget of ``PERF.md`` §3).
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import analysis as ref_analysis
from repro_torch.analysis import (determinism, kernel_parity,
                                  replay_purity, run_files, run_paths,
                                  trace_hazards)
from repro_torch.analysis.core import CallGraph, SourceFile

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
PORT = REPO / "src" / "repro_torch"
# The rule-id prefixes whose meaning is unchanged, with the suppression
# rules.
UNCHANGED = ["CK", "DT", "RP", "SN", "KP001", "KP003", "SUP"]
# Findings of the unchanged ids the port may add on src/repro_torch: the
# torch global-generator cases of DT002/RP003, by (path, line, rule).
# The port draws only through explicit generators, so there are none.
TORCH_RNG_EXTRAS = set()


def _rows(findings):
    return sorted((f.path, f.line, f.rule, f.message) for f in findings)


def _fixture_targets():
    files = sorted(p for p in REF_FIXTURES.rglob("*.py"))
    dirs = sorted({p for f in files for p in f.parents
                   if REF_FIXTURES in p.parents or p == REF_FIXTURES})
    return [str(p.relative_to(REPO)) for p in files + dirs]


@pytest.mark.parametrize("target", _fixture_targets())
def test_reference_fixture_parity_on_unchanged_rules(target):
    kw = dict(strict=True, select=UNCHANGED)
    if "kernels_tree" in target:
        kw["tests_dir"] = str(REF_FIXTURES / "kernels_tree" / "parity_tests.py")
    port = run_paths([target], **kw)
    ref = ref_analysis.run_paths([target], **kw)
    assert _rows(port.findings) == _rows(ref.findings)
    assert _rows(port.suppressed) == _rows(ref.suppressed)
    assert _rows(port.parse_errors) == _rows(ref.parse_errors)


@pytest.fixture(scope="module")
def port_tree():
    """The port's whole suite over its own tree, as the CI gate runs it."""
    return run_paths([str(PORT)], strict=True)


def test_src_tree_parity_on_unchanged_rules():
    port = run_paths([str(PORT)], strict=True, select=UNCHANGED)
    ref = ref_analysis.run_paths([str(PORT)], strict=True, select=UNCHANGED)
    extra = set(_rows(port.findings)) - set(_rows(ref.findings))
    assert {(p, ln, r) for p, ln, r, _ in extra} == TORCH_RNG_EXTRAS
    assert set(_rows(ref.findings)) <= set(_rows(port.findings))
    assert _rows(port.suppressed) == _rows(ref.suppressed)
    assert port.suppressed, "the reference's markers in the port stay live"


def test_src_tree_strict_clean(port_tree):
    assert not port_tree.parse_errors
    assert [f.format() for f in port_tree.findings] == []
    assert port_tree.suppressed, "expected documented intentional exceptions"
    rules = {f.rule for f in port_tree.suppressed}
    assert {"TH002", "CK002", "RP004", "KP003"} <= rules


# ---------------------------------------------------------------------------
# The recast rules on their golden fixtures
# ---------------------------------------------------------------------------

def _lines(findings):
    return sorted((f.line, f.rule) for f in findings)


def test_host_sync_fixture_golden():
    src = SourceFile(FIXTURES / "hot" / "bad_host_sync.py")
    roots = ("bad_host_sync.step", "bad_host_sync.host_route",
             "bad_host_sync.make_fns.decode")
    got = trace_hazards.check_project([src], CallGraph([src]), roots=roots)
    # `cold` and the nested `unused` are reached from no root; `host`'s
    # tolist and the off-card branch's numpy are host values.
    assert _lines(got) == [
        (9, "TH001"), (13, "TH002"), (14, "TH002"), (17, "TH002"),
        (18, "TH002"), (21, "TH002"), (22, "TH001"), (23, "TH002"),
        (28, "TH002"), (34, "TH002"), (43, "TH001"), (50, "TH002")]


def test_frozen_routing_and_capture_fixture_golden():
    got = trace_hazards.check(SourceFile(FIXTURES / "core" /
                                         "bad_routing.py"))
    assert _lines(got) == [(10, "TH003"), (11, "TH003"), (12, "TH003"),
                           (16, "TH004"), (21, "TH004"), (31, "TH005"),
                           (54, "TH005")]


def test_torch_rng_determinism_fixture_golden():
    path = FIXTURES / "serve" / "torch_rng.py"
    assert determinism.in_scope(str(path))
    assert _lines(determinism.check(SourceFile(path))) == [
        (8, "DT002"), (10, "DT002"), (11, "DT002"), (12, "DT002"),
        (14, "DT002"), (15, "DT002")]
    # The reference does not know torch's generator.
    assert ref_analysis.run_paths([str(path)], select=["DT"]).findings == []


def test_torch_rng_replay_purity_fixture_golden():
    files = [SourceFile(p) for p in sorted((FIXTURES / "rp_torch")
                                           .glob("*.py"))]
    got = replay_purity.check_project(files, CallGraph(files))
    # offline() draws from the global generator too, but no entrypoint
    # reaches it.
    assert sorted((Path(f.path).name, f.line, f.rule) for f in got) == [
        ("helpers.py", 9, "RP003"), ("helpers.py", 10, "RP003")]


@pytest.mark.parametrize("tests_file,good_untested", [
    ("port_parity_tests.py", [11]),
    ("port_parity_tests_unmarked.py", [6, 11]),
])
def test_kernel_registry_fixture_golden(tests_file, good_untested):
    tree = FIXTURES / "kernels_tree"
    got = kernel_parity.check_tree([str(tree)],
                                   tests_dir=str(tree / tests_file))
    rows = sorted((Path(f.path).parent.name if f.rule != "KP004"
                   else Path(f.path).name, f.line, f.rule) for f in got)
    # goodpkg: good_launch is tested against good_ref on the card (not
    # without the marker), spare_launch's test compares with no ref,
    # other_launch is only declared.  badpkg: no ref.py, and its only test
    # goes through the reference's package.
    assert rows == sorted(
        [("bad.cu", 2, "KP004"), ("badpkg", 1, "KP001"),
         ("badpkg", 1, "KP002")]
        + [("good.cu", line, "KP004") for line in good_untested])
    assert [e[0] for e in kernel_parity.cuda_entries(
        tree / "kernels" / "goodpkg")] == ["good_launch", "spare_launch"]


def test_kp004_finds_the_five_cuda_entries():
    entries = sorted(e[0] for pkg in sorted((PORT / "kernels").iterdir())
                     if (pkg / "ops.py").is_file()
                     for e in kernel_parity.cuda_entries(pkg))
    assert entries == ["flash_attention_launch", "fused_ws_front_launch",
                       "pareto_filter_launch", "runtime_pick_launch",
                       "ws_reduce_launch"]
    # Each has its card test against the package's ref.py, and KP002 reads
    # the port's tests only: the reference's tests/test_kernels.py alone
    # registers nothing.
    assert kernel_parity.check_tree([str(PORT)]) == []
    alone = kernel_parity.check_tree(
        [str(PORT)], tests_dir=str(REPO / "tests" / "test_kernels.py"))
    assert sorted((Path(f.path).parent.name, f.rule) for f in alone
                  if f.rule == "KP002") == [
        ("flash_attention", "KP002"), ("fused_solve", "KP002"),
        ("pareto_filter", "KP002"), ("ws_reduce", "KP002")]


def test_markers_fixture_golden():
    path = str(FIXTURES / "serve" / "markers.py")
    th = functools.partial(trace_hazards.check_project,
                           roots=("markers.step", "markers.stamp"))
    r = run_files([path], [determinism.check], strict=True,
                  project_checkers=[th])
    # 11: a reference marker naming TH002 is neither used nor judged here;
    # 12: a port marker without a reason (SUP001); 14: a port marker that
    # silences nothing (SUP002); 22: a port marker above a reference one
    # steps over it, and both stay live; 23: a reference marker above a
    # port one covers the port's comment line only (SUP002), so the
    # DT001 on 25 is live while the port marker silences its TH002.
    assert [(f.line, f.rule) for f in r.findings] == [
        (11, "TH002"), (12, "SUP001"), (14, "SUP002"), (23, "SUP002"),
        (25, "DT001")]
    assert _lines(r.suppressed) == [(10, "TH002"), (13, "TH002"),
                                    (22, "DT001"), (22, "TH002"),
                                    (25, "TH002")]
    lax = run_files([path], [determinism.check], strict=False,
                    project_checkers=[th])
    assert [(f.line, f.rule) for f in lax.findings] == [(11, "TH002"),
                                                        (25, "DT001")]
    # The reference reads only its own marker: the same DT001 verdicts,
    # and the TH002 marker on 11 is dead to it.
    ref = ref_analysis.run_paths([path], strict=True)
    assert [(f.line, f.rule) for f in ref.findings] == [
        (11, "SUP002"), (23, "SUP002"), (25, "DT001")]
    assert _lines(ref.suppressed) == [(22, "DT001")]


# ---------------------------------------------------------------------------
# The budget and the CLI
# ---------------------------------------------------------------------------

# Suppressed TH001/TH002 sites each hot root reaches, by file and
# function: the host syncs PERF.md §3 budgets.  A new sync on a hot path
# shows here before it reaches the card.
HOT_SITES = {
    "core.moo.pareto.pareto_mask_fast": [
        ("core/moo/pareto.py", "_pareto_masks_kernel")],
    "core.moo.pareto.pareto_masks_fast": [
        ("core/moo/pareto.py", "_pareto_masks_kernel")],
    "core.moo.hmooc.dag_aggregate": [
        ("core/moo/hmooc.py", "_host_arrays"),
        ("core/moo/hmooc.py", "_ws_pick"),
        ("core/moo/hmooc.py", "dag_aggregate"),
        ("core/moo/pareto.py", "_pareto_masks_kernel"),
        ("kernels/fused_solve/ops.py", "_as")],
    "core.moo.hmooc._hmooc2_all_fused": [
        ("core/moo/hmooc.py", "_host_arrays"),
        ("kernels/fused_solve/ops.py", "_as")],
    "core.tuning.runtime.weighted_pick_batch": [
        ("core/tuning/runtime.py", "_pick_on_card")],
    "train.serve.make_serve_fns.prefill": [],
    "train.serve.make_serve_fns.decode": [],
    "train.train_loop.make_train_step.step": [],
    "core.models.training.train_model": [
        ("core/models/training.py", "train_model")],
}


@pytest.fixture(scope="module")
def port_graph():
    from repro_torch.analysis.core import iter_python_files
    files = [SourceFile(f) for f in iter_python_files([str(PORT)])]
    return files, CallGraph(files)


def test_hot_roots_resolve(port_graph):
    _, graph = port_graph
    assert set(HOT_SITES) == set(trace_hazards.HOT_ROOTS)
    for root in trace_hazards.HOT_ROOTS:
        # A renamed root would silently take its syncs off the hot paths.
        assert trace_hazards._scopes_of_root(graph, root), root


def test_hot_root_sync_sites_pinned(port_graph, port_tree):
    files, graph = port_graph
    suppressed = {(f.path, f.line) for f in port_tree.suppressed
                  if f.rule in ("TH001", "TH002")}
    for root, want in HOT_SITES.items():
        got = trace_hazards.check_project(files, graph, roots=(root,))
        assert {(f.path, f.line) for f in got} <= suppressed, root
        sites = sorted({(Path(f.path).relative_to(PORT).as_posix(),
                         f.message.split("hot `", 1)[1].split("`", 1)[0])
                        for f in got})
        assert sites == want, root


_NO_REFERENCE = ("import runpy, sys; sys.modules['jax'] = None; "
                 "sys.modules['repro'] = None; sys.argv = sys.argv[1:]; "
                 "runpy.run_module('repro_torch.analysis', "
                 "run_name='__main__')")


@pytest.mark.parametrize("args,rc,expect", [
    (["--strict", "src/repro_torch"], 0, "TH002"),
    ([str(FIXTURES / "core" / "bad_routing.py")], 1, "TH005"),
    (["--json", "--select", "DT",
      str(FIXTURES / "serve" / "torch_rng.py")], 1, '"DT002"'),
    (["--rules"], 0, "KP004"),
])
def test_cli_exit_codes_without_jax_or_reference(args, rc, expect):
    out = subprocess.run(
        [sys.executable, "-c", _NO_REFERENCE, "analysis"] + args,
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == rc, out.stdout + out.stderr
    assert expect in out.stdout
    if "--json" in args:
        payload = json.loads(out.stdout)
        assert {f["rule"] for f in payload["findings"]} == {"DT002"}
    if "--rules" in args:
        for rule in ("TH001", "TH002", "TH003", "TH004", "TH005", "CK001",
                     "CK002", "DT001", "DT002", "DT003", "KP001", "KP002",
                     "KP003", "KP004", "RP001", "RP003", "RP005", "SN001",
                     "SN003", "SUP001", "SUP002"):
            assert rule in out.stdout, f"--rules is missing {rule}"


def test_analysis_package_imports_no_reference():
    import ast
    for path in sorted((PORT / "analysis").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for name in names:
                assert name.split(".")[0] not in ("repro", "jax"), (
                    path, name)
