"""Kernel parity-registry checker.

The counterpart of the reference's ``analysis/kernel_parity.py``.  Every
kernel package under ``src/repro_torch/kernels/`` is a hand-written CUDA
kernel beside a plain PyTorch version of the same arithmetic, and that
plain version is what makes the card's routing *checkable*.  This checker
enforces the registry contract:

* ``KP001`` **missing-ref** — a kernel package (a directory with an
  ``ops.py``) ships no ``ref.py`` reference implementation.
* ``KP002`` **unregistered-parity-test** — no test of the port
  (``tests/test_torch_*.py``, found from the repository root; never the
  reference's ``tests/test_kernels.py``) exercises the package against a
  ``*ref*`` oracle: a test function must use a symbol imported from the
  port's package *and* reference a name containing ``ref``.  Imports of
  the reference's own kernel packages (``repro.kernels.*``) do not count.
* ``KP003`` **tie-blind-routing** — a routing site outside ``kernels/``
  (recognized by the project idiom: a function-local lazy ``from
  ...kernels.<pkg> import``) dispatches to a float32-comparing kernel
  (``pareto_filter`` / ``ws_reduce`` / ``fused_solve``) without a
  ``*tie_hazard*`` guard reachable from that function or a same-module
  caller.  Without the guard, values that are distinct in float64 but
  collide in float32 make the result depend on which side of the size
  threshold the batch landed — the f32/f64 near-tie routing bug class.
* ``KP004`` **untested-cuda-entry** — an ``extern "C"`` entry *defined*
  in ``kernels/<pkg>/csrc/*.cu`` (a declaration ending in ``;`` is not a
  definition) has no ``cuda``-marked test in ``tests/test_torch_cuda.py``
  that reaches it through the package's ``ops.py`` (a function of
  ``ops.py`` whose body names the entry, or one calling such a function)
  and references a function of the package's ``ref.py``.

``flash_attention`` is exempt from KP003 by registry: its inputs are
natively f32/bf16 and it has no dtype-changing numpy fallback, so routing
cannot change the compare semantics.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile, dotted, register_rules, tokens

__all__ = ["check_file", "check_tree", "cuda_entries", "RULES",
           "ROUTED_F32_KERNELS"]

RULES = {
    "KP001": "kernel package ships no plain ref.py reference",
    "KP002": "kernel package has no parity test of the port against its ref",
    "KP003": "f32 kernel routing site without a tie-hazard guard",
    "KP004": "extern \"C\" CUDA entry has no cuda-marked test through ops.py "
             "against ref.py",
}
register_rules(RULES)

# Kernel packages whose kernel path compares in float32 while the numpy
# fallback compares in float64 — the packages KP003 guards.
ROUTED_F32_KERNELS = {"pareto_filter", "ws_reduce", "fused_solve"}

_REFERENCE_PACKAGE = "repro."


# ---------------------------------------------------------------------------
# Tree-scoped rules: KP001 / KP002 / KP004
# ---------------------------------------------------------------------------

def _kernel_packages(paths: Sequence[str]) -> List[Path]:
    pkgs: List[Path] = []
    seen: Set[Path] = set()
    for p in paths:
        p = Path(p)
        roots = [p] if p.is_dir() else [p.parent]
        for root in roots:
            for ops in root.rglob("ops.py"):
                pkg = ops.parent
                if pkg.parent.name == "kernels" and pkg not in seen:
                    seen.add(pkg)
                    pkgs.append(pkg)
    return sorted(pkgs)


def _tests_dir(pkgs: Sequence[Path], tests: Optional[str]) -> Optional[Path]:
    """The directory (or single file) holding the port's tests: ``tests``
    when given, else the first ``tests/`` above a package that holds
    ``test_torch_*.py`` files, else ``./tests``."""
    if tests is not None:
        return Path(tests)
    for pkg in pkgs:
        for anc in pkg.parents:
            cand = anc / "tests"
            if cand.is_dir() and any(cand.glob("test_torch_*.py")):
                return cand
    cand = Path("tests")
    return cand if cand.is_dir() else None


def _port_test_files(where: Optional[Path]) -> List[Path]:
    if where is None:
        return []
    if where.is_file():
        return [where]
    return sorted(where.glob("test_torch_*.py"))


def _cuda_test_file(where: Optional[Path]) -> Optional[Path]:
    if where is None:
        return None
    if where.is_file():
        return where
    cand = where / "test_torch_cuda.py"
    return cand if cand.is_file() else None


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except (SyntaxError, OSError, UnicodeDecodeError):
        return None


def _port_kernel_import(module: Optional[str]) -> Optional[Tuple[str, str]]:
    """(package, submodule) of an import from one of the port's kernel
    packages (``repro_torch.kernels.<pkg>[.<sub>]``); None for the
    reference's or anything else."""
    if not module or "kernels." not in module \
            or module.startswith(_REFERENCE_PACKAGE):
        return None
    rest = module.split("kernels.", 1)[1].split(".")
    return rest[0], (rest[1] if len(rest) > 1 else "")


def _test_functions(tree: ast.Module) -> List[ast.FunctionDef]:
    return [fn for fn in tree.body if isinstance(fn, ast.FunctionDef)
            and fn.name.startswith("test")]


def _imports_of(nodes) -> Dict[str, Tuple[str, str, str]]:
    """local name -> (kernel package, submodule, imported name)."""
    out: Dict[str, Tuple[str, str, str]] = {}
    for node in nodes:
        if isinstance(node, ast.ImportFrom):
            hit = _port_kernel_import(node.module)
            if hit is None:
                continue
            for alias in node.names:
                out[alias.asname or alias.name] = (hit[0], hit[1],
                                                   alias.name)
    return out


def _parity_tested_packages(files: Sequence[Path]) -> Set[str]:
    """Port packages exercised against a ``*ref*`` symbol by some test."""
    tested: Set[str] = set()
    for path in files:
        tree = _parse(path)
        if tree is None:
            continue
        module_imports = _imports_of(tree.body)
        for fn in _test_functions(tree):
            local = dict(module_imports)
            local.update(_imports_of(ast.walk(fn)))
            used = tokens(fn)
            if not any("ref" in u.lower() for u in used):
                continue
            tested |= {pkg for name, (pkg, _, _) in local.items()
                       if name in used}
    return tested


_ENTRY_RE = re.compile(
    r'extern\s+"C"\s+[^;{()]*?\b([A-Za-z_]\w*)\s*\(([^)]*)\)\s*([;{])',
    re.S)


def cuda_entries(pkg: Path) -> List[Tuple[str, Path, int]]:
    """(name, file, line) of every ``extern "C"`` function *defined* in
    the package's ``csrc/*.cu`` files (declarations are skipped)."""
    out = []
    for cu in sorted((pkg / "csrc").glob("*.cu")):
        try:
            text = cu.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        for m in _ENTRY_RE.finditer(text):
            if m.group(3) == "{":
                out.append((m.group(1), cu,
                            text.count("\n", 0, m.start()) + 1))
    return out


def _wrappers(pkg: Path, entry: str) -> Set[str]:
    """Functions of the package's ``ops.py`` that reach ``entry``: those
    whose body names it, and those calling one of them (in ``ops.py``)."""
    tree = _parse(pkg / "ops.py")
    if tree is None:
        return set()
    fns = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    toks = {name: tokens(fn) for name, fn in fns.items()}
    reach = {name for name, t in toks.items() if entry in t}
    grew = True
    while grew:
        more = {name for name, t in toks.items()
                if name not in reach and t & reach}
        reach |= more
        grew = bool(more)
    return reach


def _ref_functions(pkg: Path) -> Set[str]:
    tree = _parse(pkg / "ref.py")
    if tree is None:
        return set()
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _cuda_marked(tree: ast.Module, fn: ast.FunctionDef) -> bool:
    def is_cuda(node: ast.AST) -> bool:
        return any((dotted(n) or "").endswith("mark.cuda")
                   for n in ast.walk(node))
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in stmt.targets) and is_cuda(stmt.value):
            return True
    return any(is_cuda(dec) for dec in fn.decorator_list)


def _entry_tested(tree: ast.Module, pkg: str, wrappers: Set[str],
                  refs: Set[str]) -> bool:
    """Whether a cuda-marked test reaches one of ``wrappers`` through the
    package (or its ``ops``) and uses a function of its ``ref.py``."""
    module_imports = _imports_of(tree.body)
    for fn in _test_functions(tree):
        if not _cuda_marked(tree, fn):
            continue
        local = dict(module_imports)
        local.update(_imports_of(ast.walk(fn)))
        reaches = uses_ref = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and node.id in local:
                p, sub, name = local[node.id]
                if p == pkg and sub in ("", "ops") and name in wrappers:
                    reaches = True
                if p == pkg and sub in ("", "ref") and name in refs:
                    uses_ref = True
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in local:
                p, sub, name = local[node.value.id]
                mod = name if sub == "" else sub
                if p == pkg and mod == "ops" and node.attr in wrappers:
                    reaches = True
                if p == pkg and mod == "ref" and node.attr in refs:
                    uses_ref = True
        if reaches and uses_ref:
            return True
    return False


def check_tree(paths: Sequence[str],
               tests_dir: Optional[str] = None) -> List[Finding]:
    pkgs = _kernel_packages(paths)
    if not pkgs:
        return []
    findings: List[Finding] = []
    where = _tests_dir(pkgs, tests_dir)
    tested = _parity_tested_packages(_port_test_files(where))
    cuda_file = _cuda_test_file(where)
    cuda_tree = _parse(cuda_file) if cuda_file else None
    for pkg in pkgs:
        ops = pkg / "ops.py"
        if not (pkg / "ref.py").is_file():
            findings.append(Finding(
                str(ops), 1, "KP001",
                f"kernel package `{pkg.name}` has no ref.py reference "
                "implementation"))
        if pkg.name not in tested:
            shown = where or "tests"
            findings.append(Finding(
                str(ops), 1, "KP002",
                f"no parity test of the port in {shown} exercises "
                f"`{pkg.name}` against a ref oracle"))
        refs = _ref_functions(pkg)
        for entry, cu, line in cuda_entries(pkg):
            wrappers = _wrappers(pkg, entry)
            if cuda_tree is None or not wrappers or not _entry_tested(
                    cuda_tree, pkg.name, wrappers, refs):
                findings.append(Finding(
                    str(cu), line, "KP004",
                    f"CUDA entry `{entry}` has no cuda-marked test in "
                    f"{cuda_file or 'tests/test_torch_cuda.py'} reaching "
                    f"it through `{pkg.name}/ops.py` against a function "
                    "of its ref.py"))
    return findings


# ---------------------------------------------------------------------------
# File-scoped rule: KP003
# ---------------------------------------------------------------------------

def check_file(src: SourceFile) -> List[Finding]:
    if "kernels" in Path(src.path).parts:
        return []                      # intra-package composition is exempt
    fns = [n for n in ast.walk(src.tree) if isinstance(n, ast.FunctionDef)]
    toks = {fn.name: tokens(fn) for fn in fns}
    # Same-module caller graph: caller -> callees (by referenced name).
    names = set(toks)
    callers: Dict[str, Set[str]] = {n: set() for n in names}
    for fn in fns:
        for callee in toks[fn.name] & names:
            if callee != fn.name:
                callers.setdefault(callee, set()).add(fn.name)

    def guarded(name: str, seen: Set[str]) -> bool:
        if name in seen:
            return False
        seen.add(name)
        if any("tie_hazard" in t for t in toks.get(name, ())):
            return True
        return any(guarded(c, seen) for c in callers.get(name, ()))

    findings: List[Finding] = []
    for fn in fns:
        for node in ast.walk(fn):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and "kernels." in node.module:
                pkg = node.module.split("kernels.")[1].split(".")[0]
                if pkg in ROUTED_F32_KERNELS \
                        and not guarded(fn.name, set()):
                    findings.append(Finding(
                        src.path, node.lineno, "KP003",
                        f"`{fn.name}` routes to the f32 `{pkg}` kernel "
                        "with no tie-hazard guard: near-tie results would "
                        "depend on which side of the size threshold the "
                        "batch lands"))
    return findings
