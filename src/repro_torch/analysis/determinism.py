"""Determinism checker for transcript-order code paths.

The counterpart of the reference's ``analysis/determinism.py``: the same
rules over the same scopes, and DT002 also knows torch's process-wide
generator, since the port draws its randomness through explicit
``torch.Generator`` objects.

The golden bit-identity proofs (streaming output ≡ offline pipeline,
batched solve ≡ sequential transcript, per-tenant determinism under any
interleaving, scenario replay-equivalence) only hold if nothing in the
solver or serving transcript depends on wall-clock time, unseeded
randomness, or hash-iteration order.  This checker guards the
transcript-ordered subtrees — ``serve/`` (the whole subtree, including
``serve/fleet.py``'s routing/merge paths), ``core/moo/``,
``core/tuning/``, and the scenario engine
(``queryengine/scenarios.py``, whose builds must be pure functions of
their seeds) — against all three leak classes; the scope is pinned by
explicit ``in_scope`` assertions in ``tests/test_analysis.py``.  The
call-graph-scoped replay-purity checker (:mod:`.replay_purity`) covers
the same leak classes in serve-reachable code *outside* these subtrees
and defers to DT001/DT002 inside them.

Rules:

* ``DT001`` **wall-clock** — ``time.time()`` / ``datetime.now()`` /
  ``utcnow()`` / ``today()`` in a transcript path.  ``time.perf_counter``
  is allowed: it only feeds *reported* timing stats, never decisions, and
  monotonic timing is the project idiom for that (enforced by review, not
  by this rule).
* ``DT002`` **unseeded-rng** — ``np.random.default_rng()`` with no seed,
  the legacy ``np.random.*`` global-state functions, the stdlib
  ``random`` module, or torch's global generator (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial`` and the ``*_like`` draws without ``generator=``,
  ``torch.manual_seed``, and the in-place ``Tensor.uniform_``,
  ``normal_``, ``random_``, ``bernoulli_`` without ``generator=``): any
  of them makes the transcript irreproducible.
* ``DT003`` **set-iteration-order** — iterating a ``set``/``frozenset``
  (directly, via ``list``/``tuple``/``enumerate``, or through a local
  variable holding one) in a transcript path.  Python set iteration order
  varies with hash seeding across processes; ``sorted(...)`` over a set is
  the deterministic idiom and is exempt.  Membership tests are fine.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Set

from .core import Finding, SourceFile, register_rules

__all__ = ["check", "RULES", "in_scope", "torch_global_rng"]

RULES = {
    "DT001": "wall-clock read in a transcript-order path",
    "DT002": "unseeded / global-state RNG in a transcript-order path",
    "DT003": "set-iteration-order dependence in a transcript-order path",
}
register_rules(RULES)

# Transcript-ordered subtrees (path-part sequences; a sequence ending in
# a ``.py`` part pins one module file).
_SCOPES = (("serve",), ("core", "moo"), ("core", "tuning"),
           ("queryengine", "scenarios.py"))

_LEGACY_NP_RANDOM = {"rand", "randn", "randint", "random", "choice",
                     "shuffle", "permutation", "normal", "uniform",
                     "standard_normal", "seed", "random_sample"}
_STDLIB_RANDOM = {"random", "randint", "choice", "shuffle", "uniform",
                  "randrange", "sample", "seed", "getrandbits"}


# torch draws that take ``generator=`` (without it they use the global one),
# those that cannot take one, and the in-place tensor draws.
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson"}
_TORCH_LIKE_DRAWS = {"rand_like", "randn_like", "randint_like"}
_TORCH_SEEDS = {"manual_seed", "seed"}
_TENSOR_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_"}


def torch_global_rng(node: ast.Call) -> Optional[str]:
    """The dotted name of a call that draws from (or reseeds) torch's
    process-wide generator, or None."""
    d = _dotted(node.func) or ""
    leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
            else d.rsplit(".", 1)[-1])
    has_gen = any(k.arg == "generator" for k in node.keywords)
    if d.startswith("torch."):
        if leaf in _TORCH_SEEDS or d.startswith("torch.cuda.manual_seed"):
            return d
        if leaf in _TORCH_LIKE_DRAWS:
            return d
        if leaf in _TORCH_DRAWS and not has_gen:
            return d
        return None
    if isinstance(node.func, ast.Attribute) and leaf in _TENSOR_DRAWS \
            and not has_gen:
        return f".{leaf}"
    return None


def in_scope(path: str) -> bool:
    parts = Path(path).parts
    for scope in _SCOPES:
        for i in range(len(parts) - len(scope) + 1):
            if tuple(parts[i:i + len(scope)]) == scope:
                return True
    return False


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.AST, set_vars: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        d = (_dotted(node.func) or "").rsplit(".", 1)[-1]
        if d in ("set", "frozenset"):
            return True
        # set-producing methods: a.union(b), a.intersection(b), ...
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "union", "intersection", "difference",
                "symmetric_difference"):
            return _is_set_expr(node.func.value, set_vars) \
                or any(_is_set_expr(a, set_vars) for a in node.args)
    if isinstance(node, ast.Name):
        return node.id in set_vars
    return False


def _collect_set_vars(scope: ast.AST) -> Set[str]:
    """Local names assigned a set literal/constructor in this scope."""
    out: Set[str] = set()
    # Two passes so `a = set(); b = a` resolves.
    for _ in range(2):
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if _is_set_expr(node.value, out):
                    out.add(node.targets[0].id)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.value is not None:
                if _is_set_expr(node.value, out):
                    out.add(node.target.id)
    return out


def _check_scope(src: SourceFile, scope: ast.AST,
                 findings: List[Finding]) -> None:
    set_vars = _collect_set_vars(scope)
    nested = {id(x) for n in ast.walk(scope)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and n is not scope
              for x in ast.walk(n)}

    def flag_iteration(iter_expr: ast.AST, line: int) -> None:
        if _is_set_expr(iter_expr, set_vars):
            findings.append(Finding(
                src.path, line, "DT003",
                "iteration over a set is hash-order dependent; sort it "
                "(`sorted(...)`) or use an ordered container"))

    for node in ast.walk(scope):
        if id(node) in nested:
            continue
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if d in ("time.time", "time.time_ns"):
                findings.append(Finding(
                    src.path, node.lineno, "DT001",
                    f"`{d}()` in a transcript path; use the simulated "
                    "clock (or perf_counter for reported timings only)"))
            elif leaf in ("now", "utcnow", "today") and "date" in d.lower():
                findings.append(Finding(
                    src.path, node.lineno, "DT001",
                    f"`{d}()` wall-clock read in a transcript path"))
            elif leaf == "default_rng" and not node.args \
                    and not node.keywords:
                findings.append(Finding(
                    src.path, node.lineno, "DT002",
                    "`default_rng()` without a seed: transcript is not "
                    "reproducible"))
            elif d.startswith(("np.random.", "numpy.random.")) \
                    and leaf in _LEGACY_NP_RANDOM:
                findings.append(Finding(
                    src.path, node.lineno, "DT002",
                    f"global-state `{d}` in a transcript path; use a "
                    "seeded `np.random.default_rng`"))
            elif d.startswith("random.") and leaf in _STDLIB_RANDOM:
                findings.append(Finding(
                    src.path, node.lineno, "DT002",
                    f"stdlib `{d}` in a transcript path; use a seeded "
                    "`np.random.default_rng`"))
            elif (drawn := torch_global_rng(node)):
                findings.append(Finding(
                    src.path, node.lineno, "DT002",
                    f"torch's global generator (`{drawn}`) in a transcript "
                    "path; pass a seeded `torch.Generator` (`generator=`)"))
            elif leaf in ("list", "tuple", "enumerate", "iter") \
                    and node.args:
                flag_iteration(node.args[0], node.lineno)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            flag_iteration(node.iter, node.lineno)
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.DictComp, ast.SetComp)):
            for gen in node.generators:
                flag_iteration(gen.iter, node.lineno)


def check(src: SourceFile) -> List[Finding]:
    if not in_scope(src.path):
        return []
    findings: List[Finding] = []
    # Module level + each function get their own set-variable scope.
    _check_scope(src, src.tree, findings)
    seen_lines = {(f.line, f.rule) for f in findings}
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_findings: List[Finding] = []
            _check_scope(src, node, fn_findings)
            for f in fn_findings:
                if (f.line, f.rule) not in seen_lines:
                    findings.append(f)
                    seen_lines.add((f.line, f.rule))
    return findings
