"""Snapshot-safety checker for the fleet cache exchange.

The counterpart of the reference's ``analysis/snapshot_safety.py``,
unchanged in meaning.  The port's restores are
``EffectiveSetCache.restore`` (re-frozen through ``_freeze_eset``),
``CandidatePoolCache.restore`` (in place) and ``ResponseCache.restore``
(kind ``response``, which carries no array kind), and
``OptimizerFleet`` restores only through them.

The fleet's snapshot contract: caches cross process boundaries only as
content-addressed blobs.  Entries keyed or fingerprinted by process-local
state (live-object ``id()`` pins) must stay process-local — a snapshot
carrying one would collide or silently mismatch when restored elsewhere —
and numpy arrays coming back out of a blob are shared by reference among
every future cache hit, so a restore path that does not re-freeze them
(``setflags(write=False)``) reintroduces the exact mutable-shared-array
bug class the fleet once fixed by hand.

Rules (file-scoped over every ``pack_snapshot`` / ``unpack_snapshot``
site; ``CacheStore.publish`` sites are covered because blobs only enter
the store through ``pack_snapshot``):

* ``SN001`` **unfiltered snapshot** — a ``pack_snapshot(kind, entries)``
  call whose entries expression (traced through local def-use chains)
  contains no comprehension filter referencing a pin discriminator
  (``model`` / ``fingerprint`` / ``isinstance`` / ``_fp`` / ``pin``).
  Kinds registered content-pure in ``CONTENT_PURE_KINDS`` are exempt:
  every entry of such a cache is content-addressed by construction, so
  there is nothing process-local to filter out.
* ``SN002`` **identity in blob** — an ``id(...)`` call in the entries
  expression's def-use closure: an object identity is flowing into a
  serialized snapshot.
* ``SN003`` **unfrozen restore** — a function unpacks an array-carrying
  kind (``ARRAY_KINDS``) without calling ``setflags(write=False)``
  before the entries go live.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .core import Finding, SourceFile, assignments, dotted, register_rules

__all__ = ["check", "RULES", "CONTENT_PURE_KINDS", "ARRAY_KINDS",
           "PIN_TOKENS"]

RULES = {
    "SN001": "snapshot packs entries without a process-local exclusion "
             "filter",
    "SN002": "id()-derived value flows into a snapshot blob",
    "SN003": "restored snapshot arrays are not re-frozen "
             "(setflags(write=False))",
}
register_rules(RULES)

# Snapshot kinds whose every entry is content-addressed by construction
# (candidate pools are pure functions of (seed, n_candidates, scope)):
# no pin filter required when packing.
CONTENT_PURE_KINDS: Set[str] = {"pools"}
# Snapshot kinds whose blobs carry numpy arrays that cache hits hand out
# by reference: restores must re-freeze.
ARRAY_KINDS: Set[str] = {"pools", "eset"}
# A comprehension `if` mentioning any of these counts as a pin filter.
PIN_TOKENS = ("model", "fingerprint", "isinstance", "_fp", "pin")


def _call_name(node: ast.Call) -> str:
    return (dotted(node.func) or "").rsplit(".", 1)[-1]


def _literal_kind(call: ast.Call) -> Optional[str]:
    """The snapshot-kind argument when it is a string literal."""
    args = list(call.args)
    for kw in call.keywords:
        if kw.arg == "kind":
            args.append(kw.value)
    for a in args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return None


def _closure_exprs(expr: ast.AST, fn: ast.AST) -> List[ast.AST]:
    """The expression plus every rhs its names resolve to (def-use)."""
    assigns = assignments(fn)
    out: List[ast.AST] = []
    frontier = [expr]
    seen: Set[str] = set()
    while frontier:
        e = frontier.pop()
        out.append(e)
        for sub in ast.walk(e):
            if isinstance(sub, ast.Name) and sub.id not in seen:
                seen.add(sub.id)
                frontier.extend(assigns.get(sub.id, []))
    return out

def _has_pin_filter(exprs: Sequence[ast.AST]) -> bool:
    for e in exprs:
        for sub in ast.walk(e):
            if isinstance(sub, (ast.ListComp, ast.GeneratorExp,
                                ast.SetComp, ast.DictComp)):
                for gen in sub.generators:
                    for cond in gen.ifs:
                        toks = {t.lower() for t in _tokens(cond)}
                        if any(p in t for t in toks for p in PIN_TOKENS):
                            return True
    return False


def _tokens(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _has_id_call(exprs: Sequence[ast.AST]) -> bool:
    for e in exprs:
        for sub in ast.walk(e):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                    and sub.func.id == "id" and len(sub.args) == 1:
                return True
    return False


def _freezes_arrays(fn: ast.AST, module_fns: Dict[str, ast.AST]) -> bool:
    """True when the function — or a same-module helper it calls — calls
    ``x.setflags(write=False)``."""
    stack: List[ast.AST] = [fn]
    seen: Set[int] = set()
    while stack:
        f = stack.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        for node in ast.walk(f):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "setflags":
                for kw in node.keywords:
                    if kw.arg == "write" \
                            and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is False:
                        return True
            leaf = _call_name(node)
            if leaf in module_fns:
                stack.append(module_fns[leaf])
    return False


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    fns: List[ast.AST] = [n for n in ast.walk(src.tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
    module_fns: Dict[str, ast.AST] = {f.name: f for f in fns}
    for fn in fns:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "pack_snapshot":
                kind = _literal_kind(node)
                entries = (node.args[1] if len(node.args) > 1 else
                           next((kw.value for kw in node.keywords
                                 if kw.arg == "entries"), None))
                if entries is None:
                    continue
                exprs = _closure_exprs(entries, fn)
                if kind not in CONTENT_PURE_KINDS \
                        and not _has_pin_filter(exprs):
                    findings.append(Finding(
                        src.path, node.lineno, "SN001",
                        f"`{fn.name}` packs kind `{kind}` without a "
                        "filter excluding process-local (id-pinned) "
                        "entries"))
                if _has_id_call(exprs):
                    findings.append(Finding(
                        src.path, node.lineno, "SN002",
                        f"`{fn.name}` lets an `id(...)` value flow into "
                        f"the `{kind}` snapshot blob"))
            elif name == "unpack_snapshot":
                kind = _literal_kind(node)
                if kind in ARRAY_KINDS \
                        and not _freezes_arrays(fn, module_fns):
                    findings.append(Finding(
                        src.path, node.lineno, "SN003",
                        f"`{fn.name}` restores array-carrying kind "
                        f"`{kind}` without re-freezing "
                        "(`setflags(write=False)`); restored arrays are "
                        "shared by reference across cache hits"))
    return findings
