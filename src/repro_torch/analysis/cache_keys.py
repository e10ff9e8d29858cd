"""Cache-key completeness checker for the serving-layer caches.

The counterpart of the reference's ``analysis/cache_keys.py``, unchanged
in meaning.

Every hand-fixed cache bug so far was the same shape: a context dimension
the cached computation *reads* (the tenant, the model fingerprint, the
degraded flag) was missing from the *key*, so entries minted under one
context were served under another.  This checker pins the key
constructions of the registered serving caches (``ResponseCache``,
``EffectiveSetCache``, ``CandidatePoolCache`` and the degrade-marked
``_CheapEntry`` keys) and audits store sites for unkeyed context reads.

Rules:

* ``CK001`` **incomplete-key-builder** — a registered key builder
  (``template_key``, ``_response_key``, ``CandidatePoolCache.get``'s key
  tuple) no longer references one of its required context dimensions.
* ``CK002`` **unkeyed-context-read** — a function stores into a registered
  cache (``.put(key, v)`` or ``self._entries[key] = v``) while reading a
  context dimension (tenant / weights / gamma_mode / degraded / scope /
  seed / model) that does not flow into the key expression.  Key
  expressions are resolved through local assignments and same-module key
  builders; a key passed in whole as a parameter is trusted locally and
  the *callers* of the enclosing function are audited instead, through
  the project call graph (``check_project``) — closing the old blind
  spot where a helper stored under a caller-composed key and neither
  side was checked.

The context-dimension vocabulary is a name-pattern registry, not type
inference: a dimension counts as *read* when an identifier matching it
appears in the function, and as *keyed* when one appears in the key's
identifier closure.  That is exactly the granularity the historical bugs
had (the missing dimension was simply absent from the key tuple).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (CallGraph, Finding, SourceFile, param_names,
                   register_rules)

__all__ = ["check", "check_project", "RULES", "KEY_BUILDERS",
           "CONTEXT_DIMS"]

RULES = {
    "CK001": "registered cache-key builder is missing a required dimension",
    "CK002": "context dimension read in a cached computation but absent "
             "from the cache key",
}
register_rules(RULES)

# Key builders pinned by CK001: function name -> required identifier
# tokens (matched against Name ids / Attribute attrs in the returned or
# assigned key expression).
KEY_BUILDERS: Dict[str, Set[str]] = {
    # EffectiveSetCache: (benchmark, template, cfg, cost, model fingerprint)
    "template_key": {"benchmark", "template", "cfg", "cost",
                     "model_fingerprint"},
    # ResponseCache: (tenant, qid, stats fingerprint, weights, cfg, cost,
    # model fingerprint)
    "_response_key": {"tenant", "qid", "query_fingerprint", "w", "cfg",
                      "cost", "_model_fp"},
    # Fleet router: the template-affinity dims of the cache fingerprint
    # (cfg/cost/model are fleet-constant and must NOT differentiate
    # workers; benchmark+template decide cache ownership).
    "route_key": {"benchmark", "template"},
}
# Method-scoped builders: (class, method, key variable) -> required tokens.
KEY_METHOD_BUILDERS: Dict[Tuple[str, str], Set[str]] = {
    ("CandidatePoolCache", "get"): {"seed", "n_candidates", "scope"},
}

# Context-dimension name classes (substring match, lowercased) plus exact
# single-letter weight idiom.  A name hits a class if it contains the
# pattern: `tenants`, `per_q_weights`, `_model_fp`, `gamma_mode` all match.
CONTEXT_DIMS: Dict[str, Sequence[str]] = {
    "tenant": ("tenant",),
    "weights": ("weight",),
    "gamma": ("gamma",),
    "degraded": ("degrad",),
    "scope": ("scope",),
    "seed": ("seed",),
    "model": ("model",),
}
_EXACT_DIMS = {"w": "weights"}

# Attribute / name fragments that identify a registered cache object.
# ``_blobs`` is the fleet CacheStore's published-snapshot map: its store
# sites are audited like any serving cache (the key must carry every
# context dimension the publishing function reads).
_CACHE_ATTRS = ("cache", "_results", "_pools", "_entries", "_d", "_blobs")


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _tokens(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _dims_of(tokens: Set[str]) -> Set[str]:
    hit: Set[str] = set()
    for t in tokens:
        tl = t.lower()
        if t in _EXACT_DIMS:
            hit.add(_EXACT_DIMS[t])
        for dim, pats in CONTEXT_DIMS.items():
            if any(p in tl for p in pats):
                hit.add(dim)
    return hit


def _is_cache_store(node: ast.AST) -> Optional[Tuple[ast.AST, int]]:
    """(key expr, line) when ``node`` stores into a registered cache."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "put" and len(node.args) == 2:
        base = _dotted(node.func.value) or ""
        leaf = base.rsplit(".", 1)[-1]
        if any(c in leaf for c in _CACHE_ATTRS):
            return node.args[0], node.lineno
    if isinstance(node, ast.Assign) and len(node.targets) == 1 \
            and isinstance(node.targets[0], ast.Subscript):
        tgt = node.targets[0]
        base = _dotted(tgt.value) or ""
        leaf = base.rsplit(".", 1)[-1]
        if leaf in ("_entries", "_pools", "_d", "_blobs"):
            return tgt.slice, node.lineno
    return None


class _FnIndex:
    """Same-module function defs + their key-expression token closures."""

    def __init__(self, tree: ast.Module):
        self.fns: Dict[str, ast.FunctionDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                # last definition wins; good enough for module-local builders
                self.fns[node.name] = node

    def return_tokens(self, name: str) -> Set[str]:
        fn = self.fns.get(name)
        if fn is None:
            return set()
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                out |= _tokens(node.value)
        return out


def _assignments(fn: ast.FunctionDef) -> Dict[str, List[ast.AST]]:
    """name -> rhs exprs, from plain, subscript-target and for-loop binds."""
    out: Dict[str, List[ast.AST]] = {}

    def bind(target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif isinstance(target, ast.Subscript):
            base = target.value
            if isinstance(base, ast.Name):
                out.setdefault(base.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                bind(el, value)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bind(t, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            bind(node.target, node.value)
        elif isinstance(node, ast.For):
            bind(node.target, node.iter)
    return out


def _top_operands(expr: ast.AST) -> List[ast.AST]:
    """Flatten top-level tuple concatenation: ``("x",) + key`` -> both."""
    ops: List[ast.AST] = []
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
            stack.extend([e.left, e.right])
        else:
            ops.append(e)
    return ops


def _key_closure(key: ast.AST, fn: ast.FunctionDef, index: _FnIndex,
                 params: Set[str]) -> Tuple[Set[str], Set[str],
                                            Optional[str]]:
    """(identifier closure, string literals, trusted param name) of a key.

    Trusted: the key — directly or through local assignments — is a
    parameter (or a tuple-concat including one): its composition is the
    caller's responsibility, so the file-scoped pass exempts the store
    site and ``check_project`` audits the call sites binding that
    parameter instead.  The closure and literals of any *locally*
    composed part (e.g. the ``("degraded",)`` prefix of
    ``("degraded",) + exact_key``) are still collected — they count as
    keyed when the callers are audited.
    """
    assigns = _assignments(fn)
    closure: Set[str] = set()
    literals: Set[str] = set()
    trusted: Optional[str] = None
    frontier = [key]
    seen_names: Set[str] = set()
    while frontier:
        expr = frontier.pop()
        for op in _top_operands(expr):
            if isinstance(op, ast.Name) and op.id in params:
                trusted = op.id
        toks = _tokens(expr)
        closure |= toks
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                fname = (_dotted(sub.func) or "").rsplit(".", 1)[-1]
                closure |= index.return_tokens(fname)
            elif isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                             str):
                literals.add(sub.value.lower())
        for t in toks:
            if t in seen_names or t in params:
                continue
            seen_names.add(t)
            frontier.extend(assigns.get(t, []))
    return closure, literals, trusted


def _literal_dims(literals: Set[str]) -> Set[str]:
    """Dimensions encoded as string markers in the key (("degraded", ...))."""
    out: Set[str] = set()
    for dim, pats in CONTEXT_DIMS.items():
        if any(p in l for l in literals for p in pats):
            out.add(dim)
    return out


def _check_builder_fn(src: SourceFile, fn: ast.FunctionDef,
                      required: Set[str], findings: List[Finding]) -> None:
    tokens: Set[str] = set()
    line = fn.lineno
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            tokens |= _tokens(node.value)
            line = node.lineno
    missing = required - tokens
    for dim in sorted(missing):
        findings.append(Finding(
            src.path, line, "CK001",
            f"key builder `{fn.name}` no longer references required "
            f"dimension `{dim}`"))


def _check_method_builder(src: SourceFile, cls: ast.ClassDef,
                          method: ast.FunctionDef, required: Set[str],
                          findings: List[Finding]) -> None:
    key_exprs = [node.value for node in ast.walk(method)
                 if isinstance(node, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == "key"
                         for t in node.targets)]
    if not key_exprs:
        findings.append(Finding(
            src.path, method.lineno, "CK001",
            f"`{cls.name}.{method.name}` has no recognizable `key = ...` "
            "tuple to audit"))
        return
    tokens: Set[str] = set()
    for e in key_exprs:
        tokens |= _tokens(e)
    for dim in sorted(required - tokens):
        findings.append(Finding(
            src.path, key_exprs[0].lineno, "CK001",
            f"`{cls.name}.{method.name}` key tuple is missing required "
            f"dimension `{dim}`"))


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    index = _FnIndex(src.tree)

    # CK001 — pinned builders.
    for name, required in KEY_BUILDERS.items():
        fn = index.fns.get(name)
        if fn is not None:
            _check_builder_fn(src, fn, required, findings)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and (node.name, item.name) in KEY_METHOD_BUILDERS:
                    _check_method_builder(
                        src, node, item,
                        KEY_METHOD_BUILDERS[(node.name, item.name)],
                        findings)

    # CK002 — unkeyed context reads at store sites.
    for fn in ast.walk(src.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        a = fn.args
        params = {p.arg for p in a.args + a.kwonlyargs + a.posonlyargs}
        params.discard("self")
        stores: List[Tuple[ast.AST, int]] = []
        for node in ast.walk(fn):
            hit = _is_cache_store(node)
            if hit is not None:
                stores.append(hit)
        if not stores:
            continue
        fn_dims = _dims_of(_tokens(fn))
        for key_expr, line in stores:
            closure, lits, trusted = _key_closure(key_expr, fn, index,
                                                  params)
            if trusted is not None:
                continue       # caller-composed key: check_project audits it
            # String-literal markers in the key (e.g. ("degraded", ...))
            # count: the dimension is encoded even without a variable.
            keyed = _dims_of(closure) | _literal_dims(lits)
            for dim in sorted(fn_dims - keyed):
                findings.append(Finding(
                    src.path, line, "CK002",
                    f"`{fn.name}` reads context dimension `{dim}` but the "
                    "stored cache key does not include it"))
    return findings


# ---------------------------------------------------------------------------
# Interprocedural CK002: audit the callers of trusted-param store sites
# ---------------------------------------------------------------------------

def _bind_arg(fn: ast.AST, call: ast.Call,
              pname: str) -> Optional[ast.AST]:
    """The argument expression a call site binds to parameter ``pname``."""
    for kw in call.keywords:
        if kw.arg == pname:
            return kw.value
    names = [a.arg for a in fn.args.args]
    skip = 1 if names and names[0] in ("self", "cls") \
        and isinstance(call.func, ast.Attribute) else 0
    try:
        idx = names.index(pname) - skip
    except ValueError:
        return None
    if 0 <= idx < len(call.args):
        arg = call.args[idx]
        if isinstance(arg, ast.Starred):
            return None
        return arg
    return None


_MAX_PROPAGATION_DEPTH = 3


def check_project(srcs: Sequence[SourceFile],
                  graph: CallGraph) -> List[Finding]:
    """CK002 across function boundaries.

    The file-scoped pass trusts a store whose key is a parameter.  This
    pass picks those sites up: for every caller binding that parameter
    (found through the call graph), the argument's identifier closure in
    the *caller* must carry every context dimension read anywhere on the
    store path (callee reads and caller reads both count); dimensions
    already encoded locally at the store site — e.g. the ``("degraded",)``
    literal prefix — count as keyed.  Call sites that are themselves
    recognized cache stores (direct ``.put(key, v)``) are skipped: the
    file-scoped pass already audited them.  When the caller's argument is
    again a whole parameter, the audit recurses one level up
    (depth-limited).
    """
    findings: List[Finding] = []
    indexes: Dict[str, _FnIndex] = {}

    def fn_index(src: SourceFile) -> _FnIndex:
        if src.path not in indexes:
            indexes[src.path] = _FnIndex(src.tree)
        return indexes[src.path]

    # (store-path fn qname, trusted param, keyed dims so far, dims read on
    # the store path so far, depth)
    work: List[Tuple[str, str, frozenset, frozenset, int]] = []
    for qname, (src, fn) in graph.functions.items():
        params = param_names(fn)
        fn_dims = _dims_of(_tokens(fn))
        for node in ast.walk(fn):
            hit = _is_cache_store(node)
            if hit is None:
                continue
            key_expr, _line = hit
            closure, lits, trusted = _key_closure(key_expr, fn,
                                                  fn_index(src), params)
            if trusted is None:
                continue
            keyed = _dims_of(closure) | _literal_dims(lits)
            work.append((qname, trusted, frozenset(keyed),
                         frozenset(fn_dims), 0))
    seen: Set[Tuple[str, str, frozenset, frozenset]] = set()
    while work:
        qname, pname, keyed0, required0, depth = work.pop()
        state = (qname, pname, keyed0, required0)
        if state in seen or depth > _MAX_PROPAGATION_DEPTH:
            continue
        seen.add(state)
        _store_src, store_fn = graph.functions[qname]
        for site in graph.call_sites(qname):
            if _is_cache_store(site.node) is not None:
                continue
            arg = _bind_arg(store_fn, site.node, pname)
            if arg is None:
                continue
            caller_src, caller_fn = graph.functions[site.caller]
            cparams = param_names(caller_fn)
            closure, lits, trusted = _key_closure(arg, caller_fn,
                                                  fn_index(caller_src),
                                                  cparams)
            keyed = set(keyed0) | _dims_of(closure) | _literal_dims(lits)
            required = set(required0) | _dims_of(_tokens(caller_fn))
            if trusted is not None:
                work.append((site.caller, trusted, frozenset(keyed),
                             frozenset(required), depth + 1))
                continue
            callee = qname.rsplit(".", 1)[-1]
            caller = site.caller.rsplit(".", 1)[-1]
            for dim in sorted(required - keyed):
                findings.append(Finding(
                    caller_src.path, site.node.lineno, "CK002",
                    f"`{caller}` passes `{callee}` a cache key that does "
                    f"not include context dimension `{dim}` read on the "
                    "store path"))
    return findings
