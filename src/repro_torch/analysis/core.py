"""Shared dataflow / reporting core for the port's invariant checkers.

The counterpart of the reference's ``analysis/core.py``, kept in the port
so that ``repro_torch`` imports nothing of the reference package.  The
suite is a set of *invariant pins*, not a general linter: each checker
encodes one determinism or correctness contract the serving stack and the
card's hot paths depend on (see the checker modules' docstrings), and the
golden fixture tests in ``tests/test_torch_analysis.py`` pin the exact
findings each rule produces.

Two analysis layers share this module:

* **file-scoped checkers** (``SourceFile -> [Finding]``) — the per-module
  walkers (frozen routing, determinism, kernel routing, snapshots);
* **project-scoped checkers** (``(files, CallGraph) -> [Finding]``) — the
  dataflow layer: per-module symbol tables (:class:`ModuleSymbols`),
  def-use chains (:func:`assignments`), and a project-wide call graph
  (:class:`CallGraph`) with a reachability API
  (:meth:`CallGraph.reachable_from`) that the replay-purity, host-sync
  and interprocedural cache-key checkers are built on.

Findings carry ``path:line`` and a rule id.  A finding is silenced with an
inline suppression on the flagged statement (anywhere in a multi-line
statement's span), or on a comment-only line directly above it::

    out = picks.numpy()  # repro_torch: allow[TH002] the round's one readback

Two markers are read.  ``# repro_torch: allow[...]`` is the port's own
and may name any rule.  The reference's ``# repro: allow[...]`` counts
only for the rules whose meaning the port keeps unchanged
(:data:`REFERENCE_MARKER_RULES`), so one comment serves both suites; the
ids it names outside that set (the host-sync and kernel-test rules, whose
meaning here is PyTorch's) belong to the reference and are neither used
nor judged here.  A comment-only ``repro_torch:`` line covers the next
line that is not itself a comment-only marker, so it may sit above a
``repro:`` comment line; a comment-only ``repro:`` line covers exactly
the next line, as in the reference.

In ``--strict`` mode a suppression without a written justification is
itself a finding (rule ``SUP001``), and a suppression that no longer
silences anything is flagged as dead (rule ``SUP002``) — every silenced
invariant must say why, and justified exceptions cannot rot in place
after the underlying code is fixed.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from collections import Counter
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

__all__ = ["Finding", "SourceFile", "Suppression", "run_paths", "run_files",
           "render_report", "render_json", "render_rules",
           "iter_python_files", "RULES", "register_rules",
           "ModuleSymbols", "CallGraph", "assignments", "dotted", "tokens",
           "REFERENCE_MARKER_RULES"]

# rule id -> one-line description; checker modules register theirs on import.
RULES: Dict[str, str] = {
    "SUP001": "inline suppression carries no written justification",
    "SUP002": "dead suppression: the allow[...] no longer silences any "
              "finding",
}


def register_rules(rules: Dict[str, str]) -> None:
    RULES.update(rules)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str          # as given to the runner (repo-relative in CI)
    line: int          # 1-indexed
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass
class Suppression:
    line: int          # line the comment sits on
    rules: tuple       # rule ids listed in allow[...]
    reason: str        # justification text after the bracket
    covers: Tuple[int, int]   # full line span of the suppressed statement
    used: bool = False        # silenced at least one finding this run

_SUPPRESS_RE = re.compile(
    r"#\s*(repro(?:_torch)?):\s*allow\[([A-Za-z0-9_,\s]+)\]\s*(.*?)\s*$")

# Rule-id prefixes a reference ``# repro: allow[...]`` marker silences here:
# the rules whose meaning the port keeps unchanged.
REFERENCE_MARKER_RULES: Tuple[str, ...] = ("CK", "DT", "RP", "SN", "KP001",
                                           "KP003")

_COMPOUND = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.If,
             ast.While, ast.For, ast.AsyncFor, ast.With, ast.AsyncWith,
             ast.Try)


class SourceFile:
    """One parsed python file: text, AST, and its inline suppressions."""

    def __init__(self, path, text: Optional[str] = None):
        self.path = str(path)
        if text is None:
            text = Path(path).read_text()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        self._spans = self._statement_spans()
        self.suppressions: List[Suppression] = []
        # Only genuine COMMENT tokens count — an ``allow[...]`` example
        # inside a docstring must not register as a suppression.
        comments: List[Tuple[int, str]] = []
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    comments.append((tok.start[0], tok.string))
        except (tokenize.TokenError, IndentationError):
            pass
        marks = []
        for i, comment in comments:
            m = _SUPPRESS_RE.search(comment)
            if m:
                marks.append((i, m))
        marker_lines = {i for i, _ in marks
                        if self.lines[i - 1].lstrip().startswith("#")}
        for i, m in marks:
            marker = m.group(1)
            rules = tuple(r.strip() for r in m.group(2).split(",")
                          if r.strip())
            if marker == "repro":
                rules = tuple(r for r in rules
                              if r.startswith(REFERENCE_MARKER_RULES))
                if not rules:
                    continue
            # A comment-only line covers the next line; a trailing comment
            # covers its own line.  Either way the suppression extends to
            # the *full line span* of the statement it lands on, so a
            # finding reported on a continuation line of a multi-line
            # call/def is covered by an allow on any line of the statement.
            # A comment-only ``repro_torch:`` line steps over the marker
            # lines below it, so it can stand above a ``repro:`` one.
            target = i + 1 if i in marker_lines else i
            while marker == "repro_torch" and target in marker_lines:
                target += 1
            self.suppressions.append(
                Suppression(line=i, rules=rules, reason=m.group(3),
                            covers=self._spans.get(target, (target, target))))

    def _statement_spans(self) -> Dict[int, Tuple[int, int]]:
        """line -> (start, end) span of its innermost enclosing statement.

        Compound statements (def/class/if/for/...) span their *header*
        only — a suppression on a ``def`` must never silence the whole
        body.  ``ast.walk`` yields parents before children, so children
        overwrite and the innermost statement wins.
        """
        spans: Dict[int, Tuple[int, int]] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            start = node.lineno
            for dec in getattr(node, "decorator_list", []):
                start = min(start, dec.lineno)
            if isinstance(node, _COMPOUND) and node.body:
                end = max(start, node.body[0].lineno - 1)
            else:
                end = node.end_lineno or node.lineno
            for ln in range(start, end + 1):
                spans[ln] = (start, end)
        return spans

    def suppression_for(self, finding: Finding) -> Optional[Suppression]:
        for s in self.suppressions:
            if s.covers[0] <= finding.line <= s.covers[1] \
                    and finding.rule in s.rules:
                return s
        return None


# A file-scoped checker is a callable SourceFile -> List[Finding].  A
# project-scoped checker takes the whole parsed file set plus the call
# graph built over it: (Sequence[SourceFile], CallGraph) -> List[Finding].
Checker = Callable[[SourceFile], List[Finding]]


def iter_python_files(paths: Sequence[str],
                      exclude: Sequence[str] = ()) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob("*.py")
                              if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            out.append(p)
    if exclude:
        out = [f for f in out
               if not any(pat in str(f) for pat in exclude)]
    return out


# ---------------------------------------------------------------------------
# Dataflow engine: symbol tables, def-use chains, project call graph
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'jax.jit' for Attribute chains / Names; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def tokens(node: ast.AST) -> Set[str]:
    """Every Name id / Attribute attr in the subtree."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def assignments(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    """Def-use chains of one scope: name -> rhs exprs, from plain,
    subscript-target, annotated, augmented and for-loop binds."""
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
        elif isinstance(node, ast.AugAssign):
            bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            bind(node.target, node.iter)
    return out


def param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = [p.arg for p in a.args + a.kwonlyargs + a.posonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n != "self"}


# Ubiquitous container/stdlib method names: an attribute call on a
# receiver whose type cannot be inferred never falls back to a project
# method of one of these names (the near-certain match is a dict / list /
# ndarray, not a project class).
_GENERIC_METHODS = frozenset({
    "get", "pop", "update", "copy", "clear", "items", "keys", "values",
    "append", "extend", "add", "remove", "discard", "insert", "index",
    "count", "sort", "join", "split", "strip", "lstrip", "rstrip",
    "format", "encode", "decode", "setdefault", "popitem", "move_to_end",
    "startswith", "endswith", "lower", "upper", "tolist", "astype",
    "reshape", "setflags", "mean", "send", "close", "read", "write",
})


class ModuleSymbols:
    """Per-module symbol table: functions, classes + methods, imports
    (aliased, relative imports resolved against the module path), class
    attribute types, and module-level bindings."""

    def __init__(self, src: SourceFile, module: str):
        self.src = src
        self.module = module
        self.functions: Dict[str, ast.AST] = {}    # "f" / "Cls.meth" -> def
        self.classes: Dict[str, ast.ClassDef] = {}
        self.bases: Dict[str, List[str]] = {}      # class -> base name tokens
        self.imports: Dict[str, str] = {}          # local alias -> dotted
        self.attr_types: Dict[Tuple[str, str], Set[str]] = {}
        self.module_names: Set[str] = set()        # module-level bindings
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                self.bases[node.name] = [t for b in node.bases
                                         for t in tokens(b)]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.functions[f"{node.name}.{item.name}"] = item
                self._collect_attr_types(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for t in ast.walk(node):
                    if isinstance(t, ast.Name) \
                            and isinstance(t.ctx, ast.Store):
                        self.module_names.add(t.id)
        # Imports anywhere in the module (function-local lazy imports are
        # the project idiom for breaking cycles).
        pkg = module.rsplit(".", 1)[0] if "." in module else ""
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] \
                        = alias.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = module.split(".")
                    up = up[:len(up) - node.level]
                    base = ".".join(up + ([node.module] if node.module
                                          else []))
                elif not base:
                    base = pkg
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = \
                        f"{base}.{alias.name}" if base else alias.name

    def _collect_attr_types(self, cls: ast.ClassDef) -> None:
        """``self.x = ClassName(...)`` / dataclass field annotations ->
        candidate type-name tokens for ``self.x`` receivers."""
        for node in ast.walk(cls):
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                self.attr_types.setdefault(
                    (cls.name, node.target.id), set()).update(
                    tokens(node.annotation))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                if value is None:
                    continue
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        cands = {dotted(sub.func).rsplit(".", 1)[-1]
                                 for sub in ast.walk(value)
                                 if isinstance(sub, ast.Call)
                                 and dotted(sub.func)}
                        if isinstance(node, ast.AnnAssign):
                            cands |= tokens(node.annotation)
                        self.attr_types.setdefault(
                            (cls.name, t.attr), set()).update(cands)


@dataclasses.dataclass(frozen=True)
class CallSite:
    caller: str               # qualified name of the calling function
    node: ast.Call            # the call expression
    src: "SourceFile"


class CallGraph:
    """Project-wide call graph over qualified function names.

    Qualified names are ``<dotted module>.<func>`` or
    ``<dotted module>.<Class>.<method>`` where the module path is the
    file's path parts joined with dots (suffix matching makes the root
    irrelevant — see :meth:`resolve`).  Resolution order per call site:
    local/imported names, ``self``/``cls`` receivers (methods + base
    classes), typed receivers (``x = ClassName(...)`` def-use chains,
    parameter annotations, class attribute types), then a project-wide
    method-name fallback for unknown receivers (over-approximate by
    design; gated by :data:`_GENERIC_METHODS`).
    """

    def __init__(self, files: Sequence[SourceFile]):
        self.modules: Dict[str, ModuleSymbols] = {}
        self.functions: Dict[str, Tuple[SourceFile, ast.AST]] = {}
        self._method_index: Dict[str, List[str]] = {}  # meth name -> qnames
        self._class_index: Dict[str, List[str]] = {}   # class name -> modules
        self.owners: Dict[str, Tuple[str, str]] = {}   # qname -> (module, suffix)
        self._types: Dict[str, Dict[str, Set[str]]] = {}
        for src in files:
            module = ".".join(Path(src.path).with_suffix("").parts)
            if module.endswith(".__init__"):
                module = module[: -len(".__init__")]
            sym = ModuleSymbols(src, module)
            self.modules[module] = sym
            for suffix, fn in sym.functions.items():
                qname = f"{module}.{suffix}"
                self.functions[qname] = (src, fn)
                self.owners[qname] = (module, suffix)
                self._method_index.setdefault(
                    suffix.rsplit(".", 1)[-1], []).append(qname)
            for cname in sym.classes:
                self._class_index.setdefault(cname, []).append(module)
        self.edges: Dict[str, Set[str]] = {q: set() for q in self.functions}
        self.rev: Dict[str, Set[str]] = {q: set() for q in self.functions}
        self.sites: Dict[str, List[CallSite]] = {q: [] for q in self.functions}
        for module, sym in self.modules.items():
            for suffix, fn in sym.functions.items():
                self._link(module, sym, suffix, fn)

    # -- construction --------------------------------------------------------
    def _link(self, module: str, sym: ModuleSymbols, suffix: str,
              fn: ast.AST) -> None:
        caller = f"{module}.{suffix}"
        cls = suffix.rsplit(".", 1)[0] if "." in suffix else None
        local_types = self._local_types(sym, fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            for callee in self._resolve_call(sym, cls, node, local_types):
                self.edges[caller].add(callee)
                self.rev[callee].add(caller)
                self.sites[callee].append(CallSite(caller, node, sym.src))

    def resolve_call(self, qname: str, call: ast.Call) -> List[str]:
        """Callees of ``call``, a call inside the function ``qname`` (or a
        def nested in it), resolved in that function's scope."""
        module, suffix = self.owners[qname]
        cls = suffix.rsplit(".", 1)[0] if "." in suffix else None
        return self._resolve_call(self.modules[module], cls, call,
                                  self.local_types(qname))

    def local_types(self, qname: str) -> Dict[str, Set[str]]:
        """name -> candidate project class names inside ``qname``."""
        if qname not in self._types:
            module, _ = self.owners[qname]
            self._types[qname] = self._local_types(
                self.modules[module], self.functions[qname][1])
        return self._types[qname]

    def method_qnames(self, cname: str, meth: str) -> List[str]:
        """``Cls.meth`` qnames for class ``cname``, searching bases."""
        return self._method_qnames(cname, meth)

    def _local_types(self, sym: ModuleSymbols,
                     fn: ast.AST) -> Dict[str, Set[str]]:
        """name -> candidate class-name tokens, from ``x = Cls(...)``
        assignments and parameter annotations."""
        out: Dict[str, Set[str]] = {}
        for arg in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
            if arg.annotation is not None:
                hits = tokens(arg.annotation) & set(self._class_index)
                if hits:
                    out.setdefault(arg.arg, set()).update(hits)
        for name, exprs in assignments(fn).items():
            for e in exprs:
                for sub in ast.walk(e):
                    if isinstance(sub, ast.Call) and dotted(sub.func):
                        leaf = dotted(sub.func).rsplit(".", 1)[-1]
                        if leaf in self._class_index:
                            out.setdefault(name, set()).add(leaf)
        return out

    def _method_qnames(self, cname: str, meth: str,
                       seen: Optional[Set[str]] = None) -> List[str]:
        """``Cls.meth`` qnames for class ``cname``, searching bases."""
        seen = seen if seen is not None else set()
        if cname in seen:
            return []
        seen.add(cname)
        out = []
        for module in self._class_index.get(cname, ()):
            q = f"{module}.{cname}.{meth}"
            if q in self.functions:
                out.append(q)
        if not out:
            for module in self._class_index.get(cname, ()):
                for base in self.modules[module].bases.get(cname, ()):
                    out.extend(self._method_qnames(base, meth, seen))
        return out

    def _resolve_call(self, sym: ModuleSymbols, cls: Optional[str],
                      node: ast.Call,
                      local_types: Dict[str, Set[str]]) -> List[str]:
        d = dotted(node.func)
        if d is None:
            return []
        module = sym.module
        parts = d.split(".")
        head, leaf = parts[0], parts[-1]
        # Direct name: local function, local class constructor, or import.
        if len(parts) == 1:
            if d in sym.functions:
                return [f"{module}.{d}"]
            if d in sym.classes:
                return self._method_qnames(d, "__init__")
            target = sym.imports.get(d)
            if target:
                return self._qnames_for_target(target)
            return []
        # self.meth() / cls.meth() and self.attr.meth().
        if head in ("self", "cls") and cls is not None:
            if len(parts) == 2:
                hits = self._method_qnames(cls, leaf)
                if hits:
                    return hits
            elif len(parts) == 3:
                types = sym.attr_types.get((cls, parts[1]), set())
                hits = [q for t in sorted(types)
                        for q in self._method_qnames(t, leaf)]
                if hits:
                    return hits
            return self._fallback(leaf)
        # module-alias call: mod.f() with `import mod` / `from .. import mod`
        target = sym.imports.get(head)
        if target and len(parts) == 2:
            hits = self._qnames_for_target(f"{target}.{leaf}")
            if hits:
                return hits
        # typed receiver: x.meth() where x = ClassName(...) or annotated.
        if len(parts) == 2 and head in local_types:
            hits = [q for t in sorted(local_types[head])
                    for q in self._method_qnames(t, leaf)]
            if hits:
                return hits
        return self._fallback(leaf)

    def _qnames_for_target(self, target: str) -> List[str]:
        """Project qnames whose dotted name matches an imported target
        (by exact suffix, so the scan root never matters)."""
        out = [q for q in (target,) if q in self.functions]
        if out:
            return out
        suffix = "." + target
        return [q for q in self.functions if q.endswith(suffix)]

    def _fallback(self, meth: str) -> List[str]:
        if meth in _GENERIC_METHODS:
            return []
        return list(self._method_index.get(meth, ()))

    # -- queries -------------------------------------------------------------
    def resolve(self, suffix: str) -> List[str]:
        """Qualified names matching a dotted suffix.  A suffix naming a
        class expands to every method of that class."""
        hits = [q for q in self.functions
                if q == suffix or q.endswith("." + suffix)]
        if hits:
            return sorted(hits)
        out = []
        for module, sym in self.modules.items():
            for cname in sym.classes:
                q = f"{module}.{cname}"
                if q == suffix or q.endswith("." + suffix):
                    out.extend(f"{q}.{m.rsplit('.', 1)[-1]}"
                               for m in sym.functions
                               if m.startswith(cname + "."))
        return sorted(out)

    def callees(self, qname: str) -> Set[str]:
        return self.edges.get(qname, set())

    def callers(self, qname: str) -> Set[str]:
        return self.rev.get(qname, set())

    def call_sites(self, qname: str) -> List[CallSite]:
        return self.sites.get(qname, [])

    def reachable_from(self, entrypoints: Iterable[str]) -> Set[str]:
        """Every function reachable (transitively, including the
        entrypoints themselves) from dotted-suffix entrypoints."""
        frontier: List[str] = []
        for ep in entrypoints:
            frontier.extend(self.resolve(ep))
        seen: Set[str] = set()
        while frontier:
            q = frontier.pop()
            if q in seen:
                continue
            seen.add(q)
            frontier.extend(self.edges.get(q, ()))
        return seen


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    findings: List[Finding]                 # unsuppressed (actionable)
    suppressed: List[Finding]               # silenced by an inline allow
    parse_errors: List[Finding]             # unreadable / unparsable files

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors

    def counts(self) -> Dict[str, Dict[str, int]]:
        live = Counter(f.rule for f in self.findings + self.parse_errors)
        supp = Counter(f.rule for f in self.suppressed)
        return {r: {"findings": live.get(r, 0), "suppressed": supp.get(r, 0)}
                for r in sorted(set(live) | set(supp))}


def _rule_selected(rule: str, select: Optional[Sequence[str]]) -> bool:
    return select is None or any(rule.startswith(p) for p in select)


def run_files(files: Iterable, checkers: Sequence[Checker],
              *, strict: bool = False,
              project_checkers: Sequence[Callable] = (),
              extra_findings: Sequence[Finding] = (),
              select: Optional[Sequence[str]] = None) -> RunResult:
    """Run checkers over ``files``; split findings by suppression status.

    ``project_checkers`` run once over the whole parsed file set with the
    :class:`CallGraph` built over it.  ``extra_findings`` (tree-scoped
    results computed by the caller) join the same suppression pipeline.
    ``select`` is an optional list of rule-id prefixes: findings outside
    the selection are dropped, and suppression liveness (``SUP002``) is
    only judged against selected rules.
    """
    live: List[Finding] = []
    suppressed: List[Finding] = []
    errors: List[Finding] = []
    srcs: List[SourceFile] = []
    for f in files:
        if isinstance(f, SourceFile):
            srcs.append(f)
            continue
        try:
            srcs.append(SourceFile(f))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(Finding(str(f), getattr(e, "lineno", 1) or 1,
                                  "PARSE", f"unparsable file: {e}"))
    all_findings: List[Finding] = []
    for src in srcs:
        for checker in checkers:
            all_findings.extend(checker(src))
    if project_checkers:
        graph = CallGraph(srcs)
        for pc in project_checkers:
            all_findings.extend(pc(srcs, graph))
    all_findings.extend(extra_findings)
    by_path = {src.path: src for src in srcs}
    seen: Set[Tuple[str, int, str, str]] = set()
    for fd in all_findings:
        if not _rule_selected(fd.rule, select):
            continue
        key = (fd.path, fd.line, fd.rule, fd.message)
        if key in seen:            # one finding per (site, rule, message):
            continue               # file and project passes can overlap
        seen.add(key)
        src = by_path.get(fd.path)
        s = src.suppression_for(fd) if src is not None else None
        if s is None:
            live.append(fd)
        else:
            suppressed.append(fd)
            s.used = True
    sup_active = strict and _rule_selected("SUP001", select)
    if sup_active:
        for src in srcs:
            for s in src.suppressions:
                checkable = select is None or any(
                    _rule_selected(r, select) for r in s.rules)
                if not checkable:
                    continue
                if s.used and not s.reason:
                    live.append(Finding(
                        src.path, s.line, "SUP001",
                        f"suppression of {', '.join(s.rules)} has no "
                        "justification"))
                elif not s.used:
                    live.append(Finding(
                        src.path, s.line, "SUP002",
                        f"suppression of {', '.join(s.rules)} silences "
                        "nothing; remove it or re-justify"))
    live.sort(key=lambda f: (f.path, f.line, f.rule))
    return RunResult(findings=live, suppressed=suppressed,
                     parse_errors=errors)


def run_paths(paths: Sequence[str], *, strict: bool = False,
              tests_dir: Optional[str] = None,
              select: Optional[Sequence[str]] = None,
              exclude: Sequence[str] = ()) -> RunResult:
    """Full suite over ``paths``: file checkers, the project-scoped
    dataflow checkers (replay purity, host syncs on the hot paths,
    interprocedural cache keys), and the kernel-parity tree checker.
    ``tests_dir`` is the port's tests (a directory holding
    ``test_torch_*.py``, or one file), found from the repo root when not
    given."""
    from . import (cache_keys, determinism, kernel_parity, replay_purity,
                   snapshot_safety, trace_hazards)

    files = iter_python_files(paths, exclude=exclude)
    tree_findings = kernel_parity.check_tree(paths, tests_dir=tests_dir)
    result = run_files(
        files,
        [trace_hazards.check, cache_keys.check, determinism.check,
         kernel_parity.check_file, snapshot_safety.check],
        strict=strict,
        project_checkers=[cache_keys.check_project,
                          replay_purity.check_project,
                          trace_hazards.check_project],
        extra_findings=tree_findings,
        select=select)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result


def render_report(result: RunResult) -> str:
    """Findings list + the per-rule summary table printed in CI logs."""
    out: List[str] = []
    for f in result.parse_errors + result.findings:
        out.append(f.format())
    counts = result.counts()
    if counts:
        out.append("")
    width = max([len("rule")] + [len(r) for r in counts])
    out.append(f"{'rule':<{width}}  findings  suppressed  description")
    for rule, c in counts.items():
        desc = RULES.get(rule, "")
        out.append(f"{rule:<{width}}  {c['findings']:>8}  "
                   f"{c['suppressed']:>10}  {desc}")
    total = len(result.findings) + len(result.parse_errors)
    out.append(f"{'total':<{width}}  {total:>8}  "
               f"{len(result.suppressed):>10}")
    return "\n".join(out)


def render_json(result: RunResult) -> str:
    """Machine-readable report for CI annotation (one JSON object)."""
    def enc(fs: Sequence[Finding]) -> List[dict]:
        return [{"path": f.path, "line": f.line, "rule": f.rule,
                 "message": f.message} for f in fs]

    return json.dumps({
        "ok": result.ok,
        "findings": enc(result.findings),
        "parse_errors": enc(result.parse_errors),
        "suppressed": enc(result.suppressed),
        "summary": result.counts(),
    }, indent=2)


def render_rules() -> str:
    """The generated rules-reference table (every registered rule id with
    its one-line contract; the README embeds this output)."""
    from . import (cache_keys, determinism, kernel_parity,  # noqa: F401
                   replay_purity, snapshot_safety, trace_hazards)

    width = max(len(r) for r in RULES)
    out = [f"{'rule':<{width}}  contract",
           f"{'-' * width}  {'-' * 8}"]
    for rule in sorted(RULES):
        out.append(f"{rule:<{width}}  {RULES[rule]}")
    return "\n".join(out)
