"""Replay-purity checker for the serving call graph.

The counterpart of the reference's ``analysis/replay_purity.py``: the
same rules from the same entrypoints, and RP003 also knows torch's
process-wide generator (the draws :func:`.determinism.torch_global_rng`
names).

The serving stack's core guarantee is that ``serve()`` is a pure,
replay-deterministic function of the query stream + config under the
*simulated* ``ServiceTimeModel`` clock: two runs over the same stream
must be bit-identical, and a run replayed from a snapshot must match the
original.  That guarantee dies the moment any function reachable from the
serving entrypoints reads ambient process state — the wall clock, the
environment, global RNG, object identities, or mutable module globals.

This checker makes the guarantee a CI gate: it walks the project call
graph from the serving entrypoints (``OptimizerServer.serve``,
``OptimizerFleet.serve``, and every ``RuntimeSession`` method) and flags
impure reads *anywhere in the reachable set* — including helpers in
modules the path-scoped determinism checker (DT00x) never looks at.

Rules (all scoped to serve-reachable functions):

* ``RP001`` **wall-clock read** — ``time.time`` / ``time_ns`` /
  ``datetime.now`` / ``utcnow`` / ``today`` on the serving path.  The
  monotonic ``perf_counter`` is exempt: it only feeds *measured* solve
  times, which the replay harness ignores in favour of the
  ``ServiceTimeModel`` (replay compares decisions, not latencies).
* ``RP002`` **ambient env read** — ``os.environ`` / ``os.getenv`` reads
  of keys outside the registered ``REPRO_*`` namespace.  ``REPRO_*``
  keys are the project's ambient-config registry (kernel routing
  thresholds, read per-call by design — the TH003/TH004 fix idiom) and
  are held fixed across a replay by contract.
* ``RP003`` **unseeded RNG** — legacy ``np.random.*`` globals, stdlib
  ``random.*``, ``default_rng()`` with no seed argument, or torch's
  global generator.  Files
  already covered by the determinism checker's path scopes are skipped
  (DT001/DT002 own them); the value added here is reachable code
  *outside* those scopes.
* ``RP004`` **object-identity read** — ``id(x)``: process-local by
  definition, differs across replays and across fleet workers.  Uses
  where the id is a pure within-process grouping token (never compared
  across processes, never serialized) carry written justifications.
* ``RP005`` **module-global mutation** — rebinding a module global
  (``global`` + assignment) or writing ``os.environ[...]`` from the
  serving path.  Module-level *dict* memoization is exempt: filling a
  deterministic memo is idempotent across replays, rebinding a global is
  not.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from . import determinism
from .core import CallGraph, Finding, SourceFile, dotted, register_rules

__all__ = ["check_project", "RULES", "ENTRYPOINTS", "AMBIENT_ENV_PREFIXES"]

RULES = {
    "RP001": "wall-clock read reachable from the serving entrypoints",
    "RP002": "non-REPRO_* env read reachable from the serving entrypoints",
    "RP003": "unseeded RNG reachable from the serving entrypoints",
    "RP004": "id() read reachable from the serving entrypoints",
    "RP005": "module-global mutation reachable from the serving entrypoints",
}
register_rules(RULES)

# Dotted suffixes resolved against the call graph; a class name expands to
# all of its methods.
ENTRYPOINTS: Tuple[str, ...] = (
    "OptimizerServer.serve", "OptimizerFleet.serve", "RuntimeSession")

# Env keys under these prefixes are the registered ambient-config
# namespace: read per-call on purpose and pinned for the life of a replay.
AMBIENT_ENV_PREFIXES: Tuple[str, ...] = ("REPRO_",)

_WALL_CLOCK = {"time.time", "time.time_ns", "datetime.now",
               "datetime.utcnow", "datetime.today", "datetime.datetime.now",
               "datetime.datetime.utcnow", "datetime.datetime.today"}
_ENV_READ = {"os.environ.get", "os.getenv", "environ.get"}
_UNSEEDED_RNG_PREFIXES = ("np.random.", "numpy.random.", "random.")
_RNG_SEEDED_FACTORIES = {"default_rng", "PRNGKey", "key", "fold_in", "Random",
                         "seed"}


def _env_key(call: ast.Call) -> object:
    """Literal env-key string of a read, or None when non-literal."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _check_fn(src: SourceFile, qname: str, fn: ast.AST,
              findings: List[Finding]) -> None:
    in_dt_scope = determinism.in_scope(src.path)
    name = qname.rsplit(".", 1)[-1]
    assigned: Set[str] = {t.id for node in ast.walk(fn)
                          if isinstance(node, (ast.Assign, ast.AugAssign,
                                               ast.AnnAssign))
                          for t in ast.walk(node)
                          if isinstance(t, ast.Name)
                          and isinstance(t.ctx, ast.Store)}
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            # RP005: `global` + rebinding in the same scope.
            hits = [n for n in node.names if n in assigned]
            if hits:
                findings.append(Finding(
                    src.path, node.lineno, "RP005",
                    f"`{name}` rebinds module global(s) "
                    f"{', '.join(sorted(hits))} on the serving path"))
            continue
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and (dotted(t.value) or "").endswith("environ"):
                    findings.append(Finding(
                        src.path, node.lineno, "RP005",
                        f"`{name}` writes os.environ on the serving path"))
            continue
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func) or ""
        leaf = d.rsplit(".", 1)[-1]
        # RP001 — wall clock (perf_counter exempt, see module docstring).
        if not in_dt_scope and (d in _WALL_CLOCK
                                or d.endswith(".time.time")):
            findings.append(Finding(
                src.path, node.lineno, "RP001",
                f"`{name}` reads the wall clock (`{d}`) on the serving "
                "path; replay must run on the ServiceTimeModel clock"))
        # RP002 — env reads outside the ambient-config namespace.
        if d in _ENV_READ or d.endswith(".environ.get") or d == "getenv":
            key = _env_key(node)
            ambient = isinstance(key, str) and key.startswith(
                tuple(AMBIENT_ENV_PREFIXES))
            if not ambient:
                shown = key if isinstance(key, str) else "<non-literal>"
                findings.append(Finding(
                    src.path, node.lineno, "RP002",
                    f"`{name}` reads env key `{shown}` outside the "
                    "registered REPRO_* ambient-config namespace"))
        # RP002 — subscript read os.environ["K"] (an expression, not the
        # RP005 write case handled above).
        # RP003 — unseeded / global-state RNG.
        if not in_dt_scope:
            if any(d.startswith(p) for p in _UNSEEDED_RNG_PREFIXES) \
                    and leaf not in _RNG_SEEDED_FACTORIES:
                findings.append(Finding(
                    src.path, node.lineno, "RP003",
                    f"`{name}` draws from global RNG state (`{d}`) on "
                    "the serving path"))
            elif leaf == "default_rng" and not node.args \
                    and not node.keywords:
                findings.append(Finding(
                    src.path, node.lineno, "RP003",
                    f"`{name}` creates an OS-entropy-seeded generator "
                    "(`default_rng()` with no seed) on the serving path"))
            elif (drawn := determinism.torch_global_rng(node)):
                findings.append(Finding(
                    src.path, node.lineno, "RP003",
                    f"`{name}` draws from torch's global generator "
                    f"(`{drawn}`) on the serving path"))
        # RP004 — object identity.
        if isinstance(node.func, ast.Name) and node.func.id == "id" \
                and len(node.args) == 1:
            findings.append(Finding(
                src.path, node.lineno, "RP004",
                f"`{name}` reads an object identity (`id(...)`) on the "
                "serving path; ids differ across replays and workers"))
    # RP002 — bare subscript reads os.environ["K"] in Load context.
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and (dotted(node.value) or "").endswith("environ"):
            key = (node.slice.value
                   if isinstance(node.slice, ast.Constant) else None)
            ambient = isinstance(key, str) and key.startswith(
                tuple(AMBIENT_ENV_PREFIXES))
            if not ambient:
                shown = key if isinstance(key, str) else "<non-literal>"
                findings.append(Finding(
                    src.path, node.lineno, "RP002",
                    f"`{name}` reads env key `{shown}` outside the "
                    "registered REPRO_* ambient-config namespace"))


def check_project(srcs: Sequence[SourceFile], graph: CallGraph,
                  entrypoints: Sequence[str] = ENTRYPOINTS
                  ) -> List[Finding]:
    """Flag ambient-state reads in every function reachable from the
    serving entrypoints.  Nested defs/lambdas are scanned as part of
    their enclosing function (a closure defined on the serving path is
    assumed callable from it)."""
    findings: List[Finding] = []
    reach = graph.reachable_from(entrypoints)
    scanned: Set[Tuple[str, str]] = set()
    by_path: Dict[str, SourceFile] = {s.path: s for s in srcs}
    for qname in sorted(reach):
        src, fn = graph.functions[qname]
        # A method reached both directly and via its class entrypoint is
        # scanned once per distinct def node.
        key = (src.path, f"{fn.lineno}:{fn.name}")
        if key in scanned or src.path not in by_path:
            continue
        scanned.add(key)
        _check_fn(src, qname, fn, findings)
    return findings
