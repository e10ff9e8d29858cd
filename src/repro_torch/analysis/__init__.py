"""``repro_torch.analysis`` — the port's invariant-checking static analysis.

The counterpart of the reference's ``analysis`` package, with its module
names, rule ids and report format; it imports nothing of the reference.
Six checkers over the source tree:

* :mod:`.trace_hazards` (``TH*``) — host syncs and tensor branches in
  functions reachable from the card's hot roots, device and env routing
  frozen at import or first call, data-dependent shapes under CUDA-graph
  capture or ``torch.compile``.
* :mod:`.cache_keys` (``CK*``) — serving-cache key completeness against
  the context dimensions the cached computations read, file-scoped and
  interprocedurally through the call graph.
* :mod:`.determinism` (``DT*``) — wall-clock, unseeded RNG (numpy's,
  the stdlib's and torch's global generator) and set-iteration-order
  leaks in transcript-order paths.
* :mod:`.kernel_parity` (``KP*``) — every kernel package ships a ref,
  a parity test of the port, tie-tolerant f32 routing, and a card test
  of each CUDA entry against its ref.
* :mod:`.replay_purity` (``RP*``) — ambient process state (wall clock,
  env, global RNG, ``id()``, module-global mutation) read anywhere
  reachable from the serving entrypoints on the project call graph.
* :mod:`.snapshot_safety` (``SN*``) — fleet snapshot blobs: pin filters
  at pack sites, no ``id()`` flows into blobs, restores re-freeze arrays.

The dataflow layer the project-scoped checkers share — per-module symbol
tables, def-use chains, call graph + reachability — lives in
:mod:`.core` (:class:`~.core.CallGraph`).

Run ``python -m repro_torch.analysis [--strict] [paths...]`` (default
``src/repro_torch``); suppress an intentional finding inline with
``# repro_torch: allow[RULE] written justification`` (the reference's
marker counts for the rules whose meaning is unchanged, see
:mod:`.core`).  ``--rules`` prints the generated rules reference;
``--json`` emits machine-readable findings; ``--select TH,CK`` scopes the
active rule set.
"""
from .core import (CallGraph, Finding, RunResult, SourceFile, RULES,
                   render_json, render_report, render_rules, run_files,
                   run_paths)

__all__ = ["CallGraph", "Finding", "RunResult", "SourceFile", "RULES",
           "render_json", "render_report", "render_rules", "run_files",
           "run_paths"]
