"""Trace-hazard checker: host syncs on the card's hot paths and frozen
routing state.

The counterpart of the reference's ``analysis/trace_hazards.py`` with the
same rule ids, recast for PyTorch on a CUDA card.  The reference guards
jitted functions, where a host round-trip breaks the trace; here nothing
is traced, and the hazard is a host synchronisation: the host waits for
the card, and the card idles while the host catches up.  The calls the
budget in ``PERF.md`` §3 covers are the *hot roots* (:data:`HOT_ROOTS`),
and a function is *hot* when the port's :class:`~.core.CallGraph`
reaches it from one of them.  A call of a module object (``model(x)``,
``self.attn(x)``, ``layers[i](x)``) reaches every ``forward`` method of
the project, as ``nn.Module.__call__`` does.

Whether an expression is a tensor is read from the AST, per function and
in line order: parameters annotated ``torch.Tensor``, names bound to
``torch`` calls (a factory without ``device=`` makes a host tensor, and
so does ``torch.from_numpy``), tensor methods, and calls of the port's
own functions whose return annotation names a tensor.  ``.cpu()``,
``.numpy()``, ``.tolist()`` and ``.item()`` leave the card; numpy arrays
and Python values are host values.  Inside a branch that runs only when
a device is not the card (``if x.device.type != "cuda"``, the ``else``
of ``if device.type == "cuda"``) every tensor lies on the host.

Rules:

* ``TH001`` **tensor-branch** — in a hot function, a Python ``if``,
  ``while``, ``assert``, ``and``/``or`` or ternary on a tensor value: an
  implicit ``bool(tensor)``, which waits for the card.  ``x is None``,
  ``.shape``, ``.ndim``, ``.dtype``, ``.device``, ``.numel()``, ``len``
  and Python scalars are host values and exempt.
* ``TH002`` **host-sync** — in a hot function: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")`` on a tensor;
  ``float()``/``int()``/``bool()`` or ``np.asarray``/``np.array`` of a
  tensor; ``torch.cuda.synchronize`` and any ``.synchronize()`` (an
  event's or a stream's); the size-reading ops ``nonzero``, ``unique``,
  ``masked_select``, ``argwhere`` and one-argument ``torch.where``; and a
  blocking copy of host data to the card (``.to(device)`` or
  ``.cuda()`` of a host tensor without ``non_blocking=True``,
  ``torch.tensor``/``torch.as_tensor`` of host data with a ``device=``).
* ``TH003`` **import-frozen-routing** — module-level
  ``torch.cuda.is_available()`` / ``device_count()`` /
  ``get_device_name()`` / ``get_device_capability()`` or ``os.environ``
  reads: the answer is captured at import, so a later device choice or
  env change is ignored (the ``_ON_TPU`` bug class).
* ``TH004`` **first-call-frozen-routing** — an ``lru_cache``/``cache``
  wrapped function whose body reads env vars or those device queries:
  the same bug one call later.
* ``TH005`` **unbucketed-capture** — a function that captures a CUDA
  graph (``torch.cuda.graph``, ``CUDAGraph``,
  ``make_graphed_callables``) or calls a ``torch.compile``d function, and
  allocates tensors with data-dependent sizes, with no pow2/bucket
  discipline in sight: a graph replays the shapes it captured, and a
  compiled function recompiles for each new one.
"""
from __future__ import annotations

import ast
import builtins
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (CallGraph, Finding, SourceFile, assignments, dotted,
                   register_rules)

__all__ = ["check", "check_project", "hot_scopes", "RULES", "HOT_ROOTS"]

RULES = {
    "TH001": "Python branch on a tensor value in a hot function",
    "TH002": "host sync (.item()/.cpu()/synchronize/blocking copy) in a hot "
             "function",
    "TH003": "device/env detection at import time freezes routing",
    "TH004": "lru_cache over an env/device read freezes routing after one "
             "call",
    "TH005": "data-dependent sizes flow into a CUDA-graph capture or a "
             "torch.compile'd function",
}
register_rules(RULES)

# The calls whose host syncs ``PERF.md`` §3 budgets, as dotted suffixes on
# the call graph; ``a.b.f.g`` names the def ``g`` nested in function ``f``.
HOT_ROOTS: Tuple[str, ...] = (
    "core.moo.pareto.pareto_mask_fast",        # K1's callers
    "core.moo.pareto.pareto_masks_fast",
    "core.moo.hmooc.dag_aggregate",            # HMOOC2: the tie flag, K3
    "core.moo.hmooc._hmooc2_all_fused",
    "core.tuning.runtime.weighted_pick_batch",  # a runtime round
    "train.serve.make_serve_fns.prefill",      # LM serving
    "train.serve.make_serve_fns.decode",
    "train.train_loop.make_train_step.step",   # an LM train step
    "core.models.training.train_model",        # performance-model training
)

_ENV_READ_FUNCS = {"os.environ.get", "os.getenv", "environ.get", "getenv"}
_DEVICE_QUERIES = {"is_available", "device_count", "get_device_name",
                   "get_device_capability", "get_device_properties",
                   "current_device"}
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad"}
_HOST_METHODS = {"numel", "dim", "size", "element_size", "nelement",
                 "data_ptr", "stride", "get_device", "type", "data_ptr"}
# Tensor methods whose result leaves the card (each is also a TH002 site
# when its receiver is a tensor on the card).
_READBACKS = {"item", "tolist", "cpu", "numpy"}
_SIZE_READING = {"nonzero", "unique", "masked_select", "argwhere",
                 "unique_consecutive"}
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "linspace",
              "tensor", "as_tensor", "rand", "randn", "randint", "randperm",
              "eye", "empty_strided", "logspace"}
_LIKE = {"zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
         "randn_like", "randint_like"}
# torch calls that return no tensor.
_TORCH_NON_TENSOR = {"device", "Generator", "is_tensor", "is_floating_point",
                     "no_grad", "inference_mode", "enable_grad", "finfo",
                     "iinfo", "Size", "get_default_dtype", "is_grad_enabled",
                     "manual_seed", "set_grad_enabled", "dtype"}
_CAPTURE_CALLS = {"torch.cuda.graph", "cuda.graph", "torch.cuda.CUDAGraph",
                  "cuda.CUDAGraph", "CUDAGraph",
                  "torch.cuda.make_graphed_callables",
                  "make_graphed_callables"}
_COMPILE_CALLS = {"torch.compile"}
_ALLOC_FUNCS = {"zeros", "ones", "empty", "full", "pad", "zeros_like",
                "empty_strided"}

DEV, HOST = "dev", "host"


# ---------------------------------------------------------------------------
# Tensor kinds, per function, in line order
# ---------------------------------------------------------------------------

def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _is_cpu(node: Optional[ast.AST]) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and (dotted(node.func) or "").endswith(
            "device") and node.args:
        return _is_cpu(node.args[0])
    return False


_HOST_TYPES = {"ndarray", "int", "float", "bool", "str", "bytes", "complex"}
_CONTAINERS = {"Optional", "Union", "List", "Tuple", "Sequence", "list",
               "tuple", "Dict", "dict", "Mapping", "Iterable", "Set",
               "set", "frozenset"}


def _annotation_kind(ann: Optional[ast.AST]) -> Optional[str]:
    """DEV for a tensor annotation (or a container or union holding one),
    HOST when every type it names is a host value, else None."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant):
        return None if ann.value is not None else HOST
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _combine([_annotation_kind(ann.left),
                         _annotation_kind(ann.right)])
    if isinstance(ann, ast.Subscript):
        base = (dotted(ann.value) or "").rsplit(".", 1)[-1]
        if base not in _CONTAINERS:
            return None
        elts = (ann.slice.elts if isinstance(ann.slice, ast.Tuple)
                else [ann.slice])
        if base in ("Dict", "dict", "Mapping"):
            elts = elts[1:]
        elts = [e for e in elts if not (isinstance(e, ast.Constant)
                                        and e.value in (None, Ellipsis))]
        return _combine([_annotation_kind(e) for e in elts])
    leaf = (dotted(ann) or "").rsplit(".", 1)[-1]
    if leaf == "Tensor" or leaf == "Parameter":
        return DEV
    return HOST if leaf in _HOST_TYPES else None


def _combine(kinds) -> Optional[str]:
    """DEV if any part may be a tensor on the card; HOST if all are host
    values; else None."""
    kinds = list(kinds)
    if DEV in kinds:
        return DEV
    return HOST if kinds and all(k == HOST for k in kinds) else None


def _off_card_test(test: ast.AST) -> Optional[bool]:
    """True for a test that holds only off the card (``x.type !=
    "cuda"``, ``x.type == "cpu"``, ``not x.is_cuda``), False for one that
    holds only on it (``x.type == "cuda"``), None otherwise."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Attribute) \
            and test.left.attr == "type" \
            and isinstance(test.comparators[0], ast.Constant):
        val, op = test.comparators[0].value, test.ops[0]
        if (isinstance(op, ast.NotEq) and val == "cuda") or \
                (isinstance(op, ast.Eq) and val == "cpu"):
            return True
        if isinstance(op, ast.Eq) and val == "cuda":
            return False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Attribute) \
            and test.operand.attr == "is_cuda":
        return True
    return None


def _host_regions(fn: ast.AST) -> List[Tuple[int, int]]:
    """Line spans that run only off the card: the body of an off-card
    test, the ``else`` of an on-card one, and what follows an on-card
    ``if`` whose body always returns or raises."""
    spans: List[Tuple[int, int]] = []

    def span(stmts):
        if stmts:
            spans.append((stmts[0].lineno,
                          max(s.end_lineno or s.lineno for s in stmts)))

    for node in ast.walk(fn):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if not isinstance(block, list):
                continue
            for i, stmt in enumerate(block):
                if not isinstance(stmt, ast.If):
                    continue
                off = _off_card_test(stmt.test)
                if off is True:
                    span(stmt.body)
                elif off is False:
                    span(stmt.orelse)
                    if not stmt.orelse and stmt.body and isinstance(
                            stmt.body[-1], (ast.Return, ast.Raise)):
                        span(block[i + 1:])
    return spans


class _Kinds:
    """Tensor kind of expressions in one function: DEV (a tensor that may
    lie on the card), HOST (numpy, a host tensor, a Python value) or None
    (not known)."""

    def __init__(self, fn: ast.AST, returns: Dict[int, Optional[str]],
                 module_imports: Dict[str, str]):
        self.returns = returns          # id(call node) -> callee's kind
        self.imports = module_imports
        self.binds: Dict[str, List[Tuple[int, ast.AST, str]]] = {}
        self.host = _host_regions(fn)
        a = getattr(fn, "args", None)
        if a is not None:
            params = a.posonlyargs + a.args + a.kwonlyargs
            for p in params:
                k = _annotation_kind(p.annotation)
                if k:
                    self._bind(p.arg, 0, None, k)
            if a.vararg is not None:
                k = _annotation_kind(a.vararg.annotation)
                if k:
                    self._bind(a.vararg.arg, 0, None, k)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self._bind_target(t, node.value, node.lineno)
            elif isinstance(node, ast.AnnAssign):
                k = _annotation_kind(node.annotation)
                if isinstance(node.target, ast.Name):
                    if node.value is not None:
                        self._bind(node.target.id, node.lineno, node.value,
                                   k or "")
                    elif k:
                        self._bind(node.target.id, node.lineno, None, k)
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name):
                old = ast.copy_location(
                    ast.Name(node.target.id, ast.Load()), node)
                self._bind(node.target.id, node.lineno, ast.copy_location(
                    ast.BinOp(left=old, op=node.op, right=node.value), node),
                    "")
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                line = getattr(node, "lineno", None) or it.lineno
                if isinstance(node.target, ast.Name):
                    self._bind(node.target.id, line, it, "elem")
            elif isinstance(node, ast.withitem) \
                    and isinstance(node.optional_vars, ast.Name):
                self._bind(node.optional_vars.id, node.context_expr.lineno,
                           None, "")
        for binds in self.binds.values():
            binds.sort(key=lambda b: b[0])

    def _bind(self, name: str, line: int, value: Optional[ast.AST],
              how: str) -> None:
        self.binds.setdefault(name, []).append((line, value, how))

    def _bind_target(self, t: ast.AST, value: ast.AST, line: int) -> None:
        if isinstance(t, ast.Name):
            self._bind(t.id, line, value, "")
        elif isinstance(t, (ast.Tuple, ast.List)):
            # ``a, b = f(x)``: each name takes the kind of the whole.
            for el in t.elts:
                if isinstance(el, ast.Name):
                    self._bind(el.id, line, value, "")

    def in_host_region(self, line: int) -> bool:
        return any(a <= line <= b for a, b in self.host)

    def name(self, name: str, line: int, depth: int) -> Optional[str]:
        # A use on a binding's own line reads the older value (``x =
        # f(x)``), except a loop's or comprehension's target.
        binds = [b for b in self.binds.get(name, ())
                 if b[0] < line or (b[0] == line and b[2] == "elem")
                 or b[1] is None]
        if not binds:
            return None
        bline, value, how = binds[-1]
        if value is None:
            return how or None
        if how == "elem":
            if isinstance(value, (ast.List, ast.Tuple)):
                return _combine(self.of(e, depth + 1) for e in value.elts)
            return self.of(value, depth + 1)
        if how in (DEV, HOST):
            return how
        return self.of(value, depth + 1)

    def of(self, node: ast.AST, depth: int = 0) -> Optional[str]:
        if depth > 12:
            return None
        kind = self._of(node, depth)
        if kind == DEV and self.in_host_region(getattr(node, "lineno", 0)):
            return HOST
        return kind

    def _of(self, node: ast.AST, depth: int) -> Optional[str]:
        if isinstance(node, ast.Constant):
            return HOST
        if isinstance(node, ast.Name):
            return self.name(node.id, node.lineno, depth)
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return HOST
            if node.attr in ("values", "indices", "T", "mT", "real", "imag",
                             "grad", "data"):
                return self.of(node.value, depth + 1)
            return None
        if isinstance(node, ast.Subscript):
            return self.of(node.value, depth + 1)
        if isinstance(node, (ast.BinOp, ast.Compare, ast.BoolOp)):
            parts = ([node.left, node.right] if isinstance(node, ast.BinOp)
                     else [node.left] + node.comparators
                     if isinstance(node, ast.Compare) else node.values)
            if isinstance(node, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                    for op in node.ops):
                return HOST
            return _combine(self.of(p, depth + 1) for p in parts)
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return HOST
            return self.of(node.operand, depth + 1)
        if isinstance(node, ast.IfExp):
            return _combine([self.of(node.body, depth + 1),
                             self.of(node.orelse, depth + 1)])
        if isinstance(node, ast.Call):
            return self._call(node, depth)
        return None

    def _torch_call(self, d: str) -> Optional[str]:
        """The torch function a dotted call names (``torch.zeros`` ->
        ``zeros``), through ``import torch as t`` and ``from torch
        import zeros``; None when it is no torch call."""
        head, _, rest = d.partition(".")
        target = self.imports.get(head, "torch" if head == "torch" else "")
        if target == "torch":
            return rest or None
        if target.startswith("torch."):
            return target[len("torch."):] + ("." + rest if rest else "")
        return None

    def _call(self, node: ast.Call, depth: int) -> Optional[str]:
        d = dotted(node.func) or ""
        if d in ("len", "isinstance", "float", "int", "bool", "str",
                 "range", "enumerate", "zip", "hasattr", "getattr", "tuple",
                 "list", "dict", "max", "min", "sum", "sorted", "any",
                 "all", "abs", "round"):
            return HOST
        if d.startswith(("np.", "numpy.", "math.")):
            return HOST
        tfn = self._torch_call(d)
        if tfn is not None:
            tleaf = tfn.rsplit(".", 1)[-1]
            if tfn.startswith(("cuda.", "distributed.", "backends.",
                               "testing.")) or tleaf in _TORCH_NON_TENSOR:
                return None
            if tleaf == "from_numpy":
                return HOST
            if tleaf in _FACTORIES or tleaf in _LIKE:
                dev = _kw(node, "device")
                if dev is not None:
                    return HOST if _is_cpu(dev) else DEV
                if tleaf in _LIKE and node.args:
                    return self.of(node.args[0], depth + 1)
                if tleaf == "as_tensor" and node.args:
                    return self.of(node.args[0], depth + 1) or HOST
                return HOST
            args = [e for a in node.args
                    for e in ([a] + (a.elts if isinstance(
                        a, (ast.List, ast.Tuple)) else []))]
            return _combine(self.of(a, depth + 1) for a in args)
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            meth = node.func.attr
            if meth in _READBACKS or meth == "pin_memory":
                return HOST
            if meth in _HOST_METHODS or meth.startswith("is_"):
                return HOST
            if meth == "cuda":
                return DEV
            if meth == "to":
                dest = node.args[0] if node.args else _kw(node, "device")
                if _is_cpu(dest):
                    return HOST
                if isinstance(dest, ast.Attribute) and dest.attr.startswith(
                        ("float", "int", "bfloat", "bool", "half",
                         "double", "long", "uint")):
                    return self.of(recv, depth + 1)
                return DEV
            known = self.returns.get(id(node))
            if known is not None:
                return known
            return self.of(recv, depth + 1)
        known = self.returns.get(id(node))
        return known


# ---------------------------------------------------------------------------
# Hot functions: reachable from HOT_ROOTS on the call graph
# ---------------------------------------------------------------------------

def _nested(fn: ast.AST) -> Dict[str, ast.AST]:
    """Defs nested (at any depth) in ``fn`` by name."""
    return {n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn}


class _Edges:
    """Callees of the calls in a scope, for hot reachability: the call
    graph's resolution, with three changes.  A call of a name imported
    from outside the project (``subprocess.run``) reaches nothing, where
    the graph falls back to every project method of that name.  A name a
    package ``__init__`` re-exports resolves to its definition.  A call
    of a module object reaches ``forward``: the class's when the object's
    type is known, every project ``forward`` when it is not.  Calls on
    lines that run only off the card reach nothing."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.forwards = sorted(q for q in graph.functions
                               if q.endswith(".forward"))
        self._project = set(graph.modules)
        self._binds: Dict[str, Dict[str, List[ast.AST]]] = {}
        self._defs: Dict[str, Dict[str, ast.AST]] = {}
        self._inside: Dict[str, bool] = {}

    def nested(self, q: str) -> Dict[str, ast.AST]:
        """Defs nested in the function ``q``, by name."""
        if q not in self._defs:
            self._defs[q] = _nested(self.graph.functions[q][1])
        return self._defs[q]

    def _internal(self, target: str) -> bool:
        """Whether an imported dotted name lies inside the project: its
        top-level package is a part of some project module's path."""
        head = "." + target.split(".", 1)[0] + "."
        if head not in self._inside:
            self._inside[head] = any(head in f".{m}." for m in self._project)
        return self._inside[head]

    def _reexport(self, target: str, depth: int = 0) -> List[str]:
        """Definition of an imported name, through ``__init__``
        re-exports."""
        hits = self.graph._qnames_for_target(target)
        if hits or depth > 4 or "." not in target:
            return hits
        mod, name = target.rsplit(".", 1)
        for m, sym in self.graph.modules.items():
            if not ((m == mod or m.endswith("." + mod))
                    and name in sym.imports):
                continue
            found = sym.imports[name]
            # The graph bases an ``__init__``'s relative imports on its
            # parent package; they name the package's own modules.
            parent = m.rsplit(".", 1)[0]
            if sym.src.path.endswith("__init__.py") \
                    and found.startswith(parent + "."):
                hits = self._reexport(m + found[len(parent):], depth + 1)
                if hits:
                    return hits
            return self._reexport(found, depth + 1)
        return []

    def of(self, q: str, node: ast.AST, host: List[Tuple[int, int]]
           ) -> Set[str]:
        g = self.graph
        module, suffix = g.owners[q]
        sym = g.modules[module]
        cls = suffix.rsplit(".", 1)[0] if "." in suffix else None
        local = self.nested(q)
        out: Set[str] = set()
        for call in ast.walk(node):
            if not isinstance(call, ast.Call) \
                    or any(a <= call.lineno <= b for a, b in host):
                continue
            f = call.func
            d = dotted(f)
            head = d.split(".", 1)[0] if d else None
            if head in sym.imports and not self._internal(sym.imports[head]):
                continue
            hits = g.resolve_call(q, call)
            if not hits and d and head in sym.imports:
                target = sym.imports[head] + d[len(head):]
                hits = self._reexport(target)
            if hits:
                out.update(hits)
                continue
            out.update(self._module_call(q, sym, cls, f, local))
        return out

    def _assigns(self, q: str) -> Dict[str, List[ast.AST]]:
        if q not in self._binds:
            self._binds[q] = assignments(self.graph.functions[q][1])
        return self._binds[q]

    def _module_call(self, q: str, sym, cls: Optional[str], f: ast.AST,
                     local: Dict[str, ast.AST]) -> List[str]:
        """``forward`` methods a call of ``f`` may reach when ``f`` is a
        module object: a local name, ``self.<attr>`` or a subscript."""
        g = self.graph
        if isinstance(f, ast.Name):
            if f.id in sym.functions or f.id in sym.classes \
                    or f.id in sym.imports or f.id in local \
                    or hasattr(builtins, f.id):
                return []
            types = g.local_types(q).get(f.id)
            bound = self._assigns(q).get(f.id)
            if not types and bound is not None \
                    and not any(_objectish(v) for v in bound):
                return []       # a function value: ``launch = _fn()``
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and cls is not None:
            types = sym.attr_types.get((cls, f.attr))
        elif isinstance(f, ast.Subscript):
            types = None
        else:
            return []
        if types:
            hits = [m for t in sorted(types)
                    for m in g.method_qnames(t, "forward")]
            if hits:
                return hits
        return self.forwards


def _objectish(value: ast.AST) -> bool:
    """Whether a bound value may be a module object: an attribute, a
    subscript or a name, or one taken from a container by ``enumerate``,
    ``zip``, ``reversed``, ``iter``, ``list`` or ``tuple``."""
    if isinstance(value, (ast.Attribute, ast.Subscript, ast.Name)):
        return True
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
            and value.func.id in ("enumerate", "zip", "reversed", "iter",
                                  "list", "tuple"):
        return any(_objectish(a) for a in value.args)
    return False


def _scopes_of_root(graph: CallGraph, root: str
                    ) -> List[Tuple[str, ast.AST]]:
    """(enclosing function qname, def node) of a hot root: a module-level
    function or method, or a def nested in one."""
    hits = graph.resolve(root)
    if hits:
        return [(q, graph.functions[q][1]) for q in hits]
    head, _, name = root.rpartition(".")
    out = []
    for q in graph.resolve(head) if head else ():
        node = _nested(graph.functions[q][1]).get(name)
        if node is not None:
            out.append((q, node))
    return out


def hot_scopes(graph: CallGraph, roots: Sequence[str] = HOT_ROOTS,
               edges: Optional["_Edges"] = None
               ) -> Dict[str, Dict[Tuple[str, int], Tuple[str, ast.AST]]]:
    """root -> the hot scopes it reaches, keyed by (qname, def line), each
    (qname of the module-level function holding it, def node).  A nested
    root's scope is its own def plus the sibling defs it calls by name;
    a reached module-level function is scanned whole (its closures are
    assumed callable from it)."""
    edges = edges or _Edges(graph)
    host: Dict[str, List[Tuple[int, int]]] = {}
    out: Dict[str, Dict[Tuple[str, int], Tuple[str, ast.AST]]] = {}
    for root in roots:
        scopes: Dict[Tuple[str, int], Tuple[str, ast.AST]] = {}
        frontier: List[Tuple[str, ast.AST]] = list(_scopes_of_root(graph,
                                                                   root))
        while frontier:
            q, node = frontier.pop()
            key = (q, node.lineno)
            if key in scopes:
                continue
            scopes[key] = (q, node)
            top = graph.functions[q][1]
            if node is not top:
                siblings = edges.nested(q)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Name) \
                            and sub.func.id in siblings:
                        frontier.append((q, siblings[sub.func.id]))
            if q not in host:
                host[q] = _host_regions(top)
            frontier.extend((c, graph.functions[c][1])
                            for c in edges.of(q, node, host[q]))
        out[root] = scopes
    return out


def _return_kinds(graph: CallGraph, edges: "_Edges", q: str, node: ast.AST
                  ) -> Dict[int, Optional[str]]:
    """id(call) -> kind of what the call returns, for calls inside
    ``node`` that resolve to project functions with a return annotation."""
    out: Dict[int, Optional[str]] = {}
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        kinds = [_annotation_kind(graph.functions[c][1].returns)
                 for c in edges.of(q, ast.Expr(value=sub), [])]
        if kinds:
            out[id(sub)] = _combine(kinds)
    return out


def _tensor_text(node: ast.AST) -> str:
    text = ast.unparse(node)
    return text if len(text) <= 60 else text[:57] + "..."


def _check_hot(src: SourceFile, graph: CallGraph, edges: "_Edges", q: str,
               node: ast.AST, findings: List[Finding]) -> None:
    module, _ = graph.owners[q]
    kinds = _Kinds(node, _return_kinds(graph, edges, q, node),
                   graph.modules[module].imports)
    name = getattr(node, "name", q.rsplit(".", 1)[-1])

    def dev(expr: ast.AST) -> bool:
        return kinds.of(expr) == DEV

    def th001(line: int, expr: ast.AST) -> None:
        findings.append(Finding(
            src.path, line, "TH001",
            f"branch on tensor value `{_tensor_text(expr)}` in hot "
            f"`{name}`: bool() of a tensor waits for the card"))

    def th002(line: int, what: str) -> None:
        findings.append(Finding(
            src.path, line, "TH002",
            f"{what} in hot `{name}` synchronises the host with the card"))

    for sub in ast.walk(node):
        if isinstance(sub, (ast.If, ast.While, ast.Assert)):
            if dev(sub.test) and not isinstance(sub.test, ast.BoolOp):
                th001(sub.lineno, sub.test)
        elif isinstance(sub, ast.IfExp):
            if dev(sub.test) and not isinstance(sub.test, ast.BoolOp):
                th001(sub.lineno, sub.test)
        elif isinstance(sub, ast.BoolOp):
            hit = next((v for v in sub.values if dev(v)), None)
            if hit is not None:
                th001(sub.lineno, hit)
        elif isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not):
            if dev(sub.operand):
                th001(sub.lineno, sub.operand)
        elif isinstance(sub, ast.Call):
            _check_call(sub, kinds, th002)


def _check_call(call: ast.Call, kinds: _Kinds, th002) -> None:
    d = dotted(call.func) or ""
    line = call.lineno
    host_region = kinds.in_host_region(line)
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "synchronize":
        th002(line, f"`{d or '.synchronize'}()`")
        return
    if host_region:
        return
    if d in ("float", "int", "bool") and call.args \
            and kinds.of(call.args[0]) == DEV:
        th002(line, f"`{d}()` of a tensor")
        return
    if d in ("np.asarray", "np.array", "numpy.asarray", "numpy.array") \
            and call.args and kinds.of(call.args[0]) == DEV:
        th002(line, f"`{d}` of a tensor")
        return
    tfn = kinds._torch_call(d)
    if isinstance(call.func, ast.Attribute) and tfn is None:
        recv = call.func.value
        meth = call.func.attr
        if meth in _READBACKS and kinds.of(recv) == DEV:
            th002(line, f"`.{meth}()` of a tensor")
        elif meth == "to" and (_is_cpu(call.args[0] if call.args else None)
                               or _is_cpu(_kw(call, "device"))) \
                and kinds.of(recv) == DEV:
            th002(line, "`.to(\"cpu\")` of a tensor")
        elif meth in _SIZE_READING and kinds.of(recv) == DEV:
            th002(line, f"size-reading `.{meth}()` of a tensor")
        elif meth in ("to", "cuda") and kinds.of(recv) == HOST \
                and not _non_blocking(call) and _to_card(call):
            th002(line, f"blocking `.{meth}()` copy of host data to the "
                        "card")
        return
    if tfn is not None:
        tleaf = tfn.rsplit(".", 1)[-1]
        if tleaf in _SIZE_READING or (tleaf == "where"
                                      and len(call.args) == 1):
            th002(line, f"size-reading `torch.{tfn}`")
        elif tleaf in ("tensor", "as_tensor") and call.args:
            dev = _kw(call, "device")
            if dev is not None and not _is_cpu(dev) \
                    and kinds.of(call.args[0]) == HOST:
                th002(line, f"`torch.{tfn}` of host data onto the card "
                            "(a blocking copy)")


def _non_blocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _to_card(call: ast.Call) -> bool:
    """``.cuda()``, or ``.to(x)`` with a destination that is no dtype and
    not the CPU."""
    if call.func.attr == "cuda":
        return True
    dest = call.args[0] if call.args else _kw(call, "device")
    if dest is None or _is_cpu(dest):
        return False
    if isinstance(dest, ast.Attribute) and dest.attr.startswith(
            ("float", "int", "bfloat", "bool", "half", "double", "long",
             "uint")):
        return False
    return True


def check_project(srcs: Sequence[SourceFile], graph: CallGraph,
                  roots: Sequence[str] = HOT_ROOTS) -> List[Finding]:
    """TH001/TH002 over every scope reachable from the hot roots, each def
    scanned once (nested defs of a scope count as part of it)."""
    findings: List[Finding] = []
    by_path = {s.path for s in srcs}
    done: Set[Tuple[str, int]] = set()
    edges = _Edges(graph)
    for scopes in hot_scopes(graph, roots, edges).values():
        for key, (q, node) in sorted(scopes.items(),
                                     key=lambda kv: kv[0]):
            src = graph.functions[q][0]
            dkey = (src.path, node.lineno)
            if dkey in done or src.path not in by_path:
                continue
            done.add(dkey)
            _check_hot(src, graph, edges, q, node, findings)
    return findings


# ---------------------------------------------------------------------------
# File-scoped rules: TH003 / TH004 / TH005
# ---------------------------------------------------------------------------

def _device_query(d: Optional[str]) -> bool:
    if not d:
        return False
    parts = d.split(".")
    return parts[-1] in _DEVICE_QUERIES and "cuda" in parts[:-1]


def _reads_env_or_device(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = dotted(sub.func)
            if d in _ENV_READ_FUNCS or _device_query(d):
                return True
        elif isinstance(sub, ast.Subscript) \
                and dotted(sub.value) in ("os.environ", "environ"):
            return True
    return False


def _check_module_level(src: SourceFile, findings: List[Finding]) -> None:
    for stmt in src.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Import, ast.ImportFrom)):
            continue
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if _device_query(d):
                    findings.append(Finding(
                        src.path, node.lineno, "TH003",
                        f"module-level `{d}()` freezes device routing at "
                        "import; resolve per call"))
                elif d in _ENV_READ_FUNCS:
                    findings.append(Finding(
                        src.path, node.lineno, "TH003",
                        f"module-level env read `{d}` freezes the flag at "
                        "import; resolve per call"))
            elif isinstance(node, ast.Subscript) \
                    and dotted(node.value) in ("os.environ", "environ"):
                findings.append(Finding(
                    src.path, node.lineno, "TH003",
                    "module-level os.environ access freezes the flag at "
                    "import; resolve per call"))


def _check_frozen_caches(src: SourceFile, findings: List[Finding]) -> None:
    for node in ast.walk(src.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            d = dotted(dec.func if isinstance(dec, ast.Call) else dec)
            if d in ("functools.lru_cache", "lru_cache", "functools.cache",
                     "cache"):
                if _reads_env_or_device(node):
                    findings.append(Finding(
                        src.path, node.lineno, "TH004",
                        f"`{node.name}` caches an env/device read: the "
                        "routing flag freezes after the first call"))


def _compiled_names(tree: ast.Module) -> Set[str]:
    """Functions made by ``torch.compile``: decorated, or the targets of
    ``g = torch.compile(f)``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dotted(dec.func if isinstance(dec, ast.Call) else dec)
                if d in _COMPILE_CALLS:
                    out.add(node.name)
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and dotted(node.value.func) in _COMPILE_CALLS:
            for t in node.targets:
                if isinstance(t, (ast.Name, ast.Attribute)):
                    out.add(t.id if isinstance(t, ast.Name) else t.attr)
    return out


def _check_unbucketed(src: SourceFile, findings: List[Finding]) -> None:
    if not any(k in src.text for k in ("graph", "CUDAGraph", "compile")):
        return
    compiled = _compiled_names(src.tree)
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        toks: Set[str] = set()
        captures = False
        allocs: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Name):
                toks.add(node.id)
            elif isinstance(node, ast.Attribute):
                toks.add(node.attr)
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if d in _CAPTURE_CALLS or leaf in compiled \
                    or d in _COMPILE_CALLS:
                captures = True
            if leaf in _ALLOC_FUNCS and d.startswith(("torch.", "F.")) \
                    and node.args and any(isinstance(s, ast.Name)
                                          for a in node.args
                                          for s in ast.walk(a)):
                allocs.append(node.lineno)
        if not (captures and allocs):
            continue
        if any(k in t.lower() for t in toks
               for k in ("pow2", "bucket", "chunk", "block")):
            continue
        findings.append(Finding(
            src.path, allocs[0], "TH005",
            f"`{fn.name}` allocates tensors with data-dependent sizes "
            "around a CUDA-graph capture or a torch.compile'd call "
            "without a pow2/bucket ladder: every distinct shape captures "
            "or compiles anew"))


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    _check_module_level(src, findings)
    _check_frozen_caches(src, findings)
    _check_unbucketed(src, findings)
    return findings
