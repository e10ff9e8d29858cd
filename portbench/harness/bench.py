"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration is ``portbench/configs/<config>.json``;
* a traffic mix is ``portbench/traffic/<traffic>.json``;
* a metric, end-to-end or per-layer, is ``portbench/metrics/<name>.py``:
  it declares ``NAME`` and ``UNIT`` and reads its value from a run's
  record with ``read(rec)`` (``None`` when there is nothing to read); its
  layer and the metric it moves are ``BENCHMARK.json``'s alone;
* a configuration's queries are ``portbench/queries/<name>.py``, which the
  configuration names with ``"queries": "<name>"``: the module declares
  ``NAME`` (its file's name), ``SOURCE`` (the public definition, at most
  200 characters), ``N_TEMPLATES`` (equal to the configuration's
  ``n_templates``) and ``make_query(template, *, variant, seed)``, which
  builds ``repro_torch.queryengine.plan.Query`` objects tagged
  ``Query.benchmark == NAME``; it imports nothing but NumPy, the standard
  library and ``repro_torch.queryengine.plan``.  A configuration without
  the key draws from the frozen synthetic generator of its
  ``"benchmark"`` (``frozen.py``).

A cell reports the end-to-end metrics (``--trace 0``) or the per-layer
metrics (``--trace 1``) whose ``workloads`` list names it, or that have no
such list.  Adding a cell, a mix or a metric adds files and entries and
edits none; so does adding a configuration with its own queries.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, List

from . import frozen

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
QUERIES = BENCH / "queries"

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass(frozen=True)
class QuerySource:
    """Where a configuration's queries come from: ``n_templates``
    templates, ``make_query(template, *, variant, seed)`` to build one, and
    ``tag``, the ``Query.benchmark`` of every query it builds (the
    program's caches key on it with the template)."""
    tag: str
    n_templates: int
    make_query: Callable

    def make(self, template: int, *, variant: int, seed: int):
        q = self.make_query(template, variant=variant, seed=seed)
        if q.benchmark != self.tag:
            raise ValueError(f"query generator {self.tag!r} built {q.qid!r} "
                             f"tagged {q.benchmark!r}")
        return q


def synthetic_queries(benchmark: str) -> QuerySource:
    """The frozen synthetic generator of ``"tpch"`` or ``"tpcds"``."""
    return QuerySource(benchmark, frozen.N_TEMPLATES[benchmark],
                       functools.partial(frozen.make_query, benchmark))


class Benchmark:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json",
                 query_dir: Path = QUERIES):
        self.spec = json.loads(path.read_text())
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.query_dir = query_dir

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((ROOT / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def queries(self, cfg: dict) -> QuerySource:
        """The source of configuration ``cfg``'s queries: the module its
        ``"queries"`` names, or else the synthetic generator of its
        ``"benchmark"``; refused where ``n_templates`` disagrees."""
        if "queries" in cfg:
            mod = query_module(cfg["queries"], self.query_dir)
            src = QuerySource(mod.NAME, mod.N_TEMPLATES, mod.make_query)
        else:
            src = synthetic_queries(cfg["benchmark"])
        if cfg.get("n_templates") != src.n_templates:
            raise ValueError(
                f"configuration {cfg.get('name')!r} states n_templates "
                f"{cfg.get('n_templates')!r}; its queries {src.tag!r} have "
                f"{src.n_templates}")
        return src

    @staticmethod
    def traffic(name: str) -> dict:
        return json.loads((BENCH / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]


@functools.lru_cache(maxsize=None)
def metric_module(name: str) -> ModuleType:
    """The reader of metric ``name`` (``portbench/metrics/<name>.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} declares NAME {mod.NAME!r}")
    return mod


@functools.lru_cache(maxsize=None)
def query_module(name: str, where: Path = QUERIES) -> ModuleType:
    """The query generator ``name`` (``portbench/queries/<name>.py``)."""
    path = where / f"{name}.py"
    if not _NAME.fullmatch(name) or not path.is_file():
        raise FileNotFoundError(
            f"no query generator {name!r}: a configuration's queries are "
            f"portbench/queries/<name>.py, and {path} is not there")
    spec = importlib.util.spec_from_file_location(
        "portbench_queries_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    # Registered before it runs, so a dataclass in the module resolves.
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} declares NAME {mod.NAME!r}")
    if not (isinstance(mod.SOURCE, str) and 0 < len(mod.SOURCE) <= 200
            and "\n" not in mod.SOURCE):
        raise ValueError(f"{path}: SOURCE must be one line of 1 to 200 "
                         "characters")
    if not (isinstance(mod.N_TEMPLATES, int) and mod.N_TEMPLATES > 0):
        raise ValueError(f"{path}: N_TEMPLATES must be a positive int, got "
                         f"{mod.N_TEMPLATES!r}")
    return mod
