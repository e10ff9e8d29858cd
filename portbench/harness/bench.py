"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration is ``portbench/configs/<config>.json``;
* a traffic mix is ``portbench/traffic/<traffic>.json``;
* a metric, end-to-end or per-layer, is ``portbench/metrics/<name>.py``:
  it declares ``NAME`` and ``UNIT`` and reads its value from a run's
  record with ``read(rec)`` (``None`` when there is nothing to read); its
  layer and the metric it moves are ``BENCHMARK.json``'s alone.

A cell reports the end-to-end metrics (``--trace 0``) or the per-layer
metrics (``--trace 1``) whose ``workloads`` list names it, or that have no
such list.  Adding a cell, a mix or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


class Benchmark:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.spec = json.loads(path.read_text())
        self.cells = {w["name"]: w for w in self.spec["workloads"]}

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
