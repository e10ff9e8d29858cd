"""Logical query plans as operator DAGs, partitioned into subQs.

Mirrors the paper's §3.1/§4.1 structures:

* An :class:`Operator` is one node of the logical query plan (LQP) with its
  *true* output cardinality (rows, bytes) and the compile-time *estimate*
  produced by a simulated cost-based optimizer (CBO) whose error grows with
  operator depth — exactly the gap Spark AQE exploits at runtime.
* A :class:`SubQ` is a group of logical operators that maps 1:1 to a query
  stage (QS) when the plan is physically compiled: stage boundaries sit at
  data-exchange edges (shuffle / broadcast).  Scan-rooted groups and
  join/aggregate-rooted groups are the two families that occur.
* A :class:`Query` is a DAG of subQs executed in topological order, plus the
  flattened operator DAG used by the GTN plan embedder.

Cardinality semantics: ``rows``/``bytes`` are ground truth (known only to the
environment and revealed per-stage at runtime); ``est_rows``/``est_bytes``
are what the compile-time optimizer believes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["OP_TYPES", "Operator", "SubQ", "Query", "topo_order"]

# Operator vocabulary for one-hot encoding (paper §4.3: operator type one-hot).
OP_TYPES = [
    "scan",
    "filter",
    "project",
    "join",
    "agg",
    "sort",
    "exchange",
    "limit",
    "expand",
    "window",
]
_OP_INDEX = {t: i for i, t in enumerate(OP_TYPES)}


@dataclasses.dataclass
class Operator:
    op_id: int
    op_type: str
    children: List[int]                      # op_ids within the same Query
    rows: float = 0.0                        # true output cardinality
    bytes: float = 0.0                       # true output size (bytes)
    est_rows: float = 0.0                    # CBO estimate
    est_bytes: float = 0.0
    pred_tokens: Tuple[str, ...] = ()        # predicate tokens (hashed embed)

    @property
    def type_index(self) -> int:
        return _OP_INDEX[self.op_type]


@dataclasses.dataclass
class SubQ:
    """A group of operators ≙ one query stage once physically planned."""

    sq_id: int
    op_ids: List[int]                        # member operators (topological)
    children: List[int]                      # upstream subQ ids (exchange in)
    kind: str                                # "scan" | "join" | "agg"
    root_op: int                             # op_id producing the stage output
    # --- simulator-facing static features ---------------------------------
    table: Optional[str] = None              # for scans
    # Per-input true/estimated sizes, aligned with ``children`` for non-scan
    # stages; for scans these describe the table read.
    input_rows: Tuple[float, ...] = ()
    input_bytes: Tuple[float, ...] = ()
    est_input_rows: Tuple[float, ...] = ()
    est_input_bytes: Tuple[float, ...] = ()
    # Output (== root operator output).
    out_rows: float = 0.0
    out_bytes: float = 0.0
    est_out_rows: float = 0.0
    est_out_bytes: float = 0.0
    # Work shape knobs used by the analytical cost model.
    cpu_weight: float = 1.0                  # relative CPU work per byte
    skew: float = 0.0                        # partition-size skew in [0, 1)
    depth: int = 0                           # distance from the leaves


@dataclasses.dataclass
class Query:
    qid: str
    ops: List[Operator]
    subqs: List[SubQ]
    benchmark: str = ""                      # "tpch" | "tpcds"
    template: int = 0

    # -- structure helpers --------------------------------------------------
    def topo_subqs(self) -> List[int]:
        return topo_order([(s.sq_id, s.children) for s in self.subqs])

    def subq_depths(self) -> List[int]:
        depth = {}
        for sid in self.topo_subqs():
            ch = self.subqs[sid].children
            depth[sid] = 0 if not ch else 1 + max(depth[c] for c in ch)
        return [depth[s.sq_id] for s in self.subqs]

    @property
    def n_subqs(self) -> int:
        return len(self.subqs)

    def op_adjacency(self) -> np.ndarray:
        """(n_ops, n_ops) directed adjacency (child -> parent) for the GTN."""
        n = len(self.ops)
        A = np.zeros((n, n), np.float32)
        for op in self.ops:
            for c in op.children:
                A[c, op.op_id] = 1.0
        return A

    def subq_ops(self, sq_id: int) -> List[Operator]:
        return [self.ops[i] for i in self.subqs[sq_id].op_ids]


def topo_order(nodes: Sequence[Tuple[int, Sequence[int]]]) -> List[int]:
    """Kahn topological order of (id, deps) pairs; deterministic."""
    deps = {i: set(ch) for i, ch in nodes}
    order: List[int] = []
    ready = sorted([i for i, d in deps.items() if not d])
    children_of: Dict[int, List[int]] = {i: [] for i, _ in nodes}
    for i, ch in nodes:
        for c in ch:
            children_of[c].append(i)
    while ready:
        i = ready.pop(0)
        order.append(i)
        for p in sorted(children_of[i]):
            deps[p].discard(i)
            if not deps[p]:
                ready.append(p)
        ready.sort()
    if len(order) != len(deps):
        raise ValueError("cycle in subQ DAG")
    return order


def cbo_estimate(true_value: float, depth: int, rng: np.random.Generator,
                 sigma0: float = 0.25) -> float:
    """Simulated CBO cardinality estimate.

    Multiplicative log-normal error whose spread grows with operator depth
    (selectivity estimation compounds through joins) — the well-known
    exponential error growth of cardinality estimation.
    """
    sigma = sigma0 * (1.0 + 0.6 * depth)
    err = math.exp(rng.normal(0.0, sigma))
    return max(1.0, true_value * err)
