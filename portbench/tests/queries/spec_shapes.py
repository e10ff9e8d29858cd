"""A query generator for the harness's tests: three of TPC-H's own queries
at SF-100, staged as Spark plans them, for the shapes that the synthetic
generators never make.

* template 0, Q19: the filtered part side (about 1.2% of 20M rows, some
  2 MB) is under ``spark.sql.autoBroadcastJoinThreshold`` and broadcast, so
  one lineitem stage holds scan, filter (shipmode, shipinstruct), project,
  the broadcast join, the three-branch filter, project and the partial
  aggregate: seven operators.
* template 1, Q15: the ``revenue0`` view's stage feeds both the ``max``
  subquery and the join with supplier: a stage with two consumers.
* template 2, Q18: lineitem scanned twice; an aggregate in the middle of
  the DAG, filtered on ``sum(l_quantity) > 300``; a semi join; sort and
  limit at the top.

A variant redraws the selectivities; the CBO estimates carry a log-normal
error that grows with depth.  Not a configuration's generator: the program
pads a stage to four operators today, so these plans serve the reference's
and the yardstick's tests."""
from __future__ import annotations

import math
import zlib

import numpy as np

from repro_torch.queryengine.plan import Operator, Query, SubQ

NAME = "spec_shapes"
SOURCE = ("TPC-H specification, clause 2.4 (https://www.tpc.org/tpch/): "
          "Q19, Q15 and Q18 at SF-100, staged as Spark plans them")
N_TEMPLATES = 3

# (rows, bytes a row) at scale factor 100.
_TABLES = {"lineitem": (600e6, 120), "orders": (150e6, 100),
           "part": (20e6, 150), "customer": (15e6, 180),
           "supplier": (1e6, 160)}


class _Plan:
    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.ops, self.subqs = [], []

    def jitter(self, x: float) -> float:
        return x * float(np.exp(self.rng.uniform(-0.3, 0.3)))

    def op(self, kind, children, rows, width, depth, toks=()):
        rows = max(1.0, rows)
        est = max(1.0, rows * math.exp(
            self.rng.normal(0.0, 0.25 * (1 + 0.6 * depth))))
        o = Operator(len(self.ops), kind, list(children), rows, rows * width,
                     est, est * width, tuple(toks))
        self.ops.append(o)
        return o

    def scan(self, table, depth, toks=()):
        rows, width = _TABLES[table]
        return self.op("scan", [], rows, width, depth, (table, *toks))

    def stage(self, kind, members, children, table=None):
        """A stage of ``members`` (ops in order, the last its output) that
        reads ``table`` and the outputs of the stages ``children``."""
        root = members[-1]
        ins = [self.subqs[c] for c in children]
        rows = tuple(c.out_rows for c in ins)
        bys = tuple(c.out_bytes for c in ins)
        est_rows = tuple(c.est_out_rows for c in ins)
        est_bys = tuple(c.est_out_bytes for c in ins)
        if table is not None:
            t_rows, width = _TABLES[table]
            rows, bys = (t_rows, *rows), (t_rows * width, *bys)
            est_rows = (t_rows, *est_rows)
            est_bys = (t_rows * width, *est_bys)
        depth = 1 + max((c.depth for c in ins), default=-1)
        self.subqs.append(SubQ(
            sq_id=len(self.subqs), op_ids=[o.op_id for o in members],
            children=list(children), kind=kind, root_op=root.op_id,
            table=table, input_rows=rows, input_bytes=bys,
            est_input_rows=est_rows, est_input_bytes=est_bys,
            out_rows=root.rows, out_bytes=root.bytes,
            est_out_rows=root.est_rows, est_out_bytes=root.est_bytes,
            cpu_weight=1.0 if kind == "scan" else 1.5, skew=0.1, depth=depth))
        return self.subqs[-1]


def _q19(p: _Plan) -> None:
    part = p.scan("part", 0)
    pf = p.op("filter", [part.op_id], part.rows * p.jitter(0.012), 150, 0,
              ("p_brand", "p_container", "p_size", "in", "between", "or"))
    pp = p.op("project", [pf.op_id], pf.rows, 40, 0, ("p_partkey",))
    p.stage("scan", [part, pf, pp], [], "part")
    li = p.scan("lineitem", 1)
    lf = p.op("filter", [li.op_id], li.rows * p.jitter(2 / 7 * 1 / 4), 120, 1,
              ("l_shipmode", "in", "l_shipinstruct", "eq"))
    lp = p.op("project", [lf.op_id], lf.rows, 40, 1,
              ("l_partkey", "l_quantity", "l_extendedprice", "l_discount"))
    j = p.op("join", [lp.op_id, pp.op_id], lp.rows * pf.rows / part.rows,
             80, 1, ("eq", "broadcast"))
    jf = p.op("filter", [j.op_id], j.rows * p.jitter(0.05), 80, 1,
              ("p_brand", "p_container", "l_quantity", "p_size", "between",
               "or", "and"))
    jp = p.op("project", [jf.op_id], jf.rows, 16, 1, ("mul", "sub"))
    pa = p.op("agg", [jp.op_id], 200, 16, 1, ("sum",))
    p.stage("join", [li, lf, lp, j, jf, jp, pa], [0], "lineitem")
    fa = p.op("agg", [pa.op_id], 1, 16, 2, ("sum",))
    p.stage("agg", [fa], [1])


def _q15(p: _Plan) -> None:
    li = p.scan("lineitem", 0)
    lf = p.op("filter", [li.op_id], li.rows * p.jitter(0.038), 120, 0,
              ("l_shipdate", "ge", "lt", "and"))
    lp = p.op("project", [lf.op_id], lf.rows, 24, 0,
              ("l_suppkey", "mul", "sub"))
    pa = p.op("agg", [lp.op_id], 8e6, 24, 0, ("group", "sum"))
    p.stage("scan", [li, lf, lp, pa], [], "lineitem")
    rev = p.op("agg", [pa.op_id], 1e6, 24, 1, ("group", "sum"))
    p.stage("agg", [rev], [0])                       # revenue0: two consumers
    mx = p.op("agg", [rev.op_id], 1, 16, 2, ("max",))
    p.stage("agg", [mx], [1])
    sup = p.scan("supplier", 0)
    sp = p.op("project", [sup.op_id], sup.rows, 120, 0,
              ("s_suppkey", "s_name", "s_address", "s_phone"))
    p.stage("scan", [sup, sp], [], "supplier")
    j = p.op("join", [sp.op_id, rev.op_id], 1e6, 144, 3, ("eq",))
    jm = p.op("join", [j.op_id, mx.op_id], 1, 144, 3, ("eq", "scalar"))
    jp = p.op("project", [jm.op_id], 1, 144, 3, ("s_suppkey",))
    srt = p.op("sort", [jp.op_id], 1, 144, 3, ("asc",))
    p.stage("join", [j, jm, jp, srt], [3, 1, 2])


def _q18(p: _Plan) -> None:
    li = p.scan("lineitem", 0)
    lp = p.op("project", [li.op_id], li.rows, 16, 0,
              ("l_orderkey", "l_quantity"))
    pa = p.op("agg", [lp.op_id], 150e6, 16, 0, ("group", "sum"))
    p.stage("scan", [li, lp, pa], [], "lineitem")
    fa = p.op("agg", [pa.op_id], 150e6, 16, 1, ("group", "sum"))
    big = p.op("filter", [fa.op_id], fa.rows * p.jitter(4e-5), 16, 1,
               ("sum", "gt"))
    keys = p.op("project", [big.op_id], big.rows, 8, 1, ("l_orderkey",))
    p.stage("agg", [fa, big, keys], [0])
    o = p.scan("orders", 0)
    op_ = p.op("project", [o.op_id], o.rows, 32, 0,
               ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"))
    p.stage("scan", [o, op_], [], "orders")
    c = p.scan("customer", 0)
    cp = p.op("project", [c.op_id], c.rows, 40, 0, ("c_custkey", "c_name"))
    p.stage("scan", [c, cp], [], "customer")
    li2 = p.scan("lineitem", 0)
    lp2 = p.op("project", [li2.op_id], li2.rows, 16, 0,
               ("l_orderkey", "l_quantity"))
    p.stage("scan", [li2, lp2], [], "lineitem")
    semi = p.op("join", [op_.op_id, keys.op_id], keys.rows, 32, 2,
                ("eq", "semi"))
    jc = p.op("join", [semi.op_id, cp.op_id], semi.rows, 72, 2, ("eq",))
    jcp = p.op("project", [jc.op_id], jc.rows, 64, 2, ("c_name",))
    p.stage("join", [semi, jc, jcp], [2, 1, 3])
    jl = p.op("join", [jcp.op_id, lp2.op_id], jcp.rows * 4.0, 80, 3, ("eq",))
    jlp = p.op("project", [jl.op_id], jl.rows, 72, 3, ("l_quantity",))
    pa2 = p.op("agg", [jlp.op_id], jcp.rows, 72, 3, ("group", "sum"))
    p.stage("join", [jl, jlp, pa2], [5, 4])
    fa2 = p.op("agg", [pa2.op_id], pa2.rows, 72, 4, ("group", "sum"))
    srt = p.op("sort", [fa2.op_id], fa2.rows, 72, 4, ("desc", "asc"))
    lim = p.op("limit", [srt.op_id], min(srt.rows, 100.0), 72, 4)
    p.stage("agg", [fa2, srt, lim], [6])


_TEMPLATES = [("q19", _q19), ("q15", _q15), ("q18", _q18)]


def make_query(template: int, *, variant: int, seed: int) -> Query:
    if not 0 <= template < N_TEMPLATES:
        raise ValueError(f"template {template} outside 0..{N_TEMPLATES - 1}")
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(NAME.encode()), template, variant]))
    p = _Plan(rng)
    tag, build = _TEMPLATES[template]
    build(p)
    return Query(qid=f"{NAME}-{tag}-v{variant}", ops=p.ops, subqs=p.subqs,
                 benchmark=NAME, template=template)
