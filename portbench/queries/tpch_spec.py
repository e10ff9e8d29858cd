"""TPC-H's own 22 queries (specification clause 2.4) at SF-100, staged as
Spark 3 with adaptive query execution plans them.

Template ``t`` is Q(t + 1).  Each plan is a DAG of stages (subQs) with a
boundary at every exchange:

* a broadcast build is a stage of its own (AQE's broadcast query stage),
  and the broadcast hash join sits in the probe side's stage; the build
  side of a join is broadcast when it is a stage over a base table (its
  filters, projections and broadcast joins) whose rows times its projected
  width, as the cost-based optimizer estimates them at the specification's
  default substitution values, are within the default
  ``spark.sql.autoBroadcastJoinThreshold`` of 10 MB; the optimizer does
  not estimate ``LIKE``, so such a filter keeps every row in the estimate;
  a template's staging does not change with its variant, and adaptive
  execution may still turn a shuffled join into a broadcast one at run
  time (the environment's join choice);
* a shuffled join reads two or more shuffled inputs; joins, aggregates and
  filters that need no new partitioning stay in the stage;
* an aggregate is a partial aggregate before its exchange and a final one
  after it; a correlated subquery is decorrelated into an aggregate joined
  back (Q2, Q17, Q20), a scalar subquery is a stage joined in by a scalar
  join (Q11, Q15, Q22), ``EXISTS``/``IN`` a semi join and ``NOT EXISTS``/
  ``NOT IN`` an anti join (Q4, Q16, Q18, Q20, Q21, Q22); ``ORDER BY`` with
  ``LIMIT`` is a sort and a limit in the last stage.

Row counts and row widths are SF-100's.  A variant redraws the
substitution parameters within clause 2.4's ranges and computes the
selectivities from them; the CBO's estimates carry a log-normal error that
grows with an operator's depth.  Q19, Q15 and Q18 are the test fixture
``portbench/tests/queries/spec_shapes.py``'s plans."""
from __future__ import annotations

import math
import zlib

import numpy as np

from repro_torch.queryengine.plan import Operator, Query, SubQ

NAME = "tpch_spec"
SOURCE = ("TPC-H specification, clause 2.4 (https://www.tpc.org/tpch/): its "
          "22 queries at SF-100 with substitution parameters, staged as Spark "
          "3 with AQE plans them")
N_TEMPLATES = 22

# (rows, bytes a row) at scale factor 100.
_TABLES = {"lineitem": (600e6, 120), "orders": (150e6, 100),
           "partsupp": (80e6, 140), "part": (20e6, 150),
           "customer": (15e6, 180), "supplier": (1e6, 160),
           "nation": (25.0, 120), "region": (5.0, 120)}

# Days of o_orderdate's range (1992-01-01 to 1998-08-02); l_shipdate
# follows o_orderdate by 1 to 121 days.
_ORDER_DAYS = 2405.0
_SHIP_LAG = 61.0
_NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
            "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
            "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
            "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
            "UNITED KINGDOM", "UNITED STATES"]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_N_COLORS = 92


def _day(year: int, month: int = 1) -> float:
    """Days from 1992-01-01 to the first of ``month`` in ``year``."""
    return (year - 1992) * 365.25 + (month - 1) * 30.44


def _orders_in(d0: float, d1: float) -> float:
    """Share of orders with o_orderdate in [d0, d1) (days)."""
    lo, hi = max(d0, 0.0), min(d1, _ORDER_DAYS)
    return max(hi - lo, 0.0) / _ORDER_DAYS


def _shipped_in(d0: float, d1: float) -> float:
    """Share of lineitems with l_shipdate in [d0, d1) (days)."""
    return _orders_in(d0 - _SHIP_LAG, d1 - _SHIP_LAG)


class _Plan:
    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.ops, self.subqs = [], []

    def jitter(self, x: float) -> float:
        return x * float(np.exp(self.rng.uniform(-0.3, 0.3)))

    def pick(self, values, k: int = 1):
        idx = self.rng.choice(len(values), size=k, replace=False)
        return [values[int(i)] for i in idx]

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

    # -- shapes that recur ----------------------------------------------------
    def table(self, table, depth, sel, width, ftoks=(), ptoks=()):
        """Scan, filter (when ``sel`` is given) and project of a table."""
        t = self.scan(table, depth)
        members = [t]
        if sel is not None:
            members.append(self.op("filter", [t.op_id], t.rows * sel,
                                   _TABLES[table][1], depth, ftoks))
        members.append(self.op("project", [members[-1].op_id],
                               members[-1].rows, width, depth, ptoks))
        return members

    def dim(self, table, sel, width, ftoks=(), ptoks=(), children=()):
        """A small table's stage (broadcast, or joined with broadcasts
        ``children`` first); returns the stage."""
        members = self.table(table, 0, sel, width, ftoks, ptoks)
        out = members[-1]
        for c in children:
            build = self.subqs[c]
            j = self.op("join", [out.op_id, build.root_op],
                        out.rows * build.out_rows / _TABLES[build.table][0],
                        width, 0, ("eq", "broadcast"))
            out = self.op("project", [j.op_id], j.rows, width, 0)
            members += [j, out]
        return self.stage("join" if children else "scan", members,
                          list(children), table)


# ---------------------------------------------------------------------------
# The queries.  Comments give the stages; ``depth`` is an operator's number
# of joins and aggregates below it, which scales its estimate's error.
# ---------------------------------------------------------------------------
def _q1(p: _Plan) -> None:
    delta = int(p.rng.integers(60, 121))
    tail = delta ** 2 / (2 * 121 * (_ORDER_DAYS + _SHIP_LAG))
    li = p.table("lineitem", 0, 1 - tail, 40, ("l_shipdate", "le", str(delta)),
                 ("l_returnflag", "l_linestatus", "mul", "sub", "add"))
    pa = p.op("agg", [li[-1].op_id], 4 * 560, 80, 0, ("group", "sum", "avg",
                                                      "count"))
    p.stage("scan", li + [pa], [], "lineitem")
    fa = p.op("agg", [pa.op_id], 4, 80, 1, ("group", "sum", "avg", "count"))
    srt = p.op("sort", [fa.op_id], 4, 80, 1, ("asc",))
    p.stage("agg", [fa, srt], [0])


def _q2(p: _Plan) -> None:
    size = int(p.rng.integers(1, 51))
    ptype = p.pick(["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"])[0]
    region = p.pick(_REGIONS)[0]
    part_sel = 1 / 50 * 1 / 5
    # 0: the chosen parts, shuffled (the estimate counts p_size alone).
    pt = p.table("part", 0, part_sel, 40, ("p_size", "eq", str(size),
                                           "p_type", "like", ptype),
                 ("p_partkey", "p_mfgr"))
    p.stage("scan", pt, [], "part")
    # 1-3: region and nation broadcast into the region's suppliers.
    p.dim("region", 1 / 5, 16, ("r_name", "eq", region), ("r_regionkey",))
    p.dim("nation", None, 40, (), ("n_nationkey", "n_name"), children=[1])
    sup = p.table("supplier", 0, None, 150, (), ("s_suppkey", "s_name",
                                                 "s_address", "s_acctbal"))
    j = p.op("join", [sup[-1].op_id, p.subqs[2].root_op], 1e6 / 5, 170, 1,
             ("eq", "broadcast"))
    sp = p.op("project", [j.op_id], j.rows, 170, 1)
    p.stage("join", sup + [j, sp], [2], "supplier")
    # 4-6: partsupp of the chosen parts, then of the region's suppliers.
    ps = p.table("partsupp", 0, None, 24, (), ("ps_partkey", "ps_suppkey",
                                                "ps_supplycost"))
    p.stage("scan", ps, [], "partsupp")
    jp = p.op("join", [ps[-1].op_id, pt[-1].op_id], 4 * pt[-1].rows, 56, 1,
              ("eq",))
    pp = p.op("project", [jp.op_id], jp.rows, 56, 1)
    p.stage("join", [jp, pp], [4, 0])
    jo = p.op("join", [pp.op_id, sp.op_id], pp.rows / 5, 210, 2, ("eq",))
    jop = p.op("project", [jo.op_id], jo.rows, 200, 2)
    p.stage("join", [jo, jop], [5, 3])
    # 7-9: the subquery's region, nation and suppliers, broadcast.
    p.dim("region", 1 / 5, 16, ("r_name", "eq", region), ("r_regionkey",))
    p.dim("nation", None, 16, (), ("n_nationkey",), children=[7])
    sup2 = p.table("supplier", 0, None, 16, (), ("s_suppkey", "s_nationkey"))
    j2 = p.op("join", [sup2[-1].op_id, p.subqs[8].root_op], 1e6 / 5, 16, 1,
              ("eq", "broadcast"))
    sp2 = p.op("project", [j2.op_id], j2.rows, 8, 1, ("s_suppkey",))
    p.stage("join", sup2 + [j2, sp2], [8], "supplier")
    # 10: all of partsupp on the region's suppliers, partial min by part.
    ps2 = p.table("partsupp", 0, None, 24, (), ("ps_partkey", "ps_suppkey",
                                                 "ps_supplycost"))
    js = p.op("join", [ps2[-1].op_id, sp2.op_id], 80e6 / 5, 24, 1,
              ("eq", "broadcast"))
    jsp = p.op("project", [js.op_id], js.rows, 16, 1)
    pmin = p.op("agg", [jsp.op_id], 14e6, 16, 1, ("group", "min"))
    p.stage("join", ps2 + [js, jsp, pmin], [9], "partsupp")
    # 11: the final min (the decorrelated subquery) on the same
    # partitioning as the outer rows at their part's least cost, top 100.
    fmin = p.op("agg", [pmin.op_id], 14e6, 16, 2, ("group", "min"))
    jm = p.op("join", [jop.op_id, fmin.op_id], jop.rows / 4, 200, 3,
              ("eq", "ps_supplycost", "min"))
    jmp = p.op("project", [jm.op_id], jm.rows, 190, 3)
    srt = p.op("sort", [jmp.op_id], jmp.rows, 190, 3, ("desc", "asc"))
    lim = p.op("limit", [srt.op_id], min(srt.rows, 100.0), 190, 3)
    p.stage("join", [fmin, jm, jmp, srt, lim], [10, 6])


def _q3(p: _Plan) -> None:
    seg = p.pick(_SEGMENTS)[0]
    day = _day(1995, 3) + float(p.rng.integers(0, 31))
    cu = p.table("customer", 0, 1 / 5, 16, ("c_mktsegment", "eq", seg),
                 ("c_custkey",))
    p.stage("scan", cu, [], "customer")
    od = p.table("orders", 0, _orders_in(0, day), 24,
                 ("o_orderdate", "lt"), ("o_orderkey", "o_custkey",
                                          "o_orderdate", "o_shippriority"))
    p.stage("scan", od, [], "orders")
    j = p.op("join", [od[-1].op_id, cu[-1].op_id], od[-1].rows / 5, 24, 1,
             ("eq",))
    jp = p.op("project", [j.op_id], j.rows, 20, 1)
    p.stage("join", [j, jp], [1, 0])
    li = p.table("lineitem", 0, 1 - _shipped_in(0, day), 24,
                 ("l_shipdate", "gt"), ("l_orderkey", "l_extendedprice",
                                        "l_discount"))
    p.stage("scan", li, [], "lineitem")
    late = _shipped_in(day, day + 121) * _orders_in(day - 121, day) \
        / max(_orders_in(day - 121, day + 121), 1e-9)
    jl = p.op("join", [li[-1].op_id, jp.op_id], 600e6 * late / 5, 40, 2,
              ("eq",))
    jlp = p.op("project", [jl.op_id], jl.rows, 32, 2, ("mul", "sub"))
    pa = p.op("agg", [jlp.op_id], jl.rows / 2.5, 32, 2, ("group", "sum"))
    fa = p.op("agg", [pa.op_id], pa.rows, 32, 3, ("group", "sum"))
    srt = p.op("sort", [fa.op_id], fa.rows, 32, 3, ("desc", "asc"))
    lim = p.op("limit", [srt.op_id], min(srt.rows, 10.0), 32, 3)
    p.stage("join", [jl, jlp, pa, fa, srt, lim], [3, 2])


def _q4(p: _Plan) -> None:
    year, month = int(p.rng.integers(1993, 1998)), int(p.rng.integers(1, 13))
    if year == 1997:
        month = min(month, 10)
    d0 = _day(year, month)
    od = p.table("orders", 0, _orders_in(d0, d0 + 91.3), 24,
                 ("o_orderdate", "ge", "lt", "and", f"{year}-{month}"),
                 ("o_orderkey", "o_orderpriority"))
    p.stage("scan", od, [], "orders")
    li = p.table("lineitem", 0, 0.63, 8, ("l_commitdate", "lt",
                                          "l_receiptdate"), ("l_orderkey",))
    p.stage("scan", li, [], "lineitem")
    j = p.op("join", [od[-1].op_id, li[-1].op_id], od[-1].rows * 0.91, 24, 1,
             ("eq", "semi", "exists"))
    jp = p.op("project", [j.op_id], j.rows, 16, 1, ("o_orderpriority",))
    pa = p.op("agg", [jp.op_id], 5 * 200, 24, 1, ("group", "count"))
    p.stage("join", [j, jp, pa], [0, 1])
    fa = p.op("agg", [pa.op_id], 5, 24, 2, ("group", "count"))
    srt = p.op("sort", [fa.op_id], 5, 24, 2, ("asc",))
    p.stage("agg", [fa, srt], [2])


def _q5(p: _Plan) -> None:
    region = p.pick(_REGIONS)[0]
    year = int(p.rng.integers(1993, 1998))
    p.dim("region", 1 / 5, 16, ("r_name", "eq", region), ("r_regionkey",))
    p.dim("nation", None, 40, (), ("n_nationkey", "n_name"), children=[0])
    cu = p.table("customer", 0, None, 16, (), ("c_custkey", "c_nationkey"))
    jc = p.op("join", [cu[-1].op_id, p.subqs[1].root_op], 15e6 / 5, 40, 1,
              ("eq", "broadcast"))
    jcp = p.op("project", [jc.op_id], jc.rows, 40, 1)
    p.stage("join", cu + [jc, jcp], [1], "customer")
    od = p.table("orders", 0, _orders_in(_day(year), _day(year + 1)), 16,
                 ("o_orderdate", "ge", "lt", str(year)),
                 ("o_orderkey", "o_custkey"))
    p.stage("scan", od, [], "orders")
    jo = p.op("join", [od[-1].op_id, jcp.op_id], od[-1].rows / 5, 48, 2,
              ("eq",))
    jop = p.op("project", [jo.op_id], jo.rows, 48, 2)
    p.stage("join", [jo, jop], [3, 2])
    li = p.table("lineitem", 0, None, 32, (), ("l_orderkey", "l_suppkey",
                                                "l_extendedprice",
                                                "l_discount"))
    p.stage("scan", li, [], "lineitem")
    jl = p.op("join", [li[-1].op_id, jop.op_id], jop.rows * 4, 72, 3,
              ("eq",))
    jlp = p.op("project", [jl.op_id], jl.rows, 64, 3)
    p.stage("join", [jl, jlp], [5, 4])
    su = p.table("supplier", 0, None, 16, (), ("s_suppkey", "s_nationkey"))
    p.stage("scan", su, [], "supplier")
    js = p.op("join", [jlp.op_id, su[-1].op_id], jlp.rows / 25, 48, 4,
              ("eq", "and"))
    jsp = p.op("project", [js.op_id], js.rows, 40, 4, ("mul", "sub"))
    pa = p.op("agg", [jsp.op_id], 5 * 400, 40, 4, ("group", "sum"))
    p.stage("join", [js, jsp, pa], [6, 7])
    fa = p.op("agg", [pa.op_id], 5, 40, 5, ("group", "sum"))
    srt = p.op("sort", [fa.op_id], 5, 40, 5, ("desc",))
    p.stage("agg", [fa, srt], [8])


def _q6(p: _Plan) -> None:
    year = int(p.rng.integers(1993, 1998))
    disc = int(p.rng.integers(2, 10)) / 100
    qty = int(p.rng.integers(24, 26))
    sel = _shipped_in(_day(year), _day(year + 1)) * 3 / 11 * (qty - 1) / 50
    li = p.table("lineitem", 0, sel, 16,
                 ("l_shipdate", "l_discount", "between", str(disc),
                  "l_quantity", "lt", str(qty), "and"),
                 ("l_extendedprice", "l_discount"))
    pa = p.op("agg", [li[-1].op_id], 560, 16, 0, ("sum", "mul"))
    p.stage("scan", li + [pa], [], "lineitem")
    fa = p.op("agg", [pa.op_id], 1, 16, 1, ("sum",))
    p.stage("agg", [fa], [0])


def _q7(p: _Plan) -> None:
    n1, n2 = p.pick(_NATIONS, 2)
    p.dim("nation", 2 / 25, 40, ("n_name", "in", n1, n2),
          ("n_nationkey", "n_name"))
    su = p.table("supplier", 0, None, 16, (), ("s_suppkey", "s_nationkey"))
    jsn = p.op("join", [su[-1].op_id, p.subqs[0].root_op], 1e6 * 2 / 25, 40,
               1, ("eq", "broadcast"))
    jsp = p.op("project", [jsn.op_id], jsn.rows, 32, 1)
    p.stage("join", su + [jsn, jsp], [0], "supplier")          # broadcast
    ship = _shipped_in(_day(1995), _day(1997))
    li = p.table("lineitem", 0, ship, 40, ("l_shipdate", "between", "1995",
                                           "1996"),
                 ("l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice",
                  "l_discount"))
    jl = p.op("join", [li[-1].op_id, jsp.op_id], li[-1].rows * 2 / 25, 64, 2,
              ("eq", "broadcast"))
    jlp = p.op("project", [jl.op_id], jl.rows, 56, 2)
    p.stage("join", li + [jl, jlp], [1], "lineitem")
    od = p.table("orders", 0, None, 16, (), ("o_orderkey", "o_custkey"))
    p.stage("scan", od, [], "orders")
    jo = p.op("join", [jlp.op_id, od[-1].op_id], jlp.rows, 64, 3, ("eq",))
    jop = p.op("project", [jo.op_id], jo.rows, 64, 3)
    p.stage("join", [jo, jop], [2, 3])
    p.dim("nation", 2 / 25, 40, ("n_name", "in", n1, n2),
          ("n_nationkey", "n_name"))
    cu = p.table("customer", 0, None, 16, (), ("c_custkey", "c_nationkey"))
    jc = p.op("join", [cu[-1].op_id, p.subqs[5].root_op], 15e6 * 2 / 25, 40,
              1, ("eq", "broadcast"))
    jcp = p.op("project", [jc.op_id], jc.rows, 40, 1)
    p.stage("join", cu + [jc, jcp], [5], "customer")
    jx = p.op("join", [jop.op_id, jcp.op_id], jop.rows * 2 / 25, 96, 4,
              ("eq",))
    jxf = p.op("filter", [jx.op_id], jx.rows / 2, 96, 4,
               ("n_name", "eq", n1, n2, "or", "and"))
    jxp = p.op("project", [jxf.op_id], jxf.rows, 64, 4, ("year", "mul"))
    pa = p.op("agg", [jxp.op_id], 4 * 400, 64, 4, ("group", "sum"))
    p.stage("join", [jx, jxf, jxp, pa], [4, 6])
    fa = p.op("agg", [pa.op_id], 4, 64, 5, ("group", "sum"))
    srt = p.op("sort", [fa.op_id], 4, 64, 5, ("asc",))
    p.stage("agg", [fa, srt], [7])


def _q8(p: _Plan) -> None:
    nation = p.pick(_NATIONS)[0]
    region = p.pick(_REGIONS)[0]
    ptype = " ".join(p.pick(["STANDARD", "SMALL", "MEDIUM", "LARGE",
                             "ECONOMY", "PROMO"]) + p.pick(
        ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]) + p.pick(
        ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]))
    p.dim("part", 1 / 150, 16, ("p_type", "eq", ptype), ("p_partkey",))
    li = p.table("lineitem", 0, None, 40, (), ("l_partkey", "l_suppkey",
                                                "l_orderkey",
                                                "l_extendedprice",
                                                "l_discount"))
    jl = p.op("join", [li[-1].op_id, p.subqs[0].root_op], 600e6 / 150, 40, 1,
              ("eq", "broadcast"))
    jlp = p.op("project", [jl.op_id], jl.rows, 32, 1)
    p.stage("join", li + [jl, jlp], [0], "lineitem")
    od = p.table("orders", 0, _orders_in(_day(1995), _day(1997)), 24,
                 ("o_orderdate", "between", "1995", "1996"),
                 ("o_orderkey", "o_custkey", "o_orderdate"))
    p.stage("scan", od, [], "orders")
    jo = p.op("join", [jlp.op_id, od[-1].op_id],
              jlp.rows * od[-1].rows / 150e6, 48, 2, ("eq",))
    jop = p.op("project", [jo.op_id], jo.rows, 48, 2)
    p.stage("join", [jo, jop], [1, 2])
    p.dim("region", 1 / 5, 8, ("r_name", "eq", region), ("r_regionkey",))
    p.dim("nation", None, 8, (), ("n_nationkey",), children=[4])
    cu = p.table("customer", 0, None, 16, (), ("c_custkey", "c_nationkey"))
    jc = p.op("join", [cu[-1].op_id, p.subqs[5].root_op], 15e6 / 5, 8, 1,
              ("eq", "broadcast"))
    jcp = p.op("project", [jc.op_id], jc.rows, 8, 1)
    p.stage("join", cu + [jc, jcp], [5], "customer")
    jx = p.op("join", [jop.op_id, jcp.op_id], jop.rows / 5, 48, 3, ("eq",))
    jxp = p.op("project", [jx.op_id], jx.rows, 40, 3)
    p.stage("join", [jx, jxp], [3, 6])
    p.dim("nation", None, 40, (), ("n_nationkey", "n_name"))
    su = p.table("supplier", 0, None, 16, (), ("s_suppkey", "s_nationkey"))
    js = p.op("join", [su[-1].op_id, p.subqs[8].root_op], 1e6, 40, 1,
              ("eq", "broadcast"))
    jsp = p.op("project", [js.op_id], js.rows, 32, 1)
    p.stage("join", su + [js, jsp], [8], "supplier")
    jf = p.op("join", [jxp.op_id, jsp.op_id], jxp.rows, 64, 4, ("eq",))
    jfp = p.op("project", [jf.op_id], jf.rows, 40, 4,
               ("year", "case", "n_name", "eq", nation))
    pa = p.op("agg", [jfp.op_id], 2 * 400, 40, 4, ("group", "sum"))
    p.stage("join", [jf, jfp, pa], [7, 9])
    fa = p.op("agg", [pa.op_id], 2, 40, 5, ("group", "sum"))
    fp = p.op("project", [fa.op_id], 2, 24, 5, ("div",))
    srt = p.op("sort", [fp.op_id], 2, 24, 5, ("asc",))
    p.stage("agg", [fa, fp, srt], [10])


def _q9(p: _Plan) -> None:
    color = int(p.rng.integers(0, _N_COLORS))
    sel = p.jitter(5 / _N_COLORS)
    pt = p.table("part", 0, sel, 8, ("p_name", "like", f"color{color}"),
                 ("p_partkey",))
    p.stage("scan", pt, [], "part")
    li = p.table("lineitem", 0, None, 48, (), ("l_orderkey", "l_partkey",
                                                "l_suppkey", "l_quantity",
                                                "l_extendedprice",
                                                "l_discount"))
    p.stage("scan", li, [], "lineitem")
    jp = p.op("join", [li[-1].op_id, pt[-1].op_id], 600e6 * pt[-1].rows
              / 20e6, 48, 1, ("eq",))
    jpp = p.op("project", [jp.op_id], jp.rows, 48, 1)
    p.stage("join", [jp, jpp], [1, 0])
    ps = p.table("partsupp", 0, None, 24, (), ("ps_partkey", "ps_suppkey",
                                                "ps_supplycost"))
    p.stage("scan", ps, [], "partsupp")
    jps = p.op("join", [jpp.op_id, ps[-1].op_id], jpp.rows, 56, 2,
               ("eq", "and"))
    jpsp = p.op("project", [jps.op_id], jps.rows, 56, 2)
    p.stage("join", [jps, jpsp], [2, 3])
    p.dim("nation", None, 40, (), ("n_nationkey", "n_name"))
    su = p.table("supplier", 0, None, 16, (), ("s_suppkey", "s_nationkey"))
    js = p.op("join", [su[-1].op_id, p.subqs[5].root_op], 1e6, 40, 1,
              ("eq", "broadcast"))
    jsp = p.op("project", [js.op_id], js.rows, 32, 1)
    p.stage("join", su + [js, jsp], [5], "supplier")
    jx = p.op("join", [jpsp.op_id, jsp.op_id], jpsp.rows, 80, 3, ("eq",))
    jxp = p.op("project", [jx.op_id], jx.rows, 72, 3)
    p.stage("join", [jx, jxp], [4, 6])
    od = p.table("orders", 0, None, 16, (), ("o_orderkey", "o_orderdate"))
    p.stage("scan", od, [], "orders")
    jo = p.op("join", [jxp.op_id, od[-1].op_id], jxp.rows, 80, 4, ("eq",))
    jop = p.op("project", [jo.op_id], jo.rows, 48, 4, ("year", "mul", "sub"))
    pa = p.op("agg", [jop.op_id], 175 * 400, 48, 4, ("group", "sum"))
    p.stage("join", [jo, jop, pa], [7, 8])
    fa = p.op("agg", [pa.op_id], 175, 48, 5, ("group", "sum"))
    srt = p.op("sort", [fa.op_id], 175, 48, 5, ("asc", "desc"))
    p.stage("agg", [fa, srt], [9])


def _q10(p: _Plan) -> None:
    year, month = int(p.rng.integers(1993, 1996)), int(p.rng.integers(1, 13))
    if year == 1993:
        month = max(month, 2)
    elif year == 1995:
        month = 1
    d0 = _day(year, month)
    od = p.table("orders", 0, _orders_in(d0, d0 + 91.3), 16,
                 ("o_orderdate", "ge", "lt", f"{year}-{month}"),
                 ("o_orderkey", "o_custkey"))
    p.stage("scan", od, [], "orders")
    li = p.table("lineitem", 0, 0.25, 24, ("l_returnflag", "eq", "R"),
                 ("l_orderkey", "l_extendedprice", "l_discount"))
    p.stage("scan", li, [], "lineitem")
    jl = p.op("join", [li[-1].op_id, od[-1].op_id], od[-1].rows * 1.0, 32, 1,
              ("eq",))
    jlp = p.op("project", [jl.op_id], jl.rows, 24, 1)
    p.stage("join", [jl, jlp], [1, 0])
    p.dim("nation", None, 40, (), ("n_nationkey", "n_name"))
    cu = p.table("customer", 0, None, 170, (), ("c_custkey", "c_name",
                                                 "c_acctbal", "c_address",
                                                 "c_phone", "c_comment"))
    jc = p.op("join", [cu[-1].op_id, p.subqs[3].root_op], 15e6, 200, 1,
              ("eq", "broadcast"))
    jcp = p.op("project", [jc.op_id], jc.rows, 200, 1)
    p.stage("join", cu + [jc, jcp], [3], "customer")
    jx = p.op("join", [jlp.op_id, jcp.op_id], jlp.rows, 220, 2, ("eq",))
    jxp = p.op("project", [jx.op_id], jx.rows, 210, 2, ("mul", "sub"))
    pa = p.op("agg", [jxp.op_id], jx.rows / 1.3, 210, 2, ("group", "sum"))
    fa = p.op("agg", [pa.op_id], pa.rows, 210, 3, ("group", "sum"))
    srt = p.op("sort", [fa.op_id], fa.rows, 210, 3, ("desc",))
    lim = p.op("limit", [srt.op_id], min(srt.rows, 20.0), 210, 3)
    p.stage("join", [jx, jxp, pa, fa, srt, lim], [2, 4])


def _q11(p: _Plan) -> None:
    nation = p.pick(_NATIONS)[0]
    p.dim("nation", 1 / 25, 8, ("n_name", "eq", nation), ("n_nationkey",))
    su = p.table("supplier", 0, None, 16, (), ("s_suppkey", "s_nationkey"))
    jsn = p.op("join", [su[-1].op_id, p.subqs[0].root_op], 1e6 / 25, 8, 1,
               ("eq", "broadcast"))
    jsp = p.op("project", [jsn.op_id], jsn.rows, 8, 1)
    # 1: the nation's suppliers, broadcast to both partsupp scans.
    p.stage("join", su + [jsn, jsp], [0], "supplier")
    parts = []
    for group in (("group", "sum"), ("sum",)):
        ps = p.table("partsupp", 0, None, 24, (), ("ps_partkey", "ps_suppkey",
                                                    "ps_availqty",
                                                    "ps_supplycost"))
        j = p.op("join", [ps[-1].op_id, jsp.op_id], 80e6 / 25, 24, 2,
                 ("eq", "broadcast"))
        jp = p.op("project", [j.op_id], j.rows, 16, 2, ("mul",))
        pa = p.op("agg", [jp.op_id], j.rows if len(group) == 2 else 560, 16,
                  2, group)
        p.stage("join", ps + [j, jp, pa], [1], "partsupp")
        parts.append(pa)
    # 4: the scalar subquery's total.
    tot = p.op("agg", [parts[1].op_id], 1, 16, 3, ("sum", "mul"))
    p.stage("agg", [tot], [3])
    # 5: per part, over the total times FRACTION.
    fa = p.op("agg", [parts[0].op_id], 80e6 / 25 / 1.03, 16, 3,
              ("group", "sum"))
    jm = p.op("join", [fa.op_id, tot.op_id], fa.rows, 24, 4,
              ("gt", "scalar"))
    jf = p.op("filter", [jm.op_id], p.jitter(fa.rows * 0.009), 16, 4,
              ("gt", "0.000001"))
    jp = p.op("project", [jf.op_id], jf.rows, 16, 4)
    srt = p.op("sort", [jp.op_id], jp.rows, 16, 4, ("desc",))
    p.stage("join", [fa, jm, jf, jp, srt], [2, 4])


def _q12(p: _Plan) -> None:
    m1, m2 = p.pick(_SHIPMODES, 2)
    year = int(p.rng.integers(1993, 1998))
    sel = 2 / 7 * _orders_in(_day(year), _day(year + 1)) * 0.49
    li = p.table("lineitem", 0, sel, 24,
                 ("l_shipmode", "in", m1, m2, "l_commitdate", "lt",
                  "l_receiptdate", "l_shipdate", "ge", "and", str(year)),
                 ("l_orderkey", "l_shipmode"))
    p.stage("scan", li, [], "lineitem")
    od = p.table("orders", 0, None, 24, (), ("o_orderkey",
                                             "o_orderpriority"))
    p.stage("scan", od, [], "orders")
    j = p.op("join", [od[-1].op_id, li[-1].op_id], li[-1].rows, 40, 1,
             ("eq",))
    jp = p.op("project", [j.op_id], j.rows, 24, 1, ("case", "eq", "or"))
    pa = p.op("agg", [jp.op_id], 2 * 400, 24, 1, ("group", "sum"))
    p.stage("join", [j, jp, pa], [1, 0])
    fa = p.op("agg", [pa.op_id], 2, 24, 2, ("group", "sum"))
    srt = p.op("sort", [fa.op_id], 2, 24, 2, ("asc",))
    p.stage("agg", [fa, srt], [2])


def _q13(p: _Plan) -> None:
    w1 = p.pick(["special", "pending", "unusual", "express"])[0]
    w2 = p.pick(["packages", "requests", "accounts", "deposits"])[0]
    cu = p.table("customer", 0, None, 8, (), ("c_custkey",))
    p.stage("scan", cu, [], "customer")
    od = p.table("orders", 0, p.jitter(0.989), 16,
                 ("o_comment", "not", "like", w1, w2),
                 ("o_orderkey", "o_custkey"))
    p.stage("scan", od, [], "orders")
    j = p.op("join", [cu[-1].op_id, od[-1].op_id], od[-1].rows + 5e6, 16, 1,
             ("eq", "left_outer"))
    jp = p.op("project", [j.op_id], j.rows, 16, 1)
    a1 = p.op("agg", [jp.op_id], 15e6, 16, 1, ("group", "count"))
    a2 = p.op("agg", [a1.op_id], 15e6, 16, 2, ("group", "count"))
    a3 = p.op("agg", [a2.op_id], 42 * 400, 16, 2, ("group", "count"))
    p.stage("join", [j, jp, a1, a2, a3], [0, 1])
    fa = p.op("agg", [a3.op_id], 42, 16, 3, ("group", "count"))
    srt = p.op("sort", [fa.op_id], 42, 16, 3, ("desc",))
    p.stage("agg", [fa, srt], [2])


def _q14(p: _Plan) -> None:
    year, month = int(p.rng.integers(1993, 1998)), int(p.rng.integers(1, 13))
    d0 = _day(year, month)
    li = p.table("lineitem", 0, _shipped_in(d0, d0 + 30.44), 24,
                 ("l_shipdate", "ge", "lt", f"{year}-{month}"),
                 ("l_partkey", "l_extendedprice", "l_discount"))
    p.stage("scan", li, [], "lineitem")
    pt = p.table("part", 0, None, 32, (), ("p_partkey", "p_type"))
    p.stage("scan", pt, [], "part")
    j = p.op("join", [li[-1].op_id, pt[-1].op_id], li[-1].rows, 48, 1,
             ("eq",))
    jp = p.op("project", [j.op_id], j.rows, 24, 1, ("case", "like",
                                                    "PROMO", "mul"))
    pa = p.op("agg", [jp.op_id], 400, 16, 1, ("sum",))
    p.stage("join", [j, jp, pa], [0, 1])
    fa = p.op("agg", [pa.op_id], 1, 16, 2, ("sum",))
    fp = p.op("project", [fa.op_id], 1, 8, 2, ("div", "mul"))
    p.stage("agg", [fa, fp], [2])


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


def _q16(p: _Plan) -> None:
    brand = f"Brand#{int(p.rng.integers(1, 6))}{int(p.rng.integers(1, 6))}"
    sizes = sorted(int(s) for s in p.rng.choice(np.arange(1, 51), 8,
                                                replace=False))
    p.dim("supplier", 5e-4, 8, ("s_comment", "like", "Customer",
                                "Complaints"), ("s_suppkey",))
    pt = p.table("part", 0, 24 / 25 * 0.8 * 8 / 50, 48,
                 ("p_brand", "ne", brand, "p_type", "not", "like",
                  "p_size", "in", *map(str, sizes)),
                 ("p_partkey", "p_brand", "p_type", "p_size"))
    p.stage("scan", pt, [], "part")
    ps = p.table("partsupp", 0, None, 16, (), ("ps_partkey", "ps_suppkey"))
    ja = p.op("join", [ps[-1].op_id, p.subqs[0].root_op], 80e6 * 0.9995, 16,
              1, ("eq", "anti", "not_in", "broadcast"))
    jap = p.op("project", [ja.op_id], ja.rows, 16, 1)
    p.stage("join", ps + [ja, jap], [0], "partsupp")
    j = p.op("join", [jap.op_id, pt[-1].op_id], jap.rows * pt[-1].rows
             / 20e6, 56, 2, ("eq",))
    jp = p.op("project", [j.op_id], j.rows, 56, 2)
    pa = p.op("agg", [jp.op_id], j.rows, 56, 2, ("group",))
    p.stage("join", [j, jp, pa], [2, 1])
    fa = p.op("agg", [pa.op_id], pa.rows, 56, 3, ("group",))
    pc = p.op("agg", [fa.op_id], 27840 * 10, 56, 3, ("group", "count",
                                                     "distinct"))
    p.stage("agg", [fa, pc], [3])
    fc = p.op("agg", [pc.op_id], 27840, 56, 4, ("group", "count"))
    srt = p.op("sort", [fc.op_id], 27840, 56, 4, ("desc", "asc"))
    p.stage("agg", [fc, srt], [4])


def _q17(p: _Plan) -> None:
    brand = f"Brand#{int(p.rng.integers(1, 6))}{int(p.rng.integers(1, 6))}"
    container = " ".join(p.pick(["SM", "LG", "MED", "JUMBO", "WRAP"])
                         + p.pick(["CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                                   "CAN", "DRUM"]))
    p.dim("part", 1 / 25 / 40, 8, ("p_brand", "eq", brand, "p_container",
                                   "eq", container), ("p_partkey",))
    li = p.table("lineitem", 0, None, 24, (), ("l_partkey", "l_quantity",
                                                "l_extendedprice"))
    j = p.op("join", [li[-1].op_id, p.subqs[0].root_op], 600e6 / 1000, 24, 1,
             ("eq", "broadcast"))
    jp = p.op("project", [j.op_id], j.rows, 24, 1)
    p.stage("join", li + [j, jp], [0], "lineitem")
    # 2: all of lineitem, partial avg(l_quantity) by part.
    li2 = p.table("lineitem", 0, None, 16, (), ("l_partkey", "l_quantity"))
    pa = p.op("agg", [li2[-1].op_id], 400e6, 24, 0, ("group", "avg"))
    p.stage("scan", li2 + [pa], [], "lineitem")
    fa = p.op("agg", [pa.op_id], 20e6, 16, 1, ("group", "avg"))
    jq = p.op("join", [fa.op_id, jp.op_id], jp.rows, 32, 2, ("eq",))
    jf = p.op("filter", [jq.op_id], jq.rows * p.jitter(0.1), 32, 2,
              ("l_quantity", "lt", "mul", "0.2"))
    psum = p.op("agg", [jf.op_id], 400, 8, 2, ("sum",))
    p.stage("join", [fa, jq, jf, psum], [2, 1])
    fs = p.op("agg", [psum.op_id], 1, 8, 3, ("sum",))
    fp = p.op("project", [fs.op_id], 1, 8, 3, ("div", "7.0"))
    p.stage("agg", [fs, fp], [3])


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


def _q20(p: _Plan) -> None:
    color = int(p.rng.integers(0, _N_COLORS))
    year = int(p.rng.integers(1993, 1998))
    nation = p.pick(_NATIONS)[0]
    # 0-2: partsupp of the colour's parts (the estimate counts no LIKE, so
    # the parts are shuffled).
    pt = p.table("part", 0, p.jitter(1 / _N_COLORS), 8,
                 ("p_name", "like", f"color{color}"), ("p_partkey",))
    p.stage("scan", pt, [], "part")
    ps = p.table("partsupp", 0, None, 24, (), ("ps_partkey", "ps_suppkey",
                                                "ps_availqty"))
    p.stage("scan", ps, [], "partsupp")
    js = p.op("join", [ps[-1].op_id, pt[-1].op_id], 4 * pt[-1].rows, 24, 1,
              ("eq", "semi", "in"))
    jsp = p.op("project", [js.op_id], js.rows, 24, 1)
    p.stage("join", [js, jsp], [1, 0])
    # 3: the year's lines, partial sum by (part, supplier); 4: the final
    # sum joined back, availqty over half of it.
    li = p.table("lineitem", 0, _shipped_in(_day(year), _day(year + 1)), 24,
                 ("l_shipdate", "ge", "lt", str(year)),
                 ("l_partkey", "l_suppkey", "l_quantity"))
    pa = p.op("agg", [li[-1].op_id], li[-1].rows * 0.9, 24, 0,
              ("group", "sum"))
    p.stage("scan", li + [pa], [], "lineitem")
    fa = p.op("agg", [pa.op_id], pa.rows / 1.2, 24, 1, ("group", "sum"))
    jq = p.op("join", [fa.op_id, jsp.op_id], jsp.rows * 0.8, 32, 2, ("eq",))
    jf = p.op("filter", [jq.op_id], jq.rows * p.jitter(0.5), 32, 2,
              ("ps_availqty", "gt", "mul", "0.5"))
    jfp = p.op("project", [jf.op_id], jf.rows, 8, 2, ("ps_suppkey",))
    p.stage("join", [fa, jq, jf, jfp], [3, 2])
    # 5-7: the nation's suppliers, semi-joined with those suppkeys.
    p.dim("nation", 1 / 25, 8, ("n_name", "eq", nation), ("n_nationkey",))
    su = p.table("supplier", 0, None, 120, (), ("s_suppkey", "s_name",
                                                 "s_address",
                                                 "s_nationkey"))
    jn = p.op("join", [su[-1].op_id, p.subqs[5].root_op], 1e6 / 25, 120, 1,
              ("eq", "broadcast"))
    jnp = p.op("project", [jn.op_id], jn.rows, 112, 1)
    p.stage("join", su + [jn, jnp], [5], "supplier")
    jx = p.op("join", [jnp.op_id, jfp.op_id], jnp.rows * 0.05, 112, 3,
              ("eq", "semi", "in"))
    jxp = p.op("project", [jx.op_id], jx.rows, 104, 3, ("s_name",
                                                        "s_address"))
    srt = p.op("sort", [jxp.op_id], jxp.rows, 104, 3, ("asc",))
    p.stage("join", [jx, jxp, srt], [6, 4])


def _q21(p: _Plan) -> None:
    nation = p.pick(_NATIONS)[0]
    p.dim("nation", 1 / 25, 8, ("n_name", "eq", nation), ("n_nationkey",))
    su = p.table("supplier", 0, None, 40, (), ("s_suppkey", "s_name",
                                                "s_nationkey"))
    jn = p.op("join", [su[-1].op_id, p.subqs[0].root_op], 1e6 / 25, 40, 1,
              ("eq", "broadcast"))
    jnp = p.op("project", [jn.op_id], jn.rows, 32, 1)
    p.stage("join", su + [jn, jnp], [0], "supplier")     # broadcast
    # 2: l1, late lines of the nation's suppliers.
    l1 = p.table("lineitem", 0, 0.63, 16, ("l_receiptdate", "gt",
                                           "l_commitdate"),
                 ("l_orderkey", "l_suppkey"))
    j1 = p.op("join", [l1[-1].op_id, jnp.op_id], l1[-1].rows / 25, 40, 2,
              ("eq", "broadcast"))
    j1p = p.op("project", [j1.op_id], j1.rows, 40, 2)
    p.stage("join", l1 + [j1, j1p], [1], "lineitem")
    od = p.table("orders", 0, 0.49, 8, ("o_orderstatus", "eq", "F"),
                 ("o_orderkey",))
    p.stage("scan", od, [], "orders")
    l2 = p.table("lineitem", 0, None, 16, (), ("l_orderkey", "l_suppkey"))
    p.stage("scan", l2, [], "lineitem")
    l3 = p.table("lineitem", 0, 0.63, 16, ("l_receiptdate", "gt",
                                           "l_commitdate"),
                 ("l_orderkey", "l_suppkey"))
    p.stage("scan", l3, [], "lineitem")
    # 6: four inputs on one partitioning by l_orderkey.
    jo = p.op("join", [j1p.op_id, od[-1].op_id], j1p.rows * 0.49, 40, 3,
              ("eq",))
    jop = p.op("project", [jo.op_id], jo.rows, 40, 3)
    semi = p.op("join", [jop.op_id, l2[-1].op_id], jop.rows * 0.9, 40, 3,
                ("eq", "ne", "semi", "exists"))
    anti = p.op("join", [semi.op_id, l3[-1].op_id], semi.rows * p.jitter(
        0.08), 40, 3, ("eq", "ne", "anti", "not_exists"))
    ap = p.op("project", [anti.op_id], anti.rows, 32, 3, ("s_name",))
    pa = p.op("agg", [ap.op_id], 40e3 * 0.1 * 400, 40, 3, ("group", "count"))
    p.stage("join", [jo, jop, semi, anti, ap, pa], [2, 3, 4, 5])
    fa = p.op("agg", [pa.op_id], 4000, 40, 4, ("group", "count"))
    srt = p.op("sort", [fa.op_id], fa.rows, 40, 4, ("desc", "asc"))
    lim = p.op("limit", [srt.op_id], min(srt.rows, 100.0), 40, 4)
    p.stage("agg", [fa, srt, lim], [6])


def _q22(p: _Plan) -> None:
    codes = sorted(str(10 + int(c)) for c in p.rng.choice(25, 7,
                                                          replace=False))
    share = 7 / 25
    cu = p.table("customer", 0, share * 0.91, 16,
                 ("c_acctbal", "gt", "0.00", "substring", "in", *codes),
                 ("c_acctbal",))
    pa = p.op("agg", [cu[-1].op_id], 400, 16, 0, ("avg",))
    p.stage("scan", cu + [pa], [], "customer")
    avg = p.op("agg", [pa.op_id], 1, 16, 1, ("avg",))
    p.stage("agg", [avg], [0])
    c2 = p.table("customer", 0, share, 24, ("substring", "in", *codes),
                 ("c_custkey", "c_phone", "c_acctbal"))
    js = p.op("join", [c2[-1].op_id, avg.op_id], c2[-1].rows * 0.5, 24, 2,
              ("gt", "scalar"))
    jsp = p.op("project", [js.op_id], js.rows, 24, 2)
    p.stage("join", c2 + [js, jsp], [1], "customer")
    od = p.table("orders", 0, None, 8, (), ("o_custkey",))
    p.stage("scan", od, [], "orders")
    ja = p.op("join", [jsp.op_id, od[-1].op_id], jsp.rows / 3, 24, 3,
              ("eq", "anti", "not_exists"))
    jap = p.op("project", [ja.op_id], ja.rows, 16, 3, ("substring",))
    pc = p.op("agg", [jap.op_id], 7 * 400, 24, 3, ("group", "count", "sum"))
    p.stage("join", [ja, jap, pc], [2, 3])
    fc = p.op("agg", [pc.op_id], 7, 24, 4, ("group", "count", "sum"))
    srt = p.op("sort", [fc.op_id], 7, 24, 4, ("asc",))
    p.stage("agg", [fc, srt], [4])


_TEMPLATES = [_q1, _q2, _q3, _q4, _q5, _q6, _q7, _q8, _q9, _q10, _q11, _q12,
              _q13, _q14, _q15, _q16, _q17, _q18, _q19, _q20, _q21, _q22]


def make_query(template: int, *, variant: int, seed: int) -> Query:
    if not 0 <= template < N_TEMPLATES:
        raise ValueError(f"template {template} outside 0..{N_TEMPLATES - 1}")
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(NAME.encode()), template, variant]))
    p = _Plan(rng)
    _TEMPLATES[template](p)
    return Query(qid=f"{NAME}-q{template + 1}-v{variant}", ops=p.ops,
                 subqs=p.subqs, benchmark=NAME, template=template)
