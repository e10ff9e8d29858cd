"""TPC-H-like and TPC-DS-like workload generators.

The paper evaluates on 22 TPC-H and 102 TPC-DS queries at scale factor 100,
plus 50k parametric variants per benchmark used as model-training templates.
Running a real Spark cluster is out of scope here, so this module generates
*structurally faithful* workloads: star/snowflake join DAGs over catalogs
whose table cardinalities match SF-100 TPC-H / TPC-DS, with per-template
deterministic shapes and per-variant parametric perturbations (selectivities,
join fan-outs) — the same role the benchmark plays in the paper: a family of
operator DAGs with heavy-tailed sizes and compounding cardinality-estimation
error.

Template sizes are drawn to match the paper's reported extremes: TPC-H up to
12 subQs (Q9), TPC-DS up to 47 subQs.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Tuple

import numpy as np

from .plan import Operator, Query, SubQ, cbo_estimate

__all__ = [
    "Table", "TPCH_TABLES", "TPCDS_TABLES",
    "make_query", "make_benchmark", "parametric_variants", "serving_stream",
    "default_workload",
]


@dataclasses.dataclass(frozen=True)
class Table:
    name: str
    rows: float
    width: float  # bytes/row

    @property
    def bytes(self) -> float:
        return self.rows * self.width


# Scale factor 100 catalogs (rows; widths approximate on-disk widths).
TPCH_TABLES: Dict[str, Table] = {
    t.name: t for t in [
        Table("lineitem", 600e6, 120),
        Table("orders", 150e6, 100),
        Table("partsupp", 80e6, 140),
        Table("part", 20e6, 150),
        Table("customer", 15e6, 180),
        Table("supplier", 1e6, 160),
        Table("nation", 25, 120),
        Table("region", 5, 120),
    ]
}

TPCDS_TABLES: Dict[str, Table] = {
    t.name: t for t in [
        Table("store_sales", 288e6, 164),
        Table("catalog_sales", 144e6, 226),
        Table("web_sales", 72e6, 226),
        Table("inventory", 399e6, 16),
        Table("store_returns", 28.8e6, 134),
        Table("catalog_returns", 14.4e6, 166),
        Table("web_returns", 7.2e6, 162),
        Table("customer", 2e6, 132),
        Table("customer_address", 1e6, 110),
        Table("customer_demographics", 1.92e6, 42),
        Table("item", 204e3, 281),
        Table("date_dim", 73049, 141),
        Table("time_dim", 86400, 59),
        Table("store", 402, 263),
        Table("warehouse", 15, 117),
        Table("web_site", 24, 292),
        Table("web_page", 2040, 96),
        Table("promotion", 1000, 124),
        Table("household_demographics", 7200, 21),
        Table("income_band", 20, 16),
        Table("reason", 55, 38),
        Table("ship_mode", 20, 56),
        Table("call_center", 30, 305),
        Table("catalog_page", 20400, 139),
    ]
}

_FACTS = {
    "tpch": ["lineitem", "orders", "partsupp"],
    "tpcds": ["store_sales", "catalog_sales", "web_sales", "inventory",
              "store_returns", "catalog_returns", "web_returns"],
}

_PRED_VOCAB = [
    "l_shipdate", "l_quantity", "o_orderdate", "p_type", "c_mktsegment",
    "ss_sold_date", "d_year", "i_category", "ca_state", "between", "in",
    "like", "ge", "le", "eq", "and", "or", "sum", "avg", "count", "group",
]


# ---------------------------------------------------------------------------
# Template structure
# ---------------------------------------------------------------------------

def _template_tables(benchmark: str, template: int,
                     rng: np.random.Generator) -> List[str]:
    cat = TPCH_TABLES if benchmark == "tpch" else TPCDS_TABLES
    facts = _FACTS[benchmark]
    dims = [n for n in cat if n not in facts]
    if benchmark == "tpch":
        # 22 templates spanning 1..6 tables (Q1-style single-table scans up
        # to Q8/Q9-style 6-table joins).
        n_tables = int(rng.integers(1, 7))
    else:
        # 102 templates; heavy tail up to 24 tables -> ~47 subQs.
        n_tables = int(np.clip(rng.geometric(0.18) + 2, 3, 24))
    n_facts = min(1 + int(rng.random() < 0.3) + int(rng.random() < 0.15),
                  n_tables, len(facts))
    chosen = list(rng.choice(facts, size=n_facts, replace=False))
    n_dims = n_tables - n_facts
    if n_dims > 0:
        # Dims can repeat across branches in DS (date_dim joined many times);
        # sample with replacement beyond the distinct pool.
        replace = n_dims > len(dims)
        chosen += list(rng.choice(dims, size=n_dims, replace=replace))
    return chosen


def make_query(benchmark: str, template: int, *, variant: int = 0,
               seed: int = 0) -> Query:
    """Build one query (template + parametric variant) with true + CBO cards.

    The template's *structure* (tables, join tree shape) depends only on
    ``(benchmark, template)``; the variant perturbs selectivities/fan-outs
    — mirroring the paper's 50k parametric queries per benchmark.
    """
    cat = TPCH_TABLES if benchmark == "tpch" else TPCDS_TABLES
    srng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(benchmark.encode()) & 0xFFFF, template]))
    tables = _template_tables(benchmark, template, srng)
    # Variant rng: perturbs the numeric knobs only.
    vrng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(benchmark.encode()) & 0xFFFF, template,
                                1000 + variant]))
    # CBO error rng: deterministic per (template, variant) so the compile-time
    # optimizer is *consistently* wrong, as a real CBO is.
    erng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(benchmark.encode()) & 0xFFFF, template,
                                7777 + variant]))

    ops: List[Operator] = []
    subqs: List[SubQ] = []

    def new_op(op_type: str, children: List[int], rows: float, bys: float,
               est_rows: float, est_bytes: float,
               toks: Tuple[str, ...] = ()) -> int:
        op = Operator(len(ops), op_type, children, rows, bys,
                      est_rows, est_bytes, toks)
        ops.append(op)
        return op.op_id

    def pred(k: int = 3) -> Tuple[str, ...]:
        return tuple(srng.choice(_PRED_VOCAB, size=k))

    # ---- scan subQs --------------------------------------------------------
    # Each scan: scan -> filter -> project; selectivity & projection fraction
    # vary by variant.
    frontier: List[Tuple[int, float, float, float, float, float]] = []
    # (sq_id, rows, bytes, est_rows, est_bytes, width)
    for t_name in tables:
        tab = cat[t_name]
        sel_base = float(np.exp(srng.uniform(np.log(2e-3), np.log(0.6))))
        sel = float(np.clip(sel_base * np.exp(vrng.normal(0, 0.5)), 1e-5, 1.0))
        proj = float(srng.uniform(0.25, 0.9))
        rows = max(1.0, tab.rows * sel)
        width = tab.width * proj
        bys = rows * width
        est_rows = cbo_estimate(rows, 0, erng)
        est_bytes = est_rows * width
        o_scan = new_op("scan", [], tab.rows, tab.bytes, tab.rows, tab.bytes,
                        (t_name,))
        o_fil = new_op("filter", [o_scan], rows, rows * tab.width,
                       est_rows, est_rows * tab.width, pred())
        o_prj = new_op("project", [o_fil], rows, bys, est_rows, est_bytes,
                       pred(2))
        sq = SubQ(
            sq_id=len(subqs), op_ids=[o_scan, o_fil, o_prj], children=[],
            kind="scan", root_op=o_prj, table=t_name,
            input_rows=(tab.rows,), input_bytes=(tab.bytes,),
            est_input_rows=(tab.rows,), est_input_bytes=(tab.bytes,),
            out_rows=rows, out_bytes=bys, est_out_rows=est_rows,
            est_out_bytes=est_bytes,
            cpu_weight=float(srng.uniform(0.6, 1.2)),
            skew=float(srng.beta(1.2, 4.0)), depth=0,
        )
        subqs.append(sq)
        frontier.append((sq.sq_id, rows, bys, est_rows, est_bytes, width))

    # ---- join subQs (left-deep with occasional bushy merges) --------------
    srng2 = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(benchmark.encode()) & 0xFFFF, template, 5]))
    depth = 0
    while len(frontier) > 1:
        depth += 1
        # Bias toward joining the largest with a small one (star schema).
        frontier.sort(key=lambda f: -f[1])
        i = 0
        j = int(srng2.integers(1, len(frontier)))
        (sq_l, r_l, b_l, er_l, eb_l, w_l) = frontier.pop(max(i, j))
        (sq_r, r_r, b_r, er_r, eb_r, w_r) = frontier.pop(min(i, j))
        fan_base = float(np.exp(srng2.uniform(np.log(0.05), np.log(2.5))))
        fan = float(np.clip(fan_base * np.exp(vrng.normal(0, 0.4)), 1e-4, 8.0))
        rows = max(1.0, fan * max(r_l, r_r))
        width = (w_l + w_r) * float(srng2.uniform(0.4, 0.8))
        bys = rows * width
        est_rows = cbo_estimate(rows, depth, erng)
        est_bytes = est_rows * width
        left_root = subqs[sq_l].root_op
        right_root = subqs[sq_r].root_op
        o_join = new_op("join", [left_root, right_root], rows, bys,
                        est_rows, est_bytes, pred())
        members = [o_join]
        root = o_join
        if srng2.random() < 0.5:
            root = new_op("project", [o_join], rows, bys * 0.9,
                          est_rows, est_bytes * 0.9, pred(2))
            members.append(root)
            bys *= 0.9
            est_bytes *= 0.9
        sq = SubQ(
            sq_id=len(subqs), op_ids=members, children=[sq_l, sq_r],
            kind="join", root_op=root,
            input_rows=(r_l, r_r), input_bytes=(b_l, b_r),
            est_input_rows=(er_l, er_r), est_input_bytes=(eb_l, eb_r),
            out_rows=rows, out_bytes=bys, est_out_rows=est_rows,
            est_out_bytes=est_bytes,
            cpu_weight=float(srng2.uniform(1.0, 2.0)),
            skew=float(srng2.beta(1.5, 3.0)), depth=depth,
        )
        subqs.append(sq)
        frontier.append((sq.sq_id, rows, bys, est_rows, est_bytes, width))

    # ---- final aggregate subQ ---------------------------------------------
    (sq_top, r_t, b_t, er_t, eb_t, w_t) = frontier[0]
    red = float(np.exp(srng2.uniform(np.log(1e-4), np.log(0.2))))
    rows = max(1.0, r_t * red)
    bys = rows * w_t * 0.5
    est_rows = cbo_estimate(rows, depth + 1, erng)
    est_bytes = est_rows * w_t * 0.5
    top_root = subqs[sq_top].root_op
    o_agg = new_op("agg", [top_root], rows, bys, est_rows, est_bytes, pred())
    members = [o_agg]
    root = o_agg
    if srng2.random() < 0.5:
        root = new_op("sort", [o_agg], rows, bys, est_rows, est_bytes, pred(1))
        members.append(root)
    sq = SubQ(
        sq_id=len(subqs), op_ids=members, children=[sq_top], kind="agg",
        root_op=root,
        input_rows=(r_t,), input_bytes=(b_t,),
        est_input_rows=(er_t,), est_input_bytes=(eb_t,),
        out_rows=rows, out_bytes=bys, est_out_rows=est_rows,
        est_out_bytes=est_bytes,
        cpu_weight=float(srng2.uniform(1.0, 1.8)),
        skew=float(srng2.beta(1.2, 5.0)), depth=depth + 1,
    )
    subqs.append(sq)

    return Query(qid=f"{benchmark}-t{template:03d}-v{variant}", ops=ops,
                 subqs=subqs, benchmark=benchmark, template=template)


def make_benchmark(benchmark: str, *, seed: int = 0) -> List[Query]:
    """The paper's evaluation workloads: 22 TPC-H / 102 TPC-DS queries."""
    n = 22 if benchmark == "tpch" else 102
    return [make_query(benchmark, t, variant=0, seed=seed) for t in range(n)]


def parametric_variants(benchmark: str, template: int, n: int, *,
                        seed: int = 0, start: int = 1) -> List[Query]:
    """Parametric training queries from one template (paper: 50k per bench)."""
    return [make_query(benchmark, template, variant=v, seed=seed)
            for v in range(start, start + n)]


def serving_stream(benchmark: str, n: int, *, seed: int = 0,
                   zipf_a: float = 1.3, n_variants: int = 3,
                   query_seed: int = 0) -> List[Query]:
    """A production-like stream of ``n`` tuning requests.

    Template popularity is Zipf-distributed (rank weights ``1/r^a`` over a
    seeded template permutation) and each request picks one of
    ``n_variants`` parametric variants, variant 0 being the most common —
    the repeated-template traffic shape that lets a serving-layer
    effective-set cache amortize Algorithm 1.  Deterministic per seed.

    ``query_seed`` threads through to :func:`make_query`, so distinct query
    populations (not just distinct orderings) can be drawn reproducibly.

    Returns a plain ``List[Query]`` in stream order (the batch-mode
    interface).  Timed streams (arrival models, tenants) belong to the
    streaming layer, which this package does not carry yet.
    """
    n_t = 22 if benchmark == "tpch" else 102
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
    rank_of = rng.permutation(n_t)
    p = 1.0 / (1.0 + np.arange(n_t, dtype=np.float64)) ** zipf_a
    p /= p.sum()
    # Variant distribution: geometric-ish, variant 0 dominant.
    pv = 0.5 ** np.arange(n_variants, dtype=np.float64)
    pv /= pv.sum()
    out: List[Query] = []
    built: Dict[Tuple[int, int], Query] = {}
    for _ in range(n):
        t = int(rank_of[rng.choice(n_t, p=p)])
        v = int(rng.choice(n_variants, p=pv))
        if (t, v) not in built:
            built[(t, v)] = make_query(benchmark, t, variant=v,
                                       seed=query_seed)
        out.append(built[(t, v)])
    return out


def default_workload(benchmark: str, n_per_template: int = 4, *,
                     seed: int = 0) -> List[Query]:
    """Training workload: every template × ``n_per_template`` variants."""
    n_t = 22 if benchmark == "tpch" else 102
    out: List[Query] = []
    for t in range(n_t):
        out.extend(parametric_variants(benchmark, t, n_per_template,
                                       seed=seed, start=1))
    return out
