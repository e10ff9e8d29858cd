"""Frozen copies of the port's workload generators.

The yardstick must not move when the program's generator changes, so the
benchmark keeps its own copies of ``make_query`` (with
``_template_tables``, the SF-100 catalogs and the CBO error model),
``ArrivalModel.draw`` for Poisson arrivals and ``serving_stream``'s Zipf
template draw, as they stood when the benchmark was defined.  A template
is the generator's own synthetic join tree over the TPC-H or TPC-DS
SF-100 catalog (1 to 6 tables, or 3 to 24, drawn at random from it), not
one of the specifications' queries.  They build
the port's own ``Query`` types (plain dataclasses), so the server takes
them as it takes its own.  ``portbench/tests`` hold each copy equal to
``repro_torch.queryengine.workloads`` at three seeds.
"""
from __future__ import annotations

import functools
import math
import zlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.queryengine.plan import Operator, Query, SubQ

# Scale factor 100 catalogs: (rows, bytes a row).
TPCH_TABLES: Dict[str, Tuple[float, float]] = {
    "lineitem": (600e6, 120), "orders": (150e6, 100),
    "partsupp": (80e6, 140), "part": (20e6, 150), "customer": (15e6, 180),
    "supplier": (1e6, 160), "nation": (25, 120), "region": (5, 120),
}

TPCDS_TABLES: Dict[str, Tuple[float, float]] = {
    "store_sales": (288e6, 164), "catalog_sales": (144e6, 226),
    "web_sales": (72e6, 226), "inventory": (399e6, 16),
    "store_returns": (28.8e6, 134), "catalog_returns": (14.4e6, 166),
    "web_returns": (7.2e6, 162), "customer": (2e6, 132),
    "customer_address": (1e6, 110), "customer_demographics": (1.92e6, 42),
    "item": (204e3, 281), "date_dim": (73049, 141), "time_dim": (86400, 59),
    "store": (402, 263), "warehouse": (15, 117), "web_site": (24, 292),
    "web_page": (2040, 96), "promotion": (1000, 124),
    "household_demographics": (7200, 21), "income_band": (20, 16),
    "reason": (55, 38), "ship_mode": (20, 56), "call_center": (30, 305),
    "catalog_page": (20400, 139),
}

N_TEMPLATES = {"tpch": 22, "tpcds": 102}

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


def _catalog(benchmark: str) -> Dict[str, Tuple[float, float]]:
    return TPCH_TABLES if benchmark == "tpch" else TPCDS_TABLES


def cbo_estimate(true_value: float, depth: int, rng: np.random.Generator,
                 sigma0: float = 0.25) -> float:
    """Log-normal CBO estimate whose spread grows with operator depth."""
    sigma = sigma0 * (1.0 + 0.6 * depth)
    return max(1.0, true_value * math.exp(rng.normal(0.0, sigma)))


def _template_tables(benchmark: str, rng: np.random.Generator) -> List[str]:
    cat = _catalog(benchmark)
    facts = _FACTS[benchmark]
    dims = [n for n in cat if n not in facts]
    if benchmark == "tpch":
        n_tables = int(rng.integers(1, 7))
    else:
        n_tables = int(np.clip(rng.geometric(0.18) + 2, 3, 24))
    n_facts = min(1 + int(rng.random() < 0.3) + int(rng.random() < 0.15),
                  n_tables, len(facts))
    chosen = list(rng.choice(facts, size=n_facts, replace=False))
    n_dims = n_tables - n_facts
    if n_dims > 0:
        chosen += list(rng.choice(dims, size=n_dims,
                                  replace=n_dims > len(dims)))
    return chosen


def make_query(benchmark: str, template: int, *, variant: int = 0,
               seed: int = 0) -> Query:
    """One query: the template fixes the join tree, the variant the
    selectivities and fan-outs, with true and CBO-estimated cardinalities."""
    cat = _catalog(benchmark)
    tag = zlib.crc32(benchmark.encode()) & 0xFFFF

    def rng(*extra):
        return np.random.default_rng(
            np.random.SeedSequence([seed, tag, template, *extra]))

    srng = rng()
    tables = _template_tables(benchmark, srng)
    vrng = rng(1000 + variant)
    erng = rng(7777 + variant)
    ops: List[Operator] = []
    subqs: List[SubQ] = []

    def new_op(op_type, children, rows, bys, est_rows, est_bytes, toks=()):
        ops.append(Operator(len(ops), op_type, children, rows, bys,
                            est_rows, est_bytes, toks))
        return len(ops) - 1

    def pred(k: int = 3):
        return tuple(srng.choice(_PRED_VOCAB, size=k))

    frontier = []
    for t_name in tables:
        t_rows, t_width = cat[t_name]
        t_bytes = t_rows * t_width
        sel_base = float(np.exp(srng.uniform(np.log(2e-3), np.log(0.6))))
        sel = float(np.clip(sel_base * np.exp(vrng.normal(0, 0.5)), 1e-5,
                            1.0))
        proj = float(srng.uniform(0.25, 0.9))
        rows = max(1.0, t_rows * sel)
        width = t_width * proj
        bys = rows * width
        est_rows = cbo_estimate(rows, 0, erng)
        est_bytes = est_rows * width
        o_scan = new_op("scan", [], t_rows, t_bytes, t_rows, t_bytes,
                        (t_name,))
        o_fil = new_op("filter", [o_scan], rows, rows * t_width,
                       est_rows, est_rows * t_width, pred())
        o_prj = new_op("project", [o_fil], rows, bys, est_rows, est_bytes,
                       pred(2))
        sq = SubQ(
            sq_id=len(subqs), op_ids=[o_scan, o_fil, o_prj], children=[],
            kind="scan", root_op=o_prj, table=t_name,
            input_rows=(t_rows,), input_bytes=(t_bytes,),
            est_input_rows=(t_rows,), est_input_bytes=(t_bytes,),
            out_rows=rows, out_bytes=bys, est_out_rows=est_rows,
            est_out_bytes=est_bytes,
            cpu_weight=float(srng.uniform(0.6, 1.2)),
            skew=float(srng.beta(1.2, 4.0)), depth=0)
        subqs.append(sq)
        frontier.append((sq.sq_id, rows, bys, est_rows, est_bytes, width))

    srng2 = rng(5)
    depth = 0
    while len(frontier) > 1:
        depth += 1
        frontier.sort(key=lambda f: -f[1])
        j = int(srng2.integers(1, len(frontier)))
        (sq_l, r_l, b_l, er_l, eb_l, w_l) = frontier.pop(j)
        (sq_r, r_r, b_r, er_r, eb_r, w_r) = frontier.pop(0)
        fan_base = float(np.exp(srng2.uniform(np.log(0.05), np.log(2.5))))
        fan = float(np.clip(fan_base * np.exp(vrng.normal(0, 0.4)), 1e-4,
                            8.0))
        rows = max(1.0, fan * max(r_l, r_r))
        width = (w_l + w_r) * float(srng2.uniform(0.4, 0.8))
        bys = rows * width
        est_rows = cbo_estimate(rows, depth, erng)
        est_bytes = est_rows * width
        o_join = new_op("join", [subqs[sq_l].root_op, subqs[sq_r].root_op],
                        rows, bys, est_rows, est_bytes, pred())
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
            skew=float(srng2.beta(1.5, 3.0)), depth=depth)
        subqs.append(sq)
        frontier.append((sq.sq_id, rows, bys, est_rows, est_bytes, width))

    (sq_top, r_t, b_t, er_t, eb_t, w_t) = frontier[0]
    red = float(np.exp(srng2.uniform(np.log(1e-4), np.log(0.2))))
    rows = max(1.0, r_t * red)
    bys = rows * w_t * 0.5
    est_rows = cbo_estimate(rows, depth + 1, erng)
    est_bytes = est_rows * w_t * 0.5
    o_agg = new_op("agg", [subqs[sq_top].root_op], rows, bys, est_rows,
                   est_bytes, pred())
    members = [o_agg]
    root = o_agg
    if srng2.random() < 0.5:
        root = new_op("sort", [o_agg], rows, bys, est_rows, est_bytes,
                      pred(1))
        members.append(root)
    subqs.append(SubQ(
        sq_id=len(subqs), op_ids=members, children=[sq_top], kind="agg",
        root_op=root, input_rows=(r_t,), input_bytes=(b_t,),
        est_input_rows=(er_t,), est_input_bytes=(eb_t,),
        out_rows=rows, out_bytes=bys, est_out_rows=est_rows,
        est_out_bytes=est_bytes,
        cpu_weight=float(srng2.uniform(1.0, 1.8)),
        skew=float(srng2.beta(1.2, 5.0)), depth=depth + 1))
    return Query(qid=f"{benchmark}-t{template:03d}-v{variant}", ops=ops,
                 subqs=subqs, benchmark=benchmark, template=template)


def poisson_arrivals(rate_qps: float, n: int, seed: int,
                     start_s: float = 0.0) -> np.ndarray:
    """``ArrivalModel("poisson", rate_qps).draw(n, seed)``: (n,) arrival
    times of an open-loop Poisson stream."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be positive, got {rate_qps}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA221]))
    return start_s + np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


def zipf_draws(benchmark: str, n: int, seed: int, zipf_a: float = 1.3,
               n_variants: int = 3) -> List[Tuple[int, int]]:
    """``serving_stream``'s (template, variant) draws: Zipf template ranks
    over a seeded permutation, variant 0 twice as likely as 1, and so on."""
    return _zipf_draws(N_TEMPLATES[benchmark], n, seed, zipf_a, n_variants)


def _zipf_draws(n_t: int, n: int, seed: int, zipf_a: float = 1.3,
                n_variants: int = 3) -> List[Tuple[int, int]]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
    rank_of = rng.permutation(n_t)
    p = 1.0 / (1.0 + np.arange(n_t, dtype=np.float64)) ** zipf_a
    p /= p.sum()
    pv = 0.5 ** np.arange(n_variants, dtype=np.float64)
    pv /= pv.sum()
    out = []
    for _ in range(n):
        t = int(rank_of[rng.choice(n_t, p=p)])
        v = int(rng.choice(n_variants, p=pv))
        out.append((t, v))
    return out


def build_queries(benchmark: str, pairs: Sequence[Tuple[int, int]],
                  query_seed: int = 0) -> List[Query]:
    """Queries for (template, variant) pairs; a repeated pair is one object,
    as ``serving_stream`` hands it out."""
    return _build_queries(functools.partial(make_query, benchmark), pairs,
                          query_seed)


def _build_queries(make: Callable[..., Query],
                   pairs: Sequence[Tuple[int, int]],
                   query_seed: int) -> List[Query]:
    built: Dict[Tuple[int, int], Query] = {}
    out = []
    for t, v in pairs:
        if (t, v) not in built:
            built[(t, v)] = make(t, variant=v, seed=query_seed)
        out.append(built[(t, v)])
    return out
