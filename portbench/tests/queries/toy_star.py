"""A query generator for the harness's tests: four star joins over the
Star Schema Benchmark's SF-100 tables, the fact table joined to zero to
three dimensions in turn, aggregated at the top (with a sort and a limit
on the largest).  A variant redraws the selectivities and fan-outs; the
CBO estimates carry a log-normal error that grows with depth."""
from __future__ import annotations

import math
import zlib

import numpy as np

from repro_torch.queryengine.plan import Operator, Query, SubQ

NAME = "toy_star"
SOURCE = ("Star Schema Benchmark, O'Neil et al. 2009 "
          "(https://www.cs.umb.edu/~poneil/StarSchemaB.PDF): toy star joins "
          "over its SF-100 tables")
N_TEMPLATES = 4

# (rows, bytes a row) at scale factor 100.
_TABLES = {"lineorder": (600e6, 100), "customer": (3e6, 120),
           "supplier": (2e5, 110), "date": (2556, 90)}
_DIMS = ["date", "customer", "supplier"]


def _estimate(rows: float, depth: int, rng: np.random.Generator) -> float:
    return max(1.0, rows * math.exp(rng.normal(0.0, 0.25 * (1 + 0.6 * depth))))


def make_query(template: int, *, variant: int, seed: int) -> Query:
    if not 0 <= template < N_TEMPLATES:
        raise ValueError(f"template {template} outside 0..{N_TEMPLATES - 1}")
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(NAME.encode()), template, variant]))
    ops, subqs = [], []

    def op(kind, children, rows, width, depth, toks=()):
        est = _estimate(rows, depth, rng)
        ops.append(Operator(len(ops), kind, children, rows, rows * width,
                            est, est * width, toks))
        return ops[-1]

    def scan(table):
        t_rows, width = _TABLES[table]
        s = op("scan", [], t_rows, width, 0, (table,))
        sel = float(np.exp(rng.uniform(np.log(1e-3), 0.0)))
        f = op("filter", [s.op_id], t_rows * sel, width, 0, ("ge", "and"))
        p = op("project", [f.op_id], f.rows, 0.5 * width, 0, ("sum",))
        subqs.append(SubQ(
            sq_id=len(subqs), op_ids=[s.op_id, f.op_id, p.op_id],
            children=[], kind="scan", root_op=p.op_id, table=table,
            input_rows=(t_rows,), input_bytes=(t_rows * width,),
            est_input_rows=(t_rows,), est_input_bytes=(t_rows * width,),
            out_rows=p.rows, out_bytes=p.bytes, est_out_rows=p.est_rows,
            est_out_bytes=p.est_bytes, cpu_weight=1.0, skew=0.1, depth=0))
        return subqs[-1]

    def stage(kind, members, children, depth):
        root = ops[members[-1]]
        ins = [subqs[c] for c in children]
        subqs.append(SubQ(
            sq_id=len(subqs), op_ids=members, children=children, kind=kind,
            root_op=root.op_id,
            input_rows=tuple(c.out_rows for c in ins),
            input_bytes=tuple(c.out_bytes for c in ins),
            est_input_rows=tuple(c.est_out_rows for c in ins),
            est_input_bytes=tuple(c.est_out_bytes for c in ins),
            out_rows=root.rows, out_bytes=root.bytes,
            est_out_rows=root.est_rows, est_out_bytes=root.est_bytes,
            cpu_weight=1.5, skew=0.2, depth=depth))
        return subqs[-1]

    top = scan("lineorder")
    for depth, table in enumerate(_DIMS[:template], start=1):
        dim = scan(table)
        fan = float(np.exp(rng.uniform(np.log(0.05), 0.0)))
        j = op("join", [top.root_op, dim.root_op], top.out_rows * fan,
               top.out_bytes / top.out_rows + dim.out_bytes / dim.out_rows,
               depth, ("eq",))
        top = stage("join", [j.op_id], [top.sq_id, dim.sq_id], depth)
    depth = top.depth + 1
    width = 0.5 * top.out_bytes / top.out_rows
    agg = op("agg", [top.root_op], max(1.0, top.out_rows * 1e-3), width,
             depth, ("group", "sum"))
    members = [agg.op_id]
    if template == N_TEMPLATES - 1:
        srt = op("sort", [agg.op_id], agg.rows, width, depth, ("desc",))
        lim = op("limit", [srt.op_id], min(agg.rows, 100.0), width, depth)
        members += [srt.op_id, lim.op_id]
    stage("agg", members, [top.sq_id], depth)
    return Query(qid=f"{NAME}-t{template}-v{variant}", ops=ops, subqs=subqs,
                 benchmark=NAME, template=template)
