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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .plan import Operator, Query, SubQ, cbo_estimate

__all__ = [
    "Table", "TPCH_TABLES", "TPCDS_TABLES",
    "make_query", "make_benchmark", "parametric_variants", "default_workload",
    "serving_stream", "ArrivalModel", "StreamRequest", "TenantSpec",
    "multi_tenant_stream", "SLO_CLASSES",
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


_STATIONARY_KINDS = ("poisson", "uniform", "fixed")
_NONSTATIONARY_KINDS = ("diurnal", "spike", "ramp")


@dataclasses.dataclass(frozen=True)
class ArrivalModel:
    """Explicit, seeded arrival-time model for a serving stream.

    Inter-arrival gaps are drawn from a named distribution with their own
    seed stream (independent of the template/variant draws), so stream
    *timing* is reproducible and composable: the same query sequence can be
    replayed under different load shapes.

    Stationary kinds (constant ``rate_qps``):
      * ``poisson`` — exponential gaps with mean ``1/rate_qps`` (open-loop
        Poisson arrivals, the standard serving-load model);
      * ``uniform`` — gaps uniform on ``[0, 2/rate_qps]`` (same mean rate,
        bounded burstiness);
      * ``fixed``   — deterministic gaps of exactly ``1/rate_qps``.

    Nonstationary kinds (inhomogeneous Poisson processes drawn by seeded
    thinning against :meth:`rate_at`, so the whole time-varying stream is
    still a pure function of the seed):
      * ``diurnal`` — sinusoidal rate
        ``rate_qps · (1 + amplitude·sin(2π·(t−start_s)/period_s))``:
        the compressed diurnal traffic curve;
      * ``spike``   — flash crowd: ``rate_qps`` outside the window,
        ``rate_qps·spike_factor`` on ``[spike_at_s, spike_at_s+spike_dur_s)``;
      * ``ramp``    — linear rate from ``rate_qps`` to ``ramp_to_qps``
        over ``ramp_dur_s`` starting at ``start_s``, then holding.
    """
    kind: str = "poisson"
    rate_qps: float = 16.0
    start_s: float = 0.0
    # diurnal
    period_s: float = 60.0
    amplitude: float = 0.8
    # spike (flash crowd)
    spike_at_s: float = 2.0
    spike_dur_s: float = 2.0
    spike_factor: float = 4.0
    # ramp
    ramp_to_qps: float = 32.0
    ramp_dur_s: float = 4.0

    def _validate(self) -> None:
        if self.kind not in _STATIONARY_KINDS + _NONSTATIONARY_KINDS:
            raise ValueError(f"unknown arrival kind: {self.kind!r}")
        if self.rate_qps <= 0:
            raise ValueError(f"rate_qps must be positive, got {self.rate_qps}")
        if self.kind == "diurnal":
            if not 0.0 <= self.amplitude < 1.0:
                raise ValueError(
                    f"amplitude must be in [0, 1), got {self.amplitude} "
                    "(>= 1 would make the instantaneous rate nonpositive)")
            if self.period_s <= 0:
                raise ValueError(f"period_s must be positive, got "
                                 f"{self.period_s}")
        if self.kind == "spike" and (self.spike_factor <= 0
                                     or self.spike_dur_s < 0):
            raise ValueError("spike_factor must be positive and spike_dur_s "
                             f"nonnegative, got {self.spike_factor}, "
                             f"{self.spike_dur_s}")
        if self.kind == "ramp" and (self.ramp_to_qps <= 0
                                    or self.ramp_dur_s <= 0):
            raise ValueError("ramp_to_qps and ramp_dur_s must be positive, "
                             f"got {self.ramp_to_qps}, {self.ramp_dur_s}")

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate (qps) at simulated time ``t``."""
        self._validate()
        if self.kind == "diurnal":
            phase = 2.0 * np.pi * (t - self.start_s) / self.period_s
            return self.rate_qps * (1.0 + self.amplitude * np.sin(phase))
        if self.kind == "spike":
            hot = self.spike_at_s <= t < self.spike_at_s + self.spike_dur_s
            return self.rate_qps * (self.spike_factor if hot else 1.0)
        if self.kind == "ramp":
            frac = np.clip((t - self.start_s) / self.ramp_dur_s, 0.0, 1.0)
            return float(self.rate_qps
                         + (self.ramp_to_qps - self.rate_qps) * frac)
        return self.rate_qps

    def _max_rate(self) -> float:
        if self.kind == "diurnal":
            return self.rate_qps * (1.0 + self.amplitude)
        if self.kind == "spike":
            return self.rate_qps * max(self.spike_factor, 1.0)
        if self.kind == "ramp":
            return max(self.rate_qps, self.ramp_to_qps)
        return self.rate_qps

    def draw(self, n: int, seed: int = 0) -> np.ndarray:
        """(n,) nondecreasing arrival times, deterministic per seed."""
        self._validate()
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA221]))
        mean_gap = 1.0 / self.rate_qps
        if self.kind == "poisson":
            gaps = rng.exponential(mean_gap, size=n)
        elif self.kind == "uniform":
            gaps = rng.uniform(0.0, 2.0 * mean_gap, size=n)
        elif self.kind == "fixed":
            gaps = np.full(n, mean_gap)
        else:
            # Inhomogeneous Poisson via thinning: candidate arrivals at the
            # envelope rate, each accepted with probability
            # rate_at(t)/rate_max — exact, and a pure function of the seed.
            rmax = self._max_rate()
            out = np.empty(n, np.float64)
            got = 0
            t = self.start_s
            while got < n:
                t += rng.exponential(1.0 / rmax)
                if rng.random() * rmax < self.rate_at(t):
                    out[got] = t
                    got += 1
            return out
        return self.start_s + np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class StreamRequest:
    """One timed tuning request of a serving stream.

    ``weights`` carries the tenant's preference weights *effective at this
    request's arrival time*.  Stationary streams leave it ``None`` (the
    server falls back to the tenant's registered weights); scenario streams
    with mid-stream preference shifts stamp it per request at build time,
    so the (request → weights) mapping is a pure function of the scenario
    seed and replay-equivalence holds exactly across shift boundaries.
    """
    rid: int                 # position in the stream (stable request id)
    query: Query
    arrival_s: float         # simulated-clock arrival time
    tenant: str = "default"  # issuing tenant (multi-tenant admission)
    weights: Optional[Tuple[float, float]] = None  # None → tenant default


SLO_CLASSES = ("strict", "degrade", "best_effort")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of a multi-tenant serving deployment.

    Carries both halves of tenancy: the *client side* (an independent
    seeded arrival process — each tenant is its own open-loop stream) and
    the *server side* admission policy (preference weights for the MOO
    picks, a weighted-fair share, a priority tier, and an optional
    per-tenant solve budget overriding the server default).  UDAO-style
    cost/performance preferences are per-user by nature; the spec is where
    a user's ``weights`` live.

    ``slo`` declares what the server should do when the tenant's solve
    budget has become *unmeetable* for a waiting request (the head would
    start solving past ``arrival + budget − reserve·E[batch]``):

    * ``"best_effort"`` (default) — keep queueing; the request is served
      late (the pre-overload behavior).
    * ``"degrade"`` — admit it through the cheap compile path instead
      (template-cache-only solve / aggregated default θ, no fresh
      Algorithm 1), trading plan quality for admission latency.
    * ``"strict"`` — reject it outright (shed): the tenant prefers an
      explicit error over a blown budget, keeping its served tail inside
      the budget under overload.

    ``rate_limit_qps`` arms a per-tenant token bucket *ahead of* the
    waiting room: arrivals beyond the sustained rate (with a burst
    allowance of ``rate_limit_burst`` tokens) are rejected at the door
    with status ``"rate_limited"`` — they never enqueue, never solve, and
    never consume a batch slot.  ``None`` (default) disables the limiter.
    """
    name: str
    weights: Optional[Tuple[float, float]] = None  # None → server default
    arrivals: ArrivalModel = ArrivalModel()
    share: float = 1.0               # DRR weight within the priority tier
    priority: int = 0                # higher tiers compose first
    solve_budget_s: Optional[float] = None
    slo: str = "best_effort"         # overload policy: strict|degrade|best_effort
    rate_limit_qps: Optional[float] = None   # None → no rate limiter
    rate_limit_burst: float = 4.0            # bucket depth (tokens)

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.share <= 0:
            raise ValueError(f"share must be positive, got {self.share}")
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {self.slo!r}; expected one of "
                f"{SLO_CLASSES}")
        if self.rate_limit_qps is not None and self.rate_limit_qps <= 0:
            raise ValueError(f"rate_limit_qps must be positive, got "
                             f"{self.rate_limit_qps}")
        if self.rate_limit_burst < 1.0:
            raise ValueError(f"rate_limit_burst must be >= 1 (a bucket that "
                             f"cannot hold one token admits nothing), got "
                             f"{self.rate_limit_burst}")


def _tenant_seed(seed: int, name: str) -> int:
    """Derived per-tenant stream seed: independent across tenant names."""
    return int(np.random.SeedSequence(
        [seed, zlib.crc32(name.encode()) & 0xFFFFFFFF]).generate_state(1)[0]
        & 0x7FFFFFFF)


def multi_tenant_stream(benchmark: str, tenants: Sequence[TenantSpec],
                        n_per_tenant, *, seed: int = 0, zipf_a: float = 1.3,
                        n_variants: int = 3, query_seed: int = 0
                        ) -> List["StreamRequest"]:
    """Merge per-tenant serving streams into one timed request stream.

    Each tenant draws its own Zipf template mix and its own arrival
    process (``spec.arrivals``) under a name-derived seed, so tenant
    populations are independent and individually reproducible; the merged
    stream is sorted by arrival time with globally unique ``rid``s.
    ``n_per_tenant`` is one count shared by all tenants or a per-tenant
    sequence aligned with ``tenants``.
    """
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    if isinstance(n_per_tenant, (int, np.integer)):
        counts = [int(n_per_tenant)] * len(tenants)
    else:
        counts = [int(n) for n in n_per_tenant]
        if len(counts) != len(tenants):
            raise ValueError(
                f"got {len(counts)} counts for {len(tenants)} tenants")
    merged: List[StreamRequest] = []
    for spec, n in zip(tenants, counts):
        reqs = serving_stream(benchmark, n, seed=_tenant_seed(seed, spec.name),
                              zipf_a=zipf_a, n_variants=n_variants,
                              arrivals=spec.arrivals, query_seed=query_seed)
        merged.extend(dataclasses.replace(r, tenant=spec.name) for r in reqs)
    merged.sort(key=lambda r: (r.arrival_s, r.tenant, r.rid))
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(merged)]


def serving_stream(benchmark: str, n: int, *, seed: int = 0,
                   zipf_a: float = 1.3, n_variants: int = 3,
                   arrivals: Optional[ArrivalModel] = None,
                   query_seed: int = 0):
    """A production-like stream of ``n`` tuning requests.

    Template popularity is Zipf-distributed (rank weights ``1/r^a`` over a
    seeded template permutation) and each request picks one of
    ``n_variants`` parametric variants, variant 0 being the most common —
    the repeated-template traffic shape that lets a serving-layer
    effective-set cache amortize Algorithm 1.  Deterministic per seed.

    ``query_seed`` threads through to :func:`make_query`, so distinct query
    populations (not just distinct orderings) can be drawn reproducibly.

    Without ``arrivals`` the return value is a plain ``List[Query]`` in
    stream order (the batch-mode interface).  With an :class:`ArrivalModel`
    each request is stamped with an explicit seeded arrival time and the
    return value is a ``List[StreamRequest]`` — the streaming-admission
    interface consumed by ``repro_torch.serve.server.OptimizerServer``.
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
    if arrivals is None:
        return out
    times = arrivals.draw(n, seed)
    return [StreamRequest(rid=i, query=q, arrival_s=float(t))
            for i, (q, t) in enumerate(zip(out, times))]


def default_workload(benchmark: str, n_per_template: int = 4, *,
                     seed: int = 0) -> List[Query]:
    """Training workload: every template × ``n_per_template`` variants."""
    n_t = 22 if benchmark == "tpch" else 102
    out: List[Query] = []
    for t in range(n_t):
        out.extend(parametric_variants(benchmark, t, n_per_template,
                                       seed=seed, start=1))
    return out
