"""The one traffic generator: reads a mix file of parameters and builds the
window's stream, the warm-up stream and the set-up solves from the seed.

A mix file (``portbench/traffic/<mix>.json``) holds:

* ``arrivals``: ``{"kind": "poisson", "rate_qps": r, "seed": s}``, an
  open-loop Poisson stream; a run offers ``round(r * seconds)`` requests
  over about ``seconds`` of the server's clock;
* ``templates``: ``{"zipf_a": a, "seed": s}``, ``serving_stream``'s Zipf
  draw over the templates of the configuration's query source
  (``Benchmark.queries``);
* ``variants``: ``{"policy": "fresh"}``, every request a parametric
  variant never seen before in the run or its set-up, or
  ``{"policy": "zipf", "n_variants": v}``, ``serving_stream``'s own
  variants 0..v-1 (variant 0 the most common);
* ``setup``: ``{"solve": "templates" | "variants", "warmup_requests": w}``:
  solve one fresh variant of every template (the effective-set cache's
  steady state: structure hits), or every (template, variant) of the
  ``zipf`` policy (the response cache answers every window request), then
  serve ``w`` fresh requests at the cell's rate outside the window.

The mix's own seeds fix the multiset of templates (with the ``zipf``
policy, of template and variant pairs) and of inter-arrival gaps, so
every run offers the same sizes and the same arrivals; the run's seed
orders both and picks the fresh variants, the weights and the warm-up.
"""
from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np

from repro_torch.queryengine.plan import Query
from repro_torch.queryengine.workloads import StreamRequest

from . import frozen
from .bench import QuerySource, synthetic_queries

# Variant ids a seed owns: [base, base + SPAN).  Window requests take the
# first block, the warm-up the second, the set-up solves the third, so no
# variant repeats inside a run.
_SPAN = 10 ** 6
_WARM, _SETUP = 500_000, 900_000


@dataclasses.dataclass
class Traffic:
    window: List[StreamRequest]
    warmup: List[StreamRequest]
    setup: List[Query]
    rate_qps: float


def _sub_seed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([seed, tag]).generate_state(1)[0])


def _stream(source, pairs, times, query_seed) -> List[StreamRequest]:
    queries = frozen._build_queries(source.make, pairs, query_seed)
    return [StreamRequest(rid=i, query=q, arrival_s=float(t))
            for i, (q, t) in enumerate(zip(queries, times))]


def build(mix: dict, source: Union[QuerySource, str], seed: int,
          seconds: float, query_seed: int = 0) -> Traffic:
    """The run's requests and set-up queries, built from ``source``'s
    templates (a benchmark's name stands for its synthetic generator); a
    pure function of its arguments."""
    if isinstance(source, str):
        source = synthetic_queries(source)
    seed = int(seed) % (1 << 63)
    arr = mix["arrivals"]
    if arr["kind"] != "poisson":
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    rate = float(arr["rate_qps"])
    zipf_a = float(mix["templates"]["zipf_a"])
    var = mix["variants"]
    n_t = source.n_templates
    n = max(1, int(round(rate * seconds)))
    base = _SPAN * (seed + 1)
    order = np.random.default_rng(np.random.SeedSequence(
        [seed, 0x0D3E])).permutation(n)
    if var["policy"] == "fresh":
        draws = frozen._zipf_draws(n_t, n, int(mix["templates"]["seed"]),
                                   zipf_a)
        pairs = [(draws[j][0], base + i) for i, j in enumerate(order)]
    elif var["policy"] == "zipf":
        draws = frozen._zipf_draws(n_t, n, int(mix["templates"]["seed"]),
                                   zipf_a, int(var["n_variants"]))
        pairs = [draws[j] for j in order]
    else:
        raise ValueError(f"unknown variant policy {var['policy']!r}")
    gaps = np.diff(frozen.poisson_arrivals(rate, n, int(arr["seed"])),
                   prepend=0.0)
    gap_order = np.random.default_rng(np.random.SeedSequence(
        [seed, 0x6A95])).permutation(n)
    window = _stream(source, pairs, np.cumsum(gaps[gap_order]),
                     query_seed)

    setup = mix["setup"]
    w_seed = _sub_seed(seed, 0x3A11)
    n_w = int(setup["warmup_requests"])
    w_draws = frozen._zipf_draws(n_t, n_w, w_seed, zipf_a)
    warmup = _stream(source,
                     [(t, base + _WARM + j) for j, (t, _) in
                      enumerate(w_draws)],
                     frozen.poisson_arrivals(rate, n_w, w_seed), query_seed)
    if setup["solve"] == "templates":
        solve = [(t, base + _SETUP + t) for t in range(n_t)]
    elif setup["solve"] == "variants":
        solve = [(t, v) for t in range(n_t)
                 for v in range(int(var["n_variants"]))]
    else:
        raise ValueError(f"unknown set-up policy {setup['solve']!r}")
    return Traffic(window=window, warmup=warmup,
                   setup=frozen._build_queries(source.make, solve,
                                               query_seed),
                   rate_qps=rate)
