"""Performance model: graphs a wide GTN dispatch holds in the window's
flushes, Σ ``emb_wide_misses`` of the ``flush`` spans over their
``model.embed`` spans with a ``node_pad`` above four; of a dispatch's 128
rows on the card the rest is padding.  ``None`` where the program counts
no wide misses or made no wide dispatch."""
from portbench.harness.spans import named, program_trace

NAME, UNIT = "wide_graphs_per_dispatch.steady", "graphs"


def _under_flush(spans, sp) -> bool:
    while sp.parent >= 0:
        sp = spans[sp.parent]
        if sp.name == "flush":
            return True
    return False


def read(rec):
    tr = program_trace(rec)
    if tr is None:
        return None
    flushes = named(tr, "flush")
    misses = [sp.attrs["counters"].get("emb_wide_misses") for sp in flushes]
    if not flushes or None in misses:
        return None
    dispatches = sum(1 for sp in named(tr, "model.embed")
                     if (sp.attrs or {}).get("node_pad", 0) > 4
                     and _under_flush(tr.spans, sp))
    return sum(misses) / dispatches if dispatches else None
