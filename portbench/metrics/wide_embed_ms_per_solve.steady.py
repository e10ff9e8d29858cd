"""Performance model: wall time of the window's wide GTN dispatches (the
program's ``model.embed`` spans with a ``node_pad`` above four, stages of
five operators or more) inside ``flush`` spans, over the queries those
flushes solved.  ``None`` where no span carries a wider ``node_pad``."""
from portbench.harness.spans import named, program_trace, seconds, solved

NAME, UNIT = "wide_embed_ms_per_solve.steady", "ms"


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
    wide = [sp for sp in named(tr, "model.embed")
            if (sp.attrs or {}).get("node_pad", 0) > 4
            and _under_flush(tr.spans, sp)]
    n = solved(tr)
    if not wide or not n:
        return None
    return seconds(wide) / n * 1e3
