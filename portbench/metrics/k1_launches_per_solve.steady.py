"""Dominance filter: K1 (``pareto_filter``) launches counted on the
window's ``flush`` spans, over the queries those flushes solved."""
from portbench.harness.spans import counter, named, program_trace, solved

NAME, UNIT = "k1_launches_per_solve.steady", "launches"


def read(rec):
    tr = program_trace(rec)
    n = solved(tr) if tr is not None else 0
    if not n:
        return None
    return counter(named(tr, "flush"), "k1_launches") / n
