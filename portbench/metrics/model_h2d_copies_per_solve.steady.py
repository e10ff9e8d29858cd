"""Performance model: host-to-device copies (``PerfModel._to_dev`` calls,
one pageable copy an array on the card) counted on the window's ``flush``
spans, over the queries those flushes solved."""
from portbench.harness.spans import counter, named, program_trace, solved

NAME, UNIT = "model_h2d_copies_per_solve.steady", "copies"


def read(rec):
    tr = program_trace(rec)
    n = solved(tr) if tr is not None else 0
    if not n:
        return None
    return counter(named(tr, "flush"), "h2d_copies") / n
