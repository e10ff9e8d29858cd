"""HMOOC's solver phases: wall time inside the program's ``hmooc.feed``
spans (each plan's banks or assignment phase, K1 calls included) over the
queries the window's flushes solved."""
from portbench.harness.spans import named, program_trace, seconds, solved

NAME, UNIT = "hmooc_feed_ms_per_solve.steady", "ms"


def read(rec):
    tr = program_trace(rec)
    n = solved(tr) if tr is not None else 0
    if not n:
        return None
    return seconds(named(tr, "hmooc.feed")) / n * 1e3
