"""Runtime session admission: wall time inside the program's
``session_admit`` spans (each query's first AQE planning step, charged to
its flush) over the requests the window's flushes admitted."""
from portbench.harness.spans import named, program_trace, seconds

NAME, UNIT = "session_admit_ms_per_query.steady", "ms"


def read(rec):
    tr = program_trace(rec)
    if tr is None:
        return None
    n = sum(len(sp.attrs["rids"]) for sp in named(tr, "flush"))
    return seconds(named(tr, "session_admit")) / n * 1e3 if n else None
