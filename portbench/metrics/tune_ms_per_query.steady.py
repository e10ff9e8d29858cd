"""Compile-time service: the summed wall time of the window's
``tune_batch`` calls (``ServerStats.tune_windows``) over the requests they
answered."""
NAME, UNIT = "tune_ms_per_query.steady", "ms"


def read(rec):
    wins = rec.stats.tune_windows
    n = sum(b for _, b in wins)
    return sum(w for w, _ in wins) / n * 1e3 if n else None
