"""Requests finished (not rejected) over the server-clock time from the
first arrival to the last finish: all the work over all the time."""
import math

NAME, UNIT = "tuned_qps", "queries/s"


def read(rec):
    done = [s for s in rec.served
            if s.status not in ("shed", "rate_limited")
            and math.isfinite(s.finished_s)]
    if not done:
        return None
    span = max(s.finished_s for s in done) - min(s.arrival_s
                                                 for s in rec.served)
    return len(done) / span if span > 0 else None
