"""95th percentile of arrival to compile-time θ over every request offered
in the window (``ServedQuery.solve_latency_s`` on the server's clock); a
rejected or unanswered request counts as a miss (+inf).  Nearest rank."""
import math

NAME, UNIT = "solve_p95_s", "s"


def read(rec):
    lat = sorted(
        s.solve_latency_s if (s.status not in ("shed", "rate_limited")
                              and math.isfinite(s.compiled_s)) else math.inf
        for s in rec.served)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
