"""Median wait in the admission queue: micro-batch flush start less
arrival (``admitted_s - arrival_s``) over the window's requests."""
import math

import numpy as np

NAME, UNIT = "admit_wait_ms.steady", "ms"


def read(rec):
    w = [s.admitted_s - s.arrival_s for s in rec.served
         if math.isfinite(s.admitted_s)]
    return float(np.median(w)) * 1e3 if w else None
