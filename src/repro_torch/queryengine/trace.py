"""Stage input statistics shared by the trace collector and the solver.

Only the α (input-characteristics) vector and the feature dimensions live
here for now: the compile-time objectives read them.  Trace collection
(``TraceSet``, ``collect_traces``) belongs to the training path, which this
package does not carry yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["ALPHA_DIM", "GAMMA_DIM"]


def _alpha_stats(rows: Sequence[float], bys: Sequence[float]) -> np.ndarray:
    """Input-characteristics vector: log-scaled sizes of the stage inputs."""
    r = float(sum(rows))
    b = float(sum(bys))
    r1 = float(max(rows))
    b1 = float(max(bys))
    return np.array([np.log1p(r) / 20.0, np.log1p(b) / 25.0,
                     np.log1p(r1) / 20.0, np.log1p(b1) / 25.0,
                     len(rows) / 2.0], np.float64)


ALPHA_DIM = 5
GAMMA_DIM = 4
