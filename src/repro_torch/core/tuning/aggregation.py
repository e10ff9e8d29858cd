"""Aggregating fine-grained θp/θs into the single submission copy.

Spark accepts exactly one copy of θp and θs at query submission (paper §5.2,
App. C.2).  The compile-time optimizer produces per-subQ copies; this module
folds them into the initial submission values:

* Join thresholds (s3 maxShuffledHashJoinLocalMapThreshold, s4
  autoBroadcastJoinThreshold): take the **smallest** value among join-rooted
  subQs — a high threshold applied query-wide could force a broadcast from
  wrong compile-time cardinalities that AQE can never undo, while a low one
  only defers the decision to runtime where statistics are exact.  Values are
  **capped at the Spark defaults** (10 MB broadcast / 0 MB shuffled-hash) so
  small scan-rooted joins still broadcast promptly.
* All other θp/θs entries: element-wise median across subQs (robust center;
  the runtime optimizer re-tunes them per stage anyway).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ...queryengine.plan import Query

__all__ = ["aggregate_submission_theta"]

# Indices in the θp vector (see spark_space.THETA_P).
_IDX_S3 = 2   # maxShuffledHashJoinLocalMapThreshold (MB)
_IDX_S4 = 3   # autoBroadcastJoinThreshold (MB)
_CAP_S3_MB = 0.0
_CAP_S4_MB = 10.0


def aggregate_submission_theta(
    query: Query,
    theta_p_sub: np.ndarray,
    theta_s_sub: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """(m, 9) raw θp + (m, 2) raw θs → submission copies (9,), (2,)."""
    theta_p_sub = np.asarray(theta_p_sub, np.float64)
    theta_s_sub = np.asarray(theta_s_sub, np.float64)
    theta_p0 = np.median(theta_p_sub, axis=0)
    theta_s0 = np.median(theta_s_sub, axis=0)

    join_ids = [sq.sq_id for sq in query.subqs if sq.kind == "join"]
    if join_ids:
        # Smallest threshold among join subQs, capped at the defaults.
        theta_p0[_IDX_S3] = min(float(theta_p_sub[join_ids, _IDX_S3].min()),
                                _CAP_S3_MB) if _CAP_S3_MB > 0 else 0.0
        theta_p0[_IDX_S4] = min(float(theta_p_sub[join_ids, _IDX_S4].min()),
                                _CAP_S4_MB)
    return theta_p0, theta_s0
