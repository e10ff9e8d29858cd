"""The 19 Spark parameters of the paper (Table 6), in three categories.

Raw units: memory/sizes in MB, fractions in [0,1], counts as integers.
Defaults follow Spark 3.5.0 documentation (the paper's "default configuration").
"""
from __future__ import annotations

from .spaces import Param, ParamSpace

__all__ = [
    "theta_c_space",
    "theta_p_space",
    "theta_s_space",
    "THETA_C",
    "THETA_P",
    "THETA_S",
]

# --------------------------------------------------------------------------
# θc — context parameters (set at Spark-context initialization)
# --------------------------------------------------------------------------
THETA_C = [
    Param("spark.executor.cores", "int", 1, 8, default=2),                       # k1
    Param("spark.executor.memory", "int", 1, 32, log=True, default=4),           # k2 (GB)
    Param("spark.executor.instances", "int", 2, 20, default=4),                  # k3
    Param("spark.default.parallelism", "int", 8, 512, log=True, default=40),     # k4
    Param("spark.reducer.maxSizeInFlight", "int", 8, 256, log=True, default=48), # k5 (MB)
    Param("spark.shuffle.sort.bypassMergeThreshold", "int", 50, 1000, default=200),  # k6
    Param("spark.shuffle.compress", "bool", default=1),                          # k7
    Param("spark.memory.fraction", "float", 0.4, 0.9, default=0.6),              # k8
]

# --------------------------------------------------------------------------
# θp — logical-query-plan parameters (AQE parametric rules on LQP)
# --------------------------------------------------------------------------
THETA_P = [
    Param("spark.sql.adaptive.advisoryPartitionSizeInBytes", "int", 8, 512, log=True, default=64),   # s1 (MB)
    Param("spark.sql.adaptive.nonEmptyPartitionRatioForBroadcastJoin", "float", 0.0, 1.0, default=0.2),  # s2
    Param("spark.sql.adaptive.maxShuffledHashJoinLocalMapThreshold", "int", 0, 1024, default=0),     # s3 (MB)
    Param("spark.sql.adaptive.autoBroadcastJoinThreshold", "int", 0, 1024, default=10),              # s4 (MB)
    Param("spark.sql.shuffle.partitions", "int", 8, 2048, log=True, default=200),                    # s5
    Param("spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes", "int", 16, 1024, log=True, default=256),  # s6 (MB)
    Param("spark.sql.adaptive.skewJoin.skewedPartitionFactor", "int", 2, 10, default=5),             # s7
    Param("spark.sql.files.maxPartitionBytes", "int", 16, 1024, log=True, default=128),              # s8 (MB)
    Param("spark.sql.files.openCostInBytes", "int", 1, 64, log=True, default=4),                     # s9 (MB)
]

# --------------------------------------------------------------------------
# θs — query-stage parameters (AQE parametric rules on QS)
# --------------------------------------------------------------------------
THETA_S = [
    Param("spark.sql.adaptive.rebalancePartitionsSmallPartitionFactor", "float", 0.1, 0.9, default=0.2),  # s10
    Param("spark.sql.adaptive.coalescePartitions.minPartitionSize", "int", 1, 64, log=True, default=1),   # s11 (MB)
]


def theta_c_space() -> ParamSpace:
    return ParamSpace(THETA_C)


def theta_p_space() -> ParamSpace:
    return ParamSpace(THETA_P)


def theta_s_space() -> ParamSpace:
    return ParamSpace(THETA_S)
