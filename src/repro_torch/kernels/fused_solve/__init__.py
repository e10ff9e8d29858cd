"""Fused HMOOC2 aggregation kernel (public wrapper in ops.py)."""
from .ops import fused_ws_front, fused_ws_front_ref, hmooc2_scores_ref

__all__ = ["fused_ws_front", "fused_ws_front_ref", "hmooc2_scores_ref"]
