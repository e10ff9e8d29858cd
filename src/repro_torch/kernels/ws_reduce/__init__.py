"""Weighted-sum kernels: the bank reduction and a runtime round's picks
(public wrappers in ops.py)."""
from .ops import runtime_pick, runtime_pick_ref, ws_reduce, ws_reduce_ref

__all__ = ["ws_reduce", "ws_reduce_ref", "runtime_pick", "runtime_pick_ref"]
