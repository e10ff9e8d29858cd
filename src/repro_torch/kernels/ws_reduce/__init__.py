"""Weighted-sum bank-reduction kernel (public wrapper in ops.py)."""
from .ops import ws_reduce, ws_reduce_ref

__all__ = ["ws_reduce", "ws_reduce_ref"]
