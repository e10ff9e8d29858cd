"""Pareto dominance-filter kernel (public wrapper in ops.py)."""
from .ops import pareto_filter, pareto_mask_ref

__all__ = ["pareto_filter", "pareto_mask_ref"]
