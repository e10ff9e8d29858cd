"""Pareto dominance-filter kernel (public wrappers in ops.py)."""
from .ops import (pareto_filter, pareto_filter_segments, pareto_mask_ref,
                  pareto_masks_ref)

__all__ = ["pareto_filter", "pareto_filter_segments", "pareto_mask_ref",
           "pareto_masks_ref"]
