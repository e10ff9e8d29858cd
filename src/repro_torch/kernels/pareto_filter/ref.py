"""Plain PyTorch version of the Pareto dominance-filter kernel."""
from __future__ import annotations

import torch

__all__ = ["pareto_mask_ref", "pareto_masks_ref"]


def pareto_masks_ref(F: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Non-dominated masks of S independent (n, k) minimization segments.

    ``F`` is (S, n, k), ``valid`` (S, n).  Row i of segment s is kept iff
    it is valid and no valid row j of the same segment dominates it
    (F[s, j] <= F[s, i] element-wise with at least one strict <).
    Compares in float32, like the kernel.
    """
    F = F.to(torch.float32)
    valid = valid.to(torch.bool)
    le = (F[:, :, None, :] <= F[:, None, :, :]).all(-1)   # (s, j, i): j <= i
    lt = (F[:, :, None, :] < F[:, None, :, :]).any(-1)
    dom = ((le & lt) & valid[:, :, None]).any(1)
    return valid & ~dom


def pareto_mask_ref(F: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """:func:`pareto_masks_ref` of one (n, k) segment."""
    return pareto_masks_ref(F[None], valid[None])[0]
