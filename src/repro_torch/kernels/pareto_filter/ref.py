"""Plain PyTorch version of the Pareto dominance-filter kernel."""
from __future__ import annotations

import torch

__all__ = ["pareto_mask_ref"]


def pareto_mask_ref(F: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Non-dominated mask over (n, k) minimization objectives.

    A row i is kept iff it is valid and no valid row j dominates it
    (F[j] <= F[i] element-wise with at least one strict <).  Compares in
    float32, like the kernel.
    """
    F = F.to(torch.float32)
    valid = valid.to(torch.bool)
    le = (F[:, None, :] <= F[None, :, :]).all(-1)     # (j, i): j <= i
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    dom = ((le & lt) & valid[:, None]).any(0)
    return valid & ~dom
