"""Plain PyTorch version of the weighted-sum bank-reduction kernel."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ws_reduce_ref", "ws_scores"]


def ws_scores(W: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """float32 scores ``W[w] · F[..., b, :]`` → (nw, *F.shape[:-1]).

    The k terms are multiplied and added one at a time, left to right, in
    float32 — the kernel's order, so both round alike.
    """
    W = W.to(torch.float32)
    F = F.to(torch.float32)
    lead = (W.shape[0],) + (1,) * (F.dim() - 1)
    s = W[:, 0].reshape(lead) * F[..., 0]
    for c in range(1, F.shape[-1]):
        s = s + W[:, c].reshape(lead) * F[..., c]
    return s


def ws_reduce_ref(F: torch.Tensor, W: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(weight, bank) weighted argmin over solution banks.

    F: (m, B, k) objective banks (minimization).  W: (nw, k) weights.
    Returns (vals (nw, m) float32, idx (nw, m) int32): the least score and
    its first index (ties go to the lowest index, as ``jnp.argmin``).
    """
    vals, idx = torch.min(ws_scores(W, F), dim=-1)
    return vals, idx.to(torch.int32)
