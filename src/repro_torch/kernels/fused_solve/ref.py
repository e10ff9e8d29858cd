"""Plain PyTorch version of the fused HMOOC2 aggregation kernel."""
from __future__ import annotations

from typing import Tuple

import torch

from ..pareto_filter.ref import pareto_mask_ref
from ..ws_reduce.ref import ws_reduce_ref

__all__ = ["fused_ws_front_ref", "local_mask_ref"]


def local_mask_ref(P: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-dominated mask over each candidate's (nw, k) weight picks.

    P: (N, nw, k), v: (N, nw) bool → (N, nw) bool, comparing in P's dtype.
    """
    le = (P[:, :, None, :] <= P[:, None, :, :]).all(-1)   # (N, j, i): j <= i
    lt = (P[:, :, None, :] < P[:, None, :, :]).any(-1)
    dom = ((le & lt) & v[:, :, None]).any(1)
    return v & ~dom


def fused_ws_front_ref(Fn: torch.Tensor, F_bank: torch.Tensor,
                       W: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, m, B, k) normalized scores + raw banks + (nw, k) weights →
    (jj (N, nw, m) int32, P_all (N, nw, k) float64, keep (N, nw) bool).

    The weighted-sum picks and the global dominance filter compare in
    float32; the gather, its sum over subQs (left to right) and the
    per-candidate mask over the weight picks keep float64.
    """
    N, m, B, k = F_bank.shape
    nw = W.shape[0]
    _, idx = ws_reduce_ref(Fn.reshape(N * m, B, k), W)     # (nw, N*m)
    jj = idx.reshape(nw, N, m).permute(1, 0, 2)           # (N, nw, m)
    cc = torch.arange(N, device=F_bank.device)[:, None, None]
    ii = torch.arange(m, device=F_bank.device)[None, None, :]
    G = F_bank.to(torch.float64)[cc, ii, jj.long()]       # (N, nw, m, k)
    P_all = G[:, :, 0]
    for i in range(1, m):
        P_all = P_all + G[:, :, i]
    ok = torch.isfinite(G).all(-1).all(-1)                # (N, nw)
    valid = ok & local_mask_ref(P_all, ok)
    keep = pareto_mask_ref(P_all.reshape(N * nw, k).to(torch.float32),
                           valid.reshape(-1)).reshape(N, nw)
    return jj.contiguous(), P_all, keep
