"""Plain PyTorch version of the fused HMOOC2 aggregation kernel."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..pareto_filter.ref import pareto_mask_ref
from ..ws_reduce.ref import ws_reduce_ref

__all__ = ["fused_ws_front_ref", "hmooc2_scores_ref", "local_mask_ref"]


def hmooc2_scores_ref(F_bank: torch.Tensor) -> torch.Tensor:
    """(N, m, B, k) raw banks → float32 scores, bit-equal to the solver's
    ``nan_to_num(_hmooc2_normalize(F_bank).astype(float32), posinf=1e30)``.

    Each candidate's bank is normalised per objective over its finite
    entries: ``(F - lo) / span`` in float64 with ``span = hi - lo`` if
    ``hi > lo`` else 1 (a candidate with no finite entry has lo = +inf,
    hi = -inf, span 1); non-finite entries score 1e18.
    """
    F = F_bank.to(torch.float64)
    finite = torch.isfinite(F)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=F.device)
    lo = torch.where(finite, F, inf).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(finite, F, -inf).amax(dim=(1, 2), keepdim=True)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    Fn = torch.where(finite, (F - lo) / span,
                     torch.full_like(F, 1e18))
    return torch.nan_to_num(Fn.to(torch.float32), posinf=1e30)


def local_mask_ref(P: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-dominated mask over each candidate's (nw, k) weight picks.

    P: (N, nw, k), v: (N, nw) bool → (N, nw) bool, comparing in P's dtype.
    """
    le = (P[:, :, None, :] <= P[:, None, :, :]).all(-1)   # (N, j, i): j <= i
    lt = (P[:, :, None, :] < P[:, None, :, :]).any(-1)
    dom = ((le & lt) & v[:, :, None]).any(1)
    return v & ~dom


def fused_ws_front_ref(Fn: Optional[torch.Tensor], F_bank: torch.Tensor,
                       W: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, m, B, k) scores (or ``None``: :func:`hmooc2_scores_ref` of the
    bank) + raw banks + (nw, k) weights → (jj (N, nw, m) int32, P_all
    (N, nw, k) float64, keep (N, nw) bool).

    Given scores are cast to float32 and passed through
    ``nan_to_num(posinf=1e30)``.  The weighted-sum picks and the global
    dominance filter compare in float32; the gather, its sum over subQs
    (left to right) and the per-candidate mask over the weight picks keep
    float64.
    """
    N, m, B, k = F_bank.shape
    nw = W.shape[0]
    Fn = (hmooc2_scores_ref(F_bank) if Fn is None
          else torch.nan_to_num(Fn.to(torch.float32), posinf=1e30))
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
