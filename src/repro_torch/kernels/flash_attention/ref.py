"""Plain PyTorch version of the flash-attention kernel (GQA + causal)."""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, causal: bool = True) -> torch.Tensor:
    """Reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q's dtype; the products and the softmax run
    in float32.  Causal masking aligns the ends: query i sees keys
    ≤ i + (Skv − Sq).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vf = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    qf = q.to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(D)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Skv, device=q.device)[None, :]
        mask = kj <= qi + (Skv - Sq)
        logits.masked_fill_(~mask, float("-inf"))
    # In place: at the serving shape the logits alone take 2 GB.
    w = logits.sub_(logits.amax(-1, keepdim=True)).exp_()
    w.div_(w.sum(-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", w, vf)
    return out.to(q.dtype)
