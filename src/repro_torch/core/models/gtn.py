"""Graph Transformer Network embedder (paper §4.3, [6, 56]).

Multi-head self-attention over operator nodes with (i) learned per-head
additive biases on graph-structure flags (forward edge, backward edge, self)
and (ii) Laplacian positional encodings added to the input projection —
the Dwivedi–Bresson graph-transformer recipe.  Masked mean-pool over valid
nodes produces the plan embedding that feeds the regressor.

A ``torch.nn`` module with the batch axis written out (the reference maps
one graph through ``vmap``).  Parameter names follow the reference tree:
``in_proj``, ``pe_proj`` and ``layer{i}`` with ``qkv``, ``out``, ``bias``,
``ln1``, ``ln2``, ``ffn``.  These are plain tensor operations, not kernels.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .features import LAPPE_K, OP_FEAT_DIM
from .nn import Dense, LayerNorm, MLP

__all__ = ["GTNConfig", "GTN", "GTNLayer"]


@dataclasses.dataclass(frozen=True)
class GTNConfig:
    d_model: int = 48
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 96
    feat_dim: int = OP_FEAT_DIM
    pe_dim: int = LAPPE_K


class GTNLayer(nn.Module):
    def __init__(self, cfg: GTNConfig, *, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.qkv = Dense(d, 3 * d, generator=generator)
        self.out = Dense(d, d, generator=generator)
        self.bias = nn.Parameter(
            0.1 * torch.randn((cfg.n_heads, 3), generator=generator))
        self.ln1 = LayerNorm(d)
        self.ln2 = LayerNorm(d)
        self.ffn = MLP([d, cfg.d_ff, d], generator=generator)


class GTN(nn.Module):
    def __init__(self, cfg: GTNConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.in_proj = Dense(cfg.feat_dim, cfg.d_model, generator=generator)
        self.pe_proj = Dense(cfg.pe_dim, cfg.d_model, generator=generator,
                             scale=0.5)
        for i in range(cfg.n_layers):
            self.add_module(f"layer{i}", GTNLayer(cfg, generator=generator))

    def forward(self, X: torch.Tensor, pe: torch.Tensor, bias: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """(B, N, ·) graphs -> (B, d_model) embeddings.

        X: (B, N, F), pe: (B, N, K), bias: (B, N, N, 3) structure flags,
        mask: (B, N) bool node validity.
        """
        cfg = self.cfg
        B, N = X.shape[:2]
        H = cfg.n_heads
        dh = cfg.d_model // H
        h = self.in_proj(X) + self.pe_proj(pe)
        # A fill on the device: torch.tensor(-1e9, device=...) would copy
        # from the host and wait for the card on every forward.
        neg = torch.full((), -1e9, dtype=h.dtype, device=h.device)
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        attn_mask = torch.where(mask, zero, neg)[:, None, None, :]  # keys
        for i in range(cfg.n_layers):
            lp = getattr(self, f"layer{i}")
            hn = lp.ln1(h)
            qkv = lp.qkv(hn).reshape(B, N, 3, H, dh)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B,N,H,dh)
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dh)
            struct = torch.einsum("bnmf,hf->bhnm", bias, lp.bias)
            logits = logits + struct + attn_mask
            w = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(
                B, N, cfg.d_model)
            h = h + lp.out(ctx)
            hn = lp.ln2(h)
            h = h + lp.ffn(hn)
        w = mask.to(h.dtype)
        return (h * w[..., None]).sum(1) / torch.clamp(w.sum(1), min=1.0)[:, None]
