"""Minimal neural-net building blocks as ``torch.nn`` modules.

Each module mirrors a function of the JAX reference and keeps its
parameter names and layouts, so a reference parameter tree maps onto the
module's ``state_dict`` one leaf per key:

* :class:`Dense` — ``x @ w + b`` with ``w`` stored ``(d_in, d_out)``;
* :class:`LayerNorm` — ``g``/``b``, population variance, eps 1e-5;
* :class:`MLP` — ``l0 … l{n-1}`` dense layers with tanh-approximate GELU
  between them (``jax.nn.gelu``'s default);
* :func:`adamw` — the reference's ``adamw_init``/``adamw_update`` pair as a
  ``torch.optim.AdamW`` with the same settings.

Initialisation draws from an explicit ``torch.Generator`` on the host;
``torch`` and ``jax`` give different numbers from one seed, so parity tests
carry weights across instead of comparing two seeded inits.

Float32 matrix products must not run in TF32 on the card: TF32 keeps about
three decimal digits and would cost the float32 parity with the reference.
:func:`disable_tf32` sets both (process-wide) PyTorch switches; the model
calls it once, when it is built.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["Dense", "LayerNorm", "MLP", "gelu", "disable_tf32", "adamw"]


def disable_tf32() -> None:
    """Full float32 for matmuls and convolutions (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 scale: float = 1.0):
        super().__init__()
        w = torch.randn((d_in, d_out), generator=generator) \
            * (scale / math.sqrt(d_in))
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d))
        self.b = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + self.eps) * self.g + self.b


class MLP(nn.ModuleDict):
    def __init__(self, dims: Sequence[int], *, generator: torch.Generator):
        super().__init__({f"l{i}": Dense(dims[i], dims[i + 1],
                                         generator=generator)
                          for i in range(len(dims) - 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self)
        for i in range(n):
            x = self[f"l{i}"](x)
            if i < n - 1:
                x = gelu(x)
        return x


def adamw(params, lr: float = 0.0) -> torch.optim.AdamW:
    """AdamW with the reference's settings (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4).

    ``torch.optim.AdamW`` makes the reference's update: bias correction on
    both moments, and weight decay decoupled from the gradient and scaled by
    the learning rate, ``p -= lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``.  It
    computes the bias corrections in Python floats where the reference
    takes them in float32, so the two differ in the last bits.  A caller
    that follows a schedule sets ``param_groups[i]["lr"]`` before each step.
    """
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
