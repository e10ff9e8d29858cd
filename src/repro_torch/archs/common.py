"""Shared architecture machinery: the configuration, primitive layers, init.

The counterpart of the reference's ``archs/common.py`` for one card.
:class:`ArchConfig` is carried over field for field, so a configuration
means the same thing on both sides.  On one card ``dtype``, ``use_flash``,
``window`` and ``remat`` act (``remat="block"`` when the model trains);
``moment_dtype`` and ``train_accum`` are read by the training entry points.
The sharding knobs (``act_shard_model``, ``act_shard``, ``pure_dp``) are
kept but have no effect: the port runs on one card without a mesh, and
the reference's GSPMD sharding rules (``param_specs``, ``batch_axes``) are
not ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ArchConfig", "rmsnorm", "rope", "init_dense", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture's full configuration (see ``repro_torch/configs/``)."""

    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 → d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # Hybrid (jamba): attention layer every `attn_every` layers (else mamba);
    # MoE MLP every `moe_every` layers (else dense MLP).
    attn_every: int = 0
    moe_every: int = 0
    # Mamba (S6)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # RWKV6
    rwkv_head_dim: int = 64
    # Encoder–decoder (whisper): encoder layers + stub frontend length.
    enc_layers: int = 0
    enc_seq: int = 0
    cross_attention: bool = False
    # VLM: stub patch embeddings prepended to the token stream.
    n_patches: int = 0
    # Misc
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # Execution knobs.  On one card the sharding knobs do not act.
    dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: str = "block"         # none | block (recompute layers in backward)
    use_flash: bool = False      # hand-written flash-attention kernel
    window: int = 0              # sliding-window attention (0 = full)
    act_shard_model: bool = True
    act_shard: str = ""          # "" → derived from act_shard_model
    train_accum: int = 1
    rwkv_impl: str = "scan"      # "scan" (per-step) | "chunked" (GLA form)
    rwkv_chunk: int = 64
    pure_dp: bool = False

    @property
    def carry_sharding(self) -> str:
        if self.act_shard:
            return self.act_shard
        return "model" if self.act_shard_model else "none"
    # Which shapes this arch supports.
    supports_long: bool = False
    decoder_only: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_params_dense(self) -> float:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        mlp = 3 * d * f
        per_layer = attn + mlp
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * g).to(x.dtype)


@functools.cache
def _rope_freqs(half: int, theta: float, device: torch.device
                ) -> torch.Tensor:
    """The rotary frequencies, computed in float64 numpy as the reference
    does and kept in float32 on ``device``.  Cached: a copy from pageable
    host memory waits for the card, and a decode step would otherwise
    make two such copies in every layer.  Callers only read the tensor."""
    freqs = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.from_numpy(freqs).to(device=device, dtype=torch.float32)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, Dh), positions: (..., S).

    As the reference rounds: the frequencies in float64 numpy, the angles
    in float32, and cos/sin cast to ``x``'s dtype before the products.
    """
    dh = x.shape[-1]
    half = dh // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)            # (..., S,1,half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def init_dense(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale²) weights (default 1/√fan_in) in ``dtype``, drawn in
    float32 on the generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * float(s)).to(dtype)
