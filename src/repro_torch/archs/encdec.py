"""Encoder–decoder language model (the whisper-base backbone), as one
``nn.Module``.

The counterpart of the reference's ``archs/encdec.py``.  The audio
frontend is a stub: the model takes precomputed frame embeddings (B,
enc_seq, d_model).  The encoder is a bidirectional transformer over them
(RoPE over frame positions, no mask; its attention takes the flash kernel
when ``cfg.use_flash``), the decoder a causal transformer whose layers add
a cross-attention over the encoder output between self-attention and the
MLP.  That cross-attention is the reference's: a float32 einsum without
RoPE that projects the encoder output to K/V on every call, decode steps
included.  The decoder's self-attention keeps a KV cache for generation;
the encoder output is computed at prefill and carried in the cache as
``enc_out``.

Parameter names and layouts are the reference's (``embed``, ``lm_head``,
``norm_f``, ``norm_enc``, ``enc_layers.<i>.*`` and ``dec_layers.<i>.*``
with ``xattn``), so ``params_from_reference`` and ``params_to_reference``
(``archs/lm.py``) map its tree, whose layers are stacked on a leading L
axis, onto :meth:`EncDec.state_dict` and back.  Parameters are built
frozen, as :class:`~repro_torch.archs.lm.LM`'s are; with gradients on,
``cfg.remat == "block"`` recomputes each layer in the backward pass.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .act_sharding import gather_input, gather_weight, gather_weights
from .blocks import apply_attention, apply_mlp, init_attention, init_mlp
from .common import (ArchConfig, DTYPES, embed_tokens, init_dense,
                     merge_heads, rmsnorm, split_heads)
from .lm import _frozen, _params

__all__ = ["EncDec"]

Params = Dict[str, torch.Tensor]
Cache = Dict[str, Any]


def _xattn_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    dt = DTYPES[cfg.dtype]
    return {"wq": init_dense(gen, (d, h * dh), dt),
            "wk": init_dense(gen, (d, h * dh), dt),
            "wv": init_dense(gen, (d, h * dh), dt),
            "wo": init_dense(gen, (h * dh, d), dt,
                             scale=1.0 / math.sqrt(h * dh * 2 * cfg.n_layers))}


def _xattn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Cross-attention of (B, S, d) decoder states over (B, Se, d) encoder
    output: K/V projected from it on each call, every head attending every
    frame, logits and probabilities in float32."""
    p = gather_weights(p)
    x, enc_out = gather_input(x), gather_input(enc_out)
    B, S, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    Se = enc_out.shape[1]
    q = split_heads(x @ p["wq"], h, dh).transpose(1, 2)
    k = split_heads(enc_out @ p["wk"], h, dh).transpose(1, 2)
    v = split_heads(enc_out @ p["wv"], h, dh).transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(dh)
    w = torch.softmax(logits, dim=-1)
    y = torch.einsum("bhqk,bhkd->bhqd", w, v.to(torch.float32))
    y = merge_heads(y.to(x.dtype).transpose(1, 2))
    return y @ p["wo"]


class _EncLayer(nn.Module):
    """One pre-norm encoder layer: bidirectional attention, then the
    SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        self.ln_attn = _frozen(ones)
        self.ln_mlp = _frozen(ones.clone())
        self.attn = _params(init_attention(gen, cfg))
        self.mlp = _params(init_mlp(gen, cfg))

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        h, _ = apply_attention(cfg, self.attn,
                               rmsnorm(x, self.ln_attn, cfg.norm_eps),
                               positions, causal=False)
        x = x + h
        return x + apply_mlp(cfg, self.mlp,
                             rmsnorm(x, self.ln_mlp, cfg.norm_eps))


class _DecLayer(nn.Module):
    """One pre-norm decoder layer: causal self-attention (cache-aware),
    cross-attention over the encoder output, then the SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        self.ln_attn = _frozen(ones)
        self.ln_x = _frozen(ones.clone())
        self.ln_mlp = _frozen(ones.clone())
        self.attn = _params(init_attention(gen, cfg))
        self.xattn = _params(_xattn_init(gen, cfg))
        self.mlp = _params(init_mlp(gen, cfg))

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Cache],
                enc_out: torch.Tensor):
        h, new_cache = apply_attention(
            cfg, self.attn, rmsnorm(x, self.ln_attn, cfg.norm_eps), positions,
            cache=cache)
        x = x + h
        x = x + _xattn_apply(cfg, self.xattn,
                             rmsnorm(x, self.ln_x, cfg.norm_eps), enc_out)
        x = x + apply_mlp(cfg, self.mlp,
                          rmsnorm(x, self.ln_mlp, cfg.norm_eps))
        return x, new_cache


class EncDec(nn.Module):
    """Encoder–decoder LM: ``enc_layers`` encoder layers and ``norm_enc``
    over the frames; the token embedding, ``n_layers`` decoder layers,
    ``norm_f`` and the head over the tokens.

    Weights are drawn from ``generator`` on its device, in the order of
    the reference's parameter tree.  ``cfg`` is read on every call, as
    :class:`~repro_torch.archs.lm.LM` reads it.
    """

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: the {cfg.family} family is not "
                             "an encoder–decoder")
        dt = DTYPES[cfg.dtype]
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=generator.device)
        self.cfg = cfg
        self.embed = _frozen(init_dense(generator, (cfg.vocab, cfg.d_model),
                                        dt, 0.02))
        self.lm_head = _frozen(init_dense(generator, (cfg.d_model, cfg.vocab),
                                          dt))
        self.norm_f = _frozen(ones)
        self.norm_enc = _frozen(ones.clone())
        self.enc_layers = nn.ModuleList(_EncLayer(cfg, generator)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(_DecLayer(cfg, generator)
                                        for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _remat(self) -> bool:
        """Recompute a layer in the backward pass: ``remat="block"``, and
        an autograd graph is being built through the weights."""
        return (self.cfg.remat == "block" and torch.is_grad_enabled()
                and self.embed.requires_grad)

    def encode(self, frames) -> torch.Tensor:
        """(B, enc_seq, d_model) frame embeddings → the normed encoder
        output, in the model's dtype."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(DTYPES[cfg.dtype])
        B, Se, _ = x.shape
        positions = torch.arange(Se, device=self.device).expand(B, Se)
        for layer in self.enc_layers:
            if self._remat():
                x = checkpoint(layer, cfg, x, positions, use_reentrant=False)
            else:
                x = layer(cfg, x, positions)
        return rmsnorm(x, self.norm_enc, cfg.norm_eps)

    def forward(self, tokens, patches=None, caches: Optional[Cache] = None,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Logits (B, S or 1, V) and the cache {"enc_out", "dec"}.

        ``patches`` are the frames: given, they are (re)encoded; without
        them the encoder output is read from ``caches["enc_out"]``, and a
        call without either raises.  Without ``caches`` the decoder runs
        the cacheless forward (its self-attention takes the flash kernel
        when ``cfg.use_flash``); with them, the new tokens are written
        into ``caches["dec"]`` at their ``len``.
        """
        cfg = self.cfg
        if patches is not None:
            enc_out = self.encode(patches)
            dec_caches = None if caches is None else caches["dec"]
        else:
            if caches is None or "enc_out" not in caches:
                raise ValueError("decode without frames requires a "
                                 "prefilled cache")
            enc_out, dec_caches = caches["enc_out"], caches["dec"]
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        if dec_caches is not None and len(dec_caches) != len(self.dec_layers):
            raise ValueError(f"{len(dec_caches)} layer caches for "
                             f"{len(self.dec_layers)} decoder layers")
        x = embed_tokens(self.embed, tokens)
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(B, S)
        else:
            positions = torch.as_tensor(positions, device=self.device)
        new_dec: List[Cache] = []
        for i, layer in enumerate(self.dec_layers):
            if dec_caches is None and self._remat():
                x, c = checkpoint(layer, cfg, x, positions, None, enc_out,
                                  use_reentrant=False)
            else:
                x, c = layer(cfg, x, positions,
                             None if dec_caches is None else dec_caches[i],
                             enc_out)
            new_dec.append(c)
        if last_only:
            x = x[:, -1:]   # serve prefill: only next-token logits needed
        x = rmsnorm(x, self.norm_f, cfg.norm_eps)
        return x @ gather_weight(self.lm_head), {"enc_out": enc_out,
                                                  "dec": new_dec}

    def loss(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """Mean next-token cross entropy over labels ≥ 0 (float32), the
        frames in ``batch["patches"]``."""
        logits, _ = self(batch["tokens"], patches=batch["patches"])
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).to(torch.float32)
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """{"enc_out": (batch, enc_seq, d_model) zeros, "dec": one empty
        attention cache per decoder layer, (batch, Hkv, max_len, Dh) K and
        V buffers and ``len`` 0}."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        shape = (batch, cfg.n_kv, max_len, cfg.head_dim)

        def zeros(*s):
            return torch.zeros(s, dtype=dt, device=self.device)

        return {"enc_out": zeros(batch, cfg.enc_seq, cfg.d_model),
                "dec": [{"k": zeros(*shape), "v": zeros(*shape), "len": 0}
                        for _ in self.dec_layers]}
