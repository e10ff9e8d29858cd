"""Transformer blocks of the dense family: attention (GQA + RoPE) and the
SwiGLU MLP, cache-aware.

The counterpart of the reference's ``archs/blocks.py`` for what the dense
family runs.  Conventions:

* ``init_*`` returns the parameter dict of ONE layer, drawn from an
  explicit ``torch.Generator``; the model wraps it in a module.
* ``apply_*`` take ``(cfg, params, x, ...)`` and, for attention, an
  optional per-layer cache; they return ``(y, new_cache)``.
* A cache holds fixed-capacity buffers and a scalar ``len``.  The port
  writes new entries into the buffers in place (the reference's serving
  functions donate the cache, so the old one is never read again) and
  raises where the reference's ``dynamic_update_slice`` would clamp.
* Attention uses the einsum path by default and the hand-written
  flash-attention kernel on the cacheless forward when ``cfg.use_flash``.

The reference's activation-sharding constraints are no-ops without a mesh
and are dropped.  Cross-attention (the audio family), MoE, Mamba and RWKV
blocks come with the slices that port those families.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from .common import ArchConfig, DTYPES, init_dense, rope

Params = Dict[str, torch.Tensor]
NEG = -1e30

__all__ = ["init_attention", "apply_attention", "init_mlp", "apply_mlp"]


# ---------------------------------------------------------------------------
# Attention (GQA + RoPE + optional sliding window)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = DTYPES[cfg.dtype]
    p = {
        "wq": init_dense(gen, (d, hq * dh), dt),
        "wk": init_dense(gen, (d, hkv * dh), dt),
        "wv": init_dense(gen, (d, hkv * dh), dt),
        "wo": init_dense(gen, (hq * dh, d), dt,
                         scale=1.0 / math.sqrt(hq * dh * 2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dt, device=gen.device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dt, device=gen.device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dt, device=gen.device)
    return p


# Above this many logit elements the einsum path switches to the KV/Q
# chunked online-softmax path.
_CHUNK_THRESHOLD = 1 << 26


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, kv_len: Optional[int],
            q_start: Optional[int] = None, use_flash: bool) -> torch.Tensor:
    """q: (B, Hq, Sq, Dh); k/v: (B, Hkv, Skv, Dh) → (B, Hq, Sq, Dh).

    ``q_start`` is the absolute key index of query row 0 (defaults to the
    aligned-ends convention Skv − Sq); ``kv_len`` masks cache slots ≥ len.
    """
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if use_flash and kv_len is None and window == 0:
        return flash_attention(q, k, v, causal=causal)
    if Sq * Skv > _CHUNK_THRESHOLD and Sq > 1:
        return _attend_chunked(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, q_start=q_start)
    group = Hq // Hkv
    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          kr.to(torch.float32)) / math.sqrt(Dh)
    # Additive (Sq, Skv) float32 mask, as the reference builds it.
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    if q_start is None:
        q_start = Skv - Sq
    add = torch.zeros((Sq, Skv), dtype=torch.float32, device=q.device)
    if causal:
        add = add + torch.where(kj <= qi + q_start, 0.0, NEG)
    if window > 0:
        add = add + torch.where(kj > qi + q_start - window, 0.0, NEG)
    if kv_len is not None:                      # decode: valid cache prefix
        add = add + torch.where(kj < kv_len, 0.0, NEG)
    logits = logits + add[None, None]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vr.to(torch.float32))
    return out.to(q.dtype)


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, kv_len: Optional[int],
                    q_start: Optional[int], bq: int = 1024, bk: int = 4096
                    ) -> torch.Tensor:
    """Online-softmax attention, chunked over Q and KV (flash in PyTorch).

    Logit residency drops from O(Sq·Skv) to O(bq·bk) per step.  The two
    Python loops take the place of the reference's two scans; the
    arithmetic per chunk is the same.
    """
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    if q_start is None:
        q_start = Skv - Sq
    kp = F.pad(kr, (0, 0, 0, (-Skv) % bk))
    vp = F.pad(vr, (0, 0, 0, (-Skv) % bk))
    scale = 1.0 / math.sqrt(Dh)
    limit = kv_len if kv_len is not None else Skv
    dev = q.device
    outs = []
    for qi0 in range(0, Sq, bq):
        qf = F.pad(q[:, :, qi0:qi0 + bq],
                   (0, 0, 0, max(0, qi0 + bq - Sq))).to(torch.float32)
        qi = qi0 + torch.arange(bq, device=dev)[:, None]
        m = torch.full((B, Hq, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hq, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hq, bq, Dh), dtype=torch.float32, device=dev)
        for kj0 in range(0, kp.shape[2], bk):
            s = torch.einsum("bhqd,bhkd->bhqk", qf,
                             kp[:, :, kj0:kj0 + bk].to(torch.float32)) * scale
            kj = kj0 + torch.arange(bk, device=dev)[None, :]
            add = torch.where(kj < limit, 0.0, NEG)
            if causal:
                add = add + torch.where(kj <= qi + q_start, 0.0, NEG)
            if window > 0:
                add = add + torch.where(kj > qi + q_start - window, 0.0, NEG)
            s = s + add[None, None]
            m_cur = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vp[:, :, kj0:kj0 + bk].to(torch.float32))
            m = m_cur
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :Sq]


def apply_attention(cfg: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor,
                    cache: Optional[Dict[str, Any]] = None,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Self-attention with an optional KV cache.

    cache: {"k": (B, Hkv, C, Dh), "v": ..., "len": int} — the new entries
    are written at ``len`` and attention covers the valid prefix.  Without
    a cache the layer's K/V come back as a cache of exactly S entries.
    """
    B, S, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, hq, dh)
    q = rope(q, positions, cfg.rope_theta).transpose(1, 2)

    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(B, S, hkv, dh)
    v = v.reshape(B, S, hkv, dh)
    k = rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        y = _attend(q, k, v, causal=causal, window=cfg.window, kv_len=None,
                    use_flash=cfg.use_flash)
        y = y.transpose(1, 2).reshape(B, S, hq * dh)
        return y @ p["wo"], {"k": k, "v": v, "len": S}

    # Cache path: append S new entries at cache["len"] (prefill into the
    # buffer when S > 1, single-token decode when S == 1).
    C = cache["k"].shape[2]
    idx = int(cache["len"])
    if S >= C:
        # Windowed prefill longer than the (rolling) cache: attend over the
        # in-flight K/V and retain only the last C entries.
        y = _attend(q, k, v, causal=causal, window=cfg.window, kv_len=None,
                    use_flash=cfg.use_flash)
        y = y.transpose(1, 2).reshape(B, S, hq * dh)
        return y @ p["wo"], {"k": k[:, :, S - C:], "v": v[:, :, S - C:],
                             "len": C}
    if not 0 <= idx <= C - S:
        raise ValueError(f"KV cache overflow: {S} new entries at {idx} do "
                         f"not fit a capacity of {C}")
    ck, cv = cache["k"], cache["v"]
    ck[:, :, idx:idx + S] = k
    cv[:, :, idx:idx + S] = v
    kv_len = idx + S
    y = _attend(q, ck, cv, causal=causal, q_start=idx, window=cfg.window,
                kv_len=kv_len, use_flash=False)
    y = y.transpose(1, 2).reshape(B, S, hq * dh)
    return y @ p["wo"], {"k": ck, "v": cv, "len": kv_len}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = DTYPES[cfg.dtype]
    return {
        "w_gate": init_dense(gen, (d, f), dt),
        "w_up": init_dense(gen, (d, f), dt),
        "w_down": init_dense(gen, (f, d), dt,
                             scale=1.0 / math.sqrt(f * 2 * cfg.n_layers)),
    }


def apply_mlp(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
