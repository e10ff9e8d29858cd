"""Blocks of the language models: attention (GQA + RoPE, self- or
cross-), the SwiGLU MLP, the top-k capacity MoE MLP, the Mamba (S6)
selective scan and RWKV-6's time and channel mix, cache-aware.

The counterpart of the reference's ``archs/blocks.py``.  Conventions:

* ``init_*`` returns the parameter dict of ONE layer, drawn from an
  explicit ``torch.Generator``; the model wraps it in a module.
* ``apply_*`` take ``(cfg, params, x, ...)`` and, for attention, Mamba
  and the RWKV time mix, an optional per-layer cache or state; they
  return ``(y, new_cache)``.
* A cache holds fixed-capacity buffers and a scalar ``len``.  The port
  writes new entries into the buffers in place (the reference's serving
  functions donate the cache, so the old one is never read again) and
  raises where the reference's ``dynamic_update_slice`` would clamp.
* Attention uses the einsum path by default and the hand-written
  flash-attention kernel on the cacheless forward when ``cfg.use_flash``.

Under a registered mesh (``archs/act_sharding``) each layer takes its
weights gathered along the batch axes (``gather_weights``), attention
shards its DTensor queries as the reference's ``_shard_attn_acts`` does,
the flash kernel runs on each rank's own heads and the chunked route's
loop on each rank's own rows; without one, or on plain tensors, none of
this changes anything.
``apply_attention(xattn_kv=...)`` attends precomputed K/V non-causally,
as the reference's does; the encoder–decoder's own cross-attention
(``archs/encdec.py``) is the reference's float32 einsum and does not
call it.  The recurrent blocks keep the reference's
semantics, which are not the published models': RWKV-6 has no bonus
``u`` term and its output at step t reads the state before token t's
kᵀv; Mamba materialises its (B, S, din, N) float32 decays and inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.flash_attention.ops import flash_attention
from .act_sharding import (BATCH_AXES, constrain, gather_input,
                           gather_weights, get_activation_mesh, get_pure_dp)
from .common import (ArchConfig, DTYPES, init_dense, merge_heads, mesh_sizes,
                     rope, split_heads)

Params = Dict[str, torch.Tensor]
NEG = -1e30

__all__ = ["init_attention", "apply_attention", "init_mlp", "apply_mlp",
           "init_moe", "apply_moe", "moe_capacity", "moe_gates",
           "moe_route", "MoeRoute", "init_mamba", "apply_mamba",
           "init_rwkv", "apply_rwkv_time", "apply_rwkv_channel",
           "rwkv_wkv_chunked"]


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


def _shard_attn_acts(x: torch.Tensor) -> torch.Tensor:
    """Shard (B, H, S, D) attention activations: heads→model when the head
    count divides the axis, else sequence→model (sequence parallelism);
    pure-DP jobs shard batch over the whole mesh instead."""
    mesh = get_activation_mesh()
    if mesh is None:
        return x
    if get_pure_dp():
        return constrain(x, BATCH_AXES + ("model",), None, None, None)
    m = mesh_sizes(mesh).get("model", 1)
    if x.shape[1] % m == 0:
        return constrain(x, BATCH_AXES, "model", None, None)
    if x.shape[2] % m == 0:
        return constrain(x, BATCH_AXES, None, "model", None)
    return constrain(x, BATCH_AXES, None, None, None)


def _flash_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """The flash kernel on DTensor q, k, v: each rank attends its own
    heads.  As ``_shard_attn_acts`` splits q, heads go to 'model' (batch
    to the batch axes), but only when both the query and the KV head
    counts divide it, so that query head b's KV head b // group lies on
    the same rank; otherwise the heads are whole on every rank (the
    sequence is never split: the causal mask spans it)."""
    mesh = get_activation_mesh()
    m = mesh_sizes(mesh).get("model", 1)
    if get_pure_dp():
        spec = (BATCH_AXES + ("model",), None, None, None)
    else:
        heads = "model" if q.shape[1] % m == 0 and k.shape[1] % m == 0 \
            else None
        spec = (BATCH_AXES, heads, None, None)
    q, k, v = (constrain(t, *spec) for t in (q, k, v))
    attend = local_map(
        lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal),
        out_placements=list(q.placements),
        in_placements=(list(q.placements), list(k.placements),
                       list(v.placements)),
        device_mesh=mesh)
    return attend(q, k, v)


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
        if isinstance(q, DTensor):
            return _flash_local(q, k, v, causal)
        return flash_attention(q, k, v, causal=causal)
    q = _shard_attn_acts(q)
    if Sq * Skv > _CHUNK_THRESHOLD and Sq > 1:
        chunked = _chunked_local if isinstance(q, DTensor) \
            else _attend_chunked
        return chunked(q, k, v, causal=causal, window=window,
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
    kr = torch.repeat_interleave(k, group, dim=1) if group > 1 else k
    vr = torch.repeat_interleave(v, group, dim=1) if group > 1 else v
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


def _chunked_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int, kv_len: Optional[int],
                   q_start: Optional[int]) -> torch.Tensor:
    """:func:`_attend_chunked` on DTensor q, k, v: each rank runs the chunk
    loop on plain tensors, its own rows of q as ``_shard_attn_acts`` split
    them (batch, heads or sequence) against K/V repeated to the query
    heads and split as q is but whole along the sequence.  On DTensors the
    loop's dozens of ops a chunk would each go through DTensor's dispatch
    (a 32k-token prefill makes some 300 chunks a layer).  A rank whose q
    rows are a slice of the sequence starts its causal mask at that
    slice's offset."""
    mesh = q.device_mesh
    Sq, Skv = q.shape[2], k.shape[2]
    if q_start is None:
        q_start = Skv - Sq
    group = q.shape[1] // k.shape[1]
    q_pl = list(q.placements)
    kv_pl = [Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl
             for pl in q_pl]
    k, v = ((torch.repeat_interleave(t, group, dim=1) if group > 1 else t)
            .redistribute(mesh, kv_pl) for t in (k, v))
    seq = [i for i, pl in enumerate(q_pl)
           if isinstance(pl, Shard) and pl.dim == 2]     # 'model' alone

    def attend(ql, kl, vl):
        off = mesh.get_coordinate()[seq[0]] * ql.shape[2] if seq else 0
        return _attend_chunked(ql, kl, vl, causal=causal, window=window,
                               kv_len=kv_len, q_start=q_start + off)

    return local_map(attend, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=mesh)(q, k, v)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, idx: int
                 ) -> torch.Tensor:
    """``new`` (B, H, S, Dh) written into ``buf`` at slots idx … idx + S − 1,
    in place; returns the buffer.  A DTensor buffer whose slots are split
    over ranks (the sequence fallback of ``cache_shardings``) cannot take
    a slice in place: it is gathered along the slots, written, and split
    again, a new DTensor."""
    if isinstance(buf, DTensor) and any(
            isinstance(pl, Shard) and pl.dim == 2 for pl in buf.placements):
        mesh, placed = buf.device_mesh, buf.placements
        whole = buf.redistribute(mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl
            for pl in placed])
        whole[:, :, idx:idx + new.shape[2]] = new
        return whole.redistribute(mesh, placed)
    buf[:, :, idx:idx + new.shape[2]] = new
    return buf


def apply_attention(cfg: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor,
                    cache: Optional[Dict[str, Any]] = None,
                    xattn_kv: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self- (or cross-) attention with an optional KV cache.

    cache: {"k": (B, Hkv, C, Dh), "v": ..., "len": int} — the new entries
    are written at ``len`` and attention covers the valid prefix.  Without
    a cache the layer's K/V come back as a cache of exactly S entries.
    ``xattn_kv`` = (k, v), each (B, Hkv, Se, Dh), supplies precomputed
    encoder K/V: the queries attend all of them (no mask, the flash route
    when ``cfg.use_flash``) and ``cache`` comes back unchanged.
    """
    p = gather_weights(p)
    x = gather_input(x)
    B, S, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = split_heads(q, hq, dh)
    q = rope(q, positions, cfg.rope_theta).transpose(1, 2)

    if xattn_kv is not None:
        k, v = xattn_kv
        y = _attend(q, k, v, causal=False, window=0, kv_len=None,
                    use_flash=cfg.use_flash)
        return merge_heads(y.transpose(1, 2)) @ p["wo"], cache

    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = split_heads(k, hkv, dh)
    v = split_heads(v, hkv, dh)
    k = rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        y = _attend(q, k, v, causal=causal, window=cfg.window, kv_len=None,
                    use_flash=cfg.use_flash)
        y = merge_heads(y.transpose(1, 2))
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
        y = merge_heads(y.transpose(1, 2))
        return y @ p["wo"], {"k": k[:, :, S - C:], "v": v[:, :, S - C:],
                             "len": C}
    if not 0 <= idx <= C - S:
        raise ValueError(f"KV cache overflow: {S} new entries at {idx} do "
                         f"not fit a capacity of {C}")
    ck = _cache_write(cache["k"], k, idx)
    cv = _cache_write(cache["v"], v, idx)
    kv_len = idx + S
    y = _attend(q, ck, cv, causal=causal, q_start=idx, window=cfg.window,
                kv_len=kv_len, use_flash=False)
    y = merge_heads(y.transpose(1, 2))
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
    p = gather_weights(p)
    x = gather_input(x)
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE MLP (top-k dispatch with capacity)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """The router (float32 whatever ``cfg.dtype``, as the reference's) and
    the experts' SwiGLU weights stacked on a leading E axis."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = DTYPES[cfg.dtype]
    return {
        "router": init_dense(gen, (d, e), torch.float32),
        "e_gate": init_dense(gen, (e, d, f), dt),
        "e_up": init_dense(gen, (e, d, f), dt),
        "e_down": init_dense(gen, (e, f, d), dt,
                             scale=1.0 / math.sqrt(f * 2 * cfg.n_layers)),
    }


def _expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """(E, N, D) per-expert SwiGLU FFN → (E, N, D)."""
    h = F.silu(torch.bmm(xe, p["e_gate"])) * torch.bmm(xe, p["e_up"])
    return torch.bmm(h, p["e_down"])


def moe_capacity(cfg: ArchConfig, S: int, impl: str = "sort") -> int:
    """Slots an expert takes from a group of S tokens: ⌈S·k/E·cf⌉ in Python
    floats, as the reference computes it, and at most S on the einsum
    route (the reference's two routes differ there, and so do the port's)."""
    C = math.ceil(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return min(C, S) if impl == "einsum" else C


def moe_gates(cfg: ArchConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate values, expert ids), each (G, S, k): the softmax of the float32
    router logits, its top k, renormalised to sum to 1.

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises no order there.  Only exactly equal gates are
    affected, and a token's slot order changes neither the dispatch (its
    experts are distinct, so the stable sort ranks its slots by token
    alone) nor the combine (summed in expert order).
    """
    gates = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    gval, gidx = torch.topk(gates, cfg.top_k, dim=-1)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)
    return gval, gidx


@dataclasses.dataclass
class MoeRoute:
    """The sort route's dispatch of (G, S, d) tokens to E experts.

    ``gval``/``gidx`` (G, S, k) are the gates; ``pos`` (G, S, k) is each
    token-slot's rank among its expert's slots of the group, in token
    order, and ``keep`` = ``pos`` < ``capacity``: the slots past capacity
    are dropped.  ``order`` (G, S·k) lists the flat slots (s·k + j) sorted
    by expert, stably; ``starts``/``counts`` (G, E) are each expert's run
    in it.
    """
    gval: torch.Tensor
    gidx: torch.Tensor
    capacity: int
    order: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def moe_route(cfg: ArchConfig, p: Params, x: torch.Tensor) -> MoeRoute:
    """Route each group (batch row) of ``x`` on its own, as the reference
    maps its dispatch over groups: a stable argsort of the S·k expert ids,
    each expert's start by a left-side search, a slot's rank from its
    place in the sorted order."""
    G, S, _ = x.shape
    gval, gidx = moe_gates(cfg, p, x)
    if isinstance(gidx, DTensor):
        # DTensor has no rule for searchsorted: the ranks route the whole
        # batch on replicated expert ids, and the route is replicated.
        mesh = gidx.device_mesh
        rep = [Replicate()] * mesh.ndim
        r = _route(cfg, gval, gidx.redistribute(mesh, rep).to_local(), S)
        fields = {f: _replicated_like(getattr(r, f), gidx)
                  for f in ("order", "starts", "counts", "pos", "keep")}
        return dataclasses.replace(r, gidx=gidx, **fields)
    return _route(cfg, gval, gidx, S)


def _replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on ``ref``'s mesh when ``ref`` is a DTensor."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _route(cfg: ArchConfig, gval: torch.Tensor, gidx: torch.Tensor,
           S: int) -> MoeRoute:
    G = gidx.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dev = gidx.device
    e_flat = gidx.reshape(G, S * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    starts = torch.searchsorted(
        e_sorted, torch.arange(e, device=dev).repeat(G, 1))
    counts = torch.diff(starts, dim=1, append=torch.full(
        (G, 1), S * k, dtype=starts.dtype, device=dev))
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * k, device=dev).repeat(G, 1))
    pos = (rank - torch.gather(starts, 1, e_flat)).reshape(G, S, k)
    C = moe_capacity(cfg, S)
    return MoeRoute(gval=gval, gidx=gidx, capacity=C, order=order,
                    starts=starts, counts=counts, pos=pos, keep=pos < C)


def _moe_einsum(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The classic (G, S, E, C) one-hot dispatch, for small configurations
    and cross-checks."""
    G, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gval, gidx = moe_gates(cfg, p, x)
    C = moe_capacity(cfg, S, "einsum")
    onehot = F.one_hot(gidx, e).to(torch.float32)            # (G, S, k, E)
    pos = (torch.cumsum(onehot.reshape(G, S * k, e), dim=1) - 1.0
           ).reshape(G, S, k, e)
    within = (pos < C) & (onehot > 0)
    slot = torch.where(within, pos, 0.0).to(torch.int64)
    slot_oh = F.one_hot(slot, C).to(x.dtype) \
        * within.to(x.dtype)[..., None]                      # (G,S,k,E,C)
    dispatch = slot_oh.sum(2)                                # (G, S, E, C)
    combine = (slot_oh * gval.to(x.dtype)[..., None, None]).sum(2)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, x)
    ye = _expert_ffn(p, xe.transpose(0, 1).reshape(e, G * C, d))
    ye = ye.reshape(e, G, C, d).transpose(0, 1)              # (G, E, C, D)
    return torch.einsum("gsec,gecd->gsd", combine, ye)


def apply_moe(cfg: ArchConfig, p: Params, x: torch.Tensor,
              impl: str = "sort") -> torch.Tensor:
    """Top-k capacity MoE on (G, S, d) tokens, each batch row a group.

    ``sort`` (default): :func:`moe_route` ranks the token-slots within
    their experts; the (E, G·C, d) buffer is gathered (slot c of expert e
    holds its run's c-th token, zeros past its count), run through the
    per-expert SwiGLU products, and each token gathers its kept slots'
    outputs back, weighted by its gates in ``x.dtype``.  The reference
    scatter-adds those k outputs in expert-sorted order; the port sums
    them in the same order with one add per slot, so no atomics reorder
    the sum and a forward is bit-reproducible on the card.

    ``einsum``: the (G, S, E, C) one-hot dispatch.
    """
    p = gather_weights(p)
    x = gather_input(x)
    if impl == "einsum":
        return _moe_einsum(cfg, p, x)
    if impl != "sort":
        raise ValueError(f"unknown MoE dispatch {impl!r}")
    G, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = moe_route(cfg, p, x)
    C = r.capacity
    c = _replicated_like(torch.arange(C, device=x.device), r.starts)
    slot = (r.starts[:, :, None] + c).clamp(max=S * k - 1)   # (G, E, C)
    tok = torch.gather(r.order, 1, slot.reshape(G, e * C)) // k
    buf = torch.gather(x, 1, tok[..., None].expand(G, e * C, d))
    filled = (c < r.counts[:, :, None]).reshape(G, e * C, 1)
    buf = torch.where(filled, buf, 0.0)
    ye = _expert_ffn(p, buf.reshape(G, e, C, d).transpose(0, 1)
                     .reshape(e, G * C, d)).reshape(e * G * C, d)
    # Each token's slots in expert order, its k output rows and weights.
    by_e = torch.argsort(r.gidx, dim=-1)
    gidx = torch.gather(r.gidx, 2, by_e)
    pos = torch.gather(r.pos, 2, by_e).clamp(max=C - 1)
    w = (torch.gather(r.gval, 2, by_e).to(x.dtype)
         * torch.gather(r.keep, 2, by_e).to(x.dtype))
    g = _replicated_like(torch.arange(G, device=x.device)[:, None, None],
                         r.starts)
    rows = gidx * (G * C) + g * C + pos                      # (G, S, k)
    out = None
    for j in range(k):
        y = ye.index_select(0, rows[:, :, j].reshape(-1)).reshape(G, S, d) \
            * w[:, :, j, None]
        out = y if out is None else out + y
    return out


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan, chunked)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """One Mamba block: projections in ``cfg.dtype``, ``A_log`` = log(1..N)
    per channel and ``D`` = 1 in float32, as the reference's."""
    d = cfg.d_model
    din = cfg.expand * d
    n = cfg.d_state
    dt_rank = max(d // 16, 1)
    dt = DTYPES[cfg.dtype]
    dev = gen.device
    return {
        "in_proj": init_dense(gen, (d, 2 * din), dt),
        "conv_w": init_dense(gen, (din, cfg.d_conv), dt, scale=0.5),
        "x_proj": init_dense(gen, (din, dt_rank + 2 * n), dt),
        "dt_proj": init_dense(gen, (dt_rank, din), dt),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev).repeat(din, 1)),
        "D": torch.ones((din,), dtype=torch.float32, device=dev),
        "out_proj": init_dense(gen, (din, d), dt,
                               scale=1.0 / math.sqrt(din * 2 * cfg.n_layers)),
    }


def _selective_scan_chunk(A: torch.Tensor, Bx: torch.Tensor,
                          h0: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = A_t ⊙ h_{t-1} + Bx_t over axis 1, as a log-depth scan.

    A, Bx: (B, T, din, N) float32; h0: (B, din, N).  Returns (h_all,
    h_last).  The reference calls ``jax.lax.associative_scan`` with the
    combine (a1·a2, x2 + a2·x1); PyTorch has no such call, so this is the
    Hillis–Steele form of the same scan (⌈log2 T⌉ steps, each combining
    every element with the one ``shift`` before it).  The products are
    taken in another tree than XLA's, so results agree within float32
    rounding, not bit for bit.
    """
    aa, hh = A, Bx
    T = A.shape[1]
    shift = 1
    while shift < T:
        hh = torch.cat([hh[:, :shift],
                        hh[:, shift:] + aa[:, shift:] * hh[:, :-shift]], 1)
        aa = torch.cat([aa[:, :shift], aa[:, shift:] * aa[:, :-shift]], 1)
        shift *= 2
    h_all = hh + aa * h0[:, None]
    return h_all, h_all[:, -1]


def apply_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor,
                state: Optional[Params] = None, chunk: int = 256
                ) -> Tuple[torch.Tensor, Params]:
    """x: (B, S, D).  state: {"h": (B, din, N) float32, "conv": (B, k−1,
    din)}, the scan's state and the conv's last k − 1 inputs.

    As the reference: the depthwise causal conv sums its taps in order in
    the model dtype; Δ = softplus(dt_in @ dt_proj) in float32, dA =
    exp(Δ·A) and dBx = Δ·u·B materialised as (B, S, din, N) float32; with
    S a multiple of ``chunk`` and more than one chunk, h is carried from
    chunk to chunk and scanned within each, else one scan covers all of S
    (decode, and prefills of other lengths).
    """
    p = gather_weights(p)
    x = gather_input(x)
    B, S, d = x.shape
    din = cfg.expand * d
    n = cfg.d_state
    dt_rank = max(d // 16, 1)
    xs, z = torch.split(x @ p["in_proj"], din, dim=-1)       # (B, S, din)

    kk = cfg.d_conv
    if state is not None:
        ctx = state["conv"]
    else:
        ctx = torch.zeros((B, kk - 1, din), dtype=xs.dtype, device=x.device)
    xpad = torch.cat([ctx, xs], dim=1)
    conv = xpad[:, 0:S] * p["conv_w"][:, 0]
    for i in range(1, kk):
        conv = conv + xpad[:, i:i + S] * p["conv_w"][:, i]
    new_conv = xpad[:, -(kk - 1):] if kk > 1 else ctx
    u = F.silu(conv)                                         # (B, S, din)

    dt_in, Bc, Cc = torch.split(u @ p["x_proj"], [dt_rank, n, n], dim=-1)
    delta = F.softplus(dt_in @ p["dt_proj"]).to(torch.float32)
    A = -torch.exp(p["A_log"])                               # (din, N)
    dA = torch.exp(delta[..., None] * A)                     # (B, S, din, N)
    dBx = (delta * u.to(torch.float32))[..., None] \
        * Bc.to(torch.float32)[..., None, :]                 # (B, S, din, N)

    h0 = state["h"] if state is not None else torch.zeros(
        (B, din, n), dtype=torch.float32, device=x.device)
    n_chunks = max(S // chunk, 1)
    if S % chunk == 0 and n_chunks > 1:
        # Carry h across chunks sequentially; the scan within a chunk
        # bounds its temporaries to (B, chunk, din, N).
        h_last, parts = h0, []
        for c in range(0, S, chunk):
            h_c, h_last = _selective_scan_chunk(dA[:, c:c + chunk],
                                                dBx[:, c:c + chunk], h_last)
            parts.append(h_c)
        h_all = torch.cat(parts, dim=1)
    else:
        h_all, h_last = _selective_scan_chunk(dA, dBx, h0)

    y = torch.einsum("bsdn,bsn->bsd", h_all, Cc.to(torch.float32))
    y = y + u.to(torch.float32) * p["D"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, {"h": h_last, "conv": new_conv}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay linear attention + channel mix
# ---------------------------------------------------------------------------

def init_rwkv(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """One RWKV-6 layer's time and channel mix.  ``w_proj`` is drawn at
    the reference's absolute scale of 0.1, ``w_bias`` is −2 in float32,
    the ``mu_*`` token-shift mixes are 0.5 in ``cfg.dtype``."""
    d, f = cfg.d_model, cfg.d_ff
    dt = DTYPES[cfg.dtype]
    dev = gen.device
    half = torch.full((d,), 0.5, dtype=dt, device=dev)
    return {
        "r_proj": init_dense(gen, (d, d), dt),
        "k_proj": init_dense(gen, (d, d), dt),
        "v_proj": init_dense(gen, (d, d), dt),
        "g_proj": init_dense(gen, (d, d), dt),
        "w_proj": init_dense(gen, (d, d), dt, scale=0.1),
        "w_bias": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "o_proj": init_dense(gen, (d, d), dt,
                             scale=1.0 / math.sqrt(d * 2 * cfg.n_layers)),
        "mu_r": half,
        "mu_k": half.clone(),
        "mu_v": half.clone(),
        "mu_w": half.clone(),
        "ck_proj": init_dense(gen, (d, f), dt),
        "cv_proj": init_dense(gen, (f, d), dt,
                              scale=1.0 / math.sqrt(f * 2 * cfg.n_layers)),
    }


def apply_rwkv_time(cfg: ArchConfig, p: Params, x: torch.Tensor,
                    state: Optional[Params] = None
                    ) -> Tuple[torch.Tensor, Params]:
    """RWKV-6 time mix.  x: (B, S, D).

    state: {"S": (B, H, Dh, Dh) float32 wkv state, "x_prev": (B, 1, D) in
    the model dtype}.  The matrix state accumulates kᵀv under a per-channel
    decay w_t = exp(−exp(mix_w @ w_proj + w_bias)) (float32).  The output at
    step t reads the state before token t's kᵀv, and there is no bonus term.

    Route, as the reference chooses it: ``cfg.rwkv_impl == "chunked"`` with
    S > 1 a multiple of ``cfg.rwkv_chunk`` takes :func:`rwkv_wkv_chunked`;
    everything else the step-by-step scan, a Python loop of four ops a
    token.
    """
    p = gather_weights(p)
    x = gather_input(x)
    B, S, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    x_prev = state["x_prev"] if state is not None else torch.zeros(
        (B, 1, d), dtype=x.dtype, device=x.device)
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)               # token shift

    def mix(mu):
        return x + (xs - x) * mu
    r = split_heads(mix(p["mu_r"]) @ p["r_proj"], H, dh)
    k = split_heads(mix(p["mu_k"]) @ p["k_proj"], H, dh)
    v = split_heads(mix(p["mu_v"]) @ p["v_proj"], H, dh)
    g = F.silu(x @ p["g_proj"])
    w = torch.exp(-torch.exp((mix(p["mu_w"]) @ p["w_proj"]).to(torch.float32)
                             + p["w_bias"]))                 # (B, S, D) decay
    w = split_heads(w, H, dh)

    S0 = state["S"] if state is not None else torch.zeros(
        (B, H, dh, dh), dtype=torch.float32, device=x.device)
    kf, vf, rf = (t.to(torch.float32) for t in (k, v, r))

    if cfg.rwkv_impl == "chunked" and S > 1 and S % cfg.rwkv_chunk == 0:
        y, S_last = rwkv_wkv_chunked(w, kf, vf, rf, S0, chunk=cfg.rwkv_chunk)
        y = merge_heads(y)
    else:
        # Time-major copies, so each step reads contiguous (B, H, dh) rows.
        wt, kt, vt, rt = (t.transpose(0, 1).contiguous()
                          for t in (w, kf, vf, rf))
        S_last, ys = S0, []
        for t in range(S):
            ys.append(torch.einsum("bhk,bhkv->bhv", rt[t], S_last))
            S_last = S_last * wt[t][..., None] \
                + kt[t][..., None] * vt[t][..., None, :]
        y = merge_heads(torch.stack(ys, dim=1))
    y = (y.to(x.dtype) * g) @ p["o_proj"]
    return y, {"S": S_last, "x_prev": x[:, -1:]}


def apply_rwkv_channel(cfg: ArchConfig, p: Params, x: torch.Tensor
                       ) -> torch.Tensor:
    """RWKV-6 channel mix as the reference has it: relu(x @ ck)² @ cv."""
    p = gather_weights(p)
    x = gather_input(x)
    return torch.square(F.relu(x @ p["ck_proj"])) @ p["cv_proj"]


def rwkv_wkv_chunked(w: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     r: torch.Tensor, S0: torch.Tensor, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-parallel WKV recurrence (the GLA form of the time mix).

    Within a chunk of C steps the decay-weighted interactions become two
    products through log-space decay rescaling; the matrix state is
    carried only across chunk boundaries.  As the reference writes it:
    ``log(clip(w, 1e-12, 1))``, the inclusive cumulative sum L, and
    exp(−L) unguarded, so where L falls below about −88 the route
    overflows float32 (rwkv6-1.6b's width does that on random weights,
    and the reference's output is then not finite either).

    w, k, v, r: (B, S, H, Dh) with w ∈ (0, 1); S0: (B, H, Dh, Dh).
    Returns (out (B, S, H, Dh), S_last).
    """
    B, S, H, Dh = k.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {C}")
    n_chunks = S // C

    def to_chunks(t):
        return t.reshape(B, n_chunks, C, H, Dh).permute(1, 0, 3, 2, 4)
    wc, kc, vc, rc = map(to_chunks, (w, k, v, r))      # (N, B, H, C, Dh)
    logw = torch.log(torch.clamp(wc.to(torch.float32), 1e-12, 1.0))
    # L[t] = Σ_{u≤t} log w_u within the chunk (inclusive).
    L = torch.cumsum(logw, dim=3)
    tri = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                device=k.device), diagonal=-1)
    Sm, outs = S0, []
    for c in range(n_chunks):
        Lc = L[c]
        kf, vf, rf = (t[c].to(torch.float32) for t in (kc, vc, rc))
        # The state before the chunk decays through steps 1..t-1, a pair
        # s < t within the chunk through s+1..t-1.
        Lprev = torch.cat([torch.zeros_like(Lc[..., :1, :]), Lc[..., :-1, :]],
                          dim=2)
        r_dec = rf * torch.exp(Lprev)                 # (B, H, C, Dh)
        k_dec = kf * torch.exp(-Lc)
        att = torch.einsum("bhtd,bhsd->bhts", r_dec, k_dec) * tri
        intra = torch.einsum("bhts,bhsd->bhtd", att, vf)
        inter = torch.einsum("bhtd,bhdv->bhtv", r_dec, Sm)
        outs.append(intra + inter)
        # The state to the chunk's end: decay through the whole chunk.
        Lend = Lc[..., -1:, :]
        Sm = Sm * torch.exp(Lend[..., 0, :, None]) + torch.einsum(
            "bhsd,bhsv->bhdv", kf * torch.exp(Lend - Lc), vf)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, Dh)
    return out, Sm
