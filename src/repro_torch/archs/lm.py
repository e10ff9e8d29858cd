"""Decoder-only language models of the dense, MoE, hybrid (jamba), SSM
(RWKV-6) and VLM families, as one ``nn.Module``.

The counterpart of the reference's ``archs/lm.py``: a stack of pre-norm
layers.  Dense, VLM and MoE layers are attention with the SwiGLU MLP or
the top-k capacity MoE; a VLM model prepends ``n_patches`` stub patch
embeddings to the token embeddings, runs the layers over both (positions
count the patches) and slices the patch rows off before the head; an
SSM layer is RWKV-6's time mix and channel mix; a hybrid model stacks
groups of one attention layer (dense MLP) and ``attn_every − 1`` Mamba
layers, whose MLP is the MoE at positions ``i % moe_every == 1`` and
dense elsewhere.  Where the
reference scans over parameters stacked on a leading L axis (for the
hybrid family, over groups, with each group's Mamba layers stacked once
more), the port keeps one module per layer or group in an
``nn.ModuleList`` and loops over them.  Parameter names and layouts are
the reference's (weights are (d_in, d_out) and a layer computes
``x @ W``; an MoE layer's ``mlp`` holds ``router``, ``e_gate``, ``e_up``,
``e_down``, the experts stacked on a leading E axis), so
:func:`params_from_reference` maps a reference parameter tree onto
:meth:`LM.state_dict` leaf by leaf and :func:`params_to_reference` maps it
back; both also map the encoder–decoder's tree (``archs/encdec.py``),
whose ``enc_layers`` and ``dec_layers`` are stacked as ``layers`` is.

Parameters are built frozen, so serving builds no autograd graph; the
train step (``train/train_loop.py``) turns gradients on for the model it
trains.  With gradients on, ``cfg.remat == "block"`` recomputes each
layer (or group) in the backward pass (``torch.utils.checkpoint``), as the
reference wraps each scanned body in ``jax.checkpoint``.  The
flash-attention kernel has no backward pass (nor has the reference's), so
a model with ``cfg.use_flash`` does not train.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (apply_attention, apply_mamba, apply_mlp, apply_moe,
                     apply_rwkv_channel, apply_rwkv_time, init_attention,
                     init_mamba, init_mlp, init_moe, init_rwkv)
from .act_sharding import BATCH_AXES, constrain, gather_weight
from .common import ArchConfig, DTYPES, embed_tokens, init_dense, rmsnorm

__all__ = ["LM", "LM_FAMILIES", "params_from_reference",
           "params_to_reference", "reference_key"]

Cache = List[Dict[str, Any]]

# The families this module builds (the audio family is ``EncDec``'s).
LM_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")

# The reference's subtrees of per-layer leaves stacked on a leading axis:
# an LM's layers, an encoder–decoder's two stacks.
_STACKS = ("layers", "enc_layers", "dec_layers")

# A hybrid group's Mamba layers: the reference stacks each list of them on
# a second axis, (G, n, ...), and the port keeps a ModuleList.
_NESTED = ("mamba_moe", "mamba_dense")

# The reference's sequence-chunked cross entropy: above this many logit
# elements the loss never materialises the full (B, S, V) float32 logits.
CE_CHUNK_THRESHOLD = 1 << 31


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(p: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in p.items()})


def _mlp(cfg: ArchConfig, gen: torch.Generator, moe: bool
         ) -> nn.ParameterDict:
    """A layer's MLP: the top-k capacity MoE with ``moe``, else SwiGLU."""
    return _params(init_moe(gen, cfg) if moe else init_mlp(gen, cfg))


class _AttnLayer(nn.Module):
    """One pre-norm decoder layer: attention, then the SwiGLU MLP or, with
    ``moe``, the top-k capacity MoE."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, moe: bool):
        super().__init__()
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        self.moe = moe
        self.ln_attn = _frozen(ones)
        self.ln_mlp = _frozen(ones.clone())
        self.attn = _params(init_attention(gen, cfg))
        self.mlp = _mlp(cfg, gen, moe)

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict[str, Any]]):
        h, new_cache = apply_attention(
            cfg, self.attn, rmsnorm(x, self.ln_attn, cfg.norm_eps), positions,
            cache=cache)
        x = x + h
        hn = rmsnorm(x, self.ln_mlp, cfg.norm_eps)
        x = x + (apply_moe(cfg, self.mlp, hn) if self.moe
                 else apply_mlp(cfg, self.mlp, hn))
        return x, new_cache


class _MambaLayer(nn.Module):
    """One pre-norm Mamba layer of a hybrid group: the selective scan (its
    state in place of a KV cache), then the SwiGLU MLP or the MoE."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, moe: bool):
        super().__init__()
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        self.moe = moe
        self.ln_attn = _frozen(ones)
        self.ln_mlp = _frozen(ones.clone())
        self.mamba = _params(init_mamba(gen, cfg))
        self.mlp = _mlp(cfg, gen, moe)

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Dict[str, Any]]):
        h, new_state = apply_mamba(
            cfg, self.mamba, rmsnorm(x, self.ln_attn, cfg.norm_eps), state)
        x = x + h
        hn = rmsnorm(x, self.ln_mlp, cfg.norm_eps)
        x = x + (apply_moe(cfg, self.mlp, hn) if self.moe
                 else apply_mlp(cfg, self.mlp, hn))
        return x, new_state


class _RwkvLayer(nn.Module):
    """One pre-norm RWKV-6 layer: time mix (its state in place of a KV
    cache), then channel mix.  Positions are not read."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        self.ln_attn = _frozen(ones)
        self.ln_mlp = _frozen(ones.clone())
        self.rwkv = _params(init_rwkv(gen, cfg))

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, state: Optional[Dict[str, Any]]):
        h, new_state = apply_rwkv_time(
            cfg, self.rwkv, rmsnorm(x, self.ln_attn, cfg.norm_eps), state)
        x = x + h
        x = x + apply_rwkv_channel(
            cfg, self.rwkv, rmsnorm(x, self.ln_mlp, cfg.norm_eps))
        return x, new_state


def moe_positions(cfg: ArchConfig) -> List[int]:
    """The positions 1 … attn_every − 1 of a hybrid group whose Mamba layer
    has the MoE MLP, as the reference picks them."""
    return [i for i in range(1, cfg.attn_every)
            if i % cfg.moe_every == 1 or cfg.moe_every == 1]


class _Group(nn.Module):
    """One hybrid (jamba) group: an attention layer with the dense MLP, then
    ``attn_every − 1`` Mamba layers; those at :func:`moe_positions` are in
    ``mamba_moe``, the others in ``mamba_dense``, each in position order.
    Its cache is {"attn": KV cache, "moe": [Mamba states] or None,
    "dense": [...] or None}."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        n_moe = len(moe_positions(cfg))
        self.attn_layer = _AttnLayer(cfg, gen, moe=False)
        self.mamba_moe = nn.ModuleList(_MambaLayer(cfg, gen, True)
                                       for _ in range(n_moe))
        self.mamba_dense = nn.ModuleList(
            _MambaLayer(cfg, gen, False)
            for _ in range(cfg.attn_every - 1 - n_moe))

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict[str, Any]]):
        x, c_attn = self.attn_layer(cfg, x, positions,
                                    None if cache is None else cache["attn"])
        new: Dict[str, Any] = {"attn": c_attn, "moe": [], "dense": []}
        moe_pos = moe_positions(cfg)
        for i in range(1, cfg.attn_every):
            kind = "moe" if i in moe_pos else "dense"
            j = len(new[kind])
            layer = (self.mamba_moe if kind == "moe" else self.mamba_dense)[j]
            x, st = layer(cfg, x, None if cache is None else cache[kind][j])
            new[kind].append(st)
        new["moe"] = new["moe"] or None
        new["dense"] = new["dense"] or None
        return x, new


class LM(nn.Module):
    """Decoder-only LM: embedding, the layers, final norm and head (the
    embedding's transpose when ``tie_embeddings``).  ``layers`` holds
    ``n_layers`` attention layers (dense, moe), RWKV-6 layers (ssm) or
    ``n_layers / attn_every`` groups (hybrid); its i-th cache is that
    layer's or group's, as :meth:`init_cache` builds it.

    Weights are drawn from ``generator`` on its device.  ``cfg`` is read on
    every call, so replacing it (``model.cfg = model.cfg.with_(use_flash=
    False)``) switches the attention route of the same weights.
    """

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator):
        super().__init__()
        if cfg.family not in LM_FAMILIES:
            raise ValueError(f"{cfg.name}: the {cfg.family} family is not "
                             f"a decoder-only LM (one of {LM_FAMILIES})")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"split into groups of {cfg.attn_every}")
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.embed = _frozen(init_dense(generator, (cfg.vocab, cfg.d_model),
                                        dt, 0.02))
        self.norm_f = _frozen(torch.ones((cfg.d_model,), dtype=torch.float32,
                                         device=generator.device))
        if cfg.family == "hybrid":
            layers = [_Group(cfg, generator)
                      for _ in range(cfg.n_layers // cfg.attn_every)]
        elif cfg.family == "ssm":
            layers = [_RwkvLayer(cfg, generator)
                      for _ in range(cfg.n_layers)]
        else:
            layers = [_AttnLayer(cfg, generator, cfg.family == "moe")
                      for _ in range(cfg.n_layers)]
        self.layers = nn.ModuleList(layers)
        if not cfg.tie_embeddings:
            self.lm_head = _frozen(init_dense(
                generator, (cfg.d_model, cfg.vocab), dt))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return gather_weight(self.embed.T if self.cfg.tie_embeddings
                             else self.lm_head)

    def _run_layers(self, tokens, caches: Optional[Cache],
                    positions: Optional[torch.Tensor], patches=None
                    ) -> Tuple[torch.Tensor, Cache]:
        """The layers' output at the token rows, and the new caches.  A VLM
        model given ``patches`` (B, P, d_model) runs them ahead of the
        tokens, at positions 0 … P − 1, and drops their rows after the
        last layer; other families ignore them, as the reference does."""
        tokens = torch.as_tensor(tokens, device=self.device)
        if caches is not None and len(caches) != len(self.layers):
            raise ValueError(f"{len(caches)} layer caches for "
                             f"{len(self.layers)} layers")
        x = embed_tokens(self.embed, tokens)
        n_patches = 0
        if self.cfg.family == "vlm" and patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
            n_patches = patches.shape[1]
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(B, S)
        else:
            positions = torch.as_tensor(positions, device=self.device)
        new_caches = []
        x = self._shard_carry(x)
        for i, layer in enumerate(self.layers):
            if caches is None and self._remat(x):
                x, c = checkpoint(layer, self.cfg, x, positions, None,
                                  use_reentrant=False)
            else:
                x, c = layer(self.cfg, x, positions,
                             None if caches is None else caches[i])
            x = self._shard_carry(x)
            new_caches.append(c)
        return x[:, n_patches:], new_caches

    def _shard_carry(self, y: torch.Tensor) -> torch.Tensor:
        """The reference's constraint on the layer carry (the per-layer
        saved activation under remat), a no-op without a mesh.  "model":
        split d_model over TP; "seq": sequence parallelism; "none": batch
        axes only."""
        cfg = self.cfg
        baxes = BATCH_AXES + ("model",) if cfg.pure_dp else BATCH_AXES
        mode = "none" if cfg.pure_dp else cfg.carry_sharding
        if mode == "model":
            return constrain(y, baxes, None, "model")
        if mode == "seq":
            return constrain(y, baxes, "model", None)
        return constrain(y, baxes, None, None)

    def _remat(self, x: torch.Tensor) -> bool:
        """Recompute a layer in the backward pass: ``remat="block"``, and
        an autograd graph is being built through ``x``."""
        return (self.cfg.remat == "block" and torch.is_grad_enabled()
                and x.requires_grad)

    def forward(self, tokens, patches=None, caches: Optional[Cache] = None,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Logits (B, S or 1, V) and the per-layer caches.

        Without ``caches`` this is the cacheless full-sequence forward
        (prompt scoring), whose attention runs the flash kernel when
        ``cfg.use_flash``; with them, the new tokens are written into the
        caches at their ``len`` and attend the valid prefix.  A VLM model's
        ``patches`` (B, n_patches, d_model) go ahead of the tokens and
        take cache slots, but no logits.
        """
        x, new_caches = self._run_layers(tokens, caches, positions, patches)
        if last_only:
            x = x[:, -1:]   # serve prefill: only next-token logits needed
        x = rmsnorm(x, self.norm_f, self.cfg.norm_eps)
        return x @ self.head(), new_caches

    def loss(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """Mean next-token cross entropy over labels ≥ 0 (float32)."""
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x, _ = self._run_layers(batch["tokens"], None, None,
                                batch.get("patches"))
        x = rmsnorm(x, self.norm_f, self.cfg.norm_eps)
        B, S = labels.shape
        head = self.head()

        def ce(xc, lc):
            logp = torch.log_softmax((xc @ head).to(torch.float32), dim=-1)
            ll = torch.gather(logp, -1, lc.clamp(min=0)[..., None])[..., 0]
            mask = (lc >= 0).to(torch.float32)
            return -(ll * mask).sum(), mask.sum()

        n_chunks = 1
        while (B * S // n_chunks) * self.cfg.vocab > CE_CHUNK_THRESHOLD \
                and S % (2 * n_chunks) == 0:
            n_chunks *= 2
        if n_chunks > 1 and self._remat(x):
            # As the reference: each chunk's logits are recomputed in the
            # backward pass, or the chunking would save no memory.
            ce = functools.partial(checkpoint, ce, use_reentrant=False)
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        step = S // n_chunks
        for c in range(n_chunks):
            dt_, dc = ce(x[:, c * step:(c + 1) * step],
                         labels[:, c * step:(c + 1) * step])
            tot, cnt = tot + dt_, cnt + dc
        return tot / torch.clamp(cnt, min=1.0)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """One empty cache per layer or group, the reference's state:

        * attention: (batch, Hkv, C, Dh) K and V buffers, C = ``max_len``
          (or the window, if smaller), and ``len`` 0;
        * ssm: {"S": (batch, H, Dh, Dh) float32, "x_prev": (batch, 1, D)};
        * hybrid: {"attn": an attention cache, "moe" and "dense": a list
          of Mamba states {"h": (batch, din, N) float32, "conv": (batch,
          d_conv − 1, din)}, one per Mamba layer of that kind, or None}.
        """
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        dev = self.device

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def attn_cache():
            C = min(max_len, cfg.window) if cfg.window else max_len
            shape = (batch, cfg.n_kv, C, cfg.head_dim)
            return {"k": zeros(*shape), "v": zeros(*shape), "len": 0}

        def mamba_caches(n):
            din = cfg.expand * cfg.d_model
            return [{"h": zeros(batch, din, cfg.d_state,
                                dtype=torch.float32),
                     "conv": zeros(batch, cfg.d_conv - 1, din)}
                    for _ in range(n)] or None

        if cfg.family == "ssm":
            dh = cfg.rwkv_head_dim
            return [{"S": zeros(batch, cfg.d_model // dh, dh, dh,
                                dtype=torch.float32),
                     "x_prev": zeros(batch, 1, cfg.d_model)}
                    for _ in self.layers]
        if cfg.family == "hybrid":
            n_moe = len(moe_positions(cfg))
            return [{"attn": attn_cache(), "moe": mamba_caches(n_moe),
                     "dense": mamba_caches(cfg.attn_every - 1 - n_moe)}
                    for _ in self.layers]
        return [attn_cache() for _ in self.layers]


def _tensor(a: Any, index: Tuple[int, ...] = ()) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a[index]``.  ``a`` is a tensor or an
    array; bfloat16 numpy arrays (the ``ml_dtypes`` type JAX hands out) are
    reinterpreted through uint16, since ``torch.from_numpy`` does not take
    them."""
    if isinstance(a, torch.Tensor):
        a = a.detach()[index] if index else a.detach()
        return a.to("cpu", copy=True)
    a = np.asarray(a)
    if index:
        a = a[index]
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _n_stacked(node: Mapping[str, Any], axis: int = 0) -> int:
    """The length of the stacking ``axis`` of a subtree's leaves (its first
    leaf's)."""
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return node.shape[axis]


def params_from_reference(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict (:class:`LM` or ``EncDec``) from a reference
    parameter tree.

    ``tree`` is what the reference's ``build_lm(cfg).init`` (or
    ``build_encdec(cfg).init``) returns, as nested dicts of numpy arrays
    (or tensors).  ``tree["layers"]`` (an encoder–decoder's
    ``tree["enc_layers"]`` and ``tree["dec_layers"]``) holds leaves
    stacked on a leading L (or group) axis, which become
    ``layers.<i>.<path>``; a hybrid group's ``mamba_moe`` and
    ``mamba_dense`` leaves are stacked on a second axis as well, (G, n,
    ...), and become ``layers.<i>.mamba_moe.<j>.<path>``.  Dtypes are kept.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str, index: Tuple[int, ...]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.", index)
            else:
                out[f"{prefix}{k}"] = _tensor(v, index)

    walk({k: v for k, v in tree.items() if k not in _STACKS}, "", ())
    for stack in _STACKS:
        layers = tree.get(stack)
        if layers is None:
            continue
        for i in range(_n_stacked(layers)):
            for k, v in layers.items():
                if k in _NESTED:
                    for j in range(_n_stacked(v, 1)):
                        walk(v, f"{stack}.{i}.{k}.{j}.", (i, j))
                else:
                    walk({k: v}, f"{stack}.{i}.", (i,))
    return out


def reference_key(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A state-dict name's path in the reference's parameter tree and its
    index into the stacked leaf: ``layers.3.attn.wq`` → (("layers", "attn",
    "wq"), (3,)); ``layers.1.mamba_moe.2.mamba.in_proj`` → (("layers",
    "mamba_moe", "mamba", "in_proj"), (1, 2)); ``dec_layers.0.xattn.wk``
    → (("dec_layers", "xattn", "wk"), (0,)); names outside the stacks
    have the index ()."""
    parts = name.split(".")
    if parts[0] not in _STACKS:
        return tuple(parts), ()
    index, rest = (int(parts[1]),), parts[2:]
    if rest[0] in _NESTED:
        index, rest = index + (int(rest[1]),), rest[:1] + rest[2:]
    return (parts[0],) + tuple(rest), index


def _stack(by_index: Mapping[Tuple[int, ...], torch.Tensor],
           path: Tuple[str, ...]) -> torch.Tensor:
    """The leaf stacked from its pieces, one axis per index position."""
    heads = sorted({i[0] for i in by_index})
    if heads != list(range(len(heads))):
        raise ValueError(f"{'/'.join(path)}: layers {heads}")
    if all(len(i) == 1 for i in by_index):
        return torch.stack([by_index[(h,)].detach().cpu() for h in heads])
    return torch.stack([_stack({i[1:]: t for i, t in by_index.items()
                                if i[0] == h}, path) for h in heads])


def params_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's parameter tree from a state dict of :class:`LM` (or
    ``EncDec``), the inverse of :func:`params_from_reference`: nested dicts
    of CPU tensors, each per-layer leaf stacked on a leading L axis (a
    hybrid group's Mamba leaves on two).  Dtypes are kept (bfloat16
    tensors stay tensors; JAX takes them through a uint16 view).
    """
    stacks: Dict[Tuple[str, ...], Dict[Tuple[int, ...], torch.Tensor]] = {}
    out: Dict[str, Any] = {}
    for name, t in state.items():
        path, index = reference_key(name)
        if not index:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t.detach().to("cpu", copy=True)
        else:
            stacks.setdefault(path, {})[index] = t
    for path, by_index in stacks.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _stack(by_index, path)
    return out
