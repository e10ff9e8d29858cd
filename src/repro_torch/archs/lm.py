"""Decoder-only language models of the dense and MoE families, as one
``nn.Module``.

The counterpart of the reference's ``archs/lm.py`` for those two families:
a stack of pre-norm attention layers whose MLP is the SwiGLU MLP (dense)
or the top-k capacity MoE (moe).  Where the reference scans over
parameters stacked on a leading L axis, the port keeps one module per
layer in an ``nn.ModuleList`` and loops over them.  Parameter names and
layouts are the reference's (weights are (d_in, d_out) and a layer
computes ``x @ W``; an MoE layer's ``mlp`` holds ``router``, ``e_gate``,
``e_up``, ``e_down``, the experts stacked on a leading E axis), so
:func:`params_from_reference` maps a reference parameter tree onto
:meth:`LM.state_dict` leaf by leaf and :func:`params_to_reference` maps it
back.

Parameters are built frozen, so serving builds no autograd graph; the
train step (``train/train_loop.py``) turns gradients on for the model it
trains.  With gradients on, ``cfg.remat == "block"`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``), as the reference
wraps each scanned layer in ``jax.checkpoint``.  The flash-attention
kernel has no backward pass (nor has the reference's), so a model with
``cfg.use_flash`` does not train.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (apply_attention, apply_mlp, apply_moe, init_attention,
                     init_mlp, init_moe)
from .common import ArchConfig, DTYPES, init_dense, rmsnorm

__all__ = ["LM", "params_from_reference", "params_to_reference",
           "reference_key"]

Cache = List[Dict[str, Any]]

# The reference's sequence-chunked cross entropy: above this many logit
# elements the loss never materialises the full (B, S, V) float32 logits.
CE_CHUNK_THRESHOLD = 1 << 31


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


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
        self.attn = nn.ParameterDict(
            {k: _frozen(v) for k, v in init_attention(gen, cfg).items()})
        mlp = init_moe(gen, cfg) if moe else init_mlp(gen, cfg)
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in mlp.items()})

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


class LM(nn.Module):
    """Decoder-only LM of the dense or MoE family: embedding, ``n_layers``
    attention layers, final norm and head (the embedding's transpose when
    ``tie_embeddings``).  Both families take the dense KV cache.

    Weights are drawn from ``generator`` on its device.  ``cfg`` is read on
    every call, so replacing it (``model.cfg = model.cfg.with_(use_flash=
    False)``) switches the attention route of the same weights.
    """

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                "(ROADMAP queue 1, item 13, the rest of the LLM scaffold)")
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.embed = _frozen(init_dense(generator, (cfg.vocab, cfg.d_model),
                                        dt, 0.02))
        self.norm_f = _frozen(torch.ones((cfg.d_model,), dtype=torch.float32,
                                         device=generator.device))
        moe = cfg.family == "moe"
        self.layers = nn.ModuleList(_AttnLayer(cfg, generator, moe)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _frozen(init_dense(
                generator, (cfg.d_model, cfg.vocab), dt))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _run_layers(self, tokens, caches: Optional[Cache],
                    positions: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Cache]:
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        if caches is not None and len(caches) != len(self.layers):
            raise ValueError(f"{len(caches)} layer caches for "
                             f"{len(self.layers)} layers")
        x = self.embed[tokens]
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(B, S)
        else:
            positions = torch.as_tensor(positions, device=self.device)
        new_caches = []
        for i, layer in enumerate(self.layers):
            if caches is None and self._remat(x):
                x, c = checkpoint(layer, self.cfg, x, positions, None,
                                  use_reentrant=False)
            else:
                x, c = layer(self.cfg, x, positions,
                             None if caches is None else caches[i])
            new_caches.append(c)
        return x, new_caches

    def _remat(self, x: torch.Tensor) -> bool:
        """Recompute a layer in the backward pass: ``remat="block"``, and
        an autograd graph is being built through ``x``."""
        return (self.cfg.remat == "block" and torch.is_grad_enabled()
                and x.requires_grad)

    def forward(self, tokens, caches: Optional[Cache] = None,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Logits (B, S or 1, V) and the per-layer caches.

        Without ``caches`` this is the cacheless full-sequence forward
        (prompt scoring), whose attention runs the flash kernel when
        ``cfg.use_flash``; with them, the new tokens are written into the
        caches at their ``len`` and attend the valid prefix.
        """
        x, new_caches = self._run_layers(tokens, caches, positions)
        if last_only:
            x = x[:, -1:]   # serve prefill: only next-token logits needed
        x = rmsnorm(x, self.norm_f, self.cfg.norm_eps)
        return x @ self.head(), new_caches

    def loss(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """Mean next-token cross entropy over labels ≥ 0 (float32)."""
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x, _ = self._run_layers(batch["tokens"], None, None)
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
        """One empty KV cache per layer: (batch, Hkv, C, Dh) buffers, C =
        ``max_len`` (or the window, if smaller), and ``len`` 0."""
        cfg = self.cfg
        C = min(max_len, cfg.window) if cfg.window else max_len
        shape = (batch, cfg.n_kv, C, cfg.head_dim)
        dt = DTYPES[cfg.dtype]
        return [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device),
                 "len": 0} for _ in self.layers]


def _tensor(a: Any, layer: Optional[int] = None) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a`` (or of ``a[layer]``).  ``a`` is
    a tensor or an array; bfloat16 numpy arrays (the ``ml_dtypes`` type JAX
    hands out) are reinterpreted through uint16, since ``torch.from_numpy``
    does not take them."""
    if isinstance(a, torch.Tensor):
        a = a.detach() if layer is None else a.detach()[layer]
        return a.to("cpu", copy=True)
    a = np.asarray(a)
    if layer is not None:
        a = a[layer]
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_reference(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's :class:`LM` state dict from a reference parameter tree.

    ``tree`` is what the reference's ``build_lm(cfg).init`` returns, as
    nested dicts of numpy arrays (or tensors); ``tree["layers"]`` holds
    leaves stacked on a leading L axis, which become ``layers.<i>.<path>``.
    Dtypes are kept.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str, layer: Optional[int]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.", layer)
            else:
                out[f"{prefix}{k}"] = _tensor(v, layer)

    walk({k: v for k, v in tree.items() if k != "layers"}, "", None)
    for i in range(len(tree["layers"]["ln_attn"])):
        walk(tree["layers"], f"layers.{i}.", i)
    return out


def reference_key(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A state-dict name's path in the reference's parameter tree and its
    layer: ``layers.3.attn.wq`` → (("layers", "attn", "wq"), 3); names
    outside the layers have no layer."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def params_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's parameter tree from a state dict of :class:`LM`, the
    inverse of :func:`params_from_reference`: nested dicts of CPU tensors,
    each per-layer leaf stacked on a leading L axis.  Dtypes are kept
    (bfloat16 tensors stay tensors; JAX takes them through a uint16 view).
    """
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    out: Dict[str, Any] = {}
    for name, t in state.items():
        path, layer = reference_key(name)
        if layer is None:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t.detach().to("cpu", copy=True)
        else:
            stacks.setdefault(path, {})[layer] = t
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_layer)}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.stack([by_layer[i].detach().cpu()
                                      for i in range(len(by_layer))])
    return out
