"""Decoder-only language model of the dense family, as one ``nn.Module``.

The counterpart of the reference's ``archs/lm.py`` for the dense family.
Where the reference scans over parameters stacked on a leading L axis, the
port keeps one module per layer in an ``nn.ModuleList`` and loops over
them.  Parameter names and layouts are the reference's (weights are
(d_in, d_out) and a layer computes ``x @ W``), so :func:`params_from_reference`
maps a reference parameter tree onto :meth:`LM.state_dict` leaf by leaf.

Parameters do not require gradients: this slice serves, and training (and
a backward pass for the flash-attention kernel) comes with a later one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .blocks import apply_attention, apply_mlp, init_attention, init_mlp
from .common import ArchConfig, DTYPES, init_dense, rmsnorm

__all__ = ["LM", "params_from_reference"]

Cache = List[Dict[str, Any]]

# The reference's sequence-chunked cross entropy: above this many logit
# elements the loss never materialises the full (B, S, V) float32 logits.
CE_CHUNK_THRESHOLD = 1 << 31


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _DenseLayer(nn.Module):
    """One pre-norm decoder layer: attention then the SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        self.ln_attn = _frozen(ones)
        self.ln_mlp = _frozen(ones.clone())
        self.attn = nn.ParameterDict(
            {k: _frozen(v) for k, v in init_attention(gen, cfg).items()})
        self.mlp = nn.ParameterDict(
            {k: _frozen(v) for k, v in init_mlp(gen, cfg).items()})

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict[str, Any]]):
        h, new_cache = apply_attention(
            cfg, self.attn, rmsnorm(x, self.ln_attn, cfg.norm_eps), positions,
            cache=cache)
        x = x + h
        x = x + apply_mlp(cfg, self.mlp, rmsnorm(x, self.ln_mlp, cfg.norm_eps))
        return x, new_cache


class LM(nn.Module):
    """Dense decoder-only LM: embedding, ``n_layers`` layers, final norm and
    head (the embedding's transpose when ``tie_embeddings``).

    Weights are drawn from ``generator`` on its device.  ``cfg`` is read on
    every call, so replacing it (``model.cfg = model.cfg.with_(use_flash=
    False)``) switches the attention route of the same weights.
    """

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                "(ROADMAP queue 1, item 13, the rest of the LLM scaffold)")
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.embed = _frozen(init_dense(generator, (cfg.vocab, cfg.d_model),
                                        dt, 0.02))
        self.norm_f = _frozen(torch.ones((cfg.d_model,), dtype=torch.float32,
                                         device=generator.device))
        self.layers = nn.ModuleList(_DenseLayer(cfg, generator)
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
            x, c = layer(self.cfg, x, positions,
                         None if caches is None else caches[i])
            new_caches.append(c)
        return x, new_caches

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
        labels = torch.as_tensor(batch["labels"], device=self.device)
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


def _tensor(a: Any) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a``.  bfloat16 numpy arrays (the
    ``ml_dtypes`` type JAX hands out) are reinterpreted through uint16,
    since ``torch.from_numpy`` does not take them."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_reference(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's :class:`LM` state dict from a reference parameter tree.

    ``tree`` is what the reference's ``build_lm(cfg).init`` returns, as
    nested dicts of numpy arrays; ``tree["layers"]`` holds leaves stacked on
    a leading L axis, which become ``layers.<i>.<path>``.  Dtypes are kept.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str, layer: Optional[int]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.", layer)
            else:
                out[f"{prefix}{k}"] = _tensor(v if layer is None else
                                              np.asarray(v)[layer])

    walk({k: v for k, v in tree.items() if k != "layers"}, "", None)
    n_layers = len(np.asarray(tree["layers"]["ln_attn"]))
    for i in range(n_layers):
        walk(tree["layers"], f"layers.{i}.", i)
    return out
