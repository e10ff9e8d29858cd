"""Serving steps: batched prefill into a KV cache, then one-token decode.

The counterpart of the reference's ``train/serve.py``: the same two
functions, called eagerly, without jit or buffer donation (the cache is
updated in place instead, see ``archs/blocks.py``), and the cacheless
scoring forward beside them.  None of them builds an autograd graph.

Given a ``DeviceMesh``, the model's parameters become DTensors placed by
``train/sharding.params_shardings``, the mesh is registered for the
activation constraints, and each call distributes its tokens
(``batch_shardings``) and a fresh cache (``cache_shardings``) and runs
the model on DTensors (plain tensors in it taken as replicated); the
logits come back whole on every rank, the cache as DTensors.  The flash
kernel then runs on each rank's own heads (``archs/blocks._flash_local``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..archs.act_sharding import set_activation_mesh
from .sharding import (batch_shardings, cache_shardings, distribute,
                       distribute_model, params_shardings)

__all__ = ["ServeFns", "make_serve_fns"]


@dataclasses.dataclass
class ServeFns:
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode: Callable[..., Tuple[torch.Tensor, Any]]
    score: Callable[..., torch.Tensor]


def make_serve_fns(model: nn.Module, *, mesh=None) -> ServeFns:
    """``prefill(tokens, cache, patches=None)`` → (last-position logits
    (B, 1, V), cache); ``decode(tokens (B, 1), cache, positions (B, 1))`` →
    (logits, cache); ``score(tokens, patches=None)`` → logits (B, S, V),
    the cacheless forward (prompt scoring).

    ``model`` is what ``registry.build_model`` returns.  The cache comes
    from ``model.init_cache(batch, max_len)``: KV caches, for the SSM and
    hybrid families the recurrent states, which are returned anew each
    call (RWKV reads no positions), and for the audio family the encoder
    output.  ``patches`` are a VLM model's patch embeddings, which take
    the cache's first slots, or an audio model's frames, which prefill
    encodes (launching the flash kernel once an encoder layer when
    ``cfg.use_flash``).  The prompt goes through the cache path, so the
    decoder never launches the flash kernel in prefill or decode, as in
    the reference; ``score`` launches it once a layer when
    ``cfg.use_flash``.  With ``mesh`` every rank of it makes the same
    calls with the same inputs.
    """
    pure_dp = model.cfg.pure_dp
    context = contextlib.nullcontext
    if mesh is not None:
        set_activation_mesh(mesh, pure_dp=pure_dp)
        distribute_model(model, params_shardings(
            dict(model.named_parameters()), mesh, pure_dp=pure_dp))
        context = implicit_replication

    def place(tree, shardings_of):
        """``tree`` (a tensor, a batch or a cache) placed on the mesh by
        ``shardings_of``; as it is without a mesh."""
        if mesh is None or tree is None:
            return tree
        if isinstance(tree, torch.Tensor):
            return place({"t": tree}, shardings_of)["t"]
        return distribute(tree, shardings_of(tree, mesh, pure_dp=pure_dp))

    def whole(logits: torch.Tensor) -> torch.Tensor:
        return logits.full_tensor() if isinstance(logits, DTensor) \
            else logits

    def prefill(tokens, cache, patches=None):
        with torch.no_grad(), context():
            logits, cache = model(
                place(torch.as_tensor(tokens, device=model.device),
                      batch_shardings),
                patches=place(patches, batch_shardings),
                caches=place(cache, cache_shardings), last_only=True)
            return whole(logits), cache

    def decode(tokens, cache, positions):
        with torch.no_grad(), context():
            logits, cache = model(
                place(torch.as_tensor(tokens, device=model.device),
                      batch_shardings),
                caches=place(cache, cache_shardings),
                positions=place(torch.as_tensor(positions,
                                                device=model.device),
                                batch_shardings))
            return whole(logits), cache

    def score(tokens, patches=None):
        with torch.no_grad(), context():
            logits, _ = model(
                place(torch.as_tensor(tokens, device=model.device),
                      batch_shardings),
                patches=place(patches, batch_shardings))
            return whole(logits)

    return ServeFns(prefill=prefill, decode=decode, score=score)
