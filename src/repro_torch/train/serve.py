"""Serving steps: batched prefill into a KV cache, then one-token decode.

The counterpart of the reference's ``train/serve.py`` on one card: the same
two functions, called eagerly, without jit, shardings or buffer donation
(the cache is updated in place instead, see ``archs/blocks.py``).  Neither
function builds an autograd graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch import nn

__all__ = ["ServeFns", "make_serve_fns"]


@dataclasses.dataclass
class ServeFns:
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode: Callable[..., Tuple[torch.Tensor, Any]]


def make_serve_fns(model: nn.Module) -> ServeFns:
    """``prefill(tokens, cache, patches=None)`` → (last-position logits
    (B, 1, V), cache); ``decode(tokens (B, 1), cache, positions (B, 1))`` →
    (logits, cache).

    ``model`` is what ``registry.build_model`` returns.  The cache comes
    from ``model.init_cache(batch, max_len)``: KV caches, for the SSM and
    hybrid families the recurrent states, which are returned anew each
    call (RWKV reads no positions), and for the audio family the encoder
    output.  ``patches`` are a VLM model's patch embeddings, which take
    the cache's first slots, or an audio model's frames, which prefill
    encodes (launching the flash kernel once an encoder layer when
    ``cfg.use_flash``).  The prompt goes through the cache path, so the
    decoder never launches the flash kernel here, as in the reference.
    """
    def prefill(tokens, cache, patches=None):
        with torch.no_grad():
            return model(tokens, patches=patches, caches=cache,
                         last_only=True)

    def decode(tokens, cache, positions):
        with torch.no_grad():
            return model(tokens, caches=cache, positions=positions)

    return ServeFns(prefill=prefill, decode=decode)
