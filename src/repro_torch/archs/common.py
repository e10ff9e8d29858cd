"""Shared architecture machinery: the configuration, primitive layers, init.

The counterpart of the reference's ``archs/common.py``.
:class:`ArchConfig` is carried over field for field, so a configuration
means the same thing on both sides.  ``dtype``, ``use_flash``, ``window``
and ``remat`` act on every run (``remat="block"`` when the model trains);
``moment_dtype`` and ``train_accum`` are read by the training entry points.
The sharding knobs (``act_shard_model``, ``act_shard``, ``pure_dp``) act
under a mesh: the training and serving functions given a ``DeviceMesh``
place the state by :func:`param_specs` and the activations by
``archs/act_sharding.constrain``; without a mesh they change nothing.

The sharding rules are the reference's GSPMD rules.  A spec is a
:class:`P`, one entry a tensor dimension (``None``, a mesh axis name or a
tuple of names), equal to ``tuple()`` of the reference's
``PartitionSpec``; ``train/sharding.py`` turns it into DTensor
placements.  A mesh is read only through its axis names and its shape
(:func:`mesh_sizes`).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["ArchConfig", "rmsnorm", "rope", "init_dense", "MetaGenerator",
           "embed_tokens", "split_heads", "merge_heads", "DTYPES", "P",
           "mesh_sizes", "batch_axes", "param_specs"]

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
    # Execution knobs.  The sharding knobs act only under a mesh.
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
    make two such copies in every layer, and the one copy goes through
    pinned memory without a wait.  Callers only read the tensor."""
    freqs = torch.from_numpy(
        (1.0 / (theta ** (np.arange(0, half) / half))).astype(np.float32))
    if device.type == "cuda":
        freqs = freqs.pin_memory()
    return freqs.to(device, non_blocking=True)


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


def split_heads(t: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(..., h·dh) → (..., h, dh).  DTensor's view rule splits a sharded
    dimension only by a multiple of its ranks: a DTensor whose last
    dimension is split over more ranks than ``h`` is a multiple of is
    gathered along it first."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.ndim - 1
        split = [i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim in (last, -1)]
        if h % int(np.prod([mesh.size(i) for i in split] or [1])):
            t = t.redistribute(mesh, [
                Replicate() if i in split else p
                for i, p in enumerate(t.placements)])
    return t.reshape(tuple(t.shape[:-1]) + (h, dh))


class _GradPlacedAsOutput(torch.autograd.Function):
    """Identity; the gradient flowing back is placed as the output was."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        ctx.placements = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad.redistribute(grad.device_mesh, ctx.placements)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., h, dh) → (..., h·dh).  For a DTensor the gradient flowing back
    is placed as the merged output is, so the backward's split into heads
    meets a dimension DTensor's view rule can split (the product after
    it may hand back a gradient split over more ranks than h)."""
    out = t.reshape(tuple(t.shape[:-2]) + (t.shape[-2] * t.shape[-1],))
    if isinstance(out, DTensor) and out.requires_grad:
        out = _GradPlacedAsOutput.apply(out)
    return out


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]``.  DTensor's embedding rule does not take a
    table split over a mesh whose other axis splits the tokens: a DTensor
    table is gathered whole first (as FSDP gathers a weight)."""
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    return F.embedding(tokens, table)


class MetaGenerator:
    """Stands in for the generator of a model built on the ``meta`` device
    (shapes and dtypes, no values), where torch has no generator."""
    device = torch.device("meta")


def init_dense(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale²) weights (default 1/√fan_in) in ``dtype``, drawn in
    float32 on the generator's device (empty on ``meta``)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * float(s)).to(dtype)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

Axis = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``
    (replicated), a mesh axis name or a tuple of names (the dimension split
    over those axes, the first the major one).  Trailing dimensions
    without an entry are replicated.  ``P("data", None) == ("data",
    None)``, as ``tuple()`` of the reference's ``PartitionSpec`` is; as
    there, a tuple of one name is that name and an empty tuple ``None``."""

    def __new__(cls, *entries: Axis) -> "P":
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None)
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch shards over ('pod' extends 'data')."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


# (path regex, spec WITHOUT the leading scan axis), matched against the
# reference's leaf path ("layers/attn/wq").  'fsdp' resolves to the 'data'
# axis, 'tp' to 'model'.
_RULES = [
    (r"embed$", ("tp", "fsdp")),            # (V, D)
    (r"pos_embed$", (None, "fsdp")),        # (S, D)
    (r"lm_head$", ("fsdp", "tp")),          # (D, V)
    (r"(wq|wk|wv)$", ("fsdp", "tp")),       # (D, H·Dh)
    (r"(bq|bk|bv)$", ("tp",)),              # (H·Dh,)
    (r"wo$", ("tp", "fsdp")),               # (H·Dh, D)
    (r"(w_gate|w_up)$", ("fsdp", "tp")),    # (D, F)
    (r"w_down$", ("tp", "fsdp")),           # (F, D)
    (r"router$", ("fsdp", None)),           # (D, E)
    (r"(e_gate|e_up)$", ("tp", "fsdp", None)),   # (E, D, F) expert parallel
    (r"e_down$", ("tp", None, "fsdp")),     # (E, F, D)
    (r"in_proj$", ("fsdp", "tp")),          # mamba (D, 2·d_in)
    (r"conv_w$", ("tp", None)),             # (d_in, k)
    (r"x_proj$", ("tp", None)),             # (d_in, dt_rank + 2N)
    (r"dt_proj$", (None, "tp")),            # (dt_rank, d_in)
    (r"A_log$", ("tp", None)),              # (d_in, N)
    (r"D$", ("tp",)),                       # (d_in,)
    (r"out_proj$", ("tp", "fsdp")),         # (d_in, D)
    (r"(r_proj|k_proj|v_proj|g_proj|o_proj)$", ("fsdp", "tp")),  # rwkv (D, D)
    (r"w_proj$", ("fsdp", "tp")),           # rwkv decay (D, D)
    (r"(mu_.*|w_bias)$", ("tp",)),          # rwkv per-channel params (D,)
    (r"(ck_proj)$", ("fsdp", "tp")),        # rwkv channel-mix (D, F)
    (r"(cv_proj)$", ("tp", "fsdp")),        # rwkv channel-mix (F, D)
    (r"(norm.*|scale|ln_.*)$", (None,)),    # norms replicated
]


def _resolve(axis: Optional[str], mesh, pure_dp: bool) -> Axis:
    names = mesh.mesh_dim_names
    if axis == "fsdp":
        if pure_dp:
            both = tuple(a for a in ("data", "model") if a in names)
            return both or None
        return "data" if "data" in names else None
    if axis == "tp":
        if pure_dp:
            return None
        return "model" if "model" in names else None
    return axis


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh, pure_dp: bool) -> P:
    """The reference's rule for the leaf at ``path`` of ``shape`` (its
    stacked shape, scan axes first)."""
    sizes = mesh_sizes(mesh)

    def axsize(ax: Axis) -> int:
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return int(np.prod([sizes.get(a, 1) for a in ax]))
        return sizes.get(ax, 1)

    for pat, spec in _RULES:
        if re.search(pat, path):
            axes = [_resolve(a, mesh, pure_dp) for a in spec]
            axes = [None] * (len(shape) - len(axes)) + axes
            return P(*[ax if ax is None or dim % axsize(ax) == 0 else None
                       for dim, ax in zip(shape, axes)])
    return P()  # replicate by default


def param_specs(params: Mapping[str, Any], mesh, *,
                pure_dp: bool = False) -> Dict[str, P]:
    """{state-dict name: :class:`P`} chosen by the reference's leaf-path
    rules, for a model's parameters (``model.state_dict()`` or
    ``named_parameters()``, any device, ``meta`` included).

    Each name is matched by its reference path (``archs/lm.reference_key``)
    against the leaf the reference stacks from it: a per-layer tensor is
    read as its stack, (L, ...) or, for a hybrid group's Mamba leaves,
    (G, n, ...), and gets the stacked spec without its scan entries, which
    are ``None``.  Any sharded dim whose size is not divisible by the
    mesh-axis size falls back to replicated on that dim.  ``pure_dp``
    drops tensor parallelism: FSDP spans data×model.
    """
    from .lm import reference_key

    keys = {n: reference_key(n) for n in params}
    stacks: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    for path, index in keys.values():
        if index:
            top = stacks.get(path, (0,) * len(index))
            stacks[path] = tuple(max(a, i + 1) for a, i in zip(top, index))
    out = {}
    for name, t in params.items():
        path, index = keys[name]
        shape = stacks.get(path, ()) + tuple(t.shape)
        spec = _leaf_spec("/".join(path), shape, mesh, pure_dp)
        if any(ax is not None for ax in spec[:len(index)]):
            raise ValueError(f"{name}: the spec {spec} shards a scan axis")
        out[name] = P(*spec[len(index):])
    return out
