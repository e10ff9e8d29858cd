"""Sharding of the train and serve state (parameters, optimizer, caches,
batches) over a ``DeviceMesh``, with divisibility-checked fallbacks.

The counterpart of the reference's ``train/sharding.py``, with the same
rules: parameters FSDP-shard over 'data' and tensor-shard over 'model'
(``archs/common.param_specs``); batches shard over ('pod', 'data'); KV
caches shard batch→data and heads→model, degrading to sequence→model
(decode sequence parallelism) when the head count does not divide the
model axis — the GQA-few-KV-heads case.

Each ``*_shardings`` function returns, leaf for leaf, a
:class:`NamedSharding`: the mesh and a spec (``archs/common.P``, equal to
the reference's ``PartitionSpec``), whose ``placements`` are the DTensor
placements that :func:`distribute` applies.  A tree here is the port's own: a state dict
{name: tensor}, the optimizer state {"m", "v", "step"}, a batch {name:
tensor}, or a model's cache (lists of per-layer dicts, which the
reference stacks on a leading axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..archs.common import P, batch_axes, mesh_sizes, param_specs

__all__ = ["NamedSharding", "placements", "params_shardings",
           "opt_shardings", "batch_shardings", "cache_shardings",
           "tree_size_bytes", "local_size_bytes", "distribute",
           "distribute_model", "full_tensors", "tree_map"]


def placements(mesh, spec: P) -> List[Placement]:
    """The DTensor placements of ``spec`` on ``mesh``: a mesh dimension
    gets ``Shard(d)`` if it splits tensor dimension d, else
    ``Replicate()``.

    A dimension split over several axes (("pod", "data"), or under
    ``pure_dp`` ("data", "model")) is ``Shard(d)`` on each of them.
    DTensor splits such a dimension in mesh-dimension order, the first
    mesh dimension the major one, which is the order ``PartitionSpec``
    gives a tuple of axes (its first name the major one); so the axes of
    an entry must come in the mesh's order, as every rule's do.  A mesh
    dimension of size 1 splits nothing, so it gets ``Replicate()``, which
    holds the same values (and spares DTensor's rules a split of a
    size-1 tensor dimension).
    """
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> List[Placement]:
        return placements(self.mesh, self.spec)


def _axsize(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return mesh_sizes(mesh).get(name, 1)


def _named(mesh, specs: Mapping[str, P]) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, s) for k, s in specs.items()}


def params_shardings(params: Mapping[str, torch.Tensor], mesh, *,
                     pure_dp: bool = False) -> Dict[str, NamedSharding]:
    return _named(mesh, param_specs(params, mesh, pure_dp=pure_dp))


def opt_shardings(params: Mapping[str, torch.Tensor], mesh, *,
                  pure_dp: bool = False) -> Dict[str, Any]:
    pspec = param_specs(params, mesh, pure_dp=pure_dp)
    return {"m": _named(mesh, pspec), "v": _named(mesh, pspec),
            "step": NamedSharding(mesh, P())}


def batch_shardings(batch: Mapping[str, torch.Tensor], mesh, *,
                    pure_dp: bool = False) -> Dict[str, NamedSharding]:
    """Leading dim → batch axes (when divisible), rest replicated."""
    baxes = batch_axes(mesh)
    if pure_dp and "model" in mesh.mesh_dim_names:
        baxes = baxes + ("model",)
    bsize = int(np.prod([_axsize(mesh, a) for a in baxes]))

    def spec(x) -> P:
        if x.ndim == 0:
            return P()
        if x.shape[0] % bsize == 0 and x.shape[0] > 0:
            return P(baxes, *([None] * (x.ndim - 1)))
        return P(*([None] * x.ndim))
    return {k: NamedSharding(mesh, spec(x)) for k, x in batch.items()}


def cache_shardings(cache: Any, mesh, *, pure_dp: bool = False) -> Any:
    """KV caches: batch→data axes, heads→model (or seq→model fallback);
    recurrent states (``h``, ``conv``, ``S``, ``x_prev``) and the encoder
    output by their own dims.

    ``cache`` is a model's ``init_cache(batch, max_len)``; the result has
    its structure, a :class:`NamedSharding` at each tensor and ``None`` at
    each other leaf (``len``, an absent Mamba list).  A leaf's rule reads
    it as the reference stacks it: each list it sits in adds a leading
    axis, (L, B, H, C, Dh) for a layer's K, (G, n, B, din, N) for a hybrid
    group's Mamba state, and the spec drops those axes' entries.
    """
    baxes = batch_axes(mesh)
    msize = _axsize(mesh, "model")
    m_name: Optional[str] = "model"
    if pure_dp and "model" in mesh.mesh_dim_names:
        baxes = baxes + ("model",)
        msize = 1
        m_name = None
    bsize = int(np.prod([_axsize(mesh, a) for a in baxes]))

    def spec_leaf(name: str, shape: Tuple[int, ...]) -> P:
        nd = len(shape)
        if nd <= 1:
            return P()
        if name in ("k", "v") and nd == 5:          # (L, B, H, C, Dh)
            L, B, H, C, Dh = shape
            b_ax = baxes if B % bsize == 0 else None
            if m_name and H % msize == 0:
                return P(None, b_ax, m_name, None, None)
            if m_name and C % msize == 0:
                return P(None, b_ax, None, m_name, None)
            return P(None, b_ax, None, None, None)
        if name == "h" and nd == 4:                 # (L, B, din, N)
            L, B, din, N = shape
            b_ax = baxes if B % bsize == 0 else None
            m_ax = m_name if m_name and din % msize == 0 else None
            return P(None, b_ax, m_ax, None)
        if name == "conv" and nd == 4:              # (L, B, k-1, din)
            L, B, K, din = shape
            b_ax = baxes if B % bsize == 0 else None
            m_ax = m_name if m_name and din % msize == 0 else None
            return P(None, b_ax, None, m_ax)
        if name == "S" and nd == 5:                 # (L, B, H, dk, dv)
            L, B, H, dk, dv = shape
            b_ax = baxes if B % bsize == 0 else None
            m_ax = m_name if m_name and H % msize == 0 else None
            return P(None, b_ax, m_ax, None, None)
        if name == "x_prev" and nd == 4:            # (L, B, 1, D)
            L, B, _, D = shape
            b_ax = baxes if B % bsize == 0 else None
            m_ax = m_name if m_name and D % msize == 0 else None
            return P(None, b_ax, None, m_ax)
        if name == "enc_out" and nd == 3:           # (B, Se, D)
            B, Se, D = shape
            b_ax = baxes if B % bsize == 0 else None
            m_ax = m_name if m_name and D % msize == 0 else None
            return P(b_ax, None, m_ax)
        return P(*([None] * nd))

    def walk(node: Any, name: str, stack: Tuple[int, ...]) -> Any:
        if isinstance(node, Mapping):
            return {k: walk(v, k, stack) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name, stack + (len(node),)) for v in node]
        if not isinstance(node, torch.Tensor):
            return None
        spec = spec_leaf(name, stack + tuple(node.shape))
        return NamedSharding(mesh, P(*spec[len(stack):]))
    return walk(cache, "", ())


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of a tree of dicts and lists (and the
    matching leaves of ``rest``); other leaves are kept."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_size_bytes(tree: Any) -> int:
    """Bytes of a tree's tensors at their global shapes."""
    return sum(int(np.prod(x.shape)) * x.element_size()
               for x in _leaves(tree))


def local_size_bytes(tree: Any) -> int:
    """Bytes this rank holds of a tree's tensors: a DTensor's local shard,
    a plain tensor whole."""
    return sum(int(np.prod(t.shape)) * t.element_size()
               for t in (x.to_local() if isinstance(x, DTensor) else x
                         for x in _leaves(tree)))


def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor with its sharding's placements
    (a tensor already a DTensor is redistributed); the full values are
    kept.  A ``None`` sharding leaves its leaf as it is."""
    def put(x: torch.Tensor, sh: Optional[NamedSharding]) -> torch.Tensor:
        if sh is None:
            return x
        if isinstance(x, DTensor):
            return x.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(x, sh.mesh, sh.placements)
    return tree_map(put, tree, shardings)


def distribute_model(model: nn.Module,
                     shardings: Mapping[str, NamedSharding]) -> nn.Module:
    """Replace each of ``model``'s parameters by a DTensor parameter with
    its sharding's placements (same values, same ``requires_grad``); a
    model already placed so is left as it is.  Returns ``model``."""
    for name, p in list(model.named_parameters()):
        sh = shardings[name]
        if isinstance(p, DTensor) and p.device_mesh == sh.mesh \
                and list(p.placements) == sh.placements:
            continue
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        value = distribute({leaf: p.detach()}, {leaf: sh})[leaf]
        owner.register_parameter(
            leaf, nn.Parameter(value, requires_grad=p.requires_grad))
    return model


def full_tensors(tree: Any) -> Any:
    """A tree with each DTensor replaced by its full value on every rank
    (a collective: every rank of its mesh calls it), plain tensors kept."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)
