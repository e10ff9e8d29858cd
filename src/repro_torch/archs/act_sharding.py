"""Activation sharding constraints inside model code.

The counterpart of the reference's ``archs/act_sharding.py``.  Model code
is mesh-agnostic; the training and serving functions register the active
``DeviceMesh`` here and :func:`constrain` redistributes a DTensor
activation to the placements of a spec, with divisibility-checked axis
fallbacks (the reference's ``with_sharding_constraint``).  The key
consumer is the layer carry: constraining it to P(('pod','data'), None,
as well as the batch axes.

The rest is what GSPMD plans for the whole step in the reference and
DTensor decides op by op: :func:`gather_weights` gives a layer its
weights whole along the batch axes (the FSDP split) and still split
along 'model' (the tensor-parallel split), the all-gather FSDP makes
before a layer runs, whose backward reduce-scatters the gradient onto
the stored split; :func:`gather_input` gives its products their input
whole along 'model'.  Without them DTensor keeps the splits through the
products and reduces their (much larger) outputs instead.

Without a registered mesh, or on a plain tensor, :func:`constrain` returns
its input, so a run on one card without a mesh is unchanged.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from .common import P, mesh_sizes

__all__ = ["set_activation_mesh", "get_activation_mesh", "get_pure_dp",
           "constrain", "constraint_spec", "gather_input", "gather_weight",
           "gather_weights", "BATCH_AXES"]

BATCH_AXES: Tuple[str, ...] = ("pod", "data")

_CTX = threading.local()


def set_activation_mesh(mesh, pure_dp: bool = False) -> None:
    _CTX.mesh = mesh
    _CTX.pure_dp = pure_dp


def get_activation_mesh():
    return getattr(_CTX, "mesh", None)


def get_pure_dp() -> bool:
    return getattr(_CTX, "pure_dp", False)


def constrain(x: torch.Tensor, *spec: Union[None, str, Tuple[str, ...]]
              ) -> torch.Tensor:
    """Best-effort sharding constraint; no-op without a registered mesh or
    on a plain tensor.

    Each entry is an axis name, a tuple of names, or None; names missing
    from the mesh or not dividing the dim are dropped.
    """
    mesh = get_activation_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    from ..train.sharding import placements
    return x.redistribute(mesh, placements(
        mesh, constraint_spec(mesh, x.shape, spec)))


def constraint_spec(mesh, shape, spec) -> P:
    """The spec :func:`constrain` applies to a tensor of ``shape``."""
    sizes = mesh_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in sizes)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        fixed.append(axes if axes and dim % n == 0 else None)
    if len(fixed) < len(shape):
        fixed += [None] * (len(shape) - len(fixed))
    return P(*fixed)


def gather_weight(t: torch.Tensor) -> torch.Tensor:
    """One weight as :func:`gather_weights` gives it."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    keep = () if get_pure_dp() else ("model",)
    placed = [p if names[i] in keep else Replicate()
              for i, p in enumerate(t.placements)]
    if placed == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placed)


def gather_weights(p: Mapping[str, Any]) -> Dict[str, Any]:
    """A layer's weights for compute: each DTensor gathered along every
    mesh axis but 'model' (every axis under ``pure_dp``, where FSDP spans
    the whole mesh); plain tensors as they are."""
    return {k: gather_weight(v) for k, v in p.items()}


def gather_input(x: torch.Tensor) -> torch.Tensor:
    """A layer's (B, S, D) input whole along 'model' and split along the
    batch axes (under ``pure_dp`` along the whole mesh): the all-gather
    that ends the carry's split of d_model before the tensor-parallel
    products, which DTensor would otherwise run on the split input and
    reduce-scatter their (larger) outputs."""
    if get_activation_mesh() is None or not isinstance(x, DTensor):
        return x
    baxes = BATCH_AXES + ("model",) if get_pure_dp() else BATCH_AXES
    return constrain(x, baxes, *([None] * (x.ndim - 1)))
