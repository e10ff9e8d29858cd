"""Device meshes over ``torch.distributed``.

The counterpart of the reference's ``launch/mesh.py``.  A mesh is a
``DeviceMesh`` with named axes, one rank a device:

* production, single pod: 16×16 = 256 ranks ("data", "model");
* production, multi-pod: 2×16×16 = 512 ranks ("pod", "data", "model") —
  the "pod" axis extends data parallelism across pods;
* the host mesh: every rank of the current world (tests, smoke runs).

Defined as functions, so importing this module initialises nothing.  A
mesh needs a process group of its size: the launcher's (``torchrun``
and the like), or for :func:`make_host_mesh` a one-process group it
initialises itself, NCCL on the card and gloo on the host, over an
in-memory store (``dist.HashStore``), so it needs no port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "init_host_world"]


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """(16, 16) or (2, 16, 16) over a world of 256 or 512 ranks, on
    ``device`` (``None``: the card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def init_host_world(device: DeviceLike = None) -> bool:
    """Initialise a one-process group for ``device`` (``None``: the card)
    unless one exists; returns whether it did."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: DeviceLike = None):
    """Small mesh over every rank of the current world (tests / smoke
    runs), on ``device`` (``None``: the card, which must exist); without a
    process group, a one-process one (:func:`init_host_world`).  The
    default shape is the reference's: (n, 1) on two axes, else (n,)."""
    dev = resolve_device(device)
    init_host_world(dev)
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1) if len(axes) == 2 else (n,)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)
