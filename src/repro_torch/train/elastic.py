"""Elastic scaling and straggler mitigation.

The counterpart of the reference's ``train/elastic.py``, with the
reference's results:

* :func:`plan_elastic_mesh` — given the surviving device count, choose the
  largest viable (data, model) grid (model axis preserved when possible so
  tensor-sharded parameters keep their layout; data axis shrinks).
* :func:`reshard_state` — move params/opt state onto the new mesh (each
  leaf's full value placed with the new mesh's shardings).
* :func:`assign_data_shards` — deterministic data-shard ownership that
  excludes stragglers and rebalances their shards round-robin, so every
  host computes its assignment independently (no coordinator).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..archs.common import P, param_specs
from .sharding import placements

__all__ = ["plan_elastic_mesh", "reshard_state", "assign_data_shards"]


def plan_elastic_mesh(n_devices: int, *, prefer_model: int = 16,
                      axes: Tuple[str, str] = ("data", "model")):
    """Largest (data, model) grid using ≤ n_devices, preferring to keep the
    model axis at ``prefer_model`` (params keep their TP layout)."""
    model = prefer_model
    while model > 1 and n_devices // model == 0:
        model //= 2
    data = max(n_devices // model, 1)
    return (data, model), axes


def reshard_state(state: Mapping[str, Any],
                  params_shape: Mapping[str, torch.Tensor], new_mesh
                  ) -> Dict[str, Any]:
    """A (params-like) state tree {name: tensor}, or a tree of such dicts
    (an optimizer's moments), placed on ``new_mesh`` by
    ``param_specs(params_shape, new_mesh)``; the full values are kept.

    A DTensor leaf is gathered whole from its own mesh first (every rank
    of both meshes calls this), a plain tensor is taken as the full value;
    a tensor that is no parameter (an optimizer's ``step``) is replicated.
    """
    specs = param_specs(params_shape, new_mesh)

    def put(name: str, x: torch.Tensor) -> torch.Tensor:
        full = x.full_tensor() if isinstance(x, DTensor) else x
        return distribute_tensor(full.detach(), new_mesh,
                                 placements(new_mesh, specs.get(name, P())))

    def walk(node: Mapping[str, Any]) -> Dict[str, Any]:
        return {k: put(k, v) if isinstance(v, torch.Tensor)
                else walk(v) if isinstance(v, Mapping) else v
                for k, v in node.items()}
    return walk(state)


def assign_data_shards(n_shards: int, hosts: Sequence[int],
                       stragglers: Sequence[int] = ()) -> Dict[int, List[int]]:
    """Deterministic shard→host assignment excluding stragglers.

    Healthy hosts keep their base shards; orphaned shards (from stragglers)
    are redistributed round-robin by shard index — pure function of the
    inputs, so every participant derives the same plan without coordination.
    """
    healthy = [h for h in hosts if h not in set(stragglers)]
    if not healthy:
        raise ValueError("no healthy hosts")
    base = {h: [] for h in healthy}
    orphans = []
    for s in range(n_shards):
        owner = hosts[s % len(hosts)]
        if owner in base:
            base[owner].append(s)
        else:
            orphans.append(s)
    for i, s in enumerate(orphans):
        base[healthy[i % len(healthy)]].append(s)
    return base
