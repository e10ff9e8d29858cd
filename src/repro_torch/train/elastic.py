"""Elastic scaling and straggler mitigation: the mesh plan and data shards.

The counterpart of the reference's ``train/elastic.py``, pure Python with
the reference's results:

* :func:`plan_elastic_mesh` — given the surviving device count, choose the
  largest viable (data, model) grid (model axis preserved when possible so
  tensor-sharded parameters keep their layout; data axis shrinks).
* :func:`assign_data_shards` — deterministic data-shard ownership that
  excludes stragglers and rebalances their shards round-robin, so every
  host computes its assignment independently (no coordinator).

The reference's ``reshard_state`` moves a state onto a new mesh; it comes
with sharding across cards (ROADMAP item 13.4).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

__all__ = ["plan_elastic_mesh", "assign_data_shards"]


def plan_elastic_mesh(n_devices: int, *, prefer_model: int = 16,
                      axes: Tuple[str, str] = ("data", "model")):
    """Largest (data, model) grid using ≤ n_devices, preferring to keep the
    model axis at ``prefer_model`` (params keep their TP layout)."""
    model = prefer_model
    while model > 1 and n_devices // model == 0:
        model //= 2
    data = max(n_devices // model, 1)
    return (data, model), axes


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
