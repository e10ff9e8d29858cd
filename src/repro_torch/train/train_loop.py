"""The language models' training step and loop: gradient accumulation,
per-layer rematerialisation, WSD AdamW, metrics.

The counterpart of the reference's ``train/train_loop.py``.
``make_train_step`` returns a (params, opt_state, batch) → (params,
opt_state, metrics) function over the model's own parameters, updated in
place; it runs eagerly, without jit or buffer donation.  The metrics stay
on the card, so a step makes no host synchronisation of its own;
``train_loop`` reads them back only at logging steps, once each.

Given a ``DeviceMesh``, the step registers it for the activation
constraints (``archs/act_sharding``), turns the model's parameters into
DTensors placed by ``train/sharding.params_shardings``, keeps the
optimizer moments beside them (``opt_shardings``), distributes each batch
(``batch_shardings``) and runs the model on DTensors, plain tensors in it
taken as replicated.  Without a mesh nothing of this happens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, \
    Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..archs.act_sharding import set_activation_mesh
from ..archs.common import ArchConfig
from ..archs.registry import build_model
from ..device import DeviceLike, resolve_device
from .checkpoint import save_checkpoint
from .optimizer import OptConfig, opt_init, opt_update
from .sharding import (NamedSharding, batch_shardings, distribute,
                       distribute_model, opt_shardings, params_shardings)

Params = Dict[str, torch.Tensor]

__all__ = ["make_train_step", "make_init", "train_loop", "TrainStepFns"]


@dataclasses.dataclass
class TrainStepFns:
    """``init()`` → (the model's parameters by state-dict name, a fresh
    optimizer state); ``step(params, opt_state, batch)`` → (params,
    opt_state, metrics).

    Under a mesh ``params_sh`` and ``opt_sh`` are the shardings of the
    parameters and the optimizer state (``train/sharding.py``), and
    ``batch_sh(batch)`` gives a batch's; the parameters and moments are
    DTensors, the metrics plain tensors.  Without a mesh the three are
    ``None``.
    """
    init: Callable[[], Tuple[Params, Params]]
    step: Callable[..., Tuple[Params, Params, Dict[str, torch.Tensor]]]
    params_sh: Optional[Dict[str, NamedSharding]] = None
    opt_sh: Optional[Dict[str, Any]] = None
    batch_sh: Optional[Callable[[Mapping[str, Any]], Dict[str, Any]]] = None


def _to_device(batch: Mapping[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The batch's arrays on ``device``; to the card through pinned memory
    and without waiting for the copy."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def _accum_grads(model: nn.Module, tensors: Sequence[torch.Tensor],
                 batch: Dict[str, torch.Tensor], accum: int
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Mean loss and gradients over the ``accum`` microbatches of a batch
    split by :func:`_microbatches`; the gradients are summed into float32
    buffers, and one microbatch's graph lives at a time."""
    g_acc = [torch.zeros_like(t, dtype=torch.float32) for t in tensors]
    l_acc = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for i in range(accum):
        loss = model.loss({k: v[i] for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tensors)
        with torch.no_grad():
            for a, g in zip(g_acc, grads):
                a.add_(g)
            l_acc = l_acc + loss.detach()
        del loss, grads
    scale = 1.0 / accum
    with torch.no_grad():
        return l_acc * scale, [a.mul_(scale) for a in g_acc]


def _microbatches(batch: Dict[str, torch.Tensor], accum: int
                  ) -> Dict[str, torch.Tensor]:
    """Each array (B, ...) as (accum, B / accum, ...): microbatch i is rows
    i·B/accum … (i+1)·B/accum − 1, as the reference's reshape splits the
    batch."""
    B = batch["tokens"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} microbatches")
    return {k: v.reshape((accum, B // accum) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def make_train_step(model: nn.Module, opt_cfg: OptConfig = OptConfig(), *,
                    mesh=None, accum: int = 1) -> TrainStepFns:
    """The training step of ``model``, whose parameters it turns trainable.

    ``model`` is what ``registry.build_model`` returns.  The loss is
    ``model.loss`` (mean next-token cross entropy; a batch's ``patches``,
    a VLM model's patch embeddings or an audio model's frames, go to the
    card with the tokens and into it), its gradients come from autograd
    (each layer recomputed in the backward pass when ``cfg.remat ==
    "block"``), and the update is
    :func:`~repro_torch.train.optimizer.opt_update`.  With ``accum`` > 1 the
    batch's leading axis splits into ``accum`` microbatches.  A model with
    ``cfg.use_flash`` raises: the flash-attention kernel has no backward
    pass, and the step does not fall back to another attention route.

    With ``mesh`` (a ``DeviceMesh`` whose axes are among "pod", "data",
    "model") every rank of it calls the step with the same global batch;
    the model's parameters become DTensors here, the optimizer state
    from ``init()`` is placed beside them, and each microbatch is split
    over the batch axes.
    """
    if accum < 1:
        raise ValueError(f"accum must be at least 1, got {accum}")
    model.requires_grad_(True)
    p_sh = o_sh = batch_sh = None
    if mesh is not None:
        pure_dp = model.cfg.pure_dp
        set_activation_mesh(mesh, pure_dp=pure_dp)
        p_sh = params_shardings(dict(model.named_parameters()), mesh,
                                pure_dp=pure_dp)
        o_sh = opt_shardings(dict(model.named_parameters()), mesh,
                             pure_dp=pure_dp)
        distribute_model(model, p_sh)

        def batch_sh(batch: Mapping[str, Any]) -> Dict[str, Any]:
            return batch_shardings(batch, mesh, pure_dp=pure_dp)

    def init() -> Tuple[Params, Params]:
        params = dict(model.named_parameters())
        opt_state = opt_init(params, opt_cfg)
        if mesh is not None:
            opt_state = distribute(opt_state, o_sh)
        return params, opt_state

    def place(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The batch as (accum, B / accum, ...) DTensors, each microbatch
        split as ``batch_shardings`` splits a batch of its size."""
        mbs = _microbatches(batch, accum)
        sh = batch_sh({k: v[0] for k, v in mbs.items()})
        return distribute(mbs, {k: NamedSharding(mesh, (None,) + s.spec)
                                for k, s in sh.items()})

    def step(params: Params, opt_state: Params, batch: Mapping[str, Any]):
        if model.cfg.use_flash:
            raise RuntimeError(
                f"{model.cfg.name}: use_flash is set, and the flash-attention "
                "kernel has no backward pass")
        batch = _to_device(batch, model.device)
        names = list(params)
        tensors = [params[n] for n in names]
        with (implicit_replication() if mesh is not None
              else contextlib.nullcontext()):
            if mesh is not None:
                batch = place(batch)
                loss, grads = _accum_grads(model, tensors, batch, accum)
            elif accum > 1:
                loss, grads = _accum_grads(model, tensors,
                                           _microbatches(batch, accum), accum)
            else:
                loss = model.loss(batch)
                grads = torch.autograd.grad(loss, tensors)
                loss = loss.detach()
            params, opt_state, metrics = opt_update(
                params, dict(zip(names, grads)), opt_state, opt_cfg)
        metrics = {"loss": loss, **metrics}
        if mesh is not None:
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return params, opt_state, metrics

    return TrainStepFns(init=init, step=step, params_sh=p_sh, opt_sh=o_sh,
                        batch_sh=batch_sh)


def make_init(cfg: ArchConfig, device: DeviceLike = None
              ) -> Callable[[torch.Generator], nn.Module]:
    """The counterpart of the reference's jitted initialiser: a function
    that draws the model of ``cfg`` on ``device`` (``None``: the card) from
    a generator on that device."""
    dev = resolve_device(device)

    def init(generator: torch.Generator) -> nn.Module:
        return build_model(cfg, dev, generator)

    return init


def train_loop(model: nn.Module, data_iter: Iterator[Mapping[str, Any]], *,
               steps: int, mesh=None, opt_cfg: OptConfig = OptConfig(),
               accum: int = 1,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, log_every: int = 10,
               on_step: Optional[Callable[[int, Dict], None]] = None
               ) -> Dict[str, Any]:
    """Train ``model``'s current weights for ``steps`` steps; returns the
    history (the metrics of every ``log_every``-th step and the last, as
    floats, with ``step`` and ``sec``), the parameters, the optimizer state
    and the step functions.  Metrics are read back only at those steps, in
    one transfer.  The reference's ``seed`` draws the initial weights; here
    the model carries them.  ``mesh`` is :func:`make_train_step`'s."""
    first = next(data_iter)
    fns = make_train_step(model, opt_cfg, mesh=mesh, accum=accum)
    params, opt_state = fns.init()
    history = []
    batch = first
    t0 = time.perf_counter()
    step_idx = 0
    while step_idx < steps:
        params, opt_state, metrics = fns.step(params, opt_state, batch)
        step_idx += 1
        if step_idx % log_every == 0 or step_idx == steps:
            keys = sorted(metrics)
            values = torch.stack([metrics[k].to(torch.float32)
                                  for k in keys]).tolist()
            m: Dict[str, Any] = dict(zip(keys, values))
            m["step"] = step_idx
            m["sec"] = time.perf_counter() - t0
            history.append(m)
        if on_step is not None:
            on_step(step_idx, metrics)
        if checkpoint_dir and checkpoint_every and \
                step_idx % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, step_idx, params, opt_state)
        if step_idx < steps:
            batch = next(data_iter)
    return {"history": history, "params": params, "opt_state": opt_state,
            "fns": fns}
