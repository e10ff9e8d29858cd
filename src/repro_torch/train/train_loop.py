"""The language models' training step and loop: gradient accumulation,
per-layer rematerialisation, WSD AdamW, metrics.

The counterpart of the reference's ``train/train_loop.py`` on one card.
``make_train_step`` returns a (params, opt_state, batch) → (params,
opt_state, metrics) function over the model's own parameters, updated in
place; it runs eagerly, without jit, shardings or buffer donation.  The
metrics stay on the card, so a step makes no host synchronisation of its
own; ``train_loop`` reads them back only at logging steps, once each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, \
    Optional, Sequence, Tuple

import torch
from torch import nn

from ..archs.common import ArchConfig
from ..archs.registry import build_model
from ..device import DeviceLike, resolve_device
from .checkpoint import save_checkpoint
from .optimizer import OptConfig, opt_init, opt_update

Params = Dict[str, torch.Tensor]

__all__ = ["make_train_step", "make_init", "train_loop", "TrainStepFns"]


@dataclasses.dataclass
class TrainStepFns:
    """``init()`` → (the model's parameters by state-dict name, a fresh
    optimizer state); ``step(params, opt_state, batch)`` → (params,
    opt_state, metrics).

    The reference's also carries the shardings of the parameters, the
    optimizer state and the batch.  On one card there is no mesh; sharding
    across cards (ROADMAP item 13.4) brings ``torch.distributed``.
    """
    init: Callable[[], Tuple[Params, Params]]
    step: Callable[..., Tuple[Params, Params, Dict[str, torch.Tensor]]]


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
    """Mean loss and gradients over ``accum`` contiguous microbatches, as
    the reference's reshape splits the batch; the gradients are summed
    into float32 buffers, and one microbatch's graph lives at a time."""
    B = batch["tokens"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} microbatches")
    mb = B // accum
    g_acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for t in tensors]
    l_acc = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for i in range(accum):
        loss = model.loss({k: v[i * mb:(i + 1) * mb]
                           for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tensors)
        with torch.no_grad():
            for a, g in zip(g_acc, grads):
                a.add_(g)
            l_acc = l_acc + loss.detach()
        del loss, grads
    scale = 1.0 / accum
    with torch.no_grad():
        return l_acc * scale, [a.mul_(scale) for a in g_acc]


def make_train_step(model: nn.Module, opt_cfg: OptConfig = OptConfig(), *,
                    accum: int = 1) -> TrainStepFns:
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
    """
    if accum < 1:
        raise ValueError(f"accum must be at least 1, got {accum}")
    model.requires_grad_(True)

    def init() -> Tuple[Params, Params]:
        params = dict(model.named_parameters())
        return params, opt_init(params, opt_cfg)

    def step(params: Params, opt_state: Params, batch: Mapping[str, Any]):
        if model.cfg.use_flash:
            raise RuntimeError(
                f"{model.cfg.name}: use_flash is set, and the flash-attention "
                "kernel has no backward pass")
        batch = _to_device(batch, model.device)
        names = list(params)
        tensors = [params[n] for n in names]
        if accum > 1:
            loss, grads = _accum_grads(model, tensors, batch, accum)
        else:
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, tensors)
            loss = loss.detach()
        params, opt_state, metrics = opt_update(
            params, dict(zip(names, grads)), opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return TrainStepFns(init=init, step=step)


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
               steps: int, opt_cfg: OptConfig = OptConfig(), accum: int = 1,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, log_every: int = 10,
               on_step: Optional[Callable[[int, Dict], None]] = None
               ) -> Dict[str, Any]:
    """Train ``model``'s current weights for ``steps`` steps; returns the
    history (the metrics of every ``log_every``-th step and the last, as
    floats, with ``step`` and ``sec``), the parameters, the optimizer state
    and the step functions.  Metrics are read back only at those steps, in
    one transfer.  The reference's ``seed`` draws the initial weights; here
    the model carries them."""
    first = next(data_iter)
    fns = make_train_step(model, opt_cfg, accum=accum)
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
