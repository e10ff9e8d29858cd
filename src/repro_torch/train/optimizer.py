"""AdamW with a WSD (warmup–stable–decay) schedule, for the language models.

The counterpart of the reference's ``train/optimizer.py`` on one card, as
plain functions on dicts of tensors keyed by the model's state-dict names.
The arithmetic is the reference's: the global gradient norm summed in
float32, a clip scale ``min(1, clip / (‖g‖ + 1e-9))``, moments updated in
float32 and stored in ``moment_dtype`` (bfloat16 moments halve the
optimizer's memory), bias correction from the int32 step, decoupled weight
decay on every leaf, and the new parameter computed in float32 and cast to
the parameter's dtype.  ``torch.optim.AdamW`` rounds otherwise in bfloat16
(it updates in the parameter's dtype), so it is not used.

The step, the learning rate and the clip scale stay on the parameters'
device: an update makes no host synchronisation.  This is not
``core/models/nn.adamw``, the performance models' optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..archs.common import DTYPES
from ..archs.lm import params_from_reference, params_to_reference, \
    reference_key

Params = Dict[str, torch.Tensor]

__all__ = ["OptConfig", "wsd_schedule", "opt_init", "opt_update",
           "opt_state_from_reference", "opt_state_to_reference"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # WSD schedule (minicpm's recipe): linear warmup → stable → 1-sqrt decay.
    total_steps: int = 10000
    warmup_steps: int = 100
    decay_frac: float = 0.1


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 scalar on ``like``'s device.  Dividing by it
    rounds once, as the reference does; dividing by a Python number may
    multiply by its reciprocal on the card."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def wsd_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup–Stable–Decay learning-rate schedule (float32, on ``step``'s
    device)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    decay_steps = cfg.decay_frac * cfg.total_steps
    decay_start = cfg.total_steps - decay_steps
    frac = torch.clamp((step - decay_start)
                       / _f32(max(decay_steps, 1), step), 0, 1)
    decay = 1.0 - (1.0 - 0.1) * torch.sqrt(frac)    # → 0.1·lr at the end
    return cfg.lr * warm * decay


def opt_init(params: Mapping[str, torch.Tensor], cfg: OptConfig) -> Params:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter (a
    DTensor parameter's are DTensors placed as it is), and an int32 step 0
    on their device."""
    mdt = DTYPES[cfg.moment_dtype]
    zeros = {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√Σ g² in float32, summed in the reference's leaf order: its tree's
    sorted paths, each per-layer leaf's layers together."""
    order = sorted(grads, key=reference_key)
    total = None
    for n in order:
        s = torch.sum(torch.square(grads[n].to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def opt_update(params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: Params,
               cfg: OptConfig) -> Tuple[Mapping[str, torch.Tensor], Params,
                                        Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``state``'s moments;
    returns (params, state, metrics) as the reference does, with the
    metrics (``lr``, ``grad_norm``) as float32 tensors on the device."""
    step = state["step"] + 1
    lr = wsd_schedule(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9), max=1.0)
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, step_f), step_f)
    bc2 = 1 - torch.pow(_f32(cfg.b2, step_f), step_f)
    mdt = DTYPES[cfg.moment_dtype]
    for n, p in params.items():
        g32 = grads[n].to(torch.float32) * scale
        m32 = state["m"][n].to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g32
        v32 = (state["v"][n].to(torch.float32) * cfg.b2
               + (1 - cfg.b2) * g32 * g32)
        del g32
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (u + cfg.weight_decay * p32))
        state["m"][n].copy_(m32.to(mdt))
        state["v"][n].copy_(v32.to(mdt))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def opt_state_to_reference(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's optimizer state (``m`` and ``v`` as parameter trees,
    ``step``) from the port's, as CPU tensors."""
    return {"m": params_to_reference(state["m"]),
            "v": params_to_reference(state["v"]),
            "step": state["step"].detach().to("cpu", copy=True)}


def opt_state_from_reference(tree: Mapping[str, Any]) -> Params:
    """The port's optimizer state from the reference's (numpy arrays or
    tensors), as CPU tensors."""
    step = tree["step"]
    if not isinstance(step, torch.Tensor):
        step = torch.from_numpy(np.array(step))
    return {"m": params_from_reference(tree["m"]),
            "v": params_from_reference(tree["v"]),
            "step": step.to(dtype=torch.int32)}
