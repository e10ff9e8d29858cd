"""Architecture registry: ``--arch <id>`` → configuration → model.

``ARCH_IDS`` lists every architecture the reference knows, and the port
has the configuration and the model of each: the dense family
(minicpm-2b, deepseek-coder-33b, glm4-9b, qwen2-72b), the MoE family
(dbrx-132b, moonshot-v1-16b-a3b), the hybrid family
(jamba-1.5-large-398b), the SSM family (rwkv6-1.6b) and the VLM family
(internvl2-76b) as :class:`~repro_torch.archs.lm.LM`, and the audio
family (whisper-base) as :class:`~repro_torch.archs.encdec.EncDec`.
"""
from __future__ import annotations

import importlib
from typing import List, Optional

import torch

from ..device import DeviceLike, resolve_device
from torch import nn

from .common import ArchConfig, MetaGenerator
from .encdec import EncDec
from .lm import LM, LM_FAMILIES

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "build_model"]

ARCH_IDS: List[str] = [
    "minicpm-2b",
    "deepseek-coder-33b",
    "glm4-9b",
    "qwen2-72b",
    "dbrx-132b",
    "moonshot-v1-16b-a3b",
    "jamba-1.5-large-398b",
    "rwkv6-1.6b",
    "whisper-base",
    "internvl2-76b",
]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch_id: str, **overrides) -> ArchConfig:
    cfg = _module(arch_id).config()
    return cfg.with_(**overrides) if overrides else cfg


def get_smoke_config(arch_id: str, **overrides) -> ArchConfig:
    cfg = _module(arch_id).smoke_config()
    return cfg.with_(**overrides) if overrides else cfg


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model of ``cfg`` (an :class:`EncDec` for the audio family, an
    :class:`LM` otherwise) with weights drawn on ``device`` (``None``: the
    CUDA card) from ``generator`` (default: seeded with 0 on that device).
    On ``device="meta"`` the model has shapes and dtypes and no values.
    An unknown family raises ``ValueError``.
    """
    if cfg.family != "audio" and cfg.family not in LM_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = MetaGenerator()
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    if cfg.family == "audio":
        return EncDec(cfg, generator=generator)
    return LM(cfg, generator=generator)
