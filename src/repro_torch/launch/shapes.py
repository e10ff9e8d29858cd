"""The assigned input-shape cells and their input specs.

Every LM arch gets 4 shapes; ``long_500k`` runs only for sub-quadratic
families (SSM / hybrid) — full-attention archs skip it.  A spec is a
tensor on the ``meta`` device: its shape and dtype, with no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..archs.common import ArchConfig

__all__ = ["SHAPES", "ShapeCell", "cell_applicable", "train_input_specs",
           "serve_input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ArchConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.supports_long
    return True


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, cell: ShapeCell
                      ) -> Dict[str, torch.Tensor]:
    B, S = cell.global_batch, cell.seq_len
    batch = {"tokens": _spec((B, S), torch.int32),
             "labels": _spec((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = _spec((B, cfg.n_patches, cfg.d_model),
                                 torch.float32)
    if cfg.family == "audio":
        batch["patches"] = _spec((B, cfg.enc_seq, cfg.d_model),
                                 torch.float32)
    return batch


def serve_input_specs(cfg: ArchConfig, cell: ShapeCell
                      ) -> Dict[str, torch.Tensor]:
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "prefill":
        out = {"tokens": _spec((B, S), torch.int32)}
        if cfg.family == "vlm":
            out["patches"] = _spec((B, cfg.n_patches, cfg.d_model),
                                   torch.float32)
        if cfg.family == "audio":
            out["patches"] = _spec((B, cfg.enc_seq, cfg.d_model),
                                   torch.float32)
        return out
    # decode: one new token against an S-token KV cache / state.
    return {"tokens": _spec((B, 1), torch.int32),
            "positions": _spec((B, 1), torch.int32)}
