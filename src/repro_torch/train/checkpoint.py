"""Checkpoints in the reference's on-disk format: atomic publish, restart.

The counterpart of the reference's ``train/checkpoint.py``, so that either
package restores the other's checkpoints.  Layout: ``<dir>/step_<N>/``
holds ``shard_host0.npz`` (each leaf's raw bytes, flat uint8, under its
path in the reference's tree) and ``manifest.json`` (step, sorted keys,
shapes, dtypes, extra).  The step directory is written under a temporary
name and renamed, so readers never see a partial checkpoint; ``LATEST`` is
rewritten last.

Leaf paths are the reference's: ``params/embed``, ``params/layers/attn/wq``
(per-layer leaves stacked on a leading L axis), ``opt/m/...``,
``opt/v/...`` and ``opt/step``.  The port's state (its model's parameters
and optimizer state by state-dict name) is mapped onto that tree by
``params_to_reference`` / ``opt_state_to_reference`` and back.  bfloat16
leaves go through a 16-bit integer view, so nothing needs ``ml_dtypes``.

A state of DTensors (a step under a mesh) is saved whole: every rank
gathers the full values and rank 0 writes.  A checkpoint restores onto
any mesh, whatever the mesh it was saved from: the values are read whole
and placed by the shardings given, or as the tree they replace is placed.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..archs.lm import params_from_reference, params_to_reference
from .optimizer import opt_state_from_reference, opt_state_to_reference
from .sharding import NamedSharding, full_tensors, tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

# numpy's name of each dtype, as the reference's manifest writes it.
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict's leaves under their "/"-joined paths."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, flat, as uint8."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).reshape(-1).view(np.uint8)


def _from_raw(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(dtype)).copy())
    return t.reshape(shape)


def _place(got: Any, like: Any, path: str = "") -> Any:
    """``got`` in ``like``'s structure, each tensor on ``like``'s (local)
    device; a missing leaf or another shape raises."""
    if isinstance(like, Mapping):
        if sorted(got) != sorted(like):
            missing = sorted(set(like) ^ set(got))
            raise ValueError(f"{path or 'state'}: the checkpoint's leaves "
                             f"differ at {missing[:5]}")
        return {k: _place(got[k], v, f"{path}{k}/") for k, v in like.items()}
    if tuple(got.shape) != tuple(like.shape):
        raise ValueError(f"{path.rstrip('/')}: checkpoint shape "
                         f"{tuple(got.shape)}, expected {tuple(like.shape)}")
    return got.to(like.device)


def save_checkpoint(ckpt_dir: str, step: int, params: Mapping[str, Any],
                    opt_state: Optional[Mapping[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``params`` (and ``opt_state``) as ``step_<step>`` and point
    ``LATEST`` at it; returns the step directory.  With DTensors in the
    state every rank of the default process group calls this: the full
    values are gathered, rank 0 writes, and the others wait for it."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    if any(isinstance(t, DTensor) for t in _flatten(
            {"p": dict(params), "o": dict(opt_state or {})}).values()):
        params = full_tensors(dict(params))
        opt_state = None if opt_state is None else full_tensors(
            dict(opt_state))
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, params, opt_state, extra)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, params, opt_state, extra)


def _write(ckpt_dir: str, step: int, params: Mapping[str, Any],
           opt_state: Optional[Mapping[str, Any]],
           extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    state = {"params": params_to_reference(params)}
    if opt_state is not None:
        state["opt"] = opt_state_to_reference(opt_state)
    arrays = dict(sorted(_flatten(state).items()))
    for path, t in arrays.items():
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"{path}: dtype {t.dtype} has no checkpoint name")
    np.savez(os.path.join(tmp, "shard_host0.npz"),
             **{k: _raw(v) for k, v in arrays.items()})
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _DTYPE_NAMES[v.dtype] for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, tree_like: Mapping[str, Any],
                       shardings: Optional[Mapping[str, Any]] = None,
                       step: Optional[int] = None
                       ) -> Tuple[Dict[str, Any], int]:
    """Restore the checkpoint at ``step`` (default: ``LATEST``).

    ``tree_like`` is a port state tree, ``{"params": {name: tensor}}`` and
    optionally ``"opt"`` (an optimizer state); the result has its
    structure, with the checkpoint's dtypes, each tensor on the device of
    its counterpart there.  A missing leaf or another shape raises.

    ``shardings`` (the reference's argument: a tree like ``tree_like``'s of
    ``train/sharding.NamedSharding``, say ``{"params":
    params_shardings(...), "opt": opt_shardings(...)}``) places each
    leaf as a DTensor on its mesh, which need not be the mesh the
    checkpoint was saved from; without it, a leaf that is a DTensor in
    ``tree_like`` is placed as that one is, any other stays whole.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(d, "shard_host0.npz")) as data:
        for path in manifest["keys"]:
            *dirs, leaf = path.split("/")
            if dirs[0] not in tree_like:
                continue
            node = tree
            for k in dirs:
                node = node.setdefault(k, {})
            node[leaf] = _from_raw(data[path], manifest["dtypes"][path],
                                   manifest["shapes"][path])
    got = {"params": params_from_reference(tree["params"])}
    if "opt" in tree_like:
        got["opt"] = opt_state_from_reference(tree["opt"])
    got = _place(got, tree_like)

    def put(x: torch.Tensor, like: Any, sh: Optional[NamedSharding]):
        if sh is not None:
            return distribute_tensor(x, sh.mesh, sh.placements)
        if isinstance(like, DTensor):
            return distribute_tensor(x, like.device_mesh, like.placements)
        return x
    return tree_map(put, got, tree_like,
                    _complete(shardings or {}, got)), step


def _complete(shardings: Any, tree: Any) -> Any:
    """``shardings`` in ``tree``'s structure, ``None`` where it has no
    entry."""
    if isinstance(tree, Mapping):
        return {k: _complete(shardings.get(k) if isinstance(
            shardings, Mapping) else None, v) for k, v in tree.items()}
    return shardings if isinstance(shardings, NamedSharding) else None
