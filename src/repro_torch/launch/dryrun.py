"""Multi-pod dry-run: run every (arch × shape × mesh) cell on a fake world.

The counterpart of the reference's ``launch/dryrun.py``, with its purpose:
the proof that the distribution config is coherent without real
hardware.  Each cell must run on the single-pod (16, 16) and multi-pod
(2, 16, 16) production meshes for every architecture × input shape, with
the per-rank footprint it shows fitting the card, and with FLOPs, bytes
and collective bytes feeding the roofline table.

Where the reference lowers and compiles the step for 512 host devices,
the port runs it, eagerly, in one process: rank 0 of a fake world of
``DRYRUN_DEVICES`` ranks (default 512, as the reference's; read at each
call).  The fake process group (``FakeStore`` and the "fake" backend,
which come from ``torch.testing._internal.distributed.fake_pg``) completes
every collective at once without moving data; the model is built on the
``meta`` device, so no tensor holds values.  Its parameters, optimizer
state, batch and cache are placed by ``train/sharding.py``'s specs, and
one train step, or one prefill or decode call, runs under the two
counting modes of ``launch/hlo_analysis.py``.  The rows have the
reference's keys: ``memory.argument_bytes`` is the bytes of this rank's
shards of the parameters, optimizer state, batch and cache; its
``temp_bytes`` the peak of the step's own tensors held alive at once;
nothing is compiled, so ``t_compile_s`` and ``code_bytes`` are 0 and
``t_lower_s`` is the time to build and place the state.  Besides the
shape cells, :func:`dryrun_cell` takes any ``ShapeCell`` (``cell=``),
and the kind "score", the cacheless forward over every position.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k [--multi-pod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..archs.act_sharding import set_activation_mesh
from ..archs.lm import reference_key
from ..archs.registry import ARCH_IDS, build_model, get_config
from ..launch.hlo_analysis import (CollectiveCounter, FlopsBytesCounter,
                                   roofline_terms)
from ..launch.shapes import (SHAPES, ShapeCell, cell_applicable,
                             serve_input_specs, train_input_specs)
from ..train.optimizer import OptConfig
from ..train.serve import make_serve_fns
from ..train.sharding import (batch_shardings, cache_shardings, distribute,
                              local_size_bytes)
from ..train.train_loop import make_train_step

__all__ = ["dryrun_cell", "main", "make_meshes", "mesh_shape",
           "fake_world"]


def mesh_shape(n: int, multi_pod: bool) -> Tuple[int, ...]:
    """The reference's mesh for n devices: the production meshes from 512,
    shrunk proportionally below."""
    if n >= 512:
        return (2, 16, 16) if multi_pod else (16, 16)
    if n >= 8:
        if multi_pod:
            m = n // 2
            a = int(2 ** np.floor(np.log2(np.sqrt(m))))
            return (2, max(m // a, 1), a)
        a = int(2 ** np.floor(np.log2(np.sqrt(n))))
        return (max(n // a, 1), a)
    return (1, n) if not multi_pod else (1, 1, n)


def make_meshes(multi_pod: bool):
    """Production meshes over the current world, shrunk proportionally
    when it has fewer than 512 ranks."""
    shape = mesh_shape(dist.get_world_size(), multi_pod)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(n: Optional[int] = None) -> Iterator[None]:
    """A fake process group of ``n`` ranks (default ``DRYRUN_DEVICES``,
    else 512), this process rank 0, for the duration; an existing group is
    used as it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if n is None:
        n = int(os.environ.get("DRYRUN_DEVICES", "512"))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _active_params(cfg, params: Mapping[str, torch.Tensor]) -> float:
    """Active parameter count (MoE experts weighted by k/E)."""
    total = 0.0
    frac = cfg.top_k / cfg.n_experts if cfg.n_experts else 1.0
    for name, x in params.items():
        path = "/".join(reference_key(name)[0])
        n = float(np.prod(x.shape))
        if any(s in path for s in ("e_gate", "e_up", "e_down")):
            n *= frac
        total += n
    return total


def _run_cell(cfg, cell, mesh, accum: int) -> Dict[str, Any]:
    """Build and place the cell's state, run it once under both counting
    modes; returns the counts."""
    t0 = time.perf_counter()
    model = build_model(cfg, "meta")
    params = dict(model.named_parameters())
    n_active = _active_params(cfg, params)
    if cell.kind == "train":
        batch = train_input_specs(cfg, cell)
        fns = make_train_step(model, OptConfig(moment_dtype=cfg.moment_dtype),
                              mesh=mesh, accum=accum)
        params, opt_state = fns.init()
        args_bytes = (local_size_bytes(params) + local_size_bytes(opt_state)
                      + local_size_bytes(distribute(batch,
                                                    fns.batch_sh(batch))))
        t_setup = time.perf_counter() - t0
        with CollectiveCounter() as coll, FlopsBytesCounter() as fb:
            _, _, metrics = fns.step(params, opt_state, batch)
        out_bytes = local_size_bytes(metrics)
        tokens, factor = cell.global_batch * cell.seq_len, 6.0
    else:
        # VLM prefill writes patch + token KV: size the cache for both.
        max_len = cell.seq_len + (cfg.n_patches if cfg.family == "vlm"
                                  else 0)
        sf = make_serve_fns(model, mesh=mesh)
        params = dict(model.named_parameters())
        cache = None
        if cell.kind != "score":
            cache = model.init_cache(cell.global_batch, max_len)
            cache = distribute(cache, cache_shardings(cache, mesh,
                                                      pure_dp=cfg.pure_dp))
        ins = serve_input_specs(cfg, cell)
        args_bytes = (local_size_bytes(params) + local_size_bytes(cache)
                      + local_size_bytes(distribute(ins, batch_shardings(
                          ins, mesh, pure_dp=cfg.pure_dp))))
        t_setup = time.perf_counter() - t0
        with CollectiveCounter() as coll, FlopsBytesCounter() as fb:
            if cell.kind == "prefill":
                logits, _ = sf.prefill(ins["tokens"], cache,
                                       ins.get("patches"))
            elif cell.kind == "score":
                logits = sf.score(ins["tokens"], ins.get("patches"))
            else:
                logits, _ = sf.decode(ins["tokens"], cache,
                                      ins["positions"])
        out_bytes = local_size_bytes(logits)
        tokens = cell.global_batch * (1 if cell.kind == "decode"
                                      else cell.seq_len)
        factor = 2.0
    return {"t_setup": t_setup, "t_run": time.perf_counter() - t0 - t_setup,
            "args_bytes": args_bytes, "out_bytes": out_bytes,
            "temp_bytes": fb.peak_live_bytes, "flops": fb.flops,
            "bytes": fb.bytes, "coll_total": coll.total,
            "coll_by_type": dict(coll.by_type), "n_active": n_active,
            "tokens": tokens, "factor": factor}


def dryrun_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                accum: Optional[int] = None,
                overrides: Optional[Dict[str, Any]] = None,
                verbose: bool = True,
                cell: Optional[ShapeCell] = None) -> Dict[str, Any]:
    """One cell's row; ``cell`` (default ``SHAPES[shape_name]``) may be
    any shape, of the kinds "train", "prefill", "decode" and "score"."""
    cell = cell or SHAPES[shape_name]
    cfg = get_config(arch_id, **(overrides or {}))
    if accum is None:
        accum = cfg.train_accum
    if not cell_applicable(cfg, shape_name):
        return {"arch": arch_id, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch: long_500k requires "
                          "sub-quadratic attention (DESIGN.md)"}
    out: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "multi_pod": multi_pod, "status": "ok"}
    with fake_world():
        try:
            mesh = make_meshes(multi_pod)
            out["mesh"] = "x".join(map(str, mesh.shape))
            n_chips = mesh.size()
            r = _run_cell(cfg, cell, mesh, accum)
            # Per-rank counts; the roofline takes whole-step totals.
            flops_total = r["flops"] * n_chips
            terms = roofline_terms(flops_total, r["bytes"] * n_chips,
                                   r["coll_total"] * n_chips, n_chips)
            model_flops = r["factor"] * r["n_active"] * r["tokens"]
            out.update({
                "t_lower_s": round(r["t_setup"], 2),
                "t_compile_s": 0.0,
                "t_run_s": round(r["t_run"], 2),
                "memory": {
                    "argument_bytes": r["args_bytes"],
                    "output_bytes": r["out_bytes"],
                    "temp_bytes": r["temp_bytes"],
                    "code_bytes": 0,
                    "peak_per_device_gb": round(
                        (r["args_bytes"] + r["temp_bytes"]) / 1e9, 3),
                },
                "flops_per_device": r["flops"],
                "bytes_per_device": r["bytes"],
                "collective_bytes_per_device": r["coll_total"],
                "collective_by_type": r["coll_by_type"],
                "roofline": {
                    "compute_s": terms.compute_s,
                    "memory_s": terms.memory_s,
                    "collective_s": terms.collective_s,
                    "dominant": terms.dominant,
                    "bound_s": terms.bound_s,
                },
                "model_flops": model_flops,
                "n_active_params": r["n_active"],
                "useful_flops_ratio": (model_flops / flops_total
                                       if flops_total else 0.0),
                "tokens_per_step": r["tokens"],
            })
            if verbose:
                rf = out["roofline"]
                print(f"[{arch_id} × {shape_name} × {out['mesh']}] "
                      f"run {r['t_run']:.1f}s | "
                      f"peak/dev {out['memory']['peak_per_device_gb']:.2f} GB"
                      f" | compute {rf['compute_s']*1e3:.2f} ms, "
                      f"memory {rf['memory_s']*1e3:.2f} ms, "
                      f"collective {rf['collective_s']*1e3:.2f} ms "
                      f"→ {rf['dominant']}-bound | "
                      f"useful-FLOPs {out['useful_flops_ratio']:.2f}")
        except Exception as exc:  # noqa: BLE001 — record failures as data
            out["status"] = "error"
            out["error"] = f"{type(exc).__name__}: {exc}"
            out["traceback"] = traceback.format_exc()[-2000:]
            if verbose:
                print(f"[{arch_id} × {shape_name}] FAILED: {out['error']}")
        finally:
            set_activation_mesh(None)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig override key=value (repeatable)")
    args = ap.parse_args(argv)

    overrides: Dict[str, Any] = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for a, s in cells:
        res = dryrun_cell(a, s, multi_pod=args.multi_pod, accum=args.accum,
                          overrides=overrides)
        results.append(res)
        tag = "mp" if args.multi_pod else "sp"
        with open(os.path.join(args.out, f"{a}_{s}_{tag}.json"), "w") as f:
            json.dump(res, f, indent=1)
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    print(f"\n{ok} ok, {sk} skipped, {len(results)-ok-sk} failed "
          f"of {len(results)} cells")


if __name__ == "__main__":
    main()
