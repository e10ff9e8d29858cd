"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains a language model on the synthetic token stream: smoke size by
default, the published widths with ``--full``, on the CUDA card unless
``--device cpu``.  Weights are drawn from ``--seed``, as is the data.  The
flags and the lines printed are the reference's; checkpoints
(``--ckpt-dir``, ``--ckpt-every``) are in its format.  As the reference's
CLI, it trains under the host mesh (``launch/mesh.make_host_mesh``):
every rank of the current process group, or a one-process group it
initialises and ends; the parameters and optimizer state it returns are
whole on every rank.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..archs.act_sharding import set_activation_mesh
from ..archs.registry import ARCH_IDS, build_model, get_config, \
    get_smoke_config
from ..data.pipeline import data_iterator
from ..device import resolve_device
from ..launch.mesh import init_host_world, make_host_mesh
from ..train.optimizer import OptConfig
from ..train.sharding import full_tensors
from ..train.train_loop import train_loop


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns ``train_loop``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(
        args.seed))
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1),
                        moment_dtype=cfg.moment_dtype)
    it = data_iterator(cfg, global_batch=args.batch, seq_len=args.seq,
                       seed=args.seed)
    owns_world = init_host_world(dev)
    try:
        mesh = make_host_mesh(device=dev)
        t0 = time.time()
        out = train_loop(model, it, steps=args.steps, mesh=mesh,
                         opt_cfg=opt_cfg, accum=args.accum,
                         checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=args.ckpt_every)
        out["params"] = full_tensors(out["params"])
        out["opt_state"] = full_tensors(out["opt_state"])
    finally:
        set_activation_mesh(None)
        if owns_world:
            dist.destroy_process_group()
    hist = out["history"]
    print(f"\n{args.arch}: {args.steps} steps in {time.time()-t0:.1f}s")
    for h in hist[:3] + hist[-3:]:
        print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
              f"lr {h['lr']:.2e} |g| {h['grad_norm']:.3f}")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.3f} → {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return out


if __name__ == "__main__":
    main()
