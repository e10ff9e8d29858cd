"""End-to-end example: train a small LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
        [--m100] [--ckpt DIR] [--device cpu]

Default trains minicpm-2b's smoke configuration (0.2 M parameters);
``--m100`` scales to the deliverable scale (8 layers of width 512 and a
64,000-token vocabulary, 58.5 M parameters with the tied embedding).
Demonstrates: data pipeline → train step (WSD AdamW, per-layer remat) →
checkpoint → restart from the newest checkpoint.  Without ``--ckpt`` the checkpoints go to a temporary
directory that is removed at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from typing import Optional, Sequence

import torch

from ..archs.registry import build_model, get_smoke_config
from ..data.pipeline import data_iterator
from ..device import resolve_device
from ..train.checkpoint import latest_step, restore_checkpoint
from ..train.optimizer import OptConfig
from ..train.train_loop import train_loop


def m100_config():
    """The ``--m100`` configuration: minicpm-2b's family at 8 layers of
    width 512 (8 heads of 64, d_ff 1408) and a 64,000-token vocabulary."""
    return get_smoke_config("minicpm-2b").with_(
        n_layers=8, d_model=512, n_heads=8, n_kv=8, d_head=64, d_ff=1408,
        vocab=64000)


def run(steps: int = 200, batch: int = 8, seq: int = 128, m100: bool = False,
        ckpt: Optional[str] = None, device=None) -> dict:
    """Train, checkpoint at half and at the end, and restore the newest
    checkpoint; print as the reference's script does and return the
    history, the live state, the restored state and its step."""
    dev = resolve_device(device)
    cfg = m100_config() if m100 else get_smoke_config("minicpm-2b")
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), on {dev}")

    opt = OptConfig(lr=3e-3, total_steps=steps,
                    warmup_steps=max(steps // 20, 1))
    it = data_iterator(cfg, global_batch=batch, seq_len=seq)
    with contextlib.ExitStack() as stack:
        if ckpt is None:
            ckpt = stack.enter_context(tempfile.TemporaryDirectory())
        t0 = time.time()
        out = train_loop(model, it, steps=steps, opt_cfg=opt,
                         checkpoint_dir=ckpt,
                         checkpoint_every=max(steps // 2, 1))
        hist = out["history"]
        dt = time.time() - t0
        toks = steps * batch * seq
        print(f"\n{steps} steps in {dt:.1f}s ({toks/dt:.0f} tok/s)")
        print(f"loss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f}")

        # Restart-from-checkpoint demonstration (fault tolerance).
        restored, at = restore_checkpoint(
            ckpt, {"params": out["params"], "opt": out["opt_state"]},
            step=latest_step(ckpt))
    n_tensors = (len(restored["params"]) + len(restored["opt"]["m"])
                 + len(restored["opt"]["v"]) + 1)
    print(f"restored checkpoint at step {at} ({n_tensors} tensors) — "
          f"restart path verified")
    return {"model": model, "history": hist, "params": out["params"],
            "opt_state": out["opt_state"], "restored": restored,
            "restored_step": at, "n_params": n_params}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--m100", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq=args.seq,
               m100=args.m100, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
