"""Serving CLI: batched prefill + greedy decode of synthetic prompts.

``python -m repro_torch.launch.serve --arch glm4-9b --batch 4
--prompt-len 32 --gen 16`` builds the model at smoke size (``--full`` for
the published widths) with weights from ``--seed`` on the CUDA card,
prefills a batch of random prompts and decodes greedily.  A VLM model's
patch embeddings and an audio model's frames are drawn after the tokens
from the same numpy stream; the patches take the cache's first slots.
The flags and their defaults are the reference's.  As the reference's
CLI, it serves under the host mesh (``launch/mesh.make_host_mesh``):
every rank of the current process group, or a one-process group it
initialises and ends.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..archs.act_sharding import set_activation_mesh
from ..archs.registry import ARCH_IDS, build_model, get_config, \
    get_smoke_config
from ..device import DeviceLike, resolve_device
from ..launch.mesh import init_host_world, make_host_mesh
from ..train.serve import make_serve_fns


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> np.ndarray:
    """Run the CLI; returns the generated tokens (batch, gen)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="glm4-9b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(
        args.seed))
    n_patches = cfg.n_patches if cfg.family == "vlm" else 0
    max_len = args.prompt_len + args.gen + n_patches
    owns_world = init_host_world(dev)
    try:
        return _serve(args, cfg, model, dev, n_patches, max_len)
    finally:
        set_activation_mesh(None)
        if owns_world:
            dist.destroy_process_group()


def _serve(args, cfg, model, dev, n_patches: int, max_len: int
           ) -> np.ndarray:
    sf = make_serve_fns(model, mesh=make_host_mesh(device=dev))

    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)
    patches = None
    if cfg.family in ("vlm", "audio"):
        rows = cfg.n_patches if cfg.family == "vlm" else cfg.enc_seq
        patches = torch.from_numpy(rng.normal(
            0, 1, (args.batch, rows, cfg.d_model)).astype(np.float32)).to(dev)

    cache = model.init_cache(args.batch, max_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = sf.prefill(tokens, cache, patches)
    nxt = torch.argmax(logits[:, -1], -1)
    generated = [nxt.cpu().numpy()]
    t_prefill = time.perf_counter() - t0
    pos0 = args.prompt_len + n_patches
    t0 = time.perf_counter()
    for t in range(args.gen - 1):
        pos = torch.full((args.batch, 1), pos0 + t, dtype=torch.int64,
                         device=dev)
        logits, cache = sf.decode(nxt[:, None], cache, pos)
        nxt = torch.argmax(logits[:, -1], -1)
        generated.append(nxt.cpu().numpy())
    t_decode = time.perf_counter() - t0
    gen = np.stack(generated, 1)
    print(f"{args.arch}: prefill({args.batch}×{args.prompt_len}) "
          f"{t_prefill*1e3:.0f} ms; {args.gen} decode steps "
          f"{t_decode*1e3:.0f} ms "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s) "
          f"on {dev}")
    print("sample:", gen[0][:12].tolist())
    return gen


if __name__ == "__main__":
    main()
