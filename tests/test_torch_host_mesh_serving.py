"""Every family served under the one-rank host mesh on the CPU (port only).

``make_host_mesh(device="cpu")``'s (1, 1) mesh over a one-process gloo
world, which this file makes and ends.  On one rank every DTensor is
whole, so ``make_serve_fns(model, mesh=)`` must run the same kernels on
the same values as ``make_serve_fns(model)``: for the float32 smoke model
of each family with ``use_flash`` (the flash wrapper's plain version on
the host), the scoring forward, prefill (with a VLM's patches or an
audio model's frames) and three greedy decode steps give bit-equal
logits and tokens, on one model object served first without the mesh.

A decode step's attention output, merged from (B, 1, h, dh), once took a
batched product under the mesh where the unsharded tensor folds into one
``mm`` (DTensor's view rule kept the size-1 dimension's stride): the
float32 decode logits of five families up to 6.6e-6 apart.
``chip_smoke.py``'s ``[shard]`` rows hold the same at full width on the
card's NCCL mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.archs.act_sharding import set_activation_mesh
from repro_torch.archs.registry import build_model, get_smoke_config
from repro_torch.launch.mesh import init_host_world, make_host_mesh
from repro_torch.train.serve import make_serve_fns

ARCHS = ("moonshot-v1-16b-a3b", "rwkv6-1.6b", "jamba-1.5-large-398b",
         "whisper-base", "internvl2-76b", "glm4-9b")
BATCH, PROMPT, DECODE = 2, 24, 3


@pytest.fixture(scope="module")
def host_mesh():
    owns = init_host_world("cpu")
    try:
        yield make_host_mesh(device="cpu")
    finally:
        set_activation_mesh(None)
        if owns:
            dist.destroy_process_group()


def _serve(model, fns, tokens, patches):
    """Scoring logits, then prefill and DECODE greedy steps' logits and
    tokens."""
    cfg = model.cfg
    pre = patches.shape[1] if cfg.family == "vlm" else 0
    score = fns.score(tokens, patches)
    logits, cache = fns.prefill(tokens, model.init_cache(
        BATCH, pre + PROMPT + DECODE), patches)
    steps, nxt = [logits], torch.argmax(logits[:, -1], -1)
    generated = [nxt]
    for t in range(DECODE):
        pos = torch.full((BATCH, 1), pre + PROMPT + t, dtype=torch.int64)
        logits, cache = fns.decode(nxt[:, None], cache, pos)
        nxt = torch.argmax(logits[:, -1], -1)
        steps.append(logits)
        generated.append(nxt)
    return [score, torch.cat(steps, 1), torch.stack(generated, 1)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_under_host_mesh_is_bit_equal(host_mesh, arch):
    cfg = get_smoke_config(arch, dtype="float32", use_flash=True)
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, PROMPT)))
    rows = {"vlm": cfg.n_patches, "audio": cfg.enc_seq}.get(cfg.family)
    patches = None if rows is None else torch.from_numpy(rng.normal(
        size=(BATCH, rows, cfg.d_model)).astype(np.float32))
    set_activation_mesh(None)
    plain = _serve(model, make_serve_fns(model), tokens, patches)
    try:
        sharded = _serve(model, make_serve_fns(model, mesh=host_mesh),
                         tokens, patches)
    finally:
        set_activation_mesh(None)
    assert all(isinstance(p, DTensor) for p in model.parameters())
    for what, a, b in zip(("scoring", "prefill and decode", "tokens"),
                          plain, sharded):
        assert not isinstance(b, DTensor)
        assert torch.equal(a, b), (what, float((a - b).abs().max()))
