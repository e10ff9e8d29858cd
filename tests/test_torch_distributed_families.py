"""Every model family served and trained across two gloo ranks (port only).

One spawned world of two processes (``torch.multiprocessing.spawn``,
``tcp://localhost`` on a free port) runs the float32 smoke model of each
family (moonshot-v1-16b-a3b: MoE; rwkv6-1.6b: RWKV-6; jamba-1.5-large-398b:
attention, Mamba and MoE in groups; whisper-base: encoder–decoder with
its frames; internvl2-76b: the VLM with its patches; glm4-9b: dense GQA)
under the (2, 1) mesh (data parallel, FSDP) and the (1, 2) mesh (tensor
parallel), against the same calls in this process without a mesh:

* two train steps: losses within rtol 1e-5;
* the scoring forward (``make_serve_fns(model, mesh=).score``) with
  ``use_flash`` off and on (on the CPU the flash wrapper runs its plain
  version on each rank's own heads): logits within ``test_torch_lm``'s
  float32 tolerance;
* prefill (a VLM's patches, an audio model's frames with it) and three
  greedy decode steps through the cache the mesh places: each call's
  logits within that tolerance, the greedy tokens equal;
* the chunked attention of long prompts (``blocks._attend`` with the
  chunk threshold at 0), which runs each rank's chunk loop on plain
  tensors: query heads that split over the ranks and three that do not
  (each rank then takes a slice of the sequence and starts its causal
  mask at the slice's offset), GQA, a window and a cache prefix, within
  that tolerance of the chunked attention on whole tensors.

Every family runs in the one world, so the imports are paid once.
"""
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.archs import blocks
from repro_torch.archs.act_sharding import set_activation_mesh
from repro_torch.archs.registry import build_model, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.serve import make_serve_fns
from repro_torch.train.train_loop import make_train_step

ARCHS = ("moonshot-v1-16b-a3b", "rwkv6-1.6b", "jamba-1.5-large-398b",
         "whisper-base", "internvl2-76b", "glm4-9b")
MESHES = {"dp": (2, 1), "tp": (1, 2)}
STEPS = 2
BATCH, PROMPT, DECODE = 2, 12, 3
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=3)
LOSS_RTOL = 1e-5                            # test_torch_distributed's
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)      # test_torch_lm.TOL


def _cfg(arch, **over):
    return get_smoke_config(arch, dtype="float32", **over)


def _inputs(cfg):
    """(tokens (BATCH, PROMPT), patches or frames or None), from a seed."""
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, PROMPT)))
    rows = {"vlm": cfg.n_patches, "audio": cfg.enc_seq}.get(cfg.family)
    patches = None if rows is None else torch.from_numpy(
        rng.normal(0, 1, (BATCH, rows, cfg.d_model)).astype(np.float32))
    return tokens, patches


def _family(arch, mesh):
    """Train losses, scoring logits (flash off, on), and the prefill and
    decode logits and greedy tokens of ``arch`` under ``mesh`` (None: no
    mesh), as plain tensors."""
    cfg = _cfg(arch)
    out = {}
    model = build_model(cfg, "cpu")
    fns = make_train_step(model, OptConfig(**OPT), mesh=mesh)
    params, opt = fns.init()
    losses = []
    for i in range(STEPS):
        batch = make_batch(cfg, global_batch=BATCH, seq_len=PROMPT,
                           step=i)
        params, opt, m = fns.step(params, opt, batch)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    set_activation_mesh(None)
    tokens, patches = _inputs(cfg)
    model = build_model(cfg, "cpu")
    sf = make_serve_fns(model, mesh=mesh)
    for flash in (False, True):
        model.cfg = cfg.with_(use_flash=flash)
        out[f"score_flash_{flash}"] = sf.score(tokens, patches)
    model.cfg = cfg
    pre = patches.shape[1] if cfg.family == "vlm" else 0
    cache = model.init_cache(BATCH, pre + PROMPT + DECODE)
    logits, cache = sf.prefill(tokens, cache, patches)
    steps, nxt = [logits], torch.argmax(logits[:, -1], -1)
    generated = [nxt]
    for t in range(DECODE):
        pos = torch.full((BATCH, 1), pre + PROMPT + t, dtype=torch.int64)
        logits, cache = sf.decode(nxt[:, None], cache, pos)
        nxt = torch.argmax(logits[:, -1], -1)
        steps.append(logits)
        generated.append(nxt)
    set_activation_mesh(None)
    out["serve_logits"] = torch.cat(steps, 1)
    out["generated"] = torch.stack(generated, 1)
    return out


def _attend_cases():
    """{name: (q, k, v, keyword arguments of ``_attend``)}, float32 from a
    seed."""
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    B, D = 2, 8
    prompt = dict(causal=True, window=0, kv_len=None)
    return {"gqa": (t(B, 4, 8, D), t(B, 2, 8, D), t(B, 2, 8, D), prompt),
            "seq_window": (t(B, 3, 8, D), t(B, 3, 8, D), t(B, 3, 8, D),
                           dict(prompt, window=3)),
            "seq_cache": (t(B, 3, 6, D), t(B, 1, 16, D), t(B, 1, 16, D),
                          dict(causal=True, window=0, kv_len=10,
                               q_start=4))}


def _chunked_attention(mesh):
    """Each case of ``_attend_cases`` through ``blocks._attend`` with the
    chunk threshold at 0, on replicated DTensors under ``mesh`` (plain
    tensors without one), as whole tensors."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    saved = blocks._CHUNK_THRESHOLD
    blocks._CHUNK_THRESHOLD = 0
    set_activation_mesh(mesh)
    try:
        out = {}
        for name, (q, k, v, kw) in _attend_cases().items():
            if mesh is not None:
                q, k, v = (distribute_tensor(x, mesh, [Replicate()] * 2)
                           for x in (q, k, v))
            with implicit_replication():
                y = blocks._attend(q, k, v, use_flash=False, **kw)
            out[name] = y.full_tensor() if mesh is not None else y
        return out
    finally:
        blocks._CHUNK_THRESHOLD = saved
        set_activation_mesh(None)


def _worker(rank, port, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        names = ("data", "model")
        meshes = {tag: init_device_mesh("cpu", shape, mesh_dim_names=names)
                  for tag, shape in MESHES.items()}
        out = {(arch, tag): _family(arch, mesh) for arch in ARCHS
               for tag, mesh in meshes.items()}
        out["attend"] = {tag: _chunked_attention(mesh)
                         for tag, mesh in meshes.items()}
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "out.pt"))
    finally:
        set_activation_mesh(None)
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The spawned world's results, and the one-process references."""
    out_dir = str(tmp_path_factory.mktemp("dist_families"))
    mp.spawn(_worker, args=(_free_port(), out_dir), nprocs=2, join=True)
    got = torch.load(os.path.join(out_dir, "out.pt"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = {arch: _family(arch, None) for arch in ARCHS}
        want["attend"] = _chunked_attention(None)
    finally:
        torch.set_num_threads(n)
    return got, want


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_one_process(two_ranks, arch, tag):
    got, want = two_ranks
    np.testing.assert_allclose(got[arch, tag]["losses"],
                               want[arch]["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_scoring_matches_one_process(two_ranks, arch, tag, flash):
    got, want = two_ranks
    key = f"score_flash_{flash}"
    a, b = got[arch, tag][key], want[arch][key]
    assert a.shape == (BATCH, PROMPT, _cfg(arch).vocab)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **SCORE_TOL)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_one_process(two_ranks, arch, tag):
    got, want = two_ranks
    a, b = got[arch, tag], want[arch]
    assert a["serve_logits"].shape == (BATCH, 1 + DECODE, _cfg(arch).vocab)
    np.testing.assert_allclose(a["serve_logits"].numpy(),
                               b["serve_logits"].numpy(), **SCORE_TOL)
    assert torch.equal(a["generated"], b["generated"])


@pytest.mark.parametrize("name", list(_attend_cases()))
@pytest.mark.parametrize("tag", list(MESHES))
def test_chunked_attention_matches_one_process(two_ranks, tag, name):
    got, want = two_ranks
    np.testing.assert_allclose(got["attend"][tag][name].numpy(),
                               want["attend"][name].numpy(), **SCORE_TOL)
