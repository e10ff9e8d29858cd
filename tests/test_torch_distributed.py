"""The port across processes: two gloo ranks on the CPU (port only).

One spawned world of two processes (``torch.multiprocessing.spawn``,
``tcp://localhost`` on a free port) runs every check on the float32
smoke glm4-9b (dense, GQA), against the same steps in this process
without a mesh:

* three train steps (two microbatches each) under the (2, 1) mesh (data
  parallel, FSDP) and under the (1, 2) mesh (tensor parallel): losses and
  gradient norms within rtol 1e-5 of the one-process steps, and the
  parameters within ``test_torch_train_step``'s bounds (rtol 1e-5 and
  atol 1e-7 in all but 1 in 1,000 elements of a leaf, those within 2·lr:
  AdamW moves an element whose gradient sits near ε by an amount its last
  bits decide, and the ranks sum the products in another order);
* ``reshard_state`` of the (2, 1) parameters and moments onto (1, 2):
  full values bit-equal;
* the scoring forward under (1, 2) within ``test_torch_lm``'s float32
  tolerance of the unsharded forward;
* a checkpoint saved under (2, 1) (rank 0 writes the gathered state)
  restored under (1, 2) with the (1, 2) shardings: bit-equal, as DTensors
  placed as asked.
"""
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.archs.act_sharding import set_activation_mesh
from repro_torch.archs.registry import build_model, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import make_train_step

ARCH = "glm4-9b"
STEPS, ACCUM = 3, 2
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=3)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL, PARAM_OUTLIERS = 1e-5, 1e-7, 1e-3
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)      # test_torch_lm.TOL


def _cfg():
    return get_smoke_config(ARCH, dtype="float32")


def _batches():
    return [make_batch(_cfg(), global_batch=4, seq_len=16, step=i)
            for i in range(STEPS)]


def _tokens():
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, _cfg().vocab, (2, 16)))


def _train(mesh):
    """(losses, grad norms, full params, opt state, step fns)."""
    from repro_torch.train.sharding import full_tensors
    model = build_model(_cfg(), "cpu")
    fns = make_train_step(model, OptConfig(**OPT), mesh=mesh, accum=ACCUM)
    params, opt = fns.init()
    losses, norms = [], []
    for b in _batches():
        params, opt, m = fns.step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params, opt, fns


def _worker(rank, port, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.serve import make_serve_fns
    from repro_torch.train.sharding import (full_tensors, opt_shardings,
                                            params_shardings)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        names = ("data", "model")
        dp = init_device_mesh("cpu", (2, 1), mesh_dim_names=names)
        tp = init_device_mesh("cpu", (1, 2), mesh_dim_names=names)
        out = {}
        for tag, mesh in (("dp", dp), ("tp", tp)):
            losses, norms, params, opt, _ = _train(mesh)
            out[tag] = {"losses": losses, "norms": norms,
                        "params": full_tensors(params)}
            if tag == "dp":
                dp_state = (params, opt)
        params, opt = dp_state
        shape = {n: p.detach() for n, p in params.items()}
        want_p, want_o = full_tensors(params), full_tensors(opt)
        moved_p = reshard_state(params, shape, tp)
        moved_o = reshard_state(opt, shape, tp)
        assert all(t.device_mesh == tp for t in moved_p.values())
        out["reshard"] = all(
            torch.equal(full_tensors(moved_p)[n], want_p[n]) for n in want_p
        ) and all(torch.equal(a, b) for k in ("m", "v") for a, b in zip(
            full_tensors(moved_o)[k].values(), want_o[k].values())) \
            and torch.equal(full_tensors(moved_o)["step"], want_o["step"])
        ckpt = os.path.join(out_dir, "ckpt")
        save_checkpoint(ckpt, 3, params, opt)
        set_activation_mesh(None)
        model = build_model(_cfg(), "cpu")
        sh = {"params": params_shardings(dict(model.named_parameters()), tp),
              "opt": opt_shardings(dict(model.named_parameters()), tp)}
        like = {"params": {n: p.detach() for n, p in
                           model.named_parameters()},
                "opt": {"m": dict(want_o["m"]), "v": dict(want_o["v"]),
                        "step": want_o["step"]}}
        got, step = restore_checkpoint(ckpt, like, sh)
        placed = all(isinstance(t, DTensor) and t.device_mesh == tp
                     and list(t.placements) == sh["params"][n].placements
                     for n, t in got["params"].items())
        got = full_tensors(got)
        out["restore"] = step == 3 and placed and all(
            torch.equal(got["params"][n], want_p[n]) for n in want_p) \
            and all(torch.equal(got["opt"][k][n], want_o[k][n])
                    for k in ("m", "v") for n in want_o[k])
        sf = make_serve_fns(build_model(_cfg(), "cpu"), mesh=tp)
        out["score"] = sf.score(_tokens())
        set_activation_mesh(None)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "out.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The spawned world's results, and the one-process references."""
    out_dir = str(tmp_path_factory.mktemp("dist"))
    mp.spawn(_worker, args=(_free_port(), out_dir), nprocs=2, join=True)
    got = torch.load(os.path.join(out_dir, "out.pt"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, norms, params, _, _ = _train(None)
        with torch.no_grad():
            score, _ = build_model(_cfg(), "cpu")(_tokens())
    finally:
        torch.set_num_threads(n)
    return got, {"losses": losses, "norms": norms,
                 "params": {k: v.detach() for k, v in params.items()},
                 "score": score}


def _assert_params_close(got, want):
    for n, w in want.items():
        g = got[n]
        bad = ~torch.isclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        assert bad.sum().item() <= max(1, PARAM_OUTLIERS * w.numel()), n
        assert (g - w)[bad].abs().max().item() <= 2 * OPT["lr"] \
            if bad.any() else True, n


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_two_rank_train_steps_match_one_process(two_ranks, tag):
    got, want = two_ranks
    np.testing.assert_allclose(got[tag]["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[tag]["norms"], want["norms"],
                               rtol=LOSS_RTOL)
    _assert_params_close(got[tag]["params"], want["params"])


def test_reshard_state_keeps_values(two_ranks):
    got, _ = two_ranks
    assert got["reshard"]


def test_checkpoint_restores_onto_another_mesh(two_ranks):
    got, _ = two_ranks
    assert got["restore"]


def test_two_rank_scoring_matches_unsharded(two_ranks):
    got, want = two_ranks
    np.testing.assert_allclose(got["score"].numpy(), want["score"].numpy(),
                               **SCORE_TOL)
