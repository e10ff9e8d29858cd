"""Port parity: checkpoints both packages read, resuming from one, and the
training entry points (``launch/train``, ``examples/train_lm``).

A checkpoint crosses both ways: the reference saves and the port restores,
then the port saves and the reference restores.  Every leaf, bfloat16
ones included, comes back bit-equal, and both packages write the same
keys, shapes and dtypes.  Resuming: the reference takes 3 steps and saves;
the port restores into a fresh model and optimizer state and takes step 4,
which must match the reference's step 4 within the tolerances of
``test_torch_train_step``.  A port-only test trains, saves and restores in
a process where ``import jax``, ``import repro`` and ``import ml_dtypes``
fail.
"""
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.train.checkpoint import restore_checkpoint as ref_restore
from repro.train.checkpoint import save_checkpoint as ref_save
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_smoke_config as ref_smoke
from repro_torch.archs.lm import params_from_reference, params_to_reference
from repro_torch.archs.registry import build_model, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.examples import train_lm
from repro_torch.launch import train as port_launch
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import (OptConfig, opt_state_from_reference,
                                         opt_state_to_reference)
from repro_torch.train.train_loop import make_train_step

from test_torch_lm import auto_host_mesh  # noqa: F401
from test_torch_train_step import (LOSS_RTOL, OPT, _pair,  # noqa: F401
                                   _ref_step_fns, assert_state_close,
                                   one_torch_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a):
    """A leaf's bytes as an integer array (bfloat16 through uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_bit_equal(got, want):
    """``got`` (tensors) and ``want`` (arrays) in the reference's layout."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in gl] == [k for k, _ in wl]
    for (k, g), (_, w) in zip(gl, wl):
        assert str(g.dtype).replace("torch.", "") == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(k))


def _ref_state_after_a_step(api, tree, mesh, moment_dtype):
    """The reference's params and optimizer state after one step (moments
    nonzero), as numpy."""
    opt = dict(OPT, moment_dtype=moment_dtype)
    fns = _ref_step_fns(api, mesh, 1, opt)
    p = jax.tree.map(jnp.asarray, tree)
    o = ref_opt_init(p, RefOptConfig(**opt))
    b = make_batch(api.cfg, global_batch=4, seq_len=16, step=0)
    p, o, _ = fns.step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
    return jax.tree.map(np.asarray, (p, o))


@pytest.mark.parametrize("arch,moment_dtype", [("minicpm-2b", "bfloat16"),
                                               ("glm4-9b", "float32")])
def test_checkpoints_cross_both_ways(arch, moment_dtype, tmp_path,
                                     auto_host_mesh):
    api, tree, model = _pair(arch)                       # bfloat16 params
    p, o = _ref_state_after_a_step(api, tree, auto_host_mesh, moment_dtype)
    ref_save(str(tmp_path / "ref"), 1, p, o)

    # The port restores the reference's checkpoint.
    step = make_train_step(model, OptConfig(moment_dtype=moment_dtype))
    like = dict(zip(("params", "opt"), step.init()))
    restored, at = restore_checkpoint(str(tmp_path / "ref"), like)
    assert at == 1
    assert restored["params"]["embed"].dtype == torch.bfloat16
    _assert_trees_bit_equal(
        {"params": params_to_reference(restored["params"]),
         "opt": opt_state_to_reference(restored["opt"])},
        {"params": p, "opt": o})

    # The port saves; the reference restores it and finds the same bits.
    save_checkpoint(str(tmp_path / "port"), 1, restored["params"],
                    restored["opt"])
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          {"params": p, "opt": o})
    back, at = ref_restore(str(tmp_path / "port"), shapes)
    assert at == 1
    _assert_trees_bit_equal(
        {"params": params_to_reference(restored["params"]),
         "opt": opt_state_to_reference(restored["opt"])}, back)
    manifests = [json.load(open(tmp_path / d / "step_1" / "manifest.json"))
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]


def test_params_only_checkpoint(tmp_path):
    """The reference's own round-trip test saves parameters alone."""
    model = build_model(get_smoke_config("glm4-9b"), "cpu")
    sd = model.state_dict()
    save_checkpoint(str(tmp_path), 7, sd)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(str(tmp_path), {"params": sd})
    assert step == 7
    for n, t in sd.items():
        assert torch.equal(restored["params"][n].view(torch.int16),
                           t.view(torch.int16))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"params": dict(
            sd, embed=torch.zeros(3, 3, dtype=torch.bfloat16))})
    with pytest.raises(ValueError, match="leaves differ"):
        restore_checkpoint(str(tmp_path), {"params": dict(
            sd, extra=torch.zeros(3))})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"params": sd})


def test_resume_from_reference_checkpoint_matches_step_4(tmp_path,
                                                         auto_host_mesh):
    api, tree, model = _pair("glm4-9b", dtype="float32")
    fns = _ref_step_fns(api, auto_host_mesh, 1)
    p = jax.tree.map(jnp.asarray, tree)
    o = ref_opt_init(p, RefOptConfig(**OPT))
    batches = [make_batch(api.cfg, global_batch=4, seq_len=16, step=s)
               for s in range(4)]
    for b in batches[:3]:
        p, o, _ = fns.step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
    ref_save(str(tmp_path), 3, p, o)
    p, o, want = fns.step(p, o, {k: jnp.asarray(v)
                                 for k, v in batches[3].items()})

    step = make_train_step(model, OptConfig(**OPT))
    restored, at = restore_checkpoint(str(tmp_path),
                                      dict(zip(("params", "opt"),
                                               step.init())))
    assert at == 3 and int(restored["opt"]["step"]) == 3
    model.load_state_dict(restored["params"])
    params, _ = step.init()
    params, opt_state, got = step.step(params, restored["opt"], batches[3])
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_RTOL * abs(float(want[k])), k
    assert float(got["lr"]) == float(want["lr"])
    assert_state_close(params, opt_state, p, o, float(want["lr"]))


def test_reference_layout_round_trips_the_state_dict():
    """``params_to_reference`` is the inverse of ``params_from_reference``,
    bfloat16 bits included."""
    model = build_model(get_smoke_config("minicpm-2b"), "cpu")
    sd = model.state_dict()
    tree = params_to_reference(sd)
    assert tree["layers"]["attn"]["wq"].shape[0] == model.cfg.n_layers
    assert "lm_head" not in tree                        # tied embedding
    back = params_from_reference(tree)
    assert sorted(back) == sorted(sd)
    for n, t in sd.items():
        assert back[n].dtype == t.dtype
        assert torch.equal(back[n].view(torch.int16), t.view(torch.int16))
    state = opt_state_from_reference(opt_state_to_reference(
        {"m": sd, "v": sd, "step": torch.tensor(9, dtype=torch.int32)}))
    assert int(state["step"]) == 9 and sorted(state["m"]) == sorted(sd)


def test_launch_train_on_host(tmp_path, capsys):
    out = port_launch.main(["--arch", "glm4-9b", "--steps", "6", "--batch",
                            "4", "--seq", "16", "--accum", "2", "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "3", "--device",
                            "cpu"])
    text = capsys.readouterr().out
    assert "glm4-9b: 6 steps in" in text
    assert "  step    6 loss " in text and "loss " in text.splitlines()[-1]
    hist = out["history"]
    assert [h["step"] for h in hist] == [6]
    assert np.isfinite(hist[0]["loss"]) and hist[0]["lr"] > 0
    assert latest_step(str(tmp_path)) == 6
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_3", "step_6"]


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_launch_train_audio_and_vlm_on_host(arch, tmp_path, capsys):
    """``launch.train`` trains the smoke audio and VLM models on the host
    (their batches carry frames or patches): the loss is finite and falls
    from step 10 to step 20, and the checkpoint at step 20 restores
    bit-equal in both packages."""
    out = port_launch.main(["--arch", arch, "--steps", "20", "--batch", "4",
                            "--seq", "16", "--lr", "3e-3", "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "20", "--device",
                            "cpu"])
    assert f"{arch}: 20 steps in" in capsys.readouterr().out
    first, last = (h["loss"] for h in out["history"])
    assert np.isfinite(first) and last < first
    want = {"params": params_to_reference(out["params"]),
            "opt": opt_state_to_reference(out["opt_state"])}
    restored, at = restore_checkpoint(
        str(tmp_path), {"params": out["params"], "opt": out["opt_state"]})
    assert at == 20
    for n, t in out["params"].items():
        assert torch.equal(restored["params"][n], t.detach()), n
    for key in ("m", "v"):
        for n, t in out["opt_state"][key].items():
            assert torch.equal(restored["opt"][key][n], t), (key, n)
    api = ref_build(ref_smoke(arch))
    p_shape = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    o_shape = jax.eval_shape(lambda p: ref_opt_init(p, RefOptConfig()),
                             p_shape)
    back, at = ref_restore(str(tmp_path), {"params": p_shape,
                                           "opt": o_shape})
    assert at == 20
    _assert_trees_bit_equal(want, back)


def test_train_lm_example_on_host(capsys):
    out = train_lm.main(["--steps", "6", "--batch", "4", "--seq", "16",
                         "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("model: minicpm-2b (0.2M params), on cpu")
    assert "restored checkpoint at step 6" in text
    assert out["restored_step"] == 6
    for n, t in out["params"].items():
        assert torch.equal(out["restored"]["params"][n], t.detach())
    for key in ("m", "v"):
        for n, t in out["opt_state"][key].items():
            assert torch.equal(out["restored"]["opt"][key][n], t)
    assert int(out["restored"]["opt"]["step"]) == 6
    assert train_lm.m100_config().n_params_dense == 58_458_112


_PORT_ONLY = r"""
import json, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import torch
from repro_torch.launch.train import main
from repro_torch.train.checkpoint import restore_checkpoint
with tempfile.TemporaryDirectory() as d:
    out = main(["--arch", "minicpm-2b", "--steps", "4", "--batch", "4",
                "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "4",
                "--device", "cpu"])
    restored, at = restore_checkpoint(
        d, {"params": out["params"], "opt": out["opt_state"]})
    same = all(torch.equal(restored["params"][n], t.detach())
               for n, t in out["params"].items())
print(json.dumps({"loss": out["history"][-1]["loss"], "at": at,
                  "same": same}))
"""


def test_port_trains_and_checkpoints_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")                  # see one_torch_thread
    proc = subprocess.run([sys.executable, "-c", _PORT_ONLY], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["at"] == 4 and out["same"]
