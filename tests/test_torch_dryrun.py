"""Port parity: ``launch/dryrun.py`` and ``launch/hlo_analysis.py``.

* ``make_meshes`` gives the reference's shapes for 1, 4, 8, 256 and 512
  ranks, one pod and two (the reference's ``jax.devices`` and
  ``jax.make_mesh`` replaced by a list of n and a recorder; the port's on
  a fake world of n ranks), and ``make_production_mesh`` the reference's
  production meshes;
* ``_active_params`` equals the reference's for all ten configurations,
  and ``roofline_terms`` equals it with the reference's figures pinned
  into the port's module, as ``test_torch_cluster.py`` pins the cost
  model's (unpinned, the figures are the H100's);
* two cells at production size on a fake world of 256 ranks, (16, 16):
  minicpm-2b ``train_4k`` (one microbatch: the default four take about
  70 s on the host and run in the CLI's check) and glm4-9b
  ``decode_32k``.  Each reports ``ok``, and its ``argument_bytes`` equal
  the bytes of each rank's shards under the reference's specs: for the
  train cell the parameters, the optimizer state and the batch; for the
  decode cell the parameters, the cache (whose ``len`` the port keeps as
  a Python int) and the tokens and positions.  The train cell moves
  bytes in collectives; both count FLOPs and bytes;
* a full-attention architecture's ``long_500k`` cell is skipped, with the
  reference's row.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported; the
import here restores the variable.
"""
import importlib
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_config as ref_config
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import mesh as ref_mesh
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.launch.shapes import serve_input_specs as ref_serve_specs
from repro.launch.shapes import train_input_specs as ref_train_specs
from repro.train import sharding as ref_sharding
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro_torch.archs.registry import ARCH_IDS, build_model, get_config
from repro_torch.cluster import costmodel
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_production_mesh


@pytest.fixture(scope="module")
def ref_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _fake_world(n):
    assert not dist.is_initialized(), "a process group is left over"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.fixture
def world256():
    _fake_world(256)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("n", [1, 4, 8, 256, 512])
def test_make_meshes_matches_reference(n, multi_pod, ref_dryrun,
                                       monkeypatch):
    made = []
    monkeypatch.setattr(ref_dryrun.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(ref_dryrun.jax, "make_mesh",
                        lambda shape, axes: made.append((shape, axes)))
    ref_dryrun.make_meshes(multi_pod)
    shape, axes = made[-1]
    assert dryrun.mesh_shape(n, multi_pod) == tuple(shape)
    _fake_world(n)
    try:
        mesh = dryrun.make_meshes(multi_pod)
        assert mesh.shape == tuple(shape)
        assert mesh.mesh_dim_names == tuple(axes)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(multi_pod, monkeypatch):
    """``make_production_mesh`` on a fake world of 512 ranks: the
    reference's shape and axes (its ``jax.make_mesh`` recorded)."""
    made = []
    monkeypatch.setattr(ref_mesh.jax, "make_mesh",
                        lambda shape, axes: made.append((shape, axes)))
    ref_mesh.make_production_mesh(multi_pod=multi_pod)
    _fake_world(512)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert (mesh.shape, mesh.mesh_dim_names) == tuple(
            tuple(x) for x in made[-1])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_match_reference(arch, ref_dryrun):
    api = ref_build(ref_config(arch))
    shape = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    model = build_model(get_config(arch), "meta")
    assert dryrun._active_params(get_config(arch), dict(
        model.named_parameters())) == ref_dryrun._active_params(api.cfg,
                                                                shape)


def test_roofline_terms_match_reference(monkeypatch):
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW,
            hlo_analysis.LINK_BW) == (costmodel.PEAK_FLOPS, costmodel.HBM_BW,
                                      costmodel.LINK_BW) == (989e12, 3.35e12,
                                                             50e9)
    for port_name, value in (("PEAK_FLOPS", ref_hlo.PEAK_FLOPS),
                             ("HBM_BW", ref_hlo.HBM_BW),
                             ("LINK_BW", ref_hlo.ICI_BW)):
        monkeypatch.setattr(hlo_analysis, port_name, value)
    for args in ((1e15, 2e12, 3e9, 256), (4e18, 1e9, 0.0, 512),
                 (1.0, 5e14, 7e12, 1), (0.0, 0.0, 0.0, 8)):
        got = hlo_analysis.roofline_terms(*args)
        want = ref_hlo.roofline_terms(*args)
        assert got.row() == want.row()
        assert (got.bound_s, got.dominant, got.n_chips) == (
            want.bound_s, want.dominant, want.n_chips)


class _Named:
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _shard_bytes(shapes, specs, sizes):
    """Bytes of one device's shards of a tree under the reference's specs
    (every sharded dim divides), ``len`` leaves left out."""
    total = 0
    flat_x = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_s = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, _Named))
    for (kp, x), s in zip(flat_x, flat_s):
        if str(getattr(kp[-1], "key", kp[-1])) == "len":
            continue
        n = 1
        spec = tuple(s.spec) + (None,) * (len(x.shape) - len(s.spec))
        for dim, entry in zip(x.shape, spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            split = int(np.prod([sizes[a] for a in axes] or [1]))
            assert dim % split == 0
            n *= dim // split
        total += n * np.dtype(x.dtype).itemsize
    return total


def _ref_mesh():
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16), dtype=object))


def test_train_cell_runs_at_production_size(world256, monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Named)
    row = dryrun.dryrun_cell("minicpm-2b", "train_4k", accum=1,
                             verbose=False)
    assert row["status"] == "ok", row.get("traceback")
    assert row["mesh"] == "16x16"
    rcfg = ref_config("minicpm-2b")
    api = ref_build(rcfg)
    p_shape = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    o_shape = jax.eval_shape(
        lambda p: ref_opt_init(p, RefOptConfig(moment_dtype=rcfg.moment_dtype)),
        p_shape)
    batch = ref_train_specs(rcfg, REF_SHAPES["train_4k"])
    mesh, sizes = _ref_mesh(), {"data": 16, "model": 16}
    want = (_shard_bytes(p_shape, ref_sharding.params_shardings(p_shape, mesh),
                         sizes)
            + _shard_bytes(o_shape, ref_sharding.opt_shardings(p_shape, mesh),
                           sizes)
            + _shard_bytes(batch, ref_sharding.batch_shardings(batch, mesh),
                           sizes))
    assert row["memory"]["argument_bytes"] == want
    assert row["collective_by_type"] and row["collective_bytes_per_device"] > 0
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    assert row["roofline"]["bound_s"] > 0
    assert row["model_flops"] == 6.0 * row["n_active_params"] * 256 * 4096
    assert 0 < row["useful_flops_ratio"] <= 1


def test_decode_cell_runs_at_production_size(world256, monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Named)
    row = dryrun.dryrun_cell("glm4-9b", "decode_32k", verbose=False)
    assert row["status"] == "ok", row.get("traceback")
    rcfg = ref_config("glm4-9b")
    api = ref_build(rcfg)
    cell = REF_SHAPES["decode_32k"]
    p_shape = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: api.init_cache(cell.global_batch,
                                                  cell.seq_len))
    ins = ref_serve_specs(rcfg, cell)
    mesh, sizes = _ref_mesh(), {"data": 16, "model": 16}
    want = (_shard_bytes(p_shape, ref_sharding.params_shardings(p_shape, mesh),
                         sizes)
            + _shard_bytes(cache, ref_sharding.cache_shardings(cache, mesh),
                           sizes)
            + _shard_bytes(ins, ref_sharding.batch_shardings(ins, mesh),
                           sizes))
    assert row["memory"]["argument_bytes"] == want
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    assert row["tokens_per_step"] == 128


def test_long_cell_of_full_attention_is_skipped(ref_dryrun):
    got = dryrun.dryrun_cell("glm4-9b", "long_500k", verbose=False)
    assert got == ref_dryrun.dryrun_cell("glm4-9b", "long_500k",
                                         verbose=False)
    assert got["status"] == "skipped"
    assert not dist.is_initialized()
