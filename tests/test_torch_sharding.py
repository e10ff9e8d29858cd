"""Port parity: the sharding rules and their placements.

The port's specs (``archs/common.param_specs``, ``train/sharding.py``'s
``opt_``/``batch_``/``cache_shardings``, ``archs/act_sharding.constrain``
and ``archs/blocks._shard_attn_acts``) are held exactly equal to the
reference's, for all ten configurations at full size, on the meshes
(1, 1), (4, 2), (16, 16) and (2, 16, 16), with ``pure_dp`` on and off.
The reference reads a mesh only through ``axis_names`` and
``devices.shape``, so it gets a stand-in mesh; its ``NamedSharding``
(which wants real devices) is replaced by a record of the spec, and its
``with_sharding_constraint`` by one that records the spec it is given.
The port gets ``DeviceMesh``es on a fake world of 512 ranks (the "fake"
backend of ``torch.testing._internal.distributed.fake_pg``), which a
fixture creates and destroys around each test.  The reference's parameter and cache
shapes come from ``jax.eval_shape``, the port's from a model on the
``meta`` device; a port leaf is one layer of a reference leaf stacked on
leading scan axes, whose spec entries must be ``None`` and are dropped.

Also: a tuple of axes shards in the reference's order (the JAX side
computed in a subprocess with eight host devices); ``make_host_mesh``
needs a card unless asked for the CPU.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.archs import act_sharding as ref_act
from repro.archs import blocks as ref_blocks
from repro.archs.common import param_specs as ref_param_specs
from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_config as ref_config
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.launch.shapes import serve_input_specs as ref_serve_specs
from repro.launch.shapes import train_input_specs as ref_train_specs
from repro.train import sharding as ref_sharding
from repro_torch.archs import act_sharding, blocks
from repro_torch.archs.common import P, param_specs
from repro_torch.archs.lm import reference_key
from repro_torch.archs.registry import ARCH_IDS, build_model, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shapes import SHAPES, serve_input_specs, \
    train_input_specs
from repro_torch.train import sharding

WORLD = 512
MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "4x2", "16x16", "2x16x16"]
CACHE_BATCH, CACHE_LEN = 32, 64


@pytest.fixture
def world():
    """A fake world of 512 ranks for a test's meshes."""
    assert not dist.is_initialized(), "a process group is left over"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    yield
    dist.destroy_process_group()


@pytest.fixture(params=MESHES, ids=MESH_IDS)
def meshes(request, world):
    """(the reference's stand-in mesh, the port's DeviceMesh)."""
    shape, names = request.param
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=object))
    return ref, init_device_mesh("cpu", shape, mesh_dim_names=names)


class _Named:
    """Stands in for JAX's ``NamedSharding``: the mesh and the spec."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture
def ref_named(monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Named)
    monkeypatch.setattr(ref_act, "NamedSharding", _Named)


_REF_PARAMS = {}
_PORT_PARAMS = {}


def ref_params_shape(arch):
    if arch not in _REF_PARAMS:
        api = ref_build(ref_config(arch))
        _REF_PARAMS[arch] = (api, jax.eval_shape(api.init,
                                                 jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def port_model(arch):
    if arch not in _PORT_PARAMS:
        _PORT_PARAMS[arch] = build_model(get_config(arch), "meta")
    return _PORT_PARAMS[arch]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec_of(leaf):
    """A reference leaf's spec (a ``PartitionSpec`` or a recorded
    ``NamedSharding``) as a tuple."""
    return tuple(leaf.spec if isinstance(leaf, _Named) else leaf)


def _assert_stacked(port_spec, ref_spec, n_scan, what):
    ref_spec = tuple(ref_spec)
    assert all(a is None for a in ref_spec[:n_scan]), (what, ref_spec)
    assert port_spec == ref_spec[n_scan:], (what, port_spec, ref_spec)


def _assert_params_tree(port, ref, names, what):
    """``port`` {state-dict name: spec} against the reference's tree."""
    assert sorted(port) == sorted(names)
    paths = set()
    for name in names:
        path, index = reference_key(name)
        paths.add(path)
        _assert_stacked(port[name] if isinstance(port[name], P)
                        else port[name].spec,
                        _spec_of(_at(ref, path)), len(index),
                        (what, name))
    ref_paths = {tuple(str(getattr(k, "key", k)) for k in kp)
                 for kp, _ in jax.tree_util.tree_flatten_with_path(
                     ref, is_leaf=lambda x: isinstance(
                         x, (jax.sharding.PartitionSpec, _Named)))[0]}
    assert paths == ref_paths


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch, pure_dp, meshes,
                                             ref_named):
    """``param_specs`` and ``opt_shardings`` at full size; the placements
    shard exactly the dims the spec names, and ``tree_size_bytes`` is the
    reference's."""
    ref_mesh, mesh = meshes
    _, shape = ref_params_shape(arch)
    params = dict(port_model(arch).named_parameters())
    names = list(params)
    got = param_specs(params, mesh, pure_dp=pure_dp)
    _assert_params_tree(got, ref_param_specs(shape, ref_mesh,
                                             pure_dp=pure_dp), names, "param")
    opt = sharding.opt_shardings(params, mesh, pure_dp=pure_dp)
    ref_opt = ref_sharding.opt_shardings(shape, ref_mesh, pure_dp=pure_dp)
    for key in ("m", "v"):
        _assert_params_tree(opt[key], ref_opt[key], names, key)
    assert opt["step"].spec == _spec_of(ref_opt["step"]) == ()
    assert sharding.tree_size_bytes(params) == \
        ref_sharding.tree_size_bytes(shape)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for name, sh in sharding.params_shardings(params, mesh,
                                              pure_dp=pure_dp).items():
        assert sh.spec == got[name]
        want = [Replicate()] * mesh.ndim
        for d, entry in enumerate(got[name]):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and sizes[a] > 1:
                    want[mesh.mesh_dim_names.index(a)] = Shard(d)
        assert sh.placements == want, name


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, pure_dp, meshes,
                                               ref_named):
    """``batch_shardings`` of every shape cell's inputs, and
    ``cache_shardings`` of the family's ``init_cache`` at a divisible
    and an indivisible batch."""
    ref_mesh, mesh = meshes
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, cell in SHAPES.items():
        rcell = REF_SHAPES[name]
        for port_in, ref_in in (
                (train_input_specs(cfg, cell), ref_train_specs(rcfg, rcell)),
                (serve_input_specs(cfg, cell), ref_serve_specs(rcfg, rcell))):
            got = sharding.batch_shardings(port_in, mesh, pure_dp=pure_dp)
            want = ref_sharding.batch_shardings(ref_in, ref_mesh,
                                                pure_dp=pure_dp)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].spec == _spec_of(want[k]), (name, k)
    api, _ = ref_params_shape(arch)
    model = port_model(arch)
    for batch in (CACHE_BATCH, 3):
        cache = model.init_cache(batch, CACHE_LEN)
        got = sharding.cache_shardings(cache, mesh, pure_dp=pure_dp)
        want = ref_sharding.cache_shardings(
            jax.eval_shape(lambda: api.init_cache(batch, CACHE_LEN)),
            ref_mesh, pure_dp=pure_dp)
        n = _compare_cache(cache, got, want, (), ())
        assert n > 0


def _compare_cache(node, got, want, path, index):
    """Every tensor of the port's cache against the reference's leaf at
    its path; lists are the reference's stacked axes.  Returns the number
    of tensors compared."""
    if isinstance(node, dict):
        return sum(_compare_cache(v, got[k], want, path + (k,), index)
                   for k, v in node.items())
    if isinstance(node, list):
        return sum(_compare_cache(v, got[i], want, path, index + (i,))
                   for i, v in enumerate(node))
    if not isinstance(node, torch.Tensor):
        assert got is None
        return 0
    _assert_stacked(got.spec, _spec_of(_at(want, path)), len(index),
                    ("cache", path))
    return 1


CONSTRAINTS = [
    ((64, 128, 256), (("pod", "data"), None, "model")),
    ((64, 128, 256), (("pod", "data"), "model", None)),
    ((6, 128, 256), (("pod", "data"), None, None)),
    ((64, 3, 5), (("pod", "data"), "model", "model")),
    ((64, 32, 2, 64), (("pod", "data", "model"), None, None, None)),
    ((64, 36, 4096, 64), (("pod", "data"), None, "model", None)),
    ((32, 8), ("data",)),
    ((32, 8, 4), (None, ("data", "model"))),
    ((16, 8), ("missing", "model")),
]


def _record(monkeypatch):
    seen = []
    monkeypatch.setattr(ref_act.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    return seen


@pytest.mark.parametrize("shape,spec", CONSTRAINTS)
def test_constrain_fallbacks_match_reference(shape, spec, meshes,
                                             ref_named, monkeypatch):
    """``constrain``'s spec (names off the mesh or not dividing the dim
    dropped) is the reference's, and a DTensor comes out with its
    placements; a plain tensor or no mesh passes through."""
    ref_mesh, mesh = meshes
    seen = _record(monkeypatch)
    saved = act_sharding.get_activation_mesh(), act_sharding.get_pure_dp()
    ref_saved = ref_act.get_activation_mesh(), ref_act.get_pure_dp()
    try:
        ref_act.set_activation_mesh(ref_mesh)
        ref_act.constrain(jax.ShapeDtypeStruct(shape, jax.numpy.float32),
                          *spec)
        act_sharding.set_activation_mesh(mesh)
        got = act_sharding.constraint_spec(mesh, shape, spec)
        assert got == seen[-1]
        x = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                              [Replicate()] * mesh.ndim)
        y = act_sharding.constrain(x, *spec)
        assert list(y.placements) == sharding.placements(mesh, got)
        plain = torch.zeros(2, 3)
        assert act_sharding.constrain(plain, "data") is plain
        act_sharding.set_activation_mesh(None)
        assert act_sharding.constrain(x, *spec) is x
    finally:
        act_sharding.set_activation_mesh(*saved)
        ref_act.set_activation_mesh(*ref_saved)


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("shape", [(64, 32, 128, 64), (64, 36, 4096, 64),
                                   (64, 36, 9, 64), (3, 4, 16, 8)])
def test_attention_constraint_matches_reference(shape, pure_dp, meshes,
                                                ref_named, monkeypatch):
    """``_shard_attn_acts``: heads→model, else sequence→model, else the
    batch axes only; pure DP: batch over the whole mesh."""
    ref_mesh, mesh = meshes
    seen = _record(monkeypatch)
    saved = act_sharding.get_activation_mesh(), act_sharding.get_pure_dp()
    ref_saved = ref_act.get_activation_mesh(), ref_act.get_pure_dp()
    try:
        ref_act.set_activation_mesh(ref_mesh, pure_dp=pure_dp)
        ref_blocks._shard_attn_acts(
            jax.ShapeDtypeStruct(shape, jax.numpy.float32))
        act_sharding.set_activation_mesh(mesh, pure_dp=pure_dp)
        x = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                              [Replicate()] * mesh.ndim)
        y = blocks._shard_attn_acts(x)
        assert list(y.placements) == sharding.placements(mesh, P(*seen[-1]))
    finally:
        act_sharding.set_activation_mesh(*saved)
        ref_act.set_activation_mesh(*ref_saved)


_JAX_ORDER = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
out = {}
for name, spec in (("pod_data", P(("pod", "data"))),
                   ("data_model", P(("data", "model"))),
                   ("all", P(("pod", "data", "model")))):
    idx = NamedSharding(mesh, spec).devices_indices_map((16,))
    out[name] = {d.id: idx[d][0].start or 0 for d in jax.devices()}
print(json.dumps(out))
"""


def test_tuple_axes_shard_in_reference_order():
    """A dimension over ("pod", "data"), ("data", "model") or all three
    axes: each rank of a (2, 2, 2) mesh holds the block the reference's
    device of the same id holds (the first axis the major one).  Each
    rank's offset is DTensor's own, read on a fake world as that rank."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_ORDER], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not dist.is_initialized()
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=(
                "pod", "data", "model"))
            for name, entry in (("pod_data", ("pod", "data")),
                                ("data_model", ("data", "model")),
                                ("all", ("pod", "data", "model"))):
                _, offset = compute_local_shape_and_global_offset(
                    (16,), mesh, sharding.placements(mesh, P(entry)))
                assert offset[0] == want[name][str(rank)], (name, rank)
        finally:
            dist.destroy_process_group()


def test_axes_out_of_mesh_order_raise():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    with pytest.raises(ValueError):
        sharding.placements(mesh, P(("data", "pod")))


def test_host_mesh_needs_a_card_unless_asked_for_the_cpu():
    """``make_host_mesh()`` on a host without a card raises;
    ``device="cpu"`` gives a (1, 1) mesh over a one-process gloo group,
    which is ended here."""
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_host_mesh()
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        assert mesh.shape == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.device_type == "cpu"
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
