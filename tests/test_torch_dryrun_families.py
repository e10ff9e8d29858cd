"""Port parity: ``launch/dryrun.py``'s serving cells for every family.

On a fake world of 256 ranks, (16, 16), at production size: ``decode_32k``
for moonshot-v1-16b-a3b and dbrx-132b (MoE), jamba-1.5-large-398b
(hybrid: KV caches and Mamba states), rwkv6-1.6b (RWKV states),
whisper-base (the encoder output in the cache) and internvl2-76b (the
cache sized for its patch slots too), and ``prefill_32k`` for
internvl2-76b with its patches and whisper-base with its frames.  Each
cell reports ``ok``, and its ``argument_bytes`` equal the bytes of each
rank's shards of the parameters, the cache and the inputs under the
reference's specs, the cache built as the reference's dry-run builds it
(``src/repro/launch/dryrun.py``: a VLM's cache holds ``n_patches`` slots
more than the cell's length).  ``test_torch_dryrun.py`` holds the dense
cells and the helpers this file takes.  internvl2-76b's ``prefill_32k``
runs 2 of its 80 layers, here and in the reference's specs: every layer
has the same shards, and the 80 take 243–270 s on the host.

A long prefill's chunked attention under a mesh makes as many DTensor
operations at 256 chunks as at 64 (each rank runs the chunk loop on plain
tensors): on DTensors each chunk's dozens of operations went through
DTensor's dispatch, and the 32k-token prefill cell did not end in 13
minutes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro.archs.registry import build_model as ref_build
from repro.archs.registry import get_config as ref_config
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.launch.shapes import serve_input_specs as ref_serve_specs
from repro.train import sharding as ref_sharding
from repro_torch.archs import blocks
from repro_torch.archs.act_sharding import set_activation_mesh
from repro_torch.launch import dryrun
from test_torch_dryrun import _Named, _ref_mesh, _shard_bytes, world256  # noqa: F401

CELLS = [("moonshot-v1-16b-a3b", "decode_32k", None),
         ("dbrx-132b", "decode_32k", None),
         ("jamba-1.5-large-398b", "decode_32k", None),
         ("rwkv6-1.6b", "decode_32k", None),
         ("whisper-base", "decode_32k", None),
         ("internvl2-76b", "decode_32k", None),
         ("internvl2-76b", "prefill_32k", {"n_layers": 2}),
         ("whisper-base", "prefill_32k", None)]


def _reference_bytes(arch, shape, overrides=None):
    """Each rank's bytes of the parameters, cache and inputs of a serving
    cell under the reference's specs on (16, 16)."""
    rcfg = ref_config(arch, **(overrides or {}))
    api = ref_build(rcfg)
    cell = REF_SHAPES[shape]
    max_len = cell.seq_len + (rcfg.n_patches if rcfg.family == "vlm" else 0)
    p_shape = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: api.init_cache(cell.global_batch,
                                                  max_len))
    ins = ref_serve_specs(rcfg, cell)
    mesh, sizes = _ref_mesh(), {"data": 16, "model": 16}
    pure = dict(pure_dp=rcfg.pure_dp)
    return (_shard_bytes(p_shape, ref_sharding.params_shardings(
                p_shape, mesh, **pure), sizes)
            + _shard_bytes(cache, ref_sharding.cache_shardings(
                cache, mesh, **pure), sizes)
            + _shard_bytes(ins, ref_sharding.batch_shardings(
                ins, mesh, **pure), sizes))


@pytest.mark.parametrize("arch,shape,overrides", CELLS)
def test_serving_cell_runs_at_production_size(arch, shape, overrides,
                                              world256, monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Named)
    row = dryrun.dryrun_cell(arch, shape, overrides=overrides,
                             verbose=False)
    assert row["status"] == "ok", row.get("traceback")
    assert row["mesh"] == "16x16"
    assert row["memory"]["argument_bytes"] == _reference_bytes(
        arch, shape, overrides)
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    cell = REF_SHAPES[shape]
    assert row["tokens_per_step"] == cell.global_batch * (
        1 if cell.kind == "decode" else cell.seq_len)


class _DTensorOps(TorchDispatchMode):
    """Counts the operations dispatched on DTensors (DTensor then runs
    them on its local tensors)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self.n += 1
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("heads", [(64, 8), (8, 8)])
def test_chunked_attention_dispatch_does_not_grow_with_chunks(heads,
                                                              world256):
    """internvl2-76b's heads split over 'model'; whisper-base's 8 do not,
    and each rank takes a slice of the sequence."""
    mesh = dryrun.make_meshes(False)
    set_activation_mesh(mesh)
    try:
        counts = []
        for S in (16384, 32768):
            q, k, v = (distribute_tensor(
                torch.empty((32, h, S, 128), device="meta"), mesh,
                [Replicate(), Replicate()]) for h in (heads[0],) + heads[1:]
                * 2)
            with implicit_replication(), _DTensorOps() as ops:
                y = blocks._attend(q, k, v, causal=True, window=0,
                                   kv_len=S, q_start=0, use_flash=False)
            assert y.shape == q.shape
            counts.append(ops.n)
    finally:
        set_activation_mesh(None)
    assert counts[0] == counts[1], counts
