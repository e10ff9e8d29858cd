"""Port parity: the cluster autotuner (``cluster/``) and ``launch/shapes.py``.

The port's cost model carries the H100's figures; the reference's carry
its own.  Every comparison with the reference first pins the reference's
figures into the port's module (``pin_reference_figures``), so both
packages evaluate the same closed forms on the same numbers and are held
exactly:

* ``ClusterCostModel.stage_eval`` on random unit θ, every block, for the
  10 configurations × 4 shape cells (the six configurations whose family
  is not ported are carried across field for field; dbrx-132b and
  moonshot-v1-16b-a3b take the MoE branches);
* ``autotune``'s launch plans (θ dicts, prediction, front) and
  ``summary()`` with the solve time masked, for the 10 configurations × 3
  weights, on the float64 host route and, for one configuration, with the
  kernel route forced on both sides (both compare in float32);
* ``StepAdapter``'s recommendations and estimates, step by step;
* the shape cells' input specs: the reference's ``ShapeDtypeStruct`` and
  the port's ``meta`` tensors, shape and dtype.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.archs.registry import ARCH_IDS
from repro.archs.registry import get_config as ref_get_config
from repro.cluster import autotune as ref_autotune
from repro.cluster import costmodel as ref_costmodel
from repro.cluster.runtime_adapt import StepAdapter as RefStepAdapter
from repro.core.moo import pareto as ref_pareto
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import shapes as ref_shapes
from repro_torch.archs.common import ArchConfig
from repro_torch.archs.registry import get_config
from repro_torch.cluster import autotune as port_autotune
from repro_torch.cluster import costmodel as port_costmodel
from repro_torch.cluster.params import BLOCKS
from repro_torch.cluster.runtime_adapt import StepAdapter
from repro_torch.core.moo import pareto as port_pareto
from repro_torch.launch import shapes as port_shapes

PORTED = ("minicpm-2b", "deepseek-coder-33b", "glm4-9b", "qwen2-72b")
WEIGHTS = [(0.95, 0.05), (0.5, 0.5), (0.05, 0.95)]
CLUSTER_SRC = pathlib.Path(port_costmodel.__file__).parent


def pin_reference_figures(monkeypatch) -> None:
    """The reference's hardware figures in the port's cost model."""
    for port_name, value in (
            ("PEAK_FLOPS", ref_hlo.PEAK_FLOPS),
            ("HBM_BW", ref_hlo.HBM_BW),
            ("LINK_BW", ref_hlo.ICI_BW),
            ("HBM_CAP", ref_costmodel.HBM_CAP),
            ("CHIP_PRICE_H", ref_costmodel.CHIP_PRICE_H),
            ("TC_EFF", ref_costmodel.MXU_EFF)):
        monkeypatch.setattr(port_costmodel, port_name, value)


def port_config(arch: str) -> ArchConfig:
    """The port's configuration, or the reference's carried field for field
    where the family is not ported."""
    if arch in PORTED:
        return get_config(arch)
    return ArchConfig(**dataclasses.asdict(ref_get_config(arch)))


def _mask_solve_time(summary: str) -> str:
    return re.sub(r"\d+\.\d+s solve\)", "<t>s solve)", summary)


def test_h100_figures_and_no_tpu_figure():
    """Unpinned, the port's cost model holds the H100's figures, and no
    TPU name or figure of the reference stands in its sources."""
    assert port_costmodel.PEAK_FLOPS == 989e12
    assert port_costmodel.HBM_BW == 3.35e12
    assert port_costmodel.HBM_CAP == 80e9
    assert port_costmodel.LINK_BW == 50e9
    assert 0 < port_costmodel.TC_EFF < 1 and port_costmodel.CHIP_PRICE_H > 0
    text = "".join(p.read_text() for p in sorted(CLUSTER_SRC.glob("*.py")))
    for word in ("TPU", "v5e", "MXU", "ICI", "hlo_analysis"):
        assert word not in text, word
    # The link rate is the one figure the two happen to share.
    assert (port_costmodel.PEAK_FLOPS, port_costmodel.HBM_BW,
            port_costmodel.HBM_CAP, port_costmodel.CHIP_PRICE_H,
            port_costmodel.TC_EFF) != (
        ref_hlo.PEAK_FLOPS, ref_hlo.HBM_BW, ref_costmodel.HBM_CAP,
        ref_costmodel.CHIP_PRICE_H, ref_costmodel.MXU_EFF)


def test_unported_family_still_raises():
    with pytest.raises(NotImplementedError, match="item 13"):
        port_autotune.autotune("dbrx-132b", device="cpu")


def test_autotune_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_autotune.autotune("glm4-9b")


@pytest.mark.parametrize("shape", sorted(ref_shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stage_eval_matches_reference(arch, shape, monkeypatch):
    pin_reference_figures(monkeypatch)
    ref = ref_costmodel.ClusterCostModel(ref_get_config(arch),
                                         ref_shapes.SHAPES[shape])
    port = port_costmodel.ClusterCostModel(port_config(arch),
                                           port_shapes.SHAPES[shape])
    assert port.params_block == ref.params_block
    rng = np.random.default_rng(ARCH_IDS.index(arch))
    Tc = rng.random((96, port.cs.dim))
    Tps = rng.random((96, port.ps.dim + port.ss.dim))
    n_infeasible = 0
    for b in range(len(BLOCKS)):
        want = ref.stage_eval(b, Tc, Tps)
        got = port.stage_eval(b, Tc, Tps)
        np.testing.assert_array_equal(got, want)
        n_infeasible += int(np.isinf(got).any(-1).sum())
    if shape == "train_4k" and arch == "qwen2-72b":
        assert n_infeasible > 0      # the feasibility test is exercised


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_autotune_plan_matches_reference(arch, weights, monkeypatch):
    pin_reference_figures(monkeypatch)
    want = ref_autotune.autotune(arch, weights=weights,
                                 arch_cfg=ref_get_config(arch))
    got = port_autotune.autotune(arch, weights=weights,
                                 arch_cfg=port_config(arch), device="cpu")
    _assert_plans_equal(got, want)


def _assert_plans_equal(got, want):
    assert (got.arch, got.shape) == (want.arch, want.shape)
    assert got.theta_c == want.theta_c
    assert got.theta_p == want.theta_p
    assert got.theta_s == want.theta_s
    assert got.predicted == want.predicted
    np.testing.assert_array_equal(got.front, want.front)
    assert _mask_solve_time(got.summary()) == \
        _mask_solve_time(want.summary())


@pytest.fixture
def forced_kernel_route():
    saved = ref_pareto._KERNEL_MIN_N, port_pareto._KERNEL_MIN_N
    ref_pareto._KERNEL_MIN_N = port_pareto._KERNEL_MIN_N = 0
    yield
    ref_pareto._KERNEL_MIN_N, port_pareto._KERNEL_MIN_N = saved


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_autotune_kernel_route_matches_reference(shape, monkeypatch,
                                                 forced_kernel_route):
    """Every mask on the kernel route on both sides: the reference's
    Pallas kernel in interpret mode, the port's plain version.  The
    cluster fronts hold exact duplicate rows, which survive on both; and
    the plan equals the float64 host route's."""
    pin_reference_figures(monkeypatch)
    want = ref_autotune.autotune("qwen2-72b", shape,
                                 arch_cfg=ref_get_config("qwen2-72b"))
    got = port_autotune.autotune("qwen2-72b", shape, device="cpu")
    _assert_plans_equal(got, want)
    rows = {tuple(r) for r in got.front}
    assert len(rows) < got.front.shape[0]           # duplicates kept
    port_pareto._KERNEL_MIN_N = 1 << 30
    _assert_plans_equal(port_autotune.autotune("qwen2-72b", shape,
                                               device="cpu"), got)


def test_step_adapter_matches_reference():
    """The reference's hysteresis case, then seeded random observation
    sequences: every recommendation and estimate equal."""
    seqs = [[(4, 10.0), (4, 10.0), (4, 10.0), (2, 5.0), (4, 10.0), "rec",
             ("rejits", 2), (4, 50.0), "rec"]]
    rng = np.random.default_rng(0)
    for _ in range(8):
        seq = []
        for _ in range(40):
            if rng.random() < 0.3:
                seq.append("rec")
            else:
                seq.append((int(rng.choice([1, 2, 4, 8])),
                            float(rng.gamma(2.0, 3.0))))
        seqs.append(seq)
    kw = [dict(candidates=[1, 2, 4], min_gain=0.1, max_rejits=2)] + \
        [dict(candidates=[1, 2, 4, 8], min_gain=g, max_rejits=r, ema=e)
         for g, r, e in zip(rng.uniform(0, 0.3, 8), rng.integers(1, 5, 8),
                            rng.uniform(0.1, 0.9, 8))]
    n_recs = 0
    for seq, k in zip(seqs, kw):
        ref, port = RefStepAdapter(**k), StepAdapter(**k)
        assert port.recommend() == ref.recommend() is None
        for ev in seq:
            if ev == "rec":
                got, want = port.recommend(), ref.recommend()
                assert got == want
                n_recs += want is not None
            elif ev[0] == "rejits":
                ref._rejits = port._rejits = ev[1]
            else:
                ref.observe(*ev)
                port.observe(*ev)
                assert port._est == ref._est
    assert n_recs >= 3


def _spec(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), str(np.dtype(x.dtype))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_specs_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), port_config(arch)
    assert port_shapes.SHAPES.keys() == ref_shapes.SHAPES.keys()
    for name, cell in ref_shapes.SHAPES.items():
        assert dataclasses.asdict(port_shapes.SHAPES[name]) == \
            dataclasses.asdict(cell)
        assert port_shapes.cell_applicable(cfg, name) == \
            ref_shapes.cell_applicable(ref_cfg, name)
        for fn in ("train_input_specs", "serve_input_specs"):
            want = getattr(ref_shapes, fn)(ref_cfg, cell)
            got = getattr(port_shapes, fn)(cfg, port_shapes.SHAPES[name])
            assert {k: _spec(v) for k, v in got.items()} == \
                {k: _spec(v) for k, v in want.items()}
