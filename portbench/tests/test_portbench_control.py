"""The control on the card: the reference put in the program's place one
precision step down (TF32 matmuls in the network, bfloat16 runtime scores)
fails the limits that the program's own run passes, at a small size.  The
cell-size readings are taken with ``portbench/calibrate.py --control``."""
import time

import pytest

from portbench.harness import cell, correct
from portbench.harness.bench import Benchmark


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["tpch.fresh.steady",
                                       "tpch.zipf.steady"])
def test_control_is_not_correct(card, tiny, cell_name):
    b = Benchmark()
    cfg = b.config(b.cell(cell_name)["config"])
    out, rec = cell.run(b, cell_name, 5, 3.0, False, card,
                        time.perf_counter(), overrides=tiny)
    assert out["correct"], out["checks"]
    _, host_w = cell.make_weights(cell.model_configs(cfg),
                                  cfg["models"]["model_seed"], card)
    ctrl = correct.control_readings(rec, host_w, cfg, card)
    limits = cfg["check"]["limits"]
    assert any(ctrl[k] > limits[k] for k in ctrl), ctrl
