"""Fixture: the port's and the reference's suppression markers.  The hot
roots are `step` and `stamp`.  Line numbers are pinned by
tests/test_torch_analysis.py — edit both together."""
import time

import torch


def step(x: torch.Tensor):
    a = x.item()  # repro_torch: allow[TH002] fixture: the step's one readback
    b = x.item()  # repro: allow[TH002] the reference's TH marker: ignored
    # repro_torch: allow[TH002]
    c = x.item()                                    # SUP001 on line 12
    # repro_torch: allow[TH001] fixture: nothing branches here any more
    d = 0                                           # SUP002 on line 14
    return a, b, c, d


def stamp(x: torch.Tensor):
    # repro_torch: allow[TH002] fixture: above the reference's marker
    # repro: allow[DT001] fixture: the reference's marker, on its statement
    t0 = time.time() + x.item()
    # repro: allow[DT001] fixture: the reference's marker, cut off: SUP002
    # repro_torch: allow[TH002] fixture: between a marker and its line
    t1 = time.time() + x.item()                     # DT001 live
    return t0, t1
