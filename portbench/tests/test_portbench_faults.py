"""The comparison catches a broken timed path: a run of a small cell on
the host, with a fault planted underneath, comes out not correct; the same
run without the fault comes out correct.  (The harness's look for a card
is in ``run.py``; these drive the rest of a run.)"""
import time

import numpy as np
import pytest

from portbench.harness import cell
from portbench.harness.bench import Benchmark
from portbench.reference.decisions import pick_scores
from repro_torch.core.models.perf_model import PerfModel
from repro_torch.core.moo import hmooc as hmooc_mod
from repro_torch.core.tuning import compile_time as ct_mod
from repro_torch.serve import runtime as runtime_mod
from repro_torch.serve.runtime import RuntimeSession
from repro_torch.serve import service as service_mod


def _run(cell_name="tpch.fresh.steady", seed=11, seconds=3.0):
    from conftest import TINY
    out, _ = cell.run(Benchmark(), cell_name, seed, seconds, False, "cpu",
                      time.perf_counter(), overrides=TINY)
    return out


def _failed(out):
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell_name", ["tpch.fresh.steady",
                                       "tpch.zipf.steady"])
def test_sound_run_is_correct(cell_name):
    out = _run(cell_name)
    assert out["correct"], out["checks"]
    b = Benchmark()
    rate = b.traffic(b.cell(cell_name)["traffic"])["arrivals"]["rate_qps"]
    assert out["attempted"] == round(rate * 3.0) and out["failed"] == 0


def test_compile_time_answer_altered(monkeypatch):
    orig = PerfModel.predict_rows
    monkeypatch.setattr(PerfModel, "predict_rows",
                        lambda self, *a: orig(self, *a) * 1.001)
    out = _run()
    assert not out["correct"] and {"pred_gap", "plan_gap"} <= _failed(out)


def test_runtime_answer_altered(monkeypatch):
    orig = PerfModel.predict
    monkeypatch.setattr(PerfModel, "predict",
                        lambda self, *a: orig(self, *a) * 1.001)
    out = _run("tpch.zipf.steady")
    assert not out["correct"] and "pred_gap" in _failed(out)


def test_mask_altered(monkeypatch):
    orig = hmooc_mod.pareto_masks_fast

    def flipped(Fs, *a, **kw):
        masks = orig(Fs, *a, **kw)
        for m in masks:
            if m.sum() > 1:
                m[np.nonzero(m)[0][-1]] = False
        return masks
    monkeypatch.setattr(hmooc_mod, "pareto_masks_fast", flipped)
    out = _run()
    assert not out["correct"] and "mask_mismatch" in _failed(out)


def test_wun_pick_altered(monkeypatch):
    orig = ct_mod.wun_select

    def shifted(F, w):
        i, _ = orig(F, w)
        j = (i + 1) % len(F)
        return j, F[j]
    monkeypatch.setattr(ct_mod, "wun_select", shifted)
    out = _run()
    assert not out["correct"] and "wun_mismatch" in _failed(out)


def test_runtime_pick_altered(monkeypatch):
    def worst(Fs, weights, **kw):
        w = np.asarray(weights, np.float64)
        return [int(np.argmax(pick_scores(F, w[r] if w.ndim == 2 else w)))
                for r, F in enumerate(Fs)]
    monkeypatch.setattr(runtime_mod, "weighted_pick_batch", worst)
    out = _run("tpch.zipf.steady")
    assert not out["correct"] and "pick_gap" in _failed(out)


def test_runtime_step_keeps_its_state(monkeypatch):
    """Every runtime re-tuning answers the θ the stage already runs with
    (the candidate row after the shared pool)."""
    def unchanged(Fs, weights, **kw):
        return [64] * len(Fs)
    monkeypatch.setattr(runtime_mod, "weighted_pick_batch", unchanged)
    out = _run("tpch.zipf.steady")
    assert not out["correct"] and "pick_gap" in _failed(out)


def test_half_the_batch_left_out(monkeypatch):
    """A fused stage evaluation scores the first half of its requests and
    answers the rest with the mean of those."""
    orig = service_mod.fused_stage_eval

    def half(items):
        n = (len(items) + 1) // 2
        out = orig(items[:n])
        mean = np.concatenate(out).mean(0)
        return out + [np.tile(mean, (it[2].shape[0], 1))
                      for it in items[n:]]
    monkeypatch.setattr(service_mod, "fused_stage_eval", half)
    out = _run()
    assert not out["correct"] and {"pred_gap", "plan_gap"} <= _failed(out)


def test_answer_never_comes(monkeypatch):
    orig = RuntimeSession.realize

    def drop(self, entries):
        res = orig(self, entries)
        return res[:-1] if len(res) > 1 else res
    monkeypatch.setattr(RuntimeSession, "realize", drop)
    out = _run()
    assert not out["correct"] and "unanswered" in _failed(out)
