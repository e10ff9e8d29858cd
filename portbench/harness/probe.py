"""The harness's spans: wrappers around the calls into each layer of the
port, put on for the measured window and taken off after it.

Each wrapper records the call's host wall time (``time.perf_counter``
before and after; every wrapped call returns host values, so its span
holds the device work it started) with what the layer metrics need about
its inputs, and keeps a seeded sample of what the call produced for the
comparison that decides ``correct``.  A traced run sets the spans beside
the card's trace, to say what the host was doing while the card sat idle.

Nothing in ``repro_torch`` changes: the wrappers replace module globals
and instance attributes (the names the program calls through) and put the
originals back in :meth:`Probe.remove`.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List

import numpy as np

from repro_torch.core.moo import hmooc as hmooc_mod
from repro_torch.serve import runtime as runtime_mod
from repro_torch.serve import service as service_mod

SPAN_NAMES = ("tune_batch", "stage_eval", "embed_many", "predict_rows",
              "pareto_masks", "step_round", "score_requests",
              "weighted_pick")


@dataclasses.dataclass
class Span:
    t0: float
    t1: float
    info: dict

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Samples:
    """What the timed path produced, for the reference to judge."""
    # (query, subQ index, θc unit rows, θp⊕θs unit rows, [latency, $] rows)
    stage_rows: List[tuple] = dataclasses.field(default_factory=list)
    # (query, subQ index, "lqp" | "qs", raw θc row, raw θp rows, raw θs
    #  rows, γ override or None, [latency, $] rows)
    score_rows: List[tuple] = dataclasses.field(default_factory=list)
    # (objective bank (n, k), the program's mask)
    banks: List[tuple] = dataclasses.field(default_factory=list)
    # (candidate sets, weight rows (R, 2), the program's picks)
    rounds: List[tuple] = dataclasses.field(default_factory=list)


class Probe:
    """Spans and samples of one ``OptimizerServer.serve`` call."""

    def __init__(self, server, model_subq, seed: int, sample: dict):
        self.srv = server
        self.model = model_subq
        self.rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed) % (1 << 63), 0x5A3F]))
        self.stage_rows_per_call = int(sample["stage_rows_per_call"])
        self.banks_per_call = int(sample["banks_per_call"])
        self.score_requests_per_round = int(sample["score_requests_per_round"])
        self.spans: Dict[str, List[Span]] = {n: [] for n in SPAN_NAMES}
        self.samples = Samples()
        self._undo: List[tuple] = []

    # -- plumbing -------------------------------------------------------------
    def _patch(self, owner, attr: str, fn) -> None:
        had = attr in vars(owner)
        self._undo.append((owner, attr, had, vars(owner).get(attr)))
        setattr(owner, attr, fn)

    def remove(self) -> None:
        for owner, attr, had, old in reversed(self._undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def _timed(self, name: str, fn, after=None):
        spans = self.spans[name]

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            t1 = time.perf_counter()
            info = after(a, kw, out) if after is not None else {}
            spans.append(Span(t0, t1, info))
            return out
        return wrapped

    # -- the layers -------------------------------------------------------------
    def install(self) -> None:
        srv, model = self.srv, self.model
        tuning = srv.tuning
        self._patch(tuning, "tune_batch", self._timed(
            "tune_batch", tuning.tune_batch,
            lambda a, kw, out: {"n": len(a[0]),
                                "n_solved": tuning.last_batch.n_solved}))
        self._patch(service_mod, "fused_stage_eval", self._timed(
            "stage_eval", service_mod.fused_stage_eval, self._stage_eval))
        cache = model._emb_cache
        embed_many = model.embed_many

        def embed_counted(pairs):
            n0 = len(cache)
            embed_many(pairs)
            return len(cache) - n0

        def embedded_nodes(a, kw, out):
            # The memo keeps insertion order, so the call's graphs are its
            # last ``out`` keys, (id(query), qid, sq_id, kind): O(graphs
            # embedded), and nothing when the call embedded none.
            if not out:
                return {"nodes": []}
            new = list(itertools.islice(reversed(cache), out))[::-1]
            queries = {id(q): q for q, _ in a[0]}
            return {"nodes": [len(queries[k[0]].subqs[k[2]].op_ids)
                              for k in new]}
        self._patch(model, "embed_many", self._timed(
            "embed_many", embed_counted, embedded_nodes))
        self._patch(model, "predict_rows", self._timed(
            "predict_rows", model.predict_rows,
            lambda a, kw, out: {"rows": int(np.shape(a[1])[0])}))
        for name in ("pareto_mask_fast", "pareto_masks_fast"):
            self._patch(hmooc_mod, name, self._timed(
                "pareto_masks", getattr(hmooc_mod, name),
                self._masks_single if name == "pareto_mask_fast"
                else self._masks))
        session = srv.session
        self._patch(session, "step_round", self._timed(
            "step_round", session.step_round,
            lambda a, kw, out: {"requests": int(out)}))
        self._patch(runtime_mod, "score_requests", self._timed(
            "score_requests", runtime_mod.score_requests,
            self._score_requests))
        self._patch(runtime_mod, "weighted_pick_batch", self._timed(
            "weighted_pick", runtime_mod.weighted_pick_batch, self._picks))

    # -- samples ----------------------------------------------------------------
    def _stage_eval(self, a, kw, out) -> dict:
        items = a[0]
        n_rows = [it[2].shape[0] for it in items]
        total = sum(n_rows)
        if total:
            take = min(self.stage_rows_per_call, total)
            rows = np.sort(self.rng.choice(total, size=take, replace=False))
            starts = np.cumsum([0] + n_rows)
            for j in np.unique(np.searchsorted(starts, rows, "right") - 1):
                sel = rows[(rows >= starts[j]) & (rows < starts[j + 1])] \
                    - starts[j]
                obj, i, Tc, Tps = items[j]
                self.samples.stage_rows.append(
                    (obj.query, int(i), np.array(Tc[sel]),
                     np.array(Tps[sel]), np.array(out[j][sel])))
        return {"rows": total}

    def _mask_info(self, Fs, masks) -> dict:
        banks = []
        for F, m in zip(Fs, masks):
            F = np.asarray(F)
            banks.append((F.shape[0], F.shape[1],
                          int(np.isfinite(F).all(-1).sum()), int(m.sum())))
        return {"banks": banks}

    def _masks(self, a, kw, out) -> dict:
        Fs = list(a[0])
        if Fs:
            take = min(self.banks_per_call, len(Fs))
            for b in self.rng.choice(len(Fs), size=take, replace=False):
                self.samples.banks.append((np.asarray(Fs[b], np.float64),
                                           np.array(out[b])))
        return self._mask_info(Fs, out)

    def _masks_single(self, a, kw, out) -> dict:
        self.samples.banks.append((np.asarray(a[0], np.float64),
                                   np.array(out)))
        return self._mask_info([a[0]], [out])

    def _score_requests(self, a, kw, out) -> dict:
        reqs = a[0]
        if reqs:
            take = min(self.score_requests_per_round, len(reqs))
            for r in self.rng.choice(len(reqs), size=take, replace=False):
                rq = reqs[r]
                self.samples.score_rows.append(
                    (rq.backend.query, int(rq.subq.sq_id), rq.decision,
                     np.array(rq.backend.tc_row[0]), np.array(rq.theta_p),
                     np.array(rq.theta_s),
                     None if rq.gamma is None else np.array(rq.gamma),
                     np.array(out[r])))
        return {"requests": len(reqs)}

    def _picks(self, a, kw, out) -> dict:
        Fs, w = list(a[0]), np.asarray(a[1], np.float64)
        self.samples.rounds.append((Fs, w, list(out)))
        return {}
