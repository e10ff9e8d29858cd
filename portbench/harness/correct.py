"""The comparison that decides ``correct``.

After the window, the plain reference (``portbench/reference``) works out
again, from the benchmark's own weights and queries, what the timed path
produced, and each number below is held to its limit from the
configuration file:

* ``pred_gap``: the performance model's answers for a seeded sample of the
  rows the window scored, at compile time (``fused_stage_eval``: subQ
  model, estimated cardinalities) and at runtime (``score_requests``: subQ
  model for θp, QS model for θs, true cardinalities, γ): the widest
  relative gap of [latency, dollars] to the reference's, each below a
  floor of the model's own epsilon (1e-3 s; 1e-3 of the dollars a second
  the row's θc and IO cost);
* ``plan_gap``: every returned plan: its chosen front point against the
  reference's sum over subQs of [latency, dollars] at the plan's θc and
  per-subQ θp, θs (widest relative gap, floors as above times the subQs);
* ``mask_mismatch``: rows whose dominance mask differs from the
  reference's, over a seeded sample of the solver's banks and every final
  front filter (exact);
* ``wun_mismatch``: plans whose WUN pick differs from the reference's on
  the returned front (exact);
* ``pick_gap``: every runtime round's weighted picks: the widest gap by
  which a picked row's normalised weighted score lies above its set's
  least;
* ``unanswered``: requests offered in the window that got no plan (exact).

The control puts the reference in the program's place one precision step
down: the network in float32 with TF32 matmuls (the configuration states
float32 with TF32 off) and the weighted scores in bfloat16 (float32).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import decisions as ref_dec
from portbench.reference import model as ref

REJECTED = ("shed", "rate_limited")


def _nets(weights: dict, gtn: dict, dtype, device) -> dict:
    return {kind: ref.Net(w, gtn["n_heads"], gtn["n_layers"], dtype, device)
            for kind, w in weights.items()}


def _floors(lat_floor, rate):
    return np.stack([np.broadcast_to(lat_floor, np.shape(rate)),
                     lat_floor * (rate + ref.PRICE_IO_GB)], -1)


def _rel_gap(got: np.ndarray, want: np.ndarray, floor: np.ndarray) -> float:
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        floor)))


class _Rows:
    """Rows for one network: graphs to embed, θ, non-decision, and what
    to compare the objectives with."""

    def __init__(self):
        self.keys, self.theta, self.nond, self.rate = [], [], [], []

    def add(self, q, i, est, theta, nond, rate):
        n = theta.shape[0]
        self.keys.extend([(q, i, est)] * n)
        self.theta.append(theta.astype(np.float32))
        self.nond.append(np.broadcast_to(nond, (n, nond.shape[-1])))
        self.rate.append(np.broadcast_to(rate, (n,)))

    def objectives(self, net) -> np.ndarray:
        if not self.keys:
            return np.zeros((0, 2))
        E = ref.embeddings(net, self.keys)
        emb = np.stack([E[(id(q), i, est)] for q, i, est in self.keys])
        y = net.head(emb, np.concatenate(self.theta),
                     np.concatenate(self.nond))
        rate = np.concatenate(self.rate)
        return np.stack([y[:, 0], y[:, 0] * rate + y[:, 1] * ref.PRICE_IO_GB],
                        -1)


def _questions(rec):
    """The rows each network answers: sampled compile-time and runtime
    rows (``pred``) and every plan's chosen point (``plan``)."""
    pred = {"subq": _Rows(), "qs": _Rows()}
    got, floors = [], []
    for q, i, Tc, Tps, out in rec.samples.stage_rows:
        sq = q.subqs[i]
        rate = ref.resource_rate(ref.to_raw(ref.THETA_C, Tc))
        pred["subq"].add(q, i, True, np.concatenate([Tc, Tps], -1),
                         ref.nondecision(ref.alpha(sq.est_input_rows,
                                                   sq.est_input_bytes)),
                         rate)
        got.append(("subq", out))
        floors.append(("subq", _floors(1e-3, rate)))
    gammas = {}
    for q, i, dec, tc, tp, ts, gamma, out in rec.samples.score_rows:
        sq = q.subqs[i]
        n = max(tp.shape[0], ts.shape[0])
        tcu = np.broadcast_to(ref.to_unit(ref.THETA_C, tc), (n, 8))
        tsu = ref.to_unit(ref.THETA_S, np.broadcast_to(ts, (n, 2)))
        if dec == "lqp":
            kind = "subq"
            theta = np.concatenate(
                [tcu, ref.to_unit(ref.THETA_P, np.broadcast_to(tp, (n, 9))),
                 tsu], -1)
        else:
            kind = "qs"
            theta = np.concatenate([tcu, tsu], -1)
        if gamma is None:
            if id(q) not in gammas:
                gammas[id(q)] = ref.structural_gamma(q)
            gamma = gammas[id(q)][i]
        rate = float(ref.resource_rate(np.asarray(tc, np.float64)))
        pred[kind].add(q, i, kind == "subq", theta,
                       ref.nondecision(ref.alpha(sq.input_rows,
                                                 sq.input_bytes), gamma),
                       rate)
        got.append((kind, out))
        floors.append((kind, _floors(1e-3, np.full(n, rate))))
    plan = _Rows()
    plans = []
    for s in rec.served:
        ct = s.ct
        if ct is None:
            continue
        q = s.request.query
        m = q.n_subqs
        tcu = ref.to_unit(ref.THETA_C, ct.theta_c)
        theta = np.concatenate(
            [np.broadcast_to(tcu, (m, 8)),
             ref.to_unit(ref.THETA_P, ct.theta_p_sub),
             ref.to_unit(ref.THETA_S, ct.theta_s_sub)], -1)
        rate = float(ref.resource_rate(np.asarray(ct.theta_c, np.float64)))
        for i, sq in enumerate(q.subqs):
            plan.add(q, i, True, theta[i:i + 1],
                     ref.nondecision(ref.alpha(sq.est_input_rows,
                                               sq.est_input_bytes)), rate)
        plans.append((m, rate, np.asarray(ct.front[ct.choice], np.float64)))
    return pred, got, floors, plan, plans


def _pred_gap(pred, got, floors, nets) -> float:
    want = {k: rows.objectives(nets[k]) for k, rows in pred.items()}
    off = {"subq": 0, "qs": 0}
    gap = 0.0
    for (kind, out), (_, fl) in zip(got, floors):
        n = out.shape[0]
        w = want[kind][off[kind]:off[kind] + n]
        off[kind] += n
        gap = max(gap, _rel_gap(np.asarray(out, np.float64), w, fl))
    return gap


def _plan_sums(plan: _Rows, plans, net) -> List[np.ndarray]:
    Y = plan.objectives(net)
    out, off = [], 0
    for m, _, _ in plans:
        out.append(Y[off:off + m].sum(0))
        off += m
    return out


def _plan_gap(plans, sums) -> float:
    gap = 0.0
    for (m, rate, got), want in zip(plans, sums):
        gap = max(gap, _rel_gap(got, want, _floors(m * 1e-3, rate)))
    return gap


def readings(rec, weights: dict, cfg: dict) -> Dict[str, float]:
    """The program's numbers, against the float64 reference on the host."""
    gtn = cfg["models"]["gtn"]
    nets = _nets(weights, gtn, torch.float64, "cpu")
    pred, got, floors, plan, plans = _questions(rec)
    out = {"pred_gap": _pred_gap(pred, got, floors, nets),
           "plan_gap": _plan_gap(plans, _plan_sums(plan, plans,
                                                   nets["subq"]))}
    out["mask_mismatch"] = float(sum(
        int((np.asarray(m, bool) != ref_dec.pareto_mask(F)).sum())
        for F, m in rec.samples.banks))
    w_default = tuple(cfg["weights"])
    out["wun_mismatch"] = float(sum(
        s.ct.choice != ref_dec.wun_pick(
            s.ct.front, s.request.weights or w_default)
        for s in rec.served if s.ct is not None))
    gap = 0.0
    for Fs, w, picks in rec.samples.rounds:
        for r, (F, j) in enumerate(zip(Fs, picks)):
            gap = max(gap, ref_dec.pick_gap(F, w[r] if w.ndim == 2 else w,
                                            j))
    out["pick_gap"] = gap
    out["unanswered"] = float(sum(
        s.status in REJECTED or s.ct is None or s.result is None
        or not math.isfinite(s.compiled_s) for s in rec.served))
    return out


def control_readings(rec, weights: dict, cfg: dict, device) -> Dict[str,
                                                                     float]:
    """The control's numbers at the same questions: the network in float32
    with TF32 matmuls on ``device``, the runtime scores in bfloat16."""
    gtn = cfg["models"]["gtn"]
    ref64 = _nets(weights, gtn, torch.float64, "cpu")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctrl = _nets(weights, gtn, torch.float32, device)
        pred, _, floors, plan, plans = _questions(rec)
        fl = {"subq": [], "qs": []}
        for k, f in floors:
            fl[k].append(f)
        gap = 0.0
        for k, rows in pred.items():
            if rows.keys:
                gap = max(gap, _rel_gap(rows.objectives(ctrl[k]),
                                        rows.objectives(ref64[k]),
                                        np.concatenate(fl[k])))
        want_sums = _plan_sums(plan, plans, ref64["subq"])
        ctrl_sums = _plan_sums(plan, plans, ctrl["subq"])
        plan_gap = max((_rel_gap(c, wv, _floors(m * 1e-3, rate))
                        for (m, rate, _), c, wv in zip(plans, ctrl_sums,
                                                       want_sums)),
                       default=0.0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    pick = second = 0.0
    for Fs, w, _ in rec.samples.rounds:
        for r, F in enumerate(Fs):
            wr = w[r] if w.ndim == 2 else w
            pick = max(pick, ref_dec.pick_gap(F, wr, ref_dec.pick_bf16(F,
                                                                       wr)))
            s = np.sort(ref_dec.pick_scores(F, wr))
            if s.size > 1:
                second = max(second, float(s[1] - s[0]))
    # ``pick_gap.second_best``: a fault planted in the reference put in the
    # program's place, every pick one row off the best (the second-best
    # row): an upper reading for ``pick_gap`` where bfloat16 flips none.
    return {"pred_gap": gap, "plan_gap": plan_gap, "pick_gap": pick,
            "pick_gap.second_best": second}


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit; correct when none exceeds it."""
    checks = {k: {"value": values[k], "limit": float(limits[k])}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
