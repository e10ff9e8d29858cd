"""Training + evaluation for the three performance-model targets.

Reproduces paper §6.1: traces split 8:1:1 by query, AdamW on Huber(log y),
metrics = WMAPE / P50 / P90 relative error / Pearson correlation / inference
throughput (paper Table 3).

Datasets are host numpy, built exactly as the reference builds them.
:func:`train_model` stages a dataset on its device once and runs the
reference's loop there: the same batches (the reference's numpy draws, in
its order), the same learning-rate schedule in float32 and AdamW with the
reference's settings.  Nothing is read back inside the loop: the losses
stay on the device until the end, or every 200 steps when ``verbose``.
Every entry point takes ``device`` (``None`` = the CUDA card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ...device import resolve_device
from ...queryengine.trace import TraceSet
from .features import batch_graphs, featurize_plan, featurize_subq
from .gtn import GTNConfig
from .nn import adamw, disable_tf32
from .perf_model import (TARGET_EPS, ModelConfig, PerfModel, _Net,
                         make_nondecision)

__all__ = ["RowDataset", "build_dataset", "train_model", "evaluate",
           "Metrics", "train_all_models"]


@dataclasses.dataclass
class RowDataset:
    """Row-wise dataset with shared (deduplicated) graph tensors."""

    graphs: Tuple[np.ndarray, ...]   # (G, N, ·) stacked graph tensors
    graph_id: np.ndarray             # (S,) row -> graph index
    theta: np.ndarray                # (S, θd) unit decision variables
    nond: np.ndarray                 # (S, 12)
    y: np.ndarray                    # (S, 2) raw targets
    masks: Dict[str, np.ndarray]     # train/val/test row masks

    def subset(self, name: str) -> "RowDataset":
        m = self.masks[name]
        return RowDataset(self.graphs, self.graph_id[m], self.theta[m],
                          self.nond[m], self.y[m],
                          {name: np.ones(m.sum(), bool)})

    @property
    def n(self) -> int:
        return self.theta.shape[0]


def _lqp_pad(traces: TraceSet) -> int:
    mx = max(len(q.ops) for q in traces.queries)
    return int(np.ceil(mx / 16) * 16)


def build_dataset(traces: TraceSet, kind: str, seed: int = 0) -> Tuple[
        RowDataset, ModelConfig]:
    """Assemble the row dataset + model config for one target kind."""
    splits = traces.split(seed=seed)
    if kind in ("subq", "qs"):
        use_est = kind == "subq"
        pad = 4
        # Distinct graphs: one per (query, subq).
        keys = {}
        glist = []
        gid = np.zeros(traces.query_idx.shape[0], int)
        for r, (qi, si) in enumerate(zip(traces.query_idx, traces.subq_idx)):
            k = (int(qi), int(si))
            if k not in keys:
                keys[k] = len(glist)
                glist.append(featurize_subq(traces.queries[qi], si,
                                            use_est=use_est, n_pad=pad))
            gid[r] = keys[k]
        gb = batch_graphs(glist)
        if kind == "subq":
            theta = np.concatenate(
                [traces.theta_c, traces.theta_p, traces.theta_s], -1)
            nond = make_nondecision(traces.alpha_cbo)
        else:
            theta = np.concatenate([traces.theta_c, traces.theta_s], -1)
            nond = make_nondecision(traces.alpha_true, traces.beta,
                                    traces.gamma)
        y = traces.y_subq
        masks = {k: v[0] for k, v in splits.items()}
    elif kind == "lqp":
        pad = _lqp_pad(traces)
        glist = [featurize_plan(q, use_est=False, n_pad=pad)
                 for q in traces.queries]
        gb = batch_graphs(glist)
        gid = traces.q_query_idx.copy()
        theta = np.concatenate(
            [traces.q_theta_c, traces.q_theta_p, traces.q_theta_s], -1)
        nond = make_nondecision(traces.q_alpha)
        y = traces.y_query
        masks = {k: v[1] for k, v in splits.items()}
    else:
        raise ValueError(kind)

    ds = RowDataset((gb.X, gb.pe, gb.bias, gb.mask), gid,
                    theta.astype(np.float32), nond.astype(np.float32),
                    y.astype(np.float32), masks)
    cfg = ModelConfig(kind=kind, theta_dim=theta.shape[1],
                      gtn=GTNConfig())
    return ds, cfg


def _z_targets(y: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Raw targets → z = (log(y + eps) - mu) / sd, as in the reference's
    loss."""
    return (torch.log(torch.clamp(y, min=0.0) + TARGET_EPS)
            - stats[0]) / stats[1]


def _loss(net: _Net, graphs, theta: torch.Tensor, nond: torch.Tensor,
          z: torch.Tensor) -> torch.Tensor:
    """Mean Huber (delta 1) of the z residuals of one batch.

    ``F.huber_loss`` takes the quadratic branch for |r| < 1 where the
    reference takes it for |r| <= 1; at |r| = 1 both branches give 0.5 and
    slope ±1, so the value and the gradient agree there.
    """
    return F.huber_loss(net(*graphs, theta, nond), z, delta=1.0)


def _lr_schedule(lr: float, steps: int) -> np.ndarray:
    """The reference's per-step rate: warm-up over 100 steps, then cosine
    to 0.1×, each value rounded to float32."""
    out = np.empty(steps, np.float32)
    for t in range(steps):
        warm = min(1.0, (t + 1) / 100.0)
        decay = 0.5 * (1 + np.cos(np.pi * t / steps))
        out[t] = np.float32(lr * warm * (0.1 + 0.9 * decay))
    return out


def _stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``; to the card through pinned memory, so
    the copy does not wait for the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def train_model(ds: RowDataset, cfg: ModelConfig, *, steps: int = 1500,
                batch: int = 512, lr: float = 2e-3, seed: int = 0,
                verbose: bool = False,
                init_params: Optional[Mapping[str, torch.Tensor]] = None,
                device=None) -> PerfModel:
    """AdamW on the mean Huber loss of z-normalised log targets.

    The dataset's graph tensors, θ, non-decision rows, z targets and every
    step's batch indices cross to the device once, before the first step;
    a step gathers its batch there.  The indices are the reference's:
    ``np.random.default_rng(seed).choice`` draws each step's batch in the
    reference's order (the generator draws nothing else), so both packages
    see the same batches.  The per-step losses are read back once, at the
    end, into ``train_losses`` of the returned model.

    ``init_params`` (module state with dotted keys, as
    ``params_from_reference`` returns) replaces the seeded initialisation.
    It exists to carry a start across from the reference, whose seeded
    init draws other numbers than ``torch.Generator``; the batches still
    come from ``seed``.
    """
    device = resolve_device(device)
    disable_tf32()
    # Target normalization from the train split (z = (log(y+eps) - mu) / sd).
    tr_rows = ds.masks["train"]
    y_tr = ds.y[tr_rows] if tr_rows.any() else ds.y
    logy = np.log(np.maximum(y_tr, 0.0) + TARGET_EPS)
    stats = np.stack([logy.mean(0), np.maximum(logy.std(0), 1e-3)])

    net = _Net(cfg, torch.Generator().manual_seed(seed))
    if init_params is not None:
        net.load_state_dict(dict(init_params), strict=True)
    net.to(device, non_blocking=True)
    opt = adamw(net.parameters())

    rng = np.random.default_rng(seed)
    tr = ds.masks["train"]
    idx_all = np.nonzero(tr)[0]
    if idx_all.size == 0:
        idx_all = np.arange(ds.n)
    batch = min(batch, idx_all.size)
    draws = np.array([rng.choice(idx_all, size=batch,
                                 replace=idx_all.size < batch * 2)
                      for _ in range(steps)], np.int64).reshape(steps, batch)
    lrs = _lr_schedule(lr, steps)

    graphs = tuple(_stage(g, device) for g in ds.graphs)
    graph_id = _stage(ds.graph_id.astype(np.int64), device)
    theta = _stage(ds.theta, device)
    nond = _stage(ds.nond, device)
    z_all = _z_targets(_stage(ds.y, device),
                       _stage(stats.astype(np.float32), device))
    idx = _stage(draws, device)
    losses = torch.empty(steps, dtype=torch.float32, device=device)
    for t in range(steps):
        ii = idx[t]
        gi = graph_id.index_select(0, ii)
        loss = _loss(net, tuple(g.index_select(0, gi) for g in graphs),
                     theta.index_select(0, ii), nond.index_select(0, ii),
                     z_all.index_select(0, ii))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = float(lrs[t])
        opt.step()
        losses[t] = loss.detach()
        if verbose and (t + 1) % 200 == 0:
            # repro_torch: allow[TH002] verbose=True only: the progress line every 200 steps reads the mean loss; the budgeted call (verbose off) makes no sync in its loop
            recent = losses[max(0, t - 99):t + 1].mean().item()
            print(f"  step {t+1}/{steps} loss {recent:.4f}")
    model = PerfModel(cfg, params=net.state_dict(), target_stats=stats,
                      device=device)
    # repro_torch: allow[TH002] train_model's one sync a call (PERF.md §3): the per-step losses read back once, after the last step
    model.train_losses = losses.cpu().numpy()
    return model


@dataclasses.dataclass
class Metrics:
    wmape: np.ndarray     # per-target
    p50: np.ndarray
    p90: np.ndarray
    corr: np.ndarray
    # Regressor rows/s of ``PerfModel.predict`` on 8,192 rows; on the card
    # this includes the copies in and out.
    xput: float

    def row(self, i: int) -> str:
        return (f"WMAPE={self.wmape[i]:.3f} P50={self.p50[i]:.3f} "
                f"P90={self.p90[i]:.3f} Corr={self.corr[i]:.3f}")


def evaluate(model: PerfModel, ds: RowDataset, split: str = "test",
             max_rows: int = 20000) -> Metrics:
    """Accuracy on one split (on the model's device) and throughput."""
    m = ds.masks[split]
    idx = np.nonzero(m)[0]
    if idx.size > max_rows:
        idx = idx[:max_rows]
    GX, GP, GB, GM = ds.graphs
    preds = []
    for lo in range(0, idx.size, 2048):
        ii = idx[lo:lo + 2048]
        gi = ds.graph_id[ii]
        z = model.apply_rows((GX[gi], GP[gi], GB[gi], GM[gi]),
                             ds.theta[ii], ds.nond[ii])
        preds.append(model.from_z(z))
    pred = np.concatenate(preds, 0)
    truth = ds.y[idx]
    eps = 1e-6
    ae = np.abs(pred - truth)
    rel = ae / np.maximum(np.abs(truth), eps)
    wmape = ae.sum(0) / np.maximum(np.abs(truth).sum(0), eps)
    p50 = np.percentile(rel, 50, axis=0)
    p90 = np.percentile(rel, 90, axis=0)
    corr = np.array([np.corrcoef(pred[:, j], truth[:, j])[0, 1]
                     for j in range(truth.shape[1])])
    # Throughput of the solver-facing path (cached embedding + regressor).
    emb = np.zeros(model.cfg.gtn.d_model, np.float32)
    theta = np.random.default_rng(0).random(
        (8192, model.cfg.theta_dim)).astype(np.float32)
    nond = np.zeros(12, np.float32)
    model.predict(emb, theta, nond)  # first use
    t0 = time.perf_counter()
    for _ in range(5):
        model.predict(emb, theta, nond)
    xput = 5 * 8192 / (time.perf_counter() - t0)
    return Metrics(wmape, p50, p90, corr, xput)


def train_all_models(traces: TraceSet, *, steps: int = 1500,
                     lqp_steps: Optional[int] = None, seed: int = 0,
                     verbose: bool = False, device=None
                     ) -> Dict[str, Tuple[PerfModel, RowDataset, Metrics]]:
    """Train subQ / QS / L̄QP models from one trace set (paper Table 3)."""
    out = {}
    for kind in ("subq", "qs", "lqp"):
        ds, cfg = build_dataset(traces, kind, seed=seed)
        n_steps = steps if kind != "lqp" else (lqp_steps or max(300, steps // 3))
        bs = 512 if kind != "lqp" else 64
        model = train_model(ds, cfg, steps=n_steps, batch=bs, seed=seed,
                            verbose=verbose, device=device)
        met = evaluate(model, ds)
        if verbose:
            print(f"[{kind}] latency {met.row(0)} | io {met.row(1)} | "
                  f"xput {met.xput/1e3:.0f}K/s")
        out[kind] = (model, ds, met)
    return out
