"""Plain reference of the performance model and the objectives it feeds.

Works out again, from a query's attributes and the benchmark's weights:

* the per-subQ operator graph (one-hot type, log cardinalities, hashed
  predicate tokens, Laplacian positional encoding, edge flags), padded to
  4 nodes, as the subQ and QS models read it (paper §4.3);
* the GTN embedding (2 layers of biased multi-head attention, mean-pooled)
  and the MLP head, in any dtype and on any device: float64 on the host
  is the reference, float32 on the card with TF32 matmuls the control;
* the non-decision vector (α from the input sizes, β = 0, γ from a stage's
  same-depth siblings at runtime);
* the unit-space decision rows from raw Spark parameters (Table 6), and
  [latency, dollars] from [latency, IO].

Weights are the dotted-key dict the benchmark made (``gtn.layer0.qkv.w``
and so on): ``Dense`` weights are stored (d_in, d_out).
"""
from __future__ import annotations

import functools
import math
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Parameter spaces (paper Table 6): (kind, lo, hi, log).
# ---------------------------------------------------------------------------
THETA_C = [("int", 1, 8, False), ("int", 1, 32, True), ("int", 2, 20, False),
           ("int", 8, 512, True), ("int", 8, 256, True),
           ("int", 50, 1000, False), ("bool", 0, 1, False),
           ("float", 0.4, 0.9, False)]
THETA_P = [("int", 8, 512, True), ("float", 0.0, 1.0, False),
           ("int", 0, 1024, False), ("int", 0, 1024, False),
           ("int", 8, 2048, True), ("int", 16, 1024, True),
           ("int", 2, 10, False), ("int", 16, 1024, True),
           ("int", 1, 64, True)]
THETA_S = [("float", 0.1, 0.9, False), ("int", 1, 64, True)]

# Cloud prices of the analytical cost model ($ per core-hour, per GB-hour
# of memory, per GB of IO).
PRICE_CORE_H, PRICE_MEM_GB_H, PRICE_IO_GB = 0.30, 0.012, 0.0005


def to_unit(space, raw: np.ndarray) -> np.ndarray:
    raw = np.asarray(raw, np.float64)
    out = np.empty_like(raw)
    for i, (kind, lo, hi, log) in enumerate(space):
        r = raw[..., i]
        if kind == "bool":
            out[..., i] = r
        elif log:
            out[..., i] = ((np.log(np.clip(r, lo, hi)) - np.log(lo))
                           / (np.log(hi) - np.log(lo)))
        else:
            out[..., i] = (np.clip(r, lo, hi) - lo) / (hi - lo)
    return out


def to_raw(space, unit: np.ndarray) -> np.ndarray:
    unit = np.asarray(unit, np.float64)
    out = np.empty_like(unit)
    for i, (kind, lo, hi, log) in enumerate(space):
        u = np.clip(unit[..., i], 0.0, 1.0)
        if kind == "bool":
            out[..., i] = (u >= 0.5).astype(np.float64)
            continue
        if log:
            r = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
        else:
            r = lo + u * (hi - lo)
        out[..., i] = np.rint(r) if kind == "int" else r
    return out


def resource_rate(tc_raw: np.ndarray) -> np.ndarray:
    """$ a second of the cluster that raw θc rows allocate."""
    k1, k2, k3 = tc_raw[..., 0], tc_raw[..., 1], tc_raw[..., 2]
    return (k1 * k3 * PRICE_CORE_H + k2 * k3 * PRICE_MEM_GB_H) / 3600.0


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------
OP_TYPES = ["scan", "filter", "project", "join", "agg", "sort", "exchange",
            "limit", "expand", "window"]
PRED_DIM, LAPPE_K, N_PAD = 8, 4, 4
FEAT_DIM = len(OP_TYPES) + 2 + PRED_DIM


@functools.lru_cache(maxsize=4096)
def _token_vec(token: str) -> np.ndarray:
    rng = np.random.default_rng((zlib.crc32(token.encode()) ^ 1234)
                                % (2 ** 32))
    return rng.normal(0, 1, PRED_DIM) / np.sqrt(PRED_DIM)


def _lap_pe(A: np.ndarray) -> np.ndarray:
    n = A.shape[0]
    und = ((A + A.T) > 0).astype(np.float64)
    deg = und.sum(1)
    dis = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-9)), 0.0)
    vals, vecs = np.linalg.eigh(np.eye(n) - dis[:, None] * und * dis[None])
    pe = vecs[:, np.argsort(vals)[1:LAPPE_K + 1]] if n > 1 \
        else np.zeros((n, 0))
    for j in range(pe.shape[1]):
        i = int(np.argmax(np.abs(pe[:, j])))
        if pe[i, j] < 0:
            pe[:, j] = -pe[:, j]
    out = np.zeros((n, LAPPE_K), np.float32)
    out[:, :pe.shape[1]] = pe
    return out


def subq_graph(query, sq_id: int, use_est: bool):
    """(X (4, F), pe (4, K), bias (4, 4, 3), mask (4,)) of one subQ."""
    sq = query.subqs[sq_id]
    ops = [query.ops[i] for i in sq.op_ids]
    local = {op.op_id: j for j, op in enumerate(ops)}
    n = len(ops)
    X = np.zeros((N_PAD, FEAT_DIM), np.float32)
    for i, op in enumerate(ops):
        X[i, OP_TYPES.index(op.op_type)] = 1.0
        rows = op.est_rows if use_est else op.rows
        bys = op.est_bytes if use_est else op.bytes
        X[i, len(OP_TYPES)] = np.log1p(max(rows, 0.0)) / 25.0
        X[i, len(OP_TYPES) + 1] = np.log1p(max(bys, 0.0)) / 30.0
        if op.pred_tokens:
            X[i, len(OP_TYPES) + 2:] = np.mean(
                [_token_vec(t) for t in op.pred_tokens], axis=0)
    A = np.zeros((n, n), np.float32)
    for op in ops:
        for c in op.children:
            if c in local:
                A[local[c], local[op.op_id]] = 1.0
    pe = np.zeros((N_PAD, LAPPE_K), np.float32)
    pe[:n] = _lap_pe(A)
    bias = np.zeros((N_PAD, N_PAD, 3), np.float32)
    bias[:n, :n, 0] = A
    bias[:n, :n, 1] = A.T
    bias[range(n), range(n), 2] = 1.0
    mask = np.zeros(N_PAD, bool)
    mask[:n] = True
    return X, pe, bias, mask


def alpha(rows: Sequence[float], bys: Sequence[float]) -> np.ndarray:
    return np.array([np.log1p(float(sum(rows))) / 20.0,
                     np.log1p(float(sum(bys))) / 25.0,
                     np.log1p(float(max(rows))) / 20.0,
                     np.log1p(float(max(bys))) / 25.0,
                     len(rows) / 2.0], np.float64)


def _depths(query) -> List[int]:
    depth: Dict[int, int] = {}

    def d(i):
        if i not in depth:
            ch = query.subqs[i].children
            depth[i] = 0 if not ch else 1 + max(d(c) for c in ch)
        return depth[i]
    return [d(s.sq_id) for s in query.subqs]


def structural_gamma(query) -> np.ndarray:
    """(m, 4) γ: log tasks and work of a stage's same-depth siblings (input
    bytes over 128 MB partitions; input GB times CPU weight), their count,
    and the stage's depth."""
    m = len(query.subqs)
    d = np.asarray(_depths(query), np.float64)
    pres = np.zeros((m, 2))
    for i, sq in enumerate(query.subqs):
        b = float(sum(sq.input_bytes))
        pres[i] = [max(1.0, b / 128e6), (b / 1e9) * float(sq.cpu_weight)]
    g = np.zeros((m, 4))
    for i in range(m):
        sib = [j for j in range(m) if d[j] == d[i] and j != i]
        t = pres[sib, 0].sum() if sib else 0.0
        w = pres[sib, 1].sum() if sib else 0.0
        g[i] = [np.log1p(t) / 10.0, np.log1p(w) / 10.0, len(sib) / 4.0,
                d[i] / 8.0]
    return g


def nondecision(a: np.ndarray, gamma: Optional[np.ndarray] = None
                ) -> np.ndarray:
    g = np.zeros(4) if gamma is None else gamma
    return np.concatenate([a, np.zeros(3), g]).astype(np.float32)


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------
def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


class Net:
    """GTN + MLP head over the benchmark's weights, in ``dtype`` on
    ``device``."""

    def __init__(self, weights: Dict[str, np.ndarray], n_heads: int,
                 n_layers: int, dtype=torch.float64, device="cpu"):
        self.p = {k: torch.as_tensor(np.asarray(v), device=device)
                  .to(dtype) for k, v in weights.items()}
        self.H, self.L = n_heads, n_layers
        self.dtype, self.device = dtype, device
        self.n_head = len({k.split(".")[1] for k in self.p
                           if k.startswith("reg.")})

    def _t(self, a):
        return torch.as_tensor(np.array(a), device=self.device).to(
            self.dtype)

    def _dense(self, x, name):
        return x @ self.p[name + ".w"] + self.p[name + ".b"]

    def _mlp(self, x, name, n):
        for i in range(n):
            x = self._dense(x, f"{name}.l{i}")
            if i < n - 1:
                x = _gelu(x)
        return x

    def _ln(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.p[name + ".g"] \
            + self.p[name + ".b"]

    def embed(self, graphs) -> torch.Tensor:
        X, pe, bias, mask = (np.stack([g[i] for g in graphs])
                             for i in range(4))
        X, pe, bias = self._t(X), self._t(pe), self._t(bias)
        mask = torch.as_tensor(mask, device=self.device)
        B, N = X.shape[:2]
        h = self._dense(X, "gtn.in_proj") + self._dense(pe, "gtn.pe_proj")
        d = h.shape[-1]
        dh = d // self.H
        neg = torch.where(mask, 0.0, -1e9).to(self.dtype)[:, None, None, :]
        for i in range(self.L):
            lp = f"gtn.layer{i}"
            qkv = self._dense(self._ln(h, lp + ".ln1"), lp + ".qkv")
            qkv = qkv.reshape(B, N, 3, self.H, dh)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dh) \
                + torch.einsum("bnmf,hf->bhnm", bias, self.p[lp + ".bias"]) \
                + neg
            ctx = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, -1),
                               v).reshape(B, N, d)
            h = h + self._dense(ctx, lp + ".out")
            h = h + self._mlp(self._ln(h, lp + ".ln2"), lp + ".ffn", 2)
        w = mask.to(self.dtype)
        return (h * w[..., None]).sum(1) / torch.clamp(w.sum(1), min=1.0)[
            :, None]

    def head(self, emb, theta, nond) -> np.ndarray:
        """Raw targets [latency s, IO GB] (z = log(y + 1e-3), unit scale)."""
        x = torch.cat([self._t(emb) if isinstance(emb, np.ndarray) else emb,
                       self._t(theta), self._t(nond)], -1)
        z = self._mlp(x, "reg", self.n_head)
        z = z.to(torch.float64).cpu().numpy()
        return np.maximum(np.exp(z) - 1e-3, 0.0)


def log_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Widest gap of two raw target arrays in the model's log space."""
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(np.log(np.maximum(a, 0.0) + 1e-3)
                               - np.log(np.maximum(b, 0.0) + 1e-3))))


def embeddings(net: Net, keys: Sequence[Tuple[object, int, bool]],
               block: int = 4096) -> Dict[Tuple[int, int, bool], np.ndarray]:
    """Embeddings of (query, sq_id, use_est), keyed by (id(query), sq_id,
    use_est), computed in blocks of graphs."""
    uniq = {}
    for q, i, est in keys:
        uniq.setdefault((id(q), i, est), (q, i, est))
    items = list(uniq.items())
    out = {}
    for lo in range(0, len(items), block):
        part = items[lo:lo + block]
        e = net.embed([subq_graph(q, i, est) for _, (q, i, est) in part])
        for (key, _), row in zip(part, e.to(torch.float64).cpu().numpy()):
            out[key] = row
    return out
