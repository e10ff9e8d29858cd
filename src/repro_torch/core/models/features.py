"""Plan featurization for the GTN embedder (paper §4.3).

Per-operator composite encoding:
  one-hot op type (10) ⊕ log cardinality (rows, bytes) ⊕ hashed predicate
  embedding (8) — the paper uses word2vec predicate averages; offline we use
  a seeded random hash table, which plays the same role (a fixed lexical
  embedding).

Graph structure: directed adjacency (child→parent) plus Laplacian positional
encodings (K smallest non-trivial eigenvectors of the symmetric normalized
Laplacian), exactly the Dwivedi–Bresson Graph-Transformer recipe the paper
cites.

Two granularities are featurized:
  * whole-plan graphs (the L̄QP model),
  * per-subQ operator groups (subQ / QS models), padded to a small fixed
    size — subQ groups contain ≤ 4 operators by construction.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ...queryengine.plan import OP_TYPES, Operator, Query

__all__ = ["PRED_DIM", "OP_FEAT_DIM", "LAPPE_K", "encode_ops",
           "lap_positional_encoding", "GraphBatch", "featurize_subq",
           "featurize_plan", "batch_graphs", "contention_gamma"]

PRED_DIM = 8
LAPPE_K = 4
OP_FEAT_DIM = len(OP_TYPES) + 2 + PRED_DIM

_HASH_SEED = 1234

# Contention-feature scales (γ, paper §4.3): log-task / log-work pressure of
# co-running stages, sibling count, and stage depth.  One definition shared
# by trace collection (training distribution) and runtime serving (inference
# distribution) — the feature is only meaningful if both sides compute it
# identically.
GAMMA_TASK_SCALE = 10.0
GAMMA_WORK_SCALE = 10.0
GAMMA_SIB_SCALE = 4.0
GAMMA_DEPTH_SCALE = 8.0


def contention_gamma(sib_tasks, sib_work, n_sib, depth) -> np.ndarray:
    """γ contention vector(s): (..., 4) from broadcastable pressure stats.

    ``sib_tasks`` / ``sib_work`` aggregate the task count and task-seconds
    of the stages co-running with the modeled stage; ``n_sib`` counts them;
    ``depth`` is the stage's depth in its query DAG.
    """
    t, w, s, d = np.broadcast_arrays(
        np.asarray(sib_tasks, np.float64), np.asarray(sib_work, np.float64),
        np.asarray(n_sib, np.float64), np.asarray(depth, np.float64))
    return np.stack([np.log1p(t) / GAMMA_TASK_SCALE,
                     np.log1p(w) / GAMMA_WORK_SCALE,
                     s / GAMMA_SIB_SCALE,
                     d / GAMMA_DEPTH_SCALE], -1)


@functools.lru_cache(maxsize=65536)
def _token_vec(token: str) -> np.ndarray:
    # crc32: Python's str hash is process-randomized (PYTHONHASHSEED) and
    # would break saved-model reproducibility across processes.
    seed = (zlib.crc32(token.encode()) ^ _HASH_SEED) % (2 ** 32)
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, PRED_DIM) / np.sqrt(PRED_DIM)


def encode_ops(ops: Sequence[Operator], *, use_est: bool) -> np.ndarray:
    """(n_ops, OP_FEAT_DIM) composite operator encoding."""
    out = np.zeros((len(ops), OP_FEAT_DIM), np.float32)
    for i, op in enumerate(ops):
        out[i, op.type_index] = 1.0
        rows = op.est_rows if use_est else op.rows
        bys = op.est_bytes if use_est else op.bytes
        out[i, len(OP_TYPES)] = np.log1p(max(rows, 0.0)) / 25.0
        out[i, len(OP_TYPES) + 1] = np.log1p(max(bys, 0.0)) / 30.0
        if op.pred_tokens:
            vec = np.mean([_token_vec(t) for t in op.pred_tokens], axis=0)
            out[i, len(OP_TYPES) + 2:] = vec
    return out


def lap_positional_encoding(A: np.ndarray, k: int = LAPPE_K) -> np.ndarray:
    """(n, k) Laplacian PE from undirected normalized Laplacian eigvectors."""
    n = A.shape[0]
    und = ((A + A.T) > 0).astype(np.float64)
    deg = und.sum(1)
    d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-9)), 0.0)
    L = np.eye(n) - d_inv_sqrt[:, None] * und * d_inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(L)
    order = np.argsort(vals)
    pe = vecs[:, order[1:k + 1]] if n > 1 else np.zeros((n, 0))
    # Deterministic sign: first max-|entry| positive per vector.
    for j in range(pe.shape[1]):
        i = int(np.argmax(np.abs(pe[:, j])))
        if pe[i, j] < 0:
            pe[:, j] = -pe[:, j]
    out = np.zeros((n, k), np.float32)
    out[:, :pe.shape[1]] = pe
    return out


@dataclasses.dataclass
class GraphBatch:
    """Padded graph batch for the batched GTN forward."""

    X: np.ndarray        # (B, N, F) node features
    pe: np.ndarray       # (B, N, K) Laplacian PE
    bias: np.ndarray     # (B, N, N, 3) [fwd edge, bwd edge, self] flags
    mask: np.ndarray     # (B, N) node validity


def _build_graph(X: np.ndarray, A: np.ndarray, n_pad: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    n = X.shape[0]
    pe = lap_positional_encoding(A)
    Xp = np.zeros((n_pad, X.shape[1]), np.float32)
    Xp[:n] = X
    pep = np.zeros((n_pad, LAPPE_K), np.float32)
    pep[:n] = pe
    bias = np.zeros((n_pad, n_pad, 3), np.float32)
    bias[:n, :n, 0] = A
    bias[:n, :n, 1] = A.T
    bias[range(n), range(n), 2] = 1.0
    mask = np.zeros((n_pad,), bool)
    mask[:n] = True
    return Xp, pep, bias, mask


def featurize_subq(query: Query, sq_id: int, *, use_est: bool,
                   n_pad: int = 4) -> Tuple[np.ndarray, ...]:
    """Per-subQ operator-group graph (local ids, local edges)."""
    sq = query.subqs[sq_id]
    ops = [query.ops[i] for i in sq.op_ids]
    local = {op.op_id: j for j, op in enumerate(ops)}
    X = encode_ops(ops, use_est=use_est)
    A = np.zeros((len(ops), len(ops)), np.float32)
    for op in ops:
        for c in op.children:
            if c in local:
                A[local[c], local[op.op_id]] = 1.0
    return _build_graph(X, A, n_pad)


def featurize_plan(query: Query, *, use_est: bool,
                   n_pad: int = 128,
                   op_ids: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, ...]:
    """Whole-plan (or collapsed-plan subset) graph."""
    if op_ids is None:
        ops = query.ops
        local = {op.op_id: j for j, op in enumerate(ops)}
    else:
        ops = [query.ops[i] for i in op_ids]
        local = {op.op_id: j for j, op in enumerate(ops)}
    if len(ops) > n_pad:
        ops = ops[:n_pad]
        local = {op.op_id: j for j, op in enumerate(ops)}
    X = encode_ops(ops, use_est=use_est)
    A = np.zeros((len(ops), len(ops)), np.float32)
    for op in ops:
        for c in op.children:
            if c in local and op.op_id in local:
                A[local[c], local[op.op_id]] = 1.0
    return _build_graph(X, A, n_pad)


def batch_graphs(graphs: Sequence[Tuple[np.ndarray, ...]]) -> GraphBatch:
    X, pe, bias, mask = (np.stack([g[i] for g in graphs]) for i in range(4))
    return GraphBatch(X=X, pe=pe, bias=bias, mask=mask)
