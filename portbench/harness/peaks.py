"""The H100's peaks and the least time a layer's work could take on it.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, no
sparsity), which assume the card's full 700 W power limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  The performance
model runs float32 with TF32 off, so float32 is its rate; the dominance
filter compares on CUDA cores.

The operation and byte counts follow ``chip_smoke.py``'s ``bound_ms`` and
``pareto_bound_ms``, copied here so that the
yardstick cannot move.  Each counts what the call's inputs need (each input
byte read once, each output byte written once, padding rows not counted);
a layer's share is this bound over the layer's wall span, so the share
reads the same work whichever route (kernel or host) does it, and cannot
pass 100 %.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, ops: float,
            ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time for the card: bytes over the HBM rate or operations
    over their rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


def _mlp_flops(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _mlp_params(dims: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def gtn_bound_s(graphs: int, w: dict) -> float:
    """Embedding ``graphs`` subQ graphs of ``n_pad`` nodes: the products of
    the input projections, each layer's QKV, scores, structure bias,
    context, output and FFN; the graphs read once, the embeddings written
    once, the weights read once."""
    N, F, K = w["n_pad"], w["feat_dim"], w["pe_dim"]
    d, H, L, dff = w["d_model"], w["n_heads"], w["n_layers"], w["d_ff"]
    per_graph = (2 * N * F * d + 2 * N * K * d
                 + L * (2 * N * d * 3 * d + 2 * N * N * d + 2 * N * N * 3 * H
                        + 2 * N * N * d + 2 * N * d * d
                        + _mlp_flops([d, dff, d]) * N))
    params = (F * d + d + K * d + d
              + L * (d * 3 * d + 3 * d + d * d + d + 3 * H + 4 * d
                     + _mlp_params([d, dff, d])))
    n_bytes = graphs * ((N * F + N * K + N * N * 3) * 4 + N + d * 4) \
        + params * 4
    return bound_s(n_bytes, graphs * per_graph)


def head_bound_s(rows: int, w: dict) -> float:
    """The MLP head over ``rows`` rows of [embedding, θ, non-decision]."""
    dims = [w["reg_in"], *w["hidden"], w["n_targets"]]
    n_bytes = rows * (dims[0] + dims[-1]) * 4 + _mlp_params(dims) * 4
    return bound_s(n_bytes, rows * _mlp_flops(dims))


def pareto_bound_s(banks: Iterable[Tuple[int, int, int, int]]) -> float:
    """Dominance masks of banks given as (rows n, objectives k, valid rows
    V, survivors S): F read once in float32, validity read once, the mask
    written once; 2k compares per pair test, a survivor tested against
    every valid row of its bank, a dominated row only against its
    dominator."""
    n_bytes = ops = 0
    for n, k, V, S in banks:
        n_bytes += n * k * 4 + n + n
        ops += 2 * k * (S * V + (V - S))
    return bound_s(n_bytes, ops)
