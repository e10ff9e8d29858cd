"""GTN-embedder + regressor performance models (paper Fig. 6).

One :class:`PerfModel` per modeling target:

* ``subq`` — compile time: subQ operator group with CBO cardinalities;
  decision vars θc⊕θp⊕θs (19); α from CBO, β = 0, γ = 0.
* ``qs``   — runtime query stage: true cardinalities; θp dropped (already
  fixed when a QS is optimized) → θc⊕θs (10); α/β/γ observed.
* ``lqp``  — runtime collapsed plan: whole-plan graph; θc⊕θp⊕θs; predicts
  end-to-end latency of the (remaining) plan.

Targets are predicted in log1p space: [latency (s), IO (GB)].

The embedding of a plan/subQ does not depend on θ, so MOO solving caches the
GTN output once per (query, stage) and sweeps thousands of θ rows through the
small regressor — this is what makes sub-second solving feasible (paper's
60–462K inference/s).

The model's modules live on one torch device (``None`` = the CUDA card).
The inference methods take and return numpy, like the reference, so each
call copies its inputs to the device and its outputs back.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ... import tracing
from ...device import resolve_device
from ...queryengine.plan import Query
from .features import batch_graphs, featurize_plan, featurize_subq
from .gtn import GTN, GTNConfig
from .nn import MLP, disable_tf32

__all__ = ["ModelConfig", "PerfModel", "NONDECISION_DIM", "pow2_bucket",
           "make_nondecision", "params_from_reference"]

ALPHA_DIM = 5
BETA_DIM = 3
GAMMA_DIM = 4
NONDECISION_DIM = ALPHA_DIM + BETA_DIM + GAMMA_DIM


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    kind: str                      # "subq" | "qs" | "lqp"
    theta_dim: int                 # 19 for subq/lqp, 10 for qs
    gtn: GTNConfig = GTNConfig()
    hidden: Tuple[int, ...] = (128, 96)
    n_targets: int = 2

    @property
    def reg_in(self) -> int:
        return self.gtn.d_model + self.theta_dim + NONDECISION_DIM

    @property
    def pad(self) -> int:
        return 4 if self.kind in ("subq", "qs") else 128

    @property
    def use_est(self) -> bool:
        return self.kind == "subq"


TARGET_EPS = 1e-3

# Batch width of a runtime round's GTN dispatches on the card (see
# ``PerfModel._round_width``); a round with more misses takes several.
ROUND_WIDTH = 128


def pow2_bucket(n: int, lo: int = 64) -> int:
    """Smallest power of two ≥ max(n, lo).

    Batched inference pads its row axis to these buckets so a serving
    session only ever sees O(log n_max) distinct shapes per dispatch,
    however request sizes vary.
    """
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def _head_max_bucket() -> int:
    """Row cap per regressor dispatch (``REPRO_HEAD_MAX_BUCKET``).

    Fused micro-batch solves can concatenate 100k+ rows; padding that to
    the next power of two wastes up to 2× compute.  Instead the rows are
    dispatched in chunks of at most this bucket: full chunks need no
    padding at all, only the tail pads (to its own pow2 bucket ≤ the cap),
    and the shape set stays the fixed ladder {64 … cap}.  Resolved per
    call so tests/benchmarks can re-tune it.
    """
    b = int(os.environ.get("REPRO_HEAD_MAX_BUCKET", "8192"))
    return pow2_bucket(b)


class _Net(nn.Module):
    """The parameters of one PerfModel: ``gtn`` embedder + ``reg`` head."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.gtn = GTN(cfg.gtn, generator=generator)
        self.reg = MLP([cfg.reg_in, *cfg.hidden, cfg.n_targets],
                       generator=generator)

    def head(self, emb: torch.Tensor, theta: torch.Tensor,
             nond: torch.Tensor) -> torch.Tensor:
        return self.reg(torch.cat([emb, theta, nond], dim=-1))

    def forward(self, X: torch.Tensor, pe: torch.Tensor, bias: torch.Tensor,
                mask: torch.Tensor, theta: torch.Tensor,
                nond: torch.Tensor) -> torch.Tensor:
        """The reference's ``apply_rows``: embed per-row graphs and regress.

        (B, N, ·) graph tensors, (B, θd) unit θ and (B, 12) non-decision
        rows → (B, n_targets) z.  Differentiable: training calls it on a
        fresh ``_Net``.
        """
        return self.head(self.gtn(X, pe, bias, mask), theta, nond)


def _zero_padded(a: np.ndarray, width: int) -> np.ndarray:
    """``a`` with zero rows appended along the batch axis up to ``width``."""
    if a.shape[0] >= width:
        return a
    out = np.zeros((width,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


class _GraphedGTN:
    """The GTN at one input shape on the card, captured once as a CUDA
    graph.  A call copies its arrays into the graph's inputs, replays it
    and reads the embeddings back: the kernels and their order are the
    capture's on every call, so a row's bits depend on that row alone."""

    def __init__(self, gtn: GTN, arrays, device: torch.device):
        self.inputs = [torch.from_numpy(a).to(device) for a in arrays]
        # A first run off the capture (cuBLAS handles and workspaces).
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            gtn(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = gtn(*self.inputs)

    def __call__(self, arrays) -> np.ndarray:
        for dst, a in zip(self.inputs, arrays):
            dst.copy_(torch.from_numpy(a))
        self.graph.replay()
        return self.out.cpu().numpy()


def _sorted_items(state: Mapping[str, torch.Tensor]):
    """State items in the reference's leaf order.

    ``jax.tree_util`` flattens nested dicts by recursively sorted keys,
    which is the order of the dotted keys sorted by their components.
    """
    return sorted(state.items(), key=lambda kv: tuple(kv[0].split(".")))


def params_from_reference(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's module state from a reference parameter tree.

    ``tree`` is the reference ``PerfModel.params`` as nested dicts of
    arrays (``{k: np.asarray(v)}`` at the leaves); the result maps dotted
    keys (``gtn.layer0.qkv.w``) to float32 CPU tensors, ready for
    ``PerfModel(cfg, params=...)``.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for k in sorted(node):
            v = node[k]
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = torch.from_numpy(
                    np.array(v, np.float32, copy=True))

    walk(tree, "")
    return out


class PerfModel:
    """Parameter container + batched inference paths on one device.

    Targets are modeled in z-normalized log space:
    ``z = (log(y + eps) - mu) / sd`` with (mu, sd) from the training split —
    so optimizing the loss optimizes *relative* error across scales.
    """

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0,
                 target_stats: Optional[np.ndarray] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        disable_tf32()
        gen = torch.Generator().manual_seed(seed)
        # The seeded init crosses without a stream synchronisation (the
        # host's pages are staged before the call returns); params already
        # on the device (a model that was trained there) load without a
        # round trip through the host.
        net = _Net(cfg, gen).to(self.device, non_blocking=True)
        if params is not None:
            net.load_state_dict(dict(params), strict=True)
        self.net = net.eval()
        self.net.requires_grad_(False)
        # (2, n_targets): row 0 = mu, row 1 = sd of log(y + eps).
        if target_stats is None:
            target_stats = np.stack([np.zeros(cfg.n_targets),
                                     np.ones(cfg.n_targets)])
        self.target_stats = np.asarray(target_stats, np.float32)
        self._emb_cache: Dict[Any, np.ndarray] = {}
        # embed_round's CUDA graphs, by input shapes.
        self._graphs: Dict[tuple, "_GraphedGTN"] = {}
        self._fp: Optional[str] = None
        # Shape buckets seen by the padded batch paths, and the regressor
        # rows sent through predict_rows (padding excluded).
        self.head_buckets: set = set()
        self.embed_buckets: set = set()
        self.rows_predicted = 0
        # Embedding-memo misses of embed, embed_many and embed_round, the
        # GTN dispatches that embedded them, and the arrays _to_dev sent to
        # the device.
        self.emb_misses = 0
        self.emb_dispatches = 0
        self.h2d_copies = 0
        # Per-step training losses, when ``training.train_model`` built it.
        self.train_losses: Optional[np.ndarray] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Module state (dotted keys → tensors on the model's device)."""
        return self.net.state_dict()

    # -- identity -------------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable content hash of the model (params + config + target stats).

        Serving caches key entries by this instead of ``id(model)``: the
        fingerprint survives process restarts and model reloads, never pins
        the live object, and a swapped-in refreshed model gets a different
        fingerprint so stale entries can never be served.  Leaves are hashed
        in the reference's flatten order, so a model carried across from the
        reference keeps the reference's fingerprint.
        """
        if self._fp is None:
            h = hashlib.sha1()
            h.update(repr(self.cfg).encode())
            h.update(np.ascontiguousarray(self.target_stats).tobytes())
            for _, leaf in _sorted_items(self.net.state_dict()):
                a = leaf.detach().cpu().numpy()
                h.update(str(a.shape).encode())
                h.update(np.ascontiguousarray(a).tobytes())
            self._fp = h.hexdigest()
        return self._fp

    # -- inference -----------------------------------------------------------
    def _graph(self, query: Query, sq_id: Optional[int]):
        if self.cfg.kind in ("subq", "qs"):
            return featurize_subq(query, sq_id, use_est=self.cfg.use_est,
                                  n_pad=self.cfg.pad)
        return featurize_plan(query, use_est=True, n_pad=self.cfg.pad)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        self.h2d_copies += 1
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def _embed_batch(self, graphs, width: Optional[int] = None) -> np.ndarray:
        """One GTN dispatch over ``graphs``.

        With ``width`` (:meth:`embed_round`'s), zero graphs (no valid node)
        fill the batch axis up to it, and on the card the dispatch replays
        a CUDA graph captured at that shape: one launch for the GTN's ~90
        kernels, whose launches cost more host time than the card spends.
        """
        self.emb_dispatches += 1
        gb = batch_graphs(graphs)
        arrays = [gb.X, gb.pe, gb.bias, gb.mask]
        if width is not None:
            arrays = [_zero_padded(a, width) for a in arrays]
            if self.device.type == "cuda":
                self.h2d_copies += len(arrays)
                shape = tuple(a.shape for a in arrays)
                if shape not in self._graphs:
                    self._graphs[shape] = _GraphedGTN(self.net.gtn, arrays,
                                                      self.device)
                return self._graphs[shape](arrays)
        emb = self.net.gtn(*(self._to_dev(a) for a in arrays))
        return emb.cpu().numpy()

    def embed(self, query: Query, sq_id: Optional[int] = None) -> np.ndarray:
        """Cached GTN embedding for a subQ group or whole plan."""
        # repro: allow[RP004] id(query) only scopes the process-local embedding memo to one live Query object (qid alone can recur with different stats); the memo is never snapshotted and embeddings do not depend on the id value
        key = (id(query), query.qid, sq_id, self.cfg.kind)
        if key in self._emb_cache:
            return self._emb_cache[key]
        self.emb_misses += 1
        tr = tracing.TRACE
        if tr is not None:
            sp = tr.open("model.embed")
        self._emb_cache[key] = self._embed_batch(
            [self._graph(query, sq_id)])[0]
        if tr is not None:
            tr.close(sp)
        return self._emb_cache[key]

    def _misses(self, pairs: Sequence[Tuple[Query, Optional[int]]]
                ) -> List[Tuple[tuple, tuple]]:
        """(memo key, graph) of each distinct pair the memo lacks, counted
        in ``emb_misses``; a pair the memo holds costs one lookup."""
        todo = []
        seen = set()
        for query, sq_id in pairs:
            # repro: allow[RP004] same process-local memo key as `embed` (see above); replay-invariant because only membership is observable, never the id value
            key = (id(query), query.qid, sq_id, self.cfg.kind)
            if key in self._emb_cache or key in seen:
                continue
            self.emb_misses += 1
            seen.add(key)
            todo.append((key, self._graph(query, sq_id)))
        return todo

    def embed_many(self, pairs: Sequence[Tuple[Query, Optional[int]]]) -> None:
        """Fill the embedding cache for many (query, sq_id) pairs at once.

        One padded GTN dispatch replaces the per-subQ batch-of-one calls of
        :meth:`embed`.  The batch axis is padded to a power-of-two bucket
        (replicas of the first graph, sliced off afterwards).  Rows are
        independent: row j of a padded batch is graph j's embedding.
        """
        todo = self._misses(pairs)
        if not todo:
            return
        n = len(todo)
        b = pow2_bucket(n, lo=8)
        graphs = [g for _, g in todo] + [todo[0][1]] * (b - n)
        self.embed_buckets.add(b)
        emb = self._embed_batch(graphs)
        for j, (key, _) in enumerate(todo):
            self._emb_cache[key] = emb[j]

    def _round_width(self, n: int) -> int:
        """Batch width of :meth:`embed_round`'s dispatches for ``n`` misses.

        On the card one width, whatever ``n``: cuBLAS picks its GEMM kernel
        by the row count, and the kernels round differently (on an H100 a
        graph's embedding keeps its bits only within runs of widths such as
        1–4, 5–12, 15–65, 127–129), and one shape is one CUDA graph.  On
        the host every power-of-two width gives the same bits, so a lone
        miss runs alone.
        """
        if self.device.type == "cuda":
            return ROUND_WIDTH
        return pow2_bucket(n, lo=1)

    def embed_round(self, pairs: Sequence[Tuple[Query, Optional[int]]]
                    ) -> None:
        """Fill the embedding cache for a runtime round's pairs.

        The misses run as one GTN dispatch (on the card, one a
        :data:`ROUND_WIDTH` misses), zero-padded to a width that depends
        on the device alone, so a graph's embedding never depends on the
        graphs it shares a dispatch with.  A round without misses makes no
        dispatch.
        """
        todo = self._misses(pairs)
        if not todo:
            return
        tr = tracing.TRACE
        width = self._round_width(len(todo))
        for lo in range(0, len(todo), width):
            chunk = todo[lo:lo + width]
            if tr is not None:
                sp = tr.open("model.embed")
            emb = self._embed_batch([g for _, g in chunk], width)
            for j, (key, _) in enumerate(chunk):
                self._emb_cache[key] = emb[j]
            if tr is not None:
                tr.close(sp, graphs=len(chunk))

    @torch.inference_mode()
    def apply_rows(self, graphs, theta: np.ndarray,
                   nond: np.ndarray) -> np.ndarray:
        """Per-row graphs ``(X, pe, bias, mask)`` and regressor inputs → z.

        The inference side of the reference's ``apply_rows`` (its
        ``evaluate`` reads a test split through it): numpy in, z out.
        """
        X, pe, bias, mask = (self._to_dev(a) for a in graphs)
        z = self.net(X, pe, bias, mask, self._to_dev(theta),
                     self._to_dev(nond))
        return z.cpu().numpy()

    # -- target transform ------------------------------------------------------
    def to_z(self, y: np.ndarray) -> np.ndarray:
        mu, sd = self.target_stats
        return (np.log(np.maximum(y, 0.0) + TARGET_EPS) - mu) / sd

    def from_z(self, z: np.ndarray) -> np.ndarray:
        mu, sd = self.target_stats
        return np.maximum(np.exp(z * sd + mu) - TARGET_EPS, 0.0)

    @torch.inference_mode()
    def _head_z(self, emb: np.ndarray, theta: np.ndarray,
                nond: np.ndarray) -> np.ndarray:
        z = self.net.head(self._to_dev(emb), self._to_dev(theta),
                          self._to_dev(nond))
        return z.cpu().numpy()

    def predict(self, emb: np.ndarray, theta: np.ndarray,
                nond: np.ndarray) -> np.ndarray:
        """(n, θd) unit θ + (n, 12) or (12,) nondecision → (n, 2) raw targets.

        ``emb`` is one cached embedding (d,) broadcast over the rows, or a
        per-row (n, d) stack.
        """
        tr = tracing.TRACE
        if tr is not None:
            sp = tr.open("model.predict")
        theta = np.asarray(theta, np.float32)
        n = theta.shape[0]
        if nond.ndim == 1:
            nond = np.broadcast_to(nond, (n, nond.shape[0]))
        emb = np.asarray(emb, np.float32)
        embb = emb if emb.ndim == 2 \
            else np.broadcast_to(emb, (n, emb.shape[0]))
        z = self._head_z(embb, theta, np.asarray(nond, np.float32))
        out = self.from_z(z)
        if tr is not None:
            tr.close(sp, rows=n)
        return out

    def predict_rows(self, emb: np.ndarray, theta: np.ndarray,
                     nond: np.ndarray) -> np.ndarray:
        """Like :meth:`predict` but per-row emb/nond, bucket-padded.

        The fused solve path concatenates regressor rows from every
        (query, subQ, candidate) of a micro-batch into one call here.  Rows
        are zero-padded to a power-of-two bucket, in chunks of at most
        ``REPRO_HEAD_MAX_BUCKET`` rows.
        """
        tr = tracing.TRACE
        if tr is not None:
            sp = tr.open("model.predict_rows")
        emb = np.ascontiguousarray(emb, np.float32)
        theta = np.ascontiguousarray(theta, np.float32)
        nond = np.ascontiguousarray(nond, np.float32)
        n = theta.shape[0]
        self.rows_predicted += n
        cap = _head_max_bucket()
        outs = []
        for off in range(0, n, cap):
            e = emb[off:off + cap]
            t = theta[off:off + cap]
            d = nond[off:off + cap]
            c = t.shape[0]
            # Calls larger than the cap reuse the cap bucket for their tail
            # too; only calls that fit in one chunk get a smaller bucket.
            b = cap if n > cap else pow2_bucket(c)
            if b != c:
                ep = np.zeros((b, e.shape[1]), np.float32)
                ep[:c] = e
                tp = np.zeros((b, t.shape[1]), np.float32)
                tp[:c] = t
                dp = np.zeros((b, d.shape[1]), np.float32)
                dp[:c] = d
                e, t, d = ep, tp, dp
            self.head_buckets.add((b, theta.shape[1]))
            outs.append(self._head_z(e, t, d)[:c])
        out = self.from_z(outs[0] if len(outs) == 1
                          else np.concatenate(outs, 0))
        if tr is not None:
            tr.close(sp, rows=n)
        return out

    def compile_stats(self) -> dict:
        """Shape accounting, in the reference's keys.

        ``head_buckets`` and ``embed_buckets`` are the padded shapes seen.
        The port has no jit cache to count, so ``head_compiles`` and
        ``embed_compiles`` are -1, the value the reference gives when it
        cannot read its cache.
        """
        return {"head_buckets": sorted(self.head_buckets),
                "embed_buckets": sorted(self.embed_buckets),
                "head_compiles": -1, "embed_compiles": -1}

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        """npz in the reference's layout (leaves ``a{i}`` in flatten order)."""
        flat = [leaf.detach().cpu().numpy()
                for _, leaf in _sorted_items(self.net.state_dict())]
        np.savez(path, n=len(flat), target_stats=self.target_stats,
                 **{f"a{i}": x for i, x in enumerate(flat)})

    @classmethod
    def load(cls, cfg: ModelConfig, path: str, device=None) -> "PerfModel":
        """Read a ``PerfModel.save`` npz, the reference's or the port's."""
        with np.load(path) as data:
            gen = torch.Generator().manual_seed(0)
            keys = [k for k, _ in _sorted_items(_Net(cfg, gen).state_dict())]
            n = int(data["n"])
            if n != len(keys):
                raise ValueError(f"{path} holds {n} leaves, the model "
                                 f"{cfg} has {len(keys)}")
            params = {k: torch.from_numpy(np.array(data[f"a{i}"], np.float32))
                      for i, k in enumerate(keys)}
            target_stats = np.array(data["target_stats"])
        return cls(cfg, params=params, target_stats=target_stats,
                   device=device)


def make_nondecision(alpha: np.ndarray, beta: Optional[np.ndarray] = None,
                     gamma: Optional[np.ndarray] = None) -> np.ndarray:
    """Assemble [α, β, γ] with paper's compile-time zeros convention."""
    alpha = np.asarray(alpha, np.float32)
    lead = alpha.shape[:-1]
    if beta is None:
        beta = np.zeros(lead + (BETA_DIM,), np.float32)
    if gamma is None:
        gamma = np.zeros(lead + (GAMMA_DIM,), np.float32)
    return np.concatenate([alpha, beta, gamma], axis=-1).astype(np.float32)
