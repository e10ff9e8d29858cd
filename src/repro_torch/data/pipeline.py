"""Synthetic tokenized data pipeline: deterministic, host-sharded.

The counterpart of the reference's ``data/pipeline.py``, bit for bit.
Batches are a pure function of (seed, step, host): any host can regenerate
any shard, and restarting from a checkpoint at step N reproduces the exact
stream.  A Zipf-ish unigram token distribution gives non-degenerate loss
curves.  Batches are numpy arrays; the train step moves them to the card.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..archs.common import ArchConfig

__all__ = ["make_batch", "data_iterator"]


def _token_block(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    # Zipf-like marginal over the vocab (clipped), cheap to sample.
    z = rng.zipf(1.3, size=n).astype(np.int64)
    return (z % vocab).astype(np.int32)


def make_batch(cfg: ArchConfig, *, global_batch: int, seq_len: int,
               step: int, seed: int = 0, host: int = 0, n_hosts: int = 1
               ) -> Dict[str, np.ndarray]:
    """This host's slice of the global batch for ``step``."""
    if global_batch % n_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_hosts} hosts")
    b = global_batch // n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host]))
    tokens = _token_block(rng, b * seq_len, cfg.vocab).reshape(b, seq_len)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1                                   # mask final position
    batch: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            0, 1, (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["patches"] = rng.normal(
            0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def data_iterator(cfg: ArchConfig, *, global_batch: int, seq_len: int,
                  seed: int = 0, host: int = 0, n_hosts: int = 1,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, global_batch=global_batch, seq_len=seq_len,
                         step=step, seed=seed, host=host, n_hosts=n_hosts)
        step += 1
