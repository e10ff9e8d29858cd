"""Runtime adaptation of θs for training jobs — the AQE analogue.

The paper's runtime optimizer re-tunes θp/θs whenever precise statistics
arrive.  For a training job, the "precise statistics" are observed step
metrics (wall-clock, grad-norm variance, MoE expert-load balance); the θs
knobs (grad-accumulation, scan unroll) can be re-picked between steps —
a recompile is the analogue of AQE producing a new physical plan.

:class:`StepAdapter` keeps an online estimate of step time per θs choice
(bandit-style with optimistic initialization from the analytical cost
model) and recommends recompiling when a different accumulation factor is
projected ≥ ``min_gain`` faster — with a hysteresis budget so the tuner
never thrashes (each recompile costs one compile).  It runs on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["StepAdapter"]


@dataclasses.dataclass
class StepAdapter:
    candidates: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 4, 8])
    min_gain: float = 0.1          # ≥10% projected speedup to recompile
    max_rejits: int = 3
    ema: float = 0.3

    def __post_init__(self):
        self._est: Dict[int, float] = {}
        self._current: Optional[int] = None
        self._rejits = 0

    def observe(self, accum: int, step_time_s: float) -> None:
        """Feed one observed step time for the live configuration."""
        self._current = accum
        if accum in self._est:
            self._est[accum] = ((1 - self.ema) * self._est[accum]
                                + self.ema * step_time_s)
        else:
            self._est[accum] = step_time_s
            # Optimistic neighbors: memory-feasible larger accum assumed
            # mildly slower (weight re-reads), smaller mildly faster.
            for c in self.candidates:
                if c not in self._est:
                    ratio = 1.0 + 0.05 * abs(np.log2(c / accum))
                    self._est[c] = step_time_s * ratio * 0.95

    def recommend(self) -> Optional[int]:
        """Return a new accum to recompile with, or None to keep the
        current."""
        if self._current is None or self._rejits >= self.max_rejits:
            return None
        cur = self._est[self._current]
        best = min(self._est, key=self._est.get)
        if best != self._current and \
                self._est[best] <= cur * (1 - self.min_gain):
            self._rejits += 1
            return best
        return None
