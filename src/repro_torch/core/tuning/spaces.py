"""Tunable-parameter spaces.

A :class:`ParamSpace` is an ordered set of scalar parameters.  The MOO solvers
and learned models operate on the **unit hypercube** ``[0, 1]^d``; the
environment (query simulator / cluster cost model) consumes **raw** values.
Integer and boolean parameters round on conversion, log-scaled parameters map
exponentially — so the solvers stay fully continuous/vectorized while the
environment sees realistic knob values.

Host-side numpy: the spaces are bookkeeping around the solver, not device
work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Param", "ParamSpace"]


@dataclasses.dataclass(frozen=True)
class Param:
    """One tunable scalar.

    kind: "float" | "int" | "bool" | "cat".
    For "cat", ``choices`` holds the raw values; unit value indexes into it.
    """

    name: str
    kind: str = "float"
    lo: float = 0.0
    hi: float = 1.0
    log: bool = False
    default: float = 0.0
    choices: Optional[Sequence[float]] = None

    def to_raw(self, u: np.ndarray) -> np.ndarray:
        u = np.clip(u, 0.0, 1.0)
        if self.kind == "bool":
            return (u >= 0.5).astype(np.float64)
        if self.kind == "cat":
            c = np.asarray(self.choices, np.float64)
            idx = np.minimum((u * len(c)).astype(int), len(c) - 1)
            return c[idx]
        if self.log:
            lo, hi = np.log(self.lo), np.log(self.hi)
            raw = np.exp(lo + u * (hi - lo))
        else:
            raw = self.lo + u * (self.hi - self.lo)
        if self.kind == "int":
            raw = np.rint(raw)
        return raw

    def to_unit(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw, np.float64)
        if self.kind == "bool":
            return raw.astype(np.float64)
        if self.kind == "cat":
            c = np.asarray(self.choices, np.float64)
            idx = np.array([int(np.argmin(np.abs(c - r))) for r in np.atleast_1d(raw)])
            u = (idx + 0.5) / len(c)
            return u.reshape(raw.shape)
        if self.log:
            lo, hi = np.log(self.lo), np.log(self.hi)
            return (np.log(np.clip(raw, self.lo, self.hi)) - lo) / (hi - lo)
        return (np.clip(raw, self.lo, self.hi) - self.lo) / (self.hi - self.lo)


class ParamSpace:
    """Ordered collection of :class:`Param` with vectorized conversions."""

    def __init__(self, params: Sequence[Param]):
        self.params: List[Param] = list(params)
        self.names = [p.name for p in self.params]
        self._index = {p.name: i for i, p in enumerate(self.params)}

    @property
    def dim(self) -> int:
        return len(self.params)

    def index(self, name: str) -> int:
        return self._index[name]

    def __getitem__(self, name: str) -> Param:
        return self.params[self._index[name]]

    # -- conversions ------------------------------------------------------
    def to_raw(self, unit: np.ndarray) -> np.ndarray:
        """(..., d) unit -> (..., d) raw."""
        unit = np.asarray(unit, np.float64)
        out = np.empty_like(unit)
        for i, p in enumerate(self.params):
            out[..., i] = p.to_raw(unit[..., i])
        return out

    def to_unit(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw, np.float64)
        out = np.empty_like(raw)
        for i, p in enumerate(self.params):
            out[..., i] = p.to_unit(raw[..., i])
        return out

    def default_unit(self) -> np.ndarray:
        return self.to_unit(np.array([p.default for p in self.params]))

    def default_raw(self) -> np.ndarray:
        return np.array([p.default for p in self.params], np.float64)

    def raw_dict(self, raw_row: np.ndarray) -> Dict[str, float]:
        return {p.name: float(raw_row[i]) for i, p in enumerate(self.params)}

    # -- sampling ---------------------------------------------------------
    def sample_lhs(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Latin Hypercube Sample in the unit cube, shape (n, d)."""
        d = self.dim
        u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T + rng.random((n, d))) / n
        return u

    def sample_uniform(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.random((n, self.dim))

    def sample_grid(self, levels: int) -> np.ndarray:
        """Full-factorial grid with ``levels`` points/dim (use for small d)."""
        axes = [np.linspace(0.05, 0.95, levels)] * self.dim
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], -1)

    # -- snapping ---------------------------------------------------------
    def snap_unit(self, unit: np.ndarray) -> np.ndarray:
        """Round unit values through raw space (ints/bools/cats quantize)."""
        return self.to_unit(self.to_raw(unit))

    def quantized_levels(self, i: int) -> Optional[np.ndarray]:
        """Unit-space levels for discrete param i (None for continuous)."""
        p = self.params[i]
        if p.kind == "bool":
            return np.array([0.0, 1.0])
        if p.kind == "cat":
            n = len(p.choices)
            return (np.arange(n) + 0.5) / n
        if p.kind == "int":
            n_levels = int(p.hi - p.lo) + 1
            if n_levels <= 64:
                return p.to_unit(np.arange(p.lo, p.hi + 1))
        return None


def concat_unit(*arrays: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64) for a in arrays], axis=-1)
