"""Per-rank cost of a sharded step: FLOPs, bytes, collective bytes, and
the roofline terms.

The counterpart of the reference's ``launch/hlo_analysis.py``.  The
reference reads its counts from the compiled, SPMD-partitioned HLO text;
HLO has no torch counterpart, so the port counts the step as it runs, on
one rank of a (possibly fake) world, with two dispatch modes that see the
local tensors DTensor computes on (each returns ``NotImplemented`` for a
DTensor op, so DTensor lowers it to local ops and collectives first):

* :class:`CollectiveCounter` stands in for ``collective_bytes``: it sums
  the operand bytes of every ``_c10d_functional`` collective by type,
  keyed by the reference's names ("all-gather", "reduce-scatter",
  "all-reduce", "all-to-all"); every rank runs the same collectives, so
  every rank gets the same dict;
* :class:`FlopsBytesCounter` stands in for ``hlo_flops_bytes``: FLOPs by
  ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: products, attention, convolutions), and bytes as each local
  op's inputs read once and outputs written once (views move nothing);
  it also keeps the peak of the bytes its ops' outputs hold alive at
  once.

Ops DTensor runs on fake tensors to propagate shapes are not counted.
:func:`roofline_terms` takes the H100's figures from
``cluster/costmodel.py``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..cluster import costmodel

__all__ = ["CollectiveCounter", "FlopsBytesCounter", "RooflineTerms",
           "roofline_terms", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

# NVIDIA H100 SXM5 at 700 W, data sheet: dense bf16 tensor-core rate.
PEAK_FLOPS = costmodel.PEAK_FLOPS      # 989e12 FLOP/s
# The same data sheet: HBM3 bandwidth.
HBM_BW = costmodel.HBM_BW              # 3.35e12 bytes/s
# One 400 Gb/s NDR InfiniBand port per GPU (DGX H100 design).
LINK_BW = costmodel.LINK_BW            # 50e9 bytes/s

# The reference's name of each functional collective DTensor issues; any
# other is counted under its own name.  The bookkeeping ops move nothing.
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor_op(types) -> bool:
    """A DTensor op: DTensor lowers it to local ops first."""
    return any(issubclass(t, DTensor) for t in types)


def _is_fake(tensors: List[torch.Tensor]) -> bool:
    """DTensor's shape propagation, on fake tensors, which is not run."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


class CollectiveCounter(TorchDispatchMode):
    """Operand bytes of each collective, by type (``by_type``), and their
    sum (``total``), for this rank."""

    def __init__(self) -> None:
        super().__init__()
        self.by_type: Dict[str, int] = {}

    @property
    def total(self) -> int:
        return sum(self.by_type.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            return NotImplemented
        name = func._opname
        ins = _tensors((args, kwargs))
        if func.namespace == "_c10d_functional" and \
                name not in _NOT_COLLECTIVES and not _is_fake(ins):
            kind = _COLLECTIVES.get(name, name)
            b = sum(_nbytes(t) for t in ins)
            self.by_type[kind] = self.by_type.get(kind, 0) + b
        return func(*args, **kwargs)


class FlopsBytesCounter(TorchDispatchMode):
    """This rank's FLOPs (``flops``), bytes read and written (``bytes``),
    and the peak of the bytes its ops' outputs held alive at once
    (``peak_live_bytes``, an estimate of the step's temporaries)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak_live_bytes = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if (func.namespace == "_c10d_functional" or func.is_view
                or _is_fake(ins + outs)):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:           # in place: nothing new held
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live)
        return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    bytes_coll: float
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "flops": self.flops, "bytes_hbm": self.bytes_hbm,
                "bytes_coll": self.bytes_coll}


def roofline_terms(flops_total: float, bytes_total: float,
                   coll_bytes_total: float, n_chips: int) -> RooflineTerms:
    """Three roofline terms in seconds for the whole step across the mesh.

    flops/bytes are *global* (whole step, all ranks) — divided by the
    aggregate peak; collective bytes likewise over every rank's link.
    """
    return RooflineTerms(
        compute_s=flops_total / (n_chips * PEAK_FLOPS),
        memory_s=bytes_total / (n_chips * HBM_BW),
        collective_s=coll_bytes_total / (n_chips * LINK_BW),
        flops=flops_total, bytes_hbm=bytes_total,
        bytes_coll=coll_bytes_total, n_chips=n_chips)
