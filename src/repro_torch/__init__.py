"""PyTorch/CUDA port of the Spark fine-grained tuning optimizer.

A second package beside the JAX reference ``repro``, held to it by parity
tests.  It imports neither JAX nor ``repro``.  Host bookkeeping (query
plans, the simulator, the solver's sample pools and caches) stays numpy;
the performance model runs as ``torch.nn`` modules and the dominance
filter as a hand-written CUDA kernel (``kernels/pareto_filter``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
