"""The program's own spans: ``ServerStats.trace`` of the measured
``serve`` (``repro_torch.tracing``), which the server records while a
``torch.profiler`` runs, so in a ``--trace 1`` run.

Every reader returns ``None`` when the server left no trace: an untraced
run, or a program without the tracer.  Nothing here imports the program;
a trace is read through its ``spans`` (``name``, ``t0_ns``, ``t1_ns``,
``parent`` index, ``attrs``).
"""
from __future__ import annotations

from typing import List, Optional


def program_trace(rec) -> Optional[object]:
    return getattr(rec.stats, "trace", None)


def named(trace, name: str) -> List[object]:
    return [sp for sp in trace.spans if sp.name == name]


def seconds(spans) -> float:
    return sum(sp.t1_ns - sp.t0_ns for sp in spans) * 1e-9


def counter(spans, name: str) -> int:
    """Sum of one counter's deltas over ``flush`` or ``round`` spans."""
    return sum(sp.attrs["counters"][name] for sp in spans)


def solved(trace) -> int:
    """Queries the window's flushes solved afresh."""
    return sum(sp.attrs["n_solved"] for sp in named(trace, "flush"))
