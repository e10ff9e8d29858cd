"""In-memory spans and counter deltas of the optimizer server's paths.

A span is ``(name, t0_ns, t1_ns, parent, attrs)`` on
``time.perf_counter_ns``: ``parent`` is the index of the span that was
open when it began (-1 for none) and ``attrs`` a dict or ``None``.  A
:class:`Trace` keeps them in a list for the duration of one recording and
writes nothing anywhere; :meth:`OptimizerServer.serve
<repro_torch.serve.server.OptimizerServer.serve>` puts its trace on
``ServerStats.trace``.

Off by default.  A span site reads the module global :data:`TRACE` once
and does nothing more while it is ``None``::

    tr = tracing.TRACE
    if tr is not None:
        sp = tr.open("tune")
    ...
    if tr is not None:
        tr.close(sp, plans=len(active))

``serve`` records a trace when an operator asked for it (:func:`enable`),
when a ``torch.profiler`` is recording (:func:`profiler_recording`), so
the program's spans land beside the card's trace, or inside a caller's
:func:`recording`, into that trace.  ``Trace.offset_ns`` (system-clock
less ``perf_counter`` nanoseconds, read when the trace starts) puts the
spans on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch

__all__ = ["Span", "Trace", "TRACE", "enable", "disable", "enabled",
           "profiler_recording", "recording", "seconds_by_name"]


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    attrs: Optional[dict]

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


class Trace:
    """The spans of one recording, in the order they began."""

    def __init__(self):
        self.spans: List[Span] = []
        # repro: allow[RP001] the offset only places the spans on the profiler's clock; no decision reads it
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._open: List[int] = []

    def open(self, name: str) -> int:
        """Begin span ``name`` inside the innermost open span; its index."""
        i = len(self.spans)
        self.spans.append(Span(name, time.perf_counter_ns(), 0,
                               self._open[-1] if self._open else -1, None))
        self._open.append(i)
        return i

    def close(self, i: int, **attrs) -> None:
        """End span ``i`` with ``attrs``; spans still open inside it (left
        by an exception) end at the same instant."""
        t = time.perf_counter_ns()
        while self._open:
            j = self._open.pop()
            self.spans[j].t1_ns = t
            if j == i:
                break
        if attrs:
            self.spans[i].attrs = attrs

    def end(self) -> None:
        """End every span still open."""
        if self._open:
            self.close(self._open[0])


# The trace being recorded; ``None`` while tracing is off.
TRACE: Optional[Trace] = None
_ENABLED = False


def enable() -> None:
    """Record a trace of every ``OptimizerServer.serve`` call from now on."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``) is
    recording now: PyTorch's own flag, set while one runs."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


@contextlib.contextmanager
def recording() -> Iterator[Trace]:
    """Record the spans of the ``with`` body into a new :class:`Trace`
    (the trace being recorded before is put back after)."""
    # repro: allow[RP005] the tracer's one switch: spans record, and no decision reads TRACE
    global TRACE
    prev, tr = TRACE, Trace()
    TRACE = tr
    try:
        yield tr
    finally:
        tr.end()
        TRACE = prev


def seconds_by_name(trace: Trace) -> Dict[str, float]:
    """Seconds inside the trace's spans, summed by name."""
    out: Dict[str, float] = {}
    for sp in trace.spans:
        out[sp.name] = out.get(sp.name, 0.0) + sp.seconds
    return out
