"""Reading the card's profiler trace of the measured window.

``torch.profiler`` traces the card's activity alone (CUPTI: kernels,
copies, fills); host operators are not recorded, so tracing costs the host
little.  The harness's own spans (``probe.Span``, on ``perf_counter``) are
put on the profiler's clock, which is the system clock in nanoseconds,
through one offset read at the window's start.  From them: the seconds in
which some operation ran on the card (the union of device intervals inside
the window), the device operations that took most time, and the idle gaps
between device operations summed by the innermost harness span that was
open at the gap's middle: what the host was doing while the card waited.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd import DeviceType


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: List[list]
    idle_gaps: List[list]
    # Device seconds that fell outside the window (a clock check).
    outside_s: float = 0.0


def profiler():
    """The card's activity only (on a host without one, which has no
    device events, the host's)."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if torch.cuda.is_available() else act.CPU],
        record_shapes=False, with_stack=False, profile_memory=False)


def clock_offset_ns() -> int:
    """System-clock ns less ``perf_counter`` ns, now."""
    return time.time_ns() - time.perf_counter_ns()


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation in the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(dev: Iterable[Tuple[str, int, int]], window: Tuple[int, int],
              host: Iterable[Tuple[int, int, str]], top: int = 10
              ) -> TraceSummary:
    """Busy seconds, top device operations and labelled idle gaps of the
    window ``(w0, w1)``; every time in system-clock nanoseconds."""
    w0, w1 = window
    by_op: Dict[str, float] = {}
    iv, outside = [], 0
    for name, a, b in dev:
        if b <= a:
            continue
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-9
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            iv.append((lo, hi))
        outside += (b - a) - max(0, hi - lo)
    busy = _merge(iv)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    spans = sorted(host)
    idle: Dict[str, float] = {}
    open_spans: List[Tuple[int, int, str]] = []
    nxt = 0
    for a, b in gaps:                  # gaps come in time order
        mid = (a + b) // 2
        while nxt < len(spans) and spans[nxt][0] <= mid:
            open_spans.append(spans[nxt])
            nxt += 1
        open_spans = [h for h in open_spans if h[1] >= mid]
        # The innermost open span is the latest-started one.
        label = (max(open_spans)[2] if open_spans
                 else "serve (outside the spans)")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(busy_s=sum(b - a for a, b in busy) * 1e-9,
                        window_s=(w1 - w0) * 1e-9,
                        device_ops=[[k, v] for k, v in ops],
                        idle_gaps=[[k, v] for k, v in gaps_out],
                        outside_s=outside * 1e-9)
