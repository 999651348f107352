"""The profiler's reduction: from a ``torch.profiler`` trace of a steady
stretch of the window to device busy time, time by kernel, and idle gaps
laid against the benchmark's host spans.

The stretch is the span of the ``bench:`` ranges the client recorded while
the profiler ran (every moment of the loop is inside one: a step, a
submit, or a wait). Device time is every CUDA-side event (kernels, copies,
sets) that is not a range's projection onto the device: neither the
benchmark's ranges nor the port's (its spans, ``engine:``, ``kv:``,
``td:``, ``model:``, are ranges of their names while the profiler
records). An idle gap is a moment of the stretch with none of them
running; it is charged to the innermost ``bench:`` range around its
middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int, str]
# the port's span prefixes (``repro_torch.tracing.PREFIXES``, copied: the
# harness reads the trace without importing the program)
PROGRAM_RANGES = ("engine:", "kv:", "td:", "model:")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by event name
    idle_by_span: Dict[str, float]      # idle device seconds by host range
    n_device_events: int


def split_events(kineto_events, prefix: str = "bench:"
                 ) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host ``prefix`` ranges) from a profiler's raw
    events; the port's ranges are neither."""
    dev, host = [], []
    for e in kineto_events:
        name = e.name()
        user = (name.startswith((prefix,) + PROGRAM_RANGES)
                or e.is_user_annotation())
        s = e.start_ns()
        t = s + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not user:
                dev.append((s, t, name))
        elif name.startswith(prefix):
            host.append((s, t, name))
    return dev, host


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def _innermost(host: List[Interval], starts: List[int], at: int) -> str:
    """The latest-starting host range that covers ``at``."""
    i = bisect.bisect_right(starts, at) - 1
    while i >= 0:
        s, t, name = host[i]
        if s <= at < t:
            return name
        i -= 1
    return "outside bench ranges"


def reduce(dev: List[Interval], host: List[Interval],
           rename: Optional[Dict[int, str]] = None) -> Optional[TraceSummary]:
    """Summarize a stretch. ``rename`` maps a host range's start to a more
    specific name (a step that admitted against one that only decoded)."""
    if not host:
        return None
    host = sorted(host)
    if rename:
        host = [(s, t, rename.get(s, n)) for s, t, n in host]
    w0 = host[0][0]
    w1 = max(t for _, t, _ in host)
    kernel_s: Dict[str, float] = {}
    clipped = []
    for s, t, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-9
        s, t = max(s, w0), min(t, w1)
        if t > s:
            clipped.append((s, t))
    busy = _union(clipped)
    busy_ns = sum(t - s for s, t in busy)
    starts = [s for s, _, _ in host]
    idle: Dict[str, float] = {}
    cursor = w0
    for s, t in busy + [(w1, w1)]:
        if s > cursor:
            name = _innermost(host, starts, (cursor + s) // 2)
            idle[name] = idle.get(name, 0.0) + (s - cursor) * 1e-9
        cursor = max(cursor, t)
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                        kernel_s=kernel_s, idle_by_span=idle,
                        n_device_events=len(dev))


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The line's ``breakdown``: the device operations that took most
    time, and the idle time by what the host was doing."""
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
