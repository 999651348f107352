"""The benchmark's client: it submits each request when it falls due (an
open loop) or when its client is free (a closed loop), steps the engine,
and takes every token where the client sees it, after the egress frame is
decrypted (the request's ``on_token``).

It also records the benchmark's own spans: each ``Engine.step`` with the
number of requests it admitted and the tokens it produced. With a profiler
attached, each span is also a named range in the trace (``bench:...``), so
the device's idle gaps can be laid against what the host was doing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

from teebench.traffic import RequestSpec

clock = time.perf_counter


@dataclasses.dataclass
class RequestRecord:
    spec: RequestSpec
    bucket: int
    t_due: float = 0.0            # absolute (clock) time it fell due
    submitted: bool = False
    failed: bool = False
    error: str = ""
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)

    def on_token(self, _req, tok: int) -> None:
        self.times.append(clock())
        self.tokens.append(int(tok))

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.spec.max_new_tokens


@dataclasses.dataclass
class StepSpan:
    t0: float
    t1: float
    admitted: int
    produced: int


def bucket_for(buckets, n: int) -> int:
    """The engine's rule: the smallest bucket that holds the prompt."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


class Client:
    """Drive ``system`` with ``specs`` from ``t_start`` until the window
    ``[t_zero, t_zero + window_s)`` closes."""

    def __init__(self, system, specs: List[RequestSpec], *, closed: bool,
                 buckets, t_zero: float, window_s: float,
                 span: Optional[Callable] = None,
                 at_trace: Optional[float] = None,
                 start_trace: Optional[Callable] = None):
        self.system = system
        self.closed = closed
        self.t_zero = t_zero
        self.t_end = t_zero + window_s
        self.records = [RequestRecord(s, bucket_for(buckets, len(s.prompt)))
                        for s in specs]
        self.steps: List[StepSpan] = []
        self.span = span or (lambda name: contextlib.nullcontext())
        self.at_trace, self.start_trace = at_trace, start_trace
        self.trace_started = False
        if closed:
            by_client = {}
            for r in self.records:
                by_client.setdefault(r.spec.client, []).append(r)
            self._lines = list(by_client.values())   # each client's queue
            self._ready: List[RequestRecord] = []
            self._live = {}
        else:
            for r in self.records:
                r.t_due = t_zero + r.spec.t_due
            self._next = 0

    # -- submission ---------------------------------------------------------
    def _submit(self, rec: RequestRecord) -> None:
        rec.submitted = True
        with self.span("bench:submit"):
            try:
                self.system.submit(rec.spec, rec.on_token)
            except Exception as e:      # a refused request is a failure
                rec.failed = True
                rec.error = repr(e)

    def _submit_due(self, now: float) -> None:
        if self.closed:
            for rec in self._ready:
                self._submit(rec)
            self._ready = []
            return
        while (self._next < len(self.records)
               and self.records[self._next].t_due <= now):
            self._submit(self.records[self._next])
            self._next += 1

    def _refill(self, now: float) -> None:
        """Closed loop: a client whose request finished (or failed) sends
        its next one now."""
        for c, line in enumerate(self._lines):
            cur = self._live.get(c)
            if cur is not None and not (cur.finished or cur.failed):
                continue
            if not line:
                continue
            nxt = line.pop(0)
            nxt.t_due = cur.times[-1] if cur is not None and cur.times \
                else now
            self._live[c] = nxt
            self._ready.append(nxt)

    def _next_due(self) -> float:
        if self.closed or self._next >= len(self.records):
            return self.t_end
        return self.records[self._next].t_due

    # -- the loop -------------------------------------------------------------
    def run(self) -> None:
        engine = self.system.engine
        while True:
            now = clock()
            if now >= self.t_end:
                break
            if (self.start_trace is not None and not self.trace_started
                    and now >= self.at_trace):
                self.start_trace()
                self.trace_started = True
            if self.closed:
                self._refill(now)
            self._submit_due(now)
            if engine.idle:
                with self.span("bench:wait"):
                    wake = min(self._next_due(), self.t_end)
                    if self.start_trace is not None and not self.trace_started:
                        wake = min(wake, self.at_trace)
                    time.sleep(max(0.0, wake - clock()))
                continue
            waiting = len(engine.scheduler.queue)
            t0 = clock()
            with self.span("bench:step"):
                produced = engine.step()
            t1 = clock()
            self.steps.append(StepSpan(t0, t1,
                                       waiting - len(engine.scheduler.queue),
                                       produced))
