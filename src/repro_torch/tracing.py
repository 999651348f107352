"""Spans and counters at the layer boundaries of the serving path and the
trust domain, recorded only for a caller that asks for them::

    tracer = tracing.Tracer()
    with tracing.active(tracer):
        engine.run()
    for s in tracer.spans:
        print(s.name, s.t1 - s.t0, s.attrs)

While no tracer is active, :func:`span` returns one shared no-op object,
which reads no clock and records nothing.
While one is, a span records its name, its start and end on :func:`clock`
(``time.perf_counter``, the clock a benchmark client times requests with),
its parent (the innermost span open when it started), the request it
serves where it serves one, and its attrs; the records stay in
``Tracer.spans``, in the order the spans started, until the caller reads
them. ``Tracer.count`` adds to a named total and to the same-named attr of
the innermost open span, so a count can be taken over any window of spans.

The profiler stamps its events in epoch nanoseconds, a clock no
``perf_counter`` reading can be laid against. So while a ``torch.profiler``
records, each span is also a ``record_function`` range of its name, and
lands on the device trace's own clock.

Every name starts with its layer's prefix (:data:`PREFIXES`), which no
kernel name starts with. The tracer is per thread of control (a
``contextvars`` variable): a thread the traced code starts records nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

clock = time.perf_counter
PREFIXES = ("engine:", "kv:", "td:")


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    t0: Optional[float]
    t1: Optional[float] = None
    parent: Optional[int] = None     # index in Tracer.spans
    rid: Optional[int] = None        # the request, where it is one's
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """The spans and counters recorded while it is :func:`active`."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self._open: List[int] = []

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self._open:
            attrs = self.spans[self._open[-1]].attrs
            attrs[name] = attrs.get(name, 0) + n


_ACTIVE: contextvars.ContextVar[Optional[Tracer]] = contextvars.ContextVar(
    "repro_torch_tracer", default=None)


@contextlib.contextmanager
def active(tracer: Tracer) -> Iterator[Tracer]:
    """Record into ``tracer`` inside the block."""
    token = _ACTIVE.set(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[Tracer]:
    return _ACTIVE.get()


class _NoSpan:
    """What :func:`span` returns while nothing records (false in a test)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def times(self, t0: float, t1: float) -> None:
        pass


NOOP = _NoSpan()


class _Open:
    """A recording span between its start and its end."""
    __slots__ = ("tracer", "span", "range")

    def __init__(self, tracer: Tracer, span: Span):
        self.tracer, self.span, self.range = tracer, span, None

    def __enter__(self):
        tr, sp = self.tracer, self.span
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(sp.name)
            self.range.__enter__()
        sp.t0 = clock()
        sp.parent = tr._open[-1] if tr._open else None
        tr._open.append(len(tr.spans))
        tr.spans.append(sp)
        return self

    def __exit__(self, *exc) -> bool:
        if self.span.t1 is None:
            self.span.t1 = clock()
        self.tracer._open.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def times(self, t0: float, t1: float) -> None:
        """Start and end the span at readings of :func:`clock` the caller
        took inside it."""
        self.span.t0, self.span.t1 = t0, t1


def span(name: str, *, rid: Optional[int] = None, **attrs):
    """A context manager around one pass through a boundary."""
    tracer = _ACTIVE.get()
    if tracer is None:
        return NOOP
    return _Open(tracer, Span(name, None, rid=rid, attrs=attrs))
