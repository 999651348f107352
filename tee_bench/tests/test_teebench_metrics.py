"""The metric arithmetic on synthetic timelines: a stall inside the
window moves the tails and the rate; the span readers on hand-made
spans."""

import types

import pytest

from teebench import spec
from teebench.client import RequestRecord
from teebench.runner import Run
from teebench.traffic import RequestSpec

import numpy as np


def _timeline(stall=None, n=40, window=10.0, itl=0.05, tokens=20):
    """n requests due 0.25 s apart from t = 0, each first token 0.1 s
    after it falls due, then one token every ``itl`` s. ``stall`` is a list
    of (start, length) pauses of the server: every token due at or after a
    pause's start comes its length later."""
    recs = []
    for i in range(n):
        due = 0.25 * i
        rec = RequestRecord(RequestSpec(due, np.ones(8, np.int32), tokens),
                            16, t_due=due, submitted=True)
        for k in range(tokens):
            t = due + 0.1 + k * itl
            t += sum(length for start, length in stall or () if t >= start)
            rec.times.append(t)
            rec.tokens.append(1)
        recs.append(rec)
    return Run(cfg={}, cell={}, traffic={}, t_zero=0.0, t_end=window,
               setup_s=1.0, timings={}, records=recs, steps=[],
               decode_calls=[])


def _read(name, run):
    return spec.reader(name)(run)


def test_a_stall_moves_the_tails_and_the_rate():
    """Pauses of 0.2 s every half second (a long prefill in front of the
    decode steps) in the middle of the window."""
    calm = _timeline(tokens=60)
    stalled = _timeline(tokens=60,
                        stall=[(2.0 + 0.5 * i, 0.2) for i in range(12)])
    assert _read("output_tok_s", stalled) < _read("output_tok_s", calm)
    assert _read("itl_p95_ms", calm) == pytest.approx(50.0)
    assert _read("itl_p95_ms", stalled) > _read("itl_p95_ms", calm)
    assert _read("ttft_p90_ms", stalled) > _read("ttft_p90_ms", calm)
    assert _read("ttft_p90_ms", calm) == pytest.approx(100.0)
    assert _read("itl_p95_ms", stalled) == pytest.approx(250.0)


def test_rate_counts_tokens_received_in_the_window():
    run = _timeline(window=10.0)
    inside = sum(1 for r in run.records for t in r.times if 0 <= t < 10.0)
    assert _read("output_tok_s", run) == pytest.approx(inside / 10.0)


def test_unserved_and_failed_requests_count_at_their_age():
    run = _timeline(n=10)
    late = RequestRecord(RequestSpec(9.0, np.ones(8, np.int32), 4), 16,
                         t_due=9.0, submitted=True)
    failed = RequestRecord(RequestSpec(8.0, np.ones(8, np.int32), 4), 16,
                           t_due=8.0, submitted=True, failed=True)
    run.records += [late, failed]
    ages = sorted([100.0] * 10 + [1000.0, 2000.0])
    assert _read("ttft_p90_ms", run) == pytest.approx(
        float(np.percentile(ages, 90)))


def test_gaps_count_where_they_end():
    run = _timeline(n=1, tokens=5, itl=1.0, window=2.5)
    # tokens at 0.1, 1.1, 2.1, 3.1, 4.1: two gaps end inside [0, 2.5)
    assert _read("itl_p95_ms", run) == pytest.approx(1000.0)
    assert _read("output_tok_s", run) == pytest.approx(3 / 2.5)


def _span(name, t0, t1, **attrs):
    """A span as ``repro_torch.tracing.Span`` records one."""
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, attrs=attrs)


def test_span_readers_take_the_ports_spans():
    """Prefill time per row prefilled, and the mean decode launch; other
    spans, and one still open, count for nothing."""
    run = _timeline(n=1)
    assert _read("prefill_ms.chat", run) is None
    assert _read("decode_launch_ms.chat", run) is None
    run.spans = [
        _span("engine:step", 0.0, 1.0, rows=2),
        _span("engine:prefill", 0.1, 0.3, rows=1, bucket=256),
        _span("engine:first_token", 0.2, 0.3),
        _span("engine:prefill", 0.5, 0.9, rows=2, bucket=512),
        _span("kv:decode_launch", 1.0, 1.04, rows=3),
        _span("kv:decode_wait", 1.04, 1.05),
        _span("kv:decode_launch", 1.1, 1.12, rows=3),
        _span("engine:prefill", 2.0, None, rows=4),
        _span("kv:decode_launch", 2.1, None, rows=3)]
    assert _read("prefill_ms.chat", run) == pytest.approx(600.0 / 3)
    assert _read("decode_launch_ms.chat", run) == pytest.approx(30.0)
