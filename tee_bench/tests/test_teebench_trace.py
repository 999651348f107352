"""The profiler's reduction on a synthetic trace: busy time is the union
of device events inside the stretch, and each idle gap is charged to the
innermost host range around it."""

import pytest

from teebench import trace


class _Ev:
    def __init__(self, name, dev, s, t, user=False):
        self._n, self._d, self._s, self._t, self._u = name, dev, s, t, user

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t - self._s

    def is_user_annotation(self):
        return self._u


MS = 1_000_000


def _events():
    ms = MS
    return [
        _Ev("bench:step", "CPU", 0, 10 * ms, True),
        _Ev("bench:submit", "CPU", 2 * ms, 3 * ms, True),
        _Ev("bench:wait", "CPU", 10 * ms, 12 * ms, True),
        _Ev("bench:step", "CUDA", 0, 10 * ms, True),   # a range's shadow
        _Ev("gemm", "CUDA", 1 * ms, 2 * ms),
        _Ev("gemm", "CUDA", 1500000, 2500000),          # overlaps
        _Ev("split_kernel", "CUDA", 4 * ms, 9 * ms),
        _Ev("aten::mm", "CPU", 1 * ms, 2 * ms),
    ]


def test_busy_idle_and_kernel_time():
    ms = MS
    dev, host = trace.split_events(_events())
    assert len(dev) == 3 and len(host) == 3
    s = trace.reduce(dev, host, rename={0: "bench:step_decode"})
    assert s.window_s == pytest.approx(12e-3)
    assert s.busy_s == pytest.approx(6.5e-3)
    assert s.kernel_s == {"gemm": pytest.approx(2e-3),
                          "split_kernel": pytest.approx(5e-3)}
    # idle gaps 0-1 and 2.5-4 (its middle in the step, past the submit)
    # are the step's; 9-12 (its middle in the wait) the wait's
    assert s.idle_by_span == {"bench:step_decode": pytest.approx(2.5e-3),
                              "bench:wait": pytest.approx(3e-3)}
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "split_kernel"
    assert b["idle_gaps"][0] == ["bench:wait", pytest.approx(3e-3)]
    # a gap inside the submit is the submit's, the innermost range
    s2 = trace.reduce([(0, 2 * ms, "k"), (2600000, 10 * ms, "k")], host)
    assert s2.idle_by_span["bench:submit"] == pytest.approx(0.6e-3)


def test_no_host_ranges_no_summary():
    assert trace.reduce([], []) is None


def test_the_ports_ranges_move_nothing():
    """The port's spans are ranges of their names while the profiler
    records: on the host and as projections on the device, flagged as user
    annotations or not. The reduction reads the same with them."""
    ms = MS
    ranges = [
        _Ev("engine:step", "CPU", 0, 10 * ms, True),
        _Ev("engine:step", "CUDA", 0, 10 * ms, True),
        _Ev("kv:decode_launch", "CPU", 3 * ms, 9 * ms, True),
        _Ev("kv:decode_launch", "CUDA", 2 * ms, 11 * ms),
        _Ev("td:frame", "CUDA", 9 * ms, 12 * ms),
        _Ev("engine:prefill", "CUDA", 0, 12 * ms)]
    plain = trace.split_events(_events())
    assert trace.split_events(_events() + ranges) == plain
    a = trace.reduce(*trace.split_events(_events() + ranges),
                     rename={0: "bench:step_decode"})
    b = trace.reduce(*plain, rename={0: "bench:step_decode"})
    assert a == b and a.busy_s == pytest.approx(6.5e-3)
    assert trace.breakdown(a) == trace.breakdown(b)
