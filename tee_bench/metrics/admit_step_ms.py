"""Host time of the ``Engine.step`` calls that admitted requests (their
prefills and the decode step after them), per request admitted, over the
window before the profiler started."""


def read(run):
    steps = [s for s in run.steps
             if run.t_zero <= s.t0 and s.t1 <= run.untraced_end
             and s.admitted > 0]
    n = sum(s.admitted for s in steps)
    return sum(s.t1 - s.t0 for s in steps) / n * 1e3 if n else None
