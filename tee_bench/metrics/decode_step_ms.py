"""Mean host time of an ``Engine.step`` that admitted nothing (decode,
sampling, egress), over the window before the profiler started."""


def read(run):
    d = [s.t1 - s.t0 for s in run.steps
         if run.t_zero <= s.t0 and s.t1 <= run.untraced_end
         and s.admitted == 0 and s.produced > 0]
    return sum(d) / len(d) * 1e3 if d else None
