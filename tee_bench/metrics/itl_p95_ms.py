"""The 95th percentile of every gap between consecutive tokens of one
request, as the client received them, over the gaps that end in the
window (before the profiler started, in a traced run)."""

from teebench.stats import percentile


def read(run):
    gaps = [b - a for r in run.records for a, b in zip(r.times, r.times[1:])
            if run.t_zero <= b < run.untraced_end]
    v = percentile(gaps, 95)
    return None if v is None else v * 1e3
