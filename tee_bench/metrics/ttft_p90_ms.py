"""The 90th percentile over every request due in the window of the time
from when it fell due to when its first token reached the client; a
request with no first token at the window's close (a failed one
included) counts at its age then."""

from teebench.stats import percentile


def read(run):
    w0, w1 = run.t_zero, run.t_end
    ages = []
    for r in run.records:
        if not r.submitted or not w0 <= r.t_due < w1:
            continue
        first = r.times[0] if r.times and not r.failed else w1
        ages.append(min(first, w1) - r.t_due)
    v = percentile(ages, 90)
    return None if v is None else v * 1e3
