"""Tokens the client received in the window, over the window's seconds."""


def read(run):
    n = sum(1 for r in run.records for t in r.times
            if run.t_zero <= t < run.t_end)
    return n / run.window_s
