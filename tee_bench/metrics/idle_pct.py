"""The share of the traced stretch in which no operation ran on the
device."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.n_device_events == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
