"""B3's share of its roofline: the least time the card could take to move
the bytes the traced decode steps' live lengths need (the yardstick's
count at 3.35 TB/s), over the device time of B3's two launches (the split
pass and the combine pass) in the trace."""

from teebench import yardstick
from teebench.runner import B3_KERNELS


def read(run):
    if run.summary is None:
        return None
    dev = sum(s for name, s in run.summary.kernel_s.items()
              if any(k in name for k in B3_KERNELS))
    if dev <= 0:
        return None
    page = run.cell["engine"]["page_size"]
    nbytes = sum(yardstick.b3_bytes(run.cfg, c.valid, page)
                 for c in run.decode_calls if c.t0 >= run.t_trace)
    return 100.0 * yardstick.hbm_bound_s(nbytes) / dev
