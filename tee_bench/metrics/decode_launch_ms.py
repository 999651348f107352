"""Mean host time of the port's decode launches (its ``kv:decode_launch``
spans: the write slots, the uploads and the forward's enqueue) over the
traced stretch. The profiler records there, so its cost on each operation
the host enqueues is in it."""


def read(run):
    d = [s.t1 - s.t0 for s in run.spans
         if s.name == "kv:decode_launch" and s.t1 is not None]
    return sum(d) / len(d) * 1e3 if d else None
