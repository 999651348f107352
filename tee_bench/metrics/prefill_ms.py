"""Host time of the port's prefills (its ``engine:prefill`` spans: an
admission's upload, prefill, first tokens, KV insert and first frames)
over the traced stretch, per row prefilled (the spans' ``rows``). The
profiler records there, so its cost on each operation the host enqueues
is in it."""


def read(run):
    spans = [s for s in run.spans if s.name == "engine:prefill"
             and s.t1 is not None]
    rows = sum(s.attrs.get("rows", 0) for s in spans)
    return sum(s.t1 - s.t0 for s in spans) / rows * 1e3 if rows else None
