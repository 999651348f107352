"""Model FLOPs of the real prompt and output tokens served in the window
before the profiler started (the yardstick's formula: no bucket padding,
causal context of real positions), over that time at the bf16 peak. A
prompt counts when its first token reaches the client; a decode step when
it returns."""

from teebench import yardstick


def read(run):
    w0, w1 = run.t_zero, run.untraced_end
    if w1 <= w0:
        return None
    flops = sum(yardstick.prefill_flops(run.cfg, len(r.spec.prompt))
                for r in run.records if r.times and w0 <= r.times[0] < w1)
    flops += sum(yardstick.decode_flops(run.cfg, [v - p for v, p in
                                                   zip(c.valid, c.pads)])
                 for c in run.decode_calls if w0 <= c.t1 < w1)
    return 100.0 * flops / ((w1 - w0) * yardstick.PEAK_BF16_FLOPS)
