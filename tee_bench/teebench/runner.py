"""One run of one cell: set-up, the measured window, the metrics, and the
correctness check, as the result line reports them."""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, List, Optional

from teebench import check, spec, stats, trace, traffic as traffic_mod
from teebench.client import Client, RequestRecord, StepSpan, clock
from teebench.program import System, decode_path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
B3_KERNELS = ("split_kernel", "combine_kernel")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cfg: dict
    cell: dict
    traffic: dict
    t_zero: float                 # the window opens (host clock)
    t_end: float                  # the window closes
    setup_s: float
    timings: Dict[str, float]     # set-up parts (weights, seal, unseal, ...)
    records: List[RequestRecord]
    steps: List[StepSpan]
    decode_calls: list            # program.DecodeCall, in order
    t_trace: Optional[float] = None   # the profiler started (host clock)
    summary: Optional[trace.TraceSummary] = None
    # the port's spans (``repro_torch.tracing.Span``: name, t0 and t1 on
    # the host clock, attrs) and counter totals over the traced stretch
    spans: list = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_zero

    @property
    def untraced_end(self) -> float:
        """Where host-clock rates stop: the window's close, or the
        profiler's start in a traced run (its overhead stays out)."""
        return self.t_trace if self.t_trace is not None else self.t_end


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def serve(system, cfg: dict, cell: dict, mix: dict, seed: int,
          seconds: float, *, traced: bool, t_process0: float,
          rate: Optional[float] = None) -> Run:
    """Warm up, pre-roll, and measure one window on ``system``."""
    import torch
    system.coalesce = mix["coalesce"]
    t0 = clock()
    system.warm_up(system.buckets)
    system.timings["warmup_s"] = clock() - t0
    arrivals = dict(cell["arrivals"])
    if rate is not None:
        arrivals["rate_per_s"] = rate
    preroll = cell["preroll_s"]
    specs = traffic_mod.generate(mix, arrivals, cfg["vocab_size"], seed,
                                 seconds, preroll)
    prof = None
    span = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if system.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        span = torch.profiler.record_function
    t_start = clock()
    t_zero = t_start + preroll
    trace_at = t_zero + seconds - cell["trace_s"] if traced else None
    started = {}

    def start_trace():
        started["t"] = clock()
        started["step"] = len(client.steps)
        prof.start()
        system.start_tracing()

    client = Client(system, specs, closed=mix["arrival"] == "closed",
                    buckets=system.buckets, t_zero=t_zero, window_s=seconds,
                    span=span, at_trace=trace_at,
                    start_trace=start_trace if traced else None)
    client.run()
    summary = None
    spans, counters = [], {}
    if prof is not None and "t" in started:
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        spans, counters = system.stop_tracing()
        prof.stop()
        dev, host = trace.split_events(prof.profiler.kineto_results.events())
        steps = [s for s in host if s[2] == "bench:step"]
        rename = {}
        for (s, _, _), st in zip(sorted(steps),
                                 client.steps[started["step"]:]):
            rename[s] = ("bench:step_admit" if st.admitted
                         else "bench:step_decode")
        summary = trace.reduce(dev, host, rename)
        del prof
    return Run(cfg=cfg, cell=cell, traffic=mix, t_zero=t_zero,
               t_end=t_zero + seconds, setup_s=t_zero - t_process0,
               timings=dict(system.timings), records=client.records,
               steps=client.steps, decode_calls=list(system.decode_calls),
               t_trace=started.get("t"), summary=summary, spans=spans,
               counters=counters)


def info(run: Run) -> dict:
    """Numbers beside the judged ones, for the record (an earlier line)."""
    w0, w1 = run.t_zero, run.t_end
    due = [r for r in run.records if r.submitted and w0 <= r.t_due < w1]
    ttft = [(r.times[0] if r.times and r.times[0] < w1 else w1) - r.t_due
            for r in due]
    gaps = [b - a for r in run.records for a, b in zip(r.times, r.times[1:])
            if w0 <= b < w1]
    steps = [s for s in run.steps if w0 <= s.t0 and s.t1 <= w1]
    pct = stats.percentile

    def ms(v):
        return None if v is None else v * 1e3

    return {
        "requests_due": len(due),
        "requests_done_in_window": sum(1 for r in run.records if r.finished
                                       and w0 <= r.times[-1] < w1),
        "queued_at_close": sum(1 for r in run.records if r.submitted
                               and not r.times),
        "tokens_in_window": sum(1 for r in run.records for t in r.times
                                if w0 <= t < w1),
        "ttft_ms": {q: ms(pct(ttft, q)) for q in (50, 75, 90, 95)},
        "itl_ms": {q: ms(pct(gaps, q)) for q in (50, 90, 95, 97.5, 99, 99.5)},
        "gaps": len(gaps),
        "steps": len(steps),
        "admit_steps": sum(1 for s in steps if s.admitted),
        "step_ms_mean": ms(sum(s.t1 - s.t0 for s in steps)
                           / max(1, len(steps))),
        "timings_s": run.timings, "setup_s": run.setup_s,
    }


def judge(cmp: dict, chk: dict, failed: int, b3_launches=None,
          gap_key: str = "max_logit_gap",
          decode: str = "kernel") -> Dict[str, dict]:
    """Each number compared, beside its limit, and whether it holds. B3's
    launches (counted on the card only) are held on the kernel decode
    path; the gather path never launches it."""
    gap = cmp[gap_key]
    checks = {
        "max_logit_gap": {"value": gap, "limit": chk["max_logit_gap"],
                          "ok": gap is not None
                          and gap <= chk["max_logit_gap"]},
        "tokens_compared": {"value": cmp["tokens_compared"],
                            "limit": chk["min_tokens"],
                            "ok": cmp["tokens_compared"] >= chk["min_tokens"]},
        "requests_compared": {"value": cmp["requests_compared"],
                              "limit": chk["min_requests"],
                              "ok": cmp["requests_compared"]
                              >= chk["min_requests"]},
        "failed_requests": {"value": failed, "limit": 0, "ok": failed == 0},
    }
    if decode == "kernel" and b3_launches is not None:
        checks["b3_launches"] = {"value": b3_launches, "limit": 1,
                                 "ok": b3_launches >= 1}
    return checks


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, *, device, t_process0: float, cell=None, cfg=None,
             mix=None, model_cfg=None, fault: Optional[str] = None,
             control: bool = False) -> dict:
    """One run as ``run.py`` makes it; ``cell``, ``cfg``, ``mix`` and
    ``model_cfg`` replace the files' (the CPU tests' smoke sizes). With
    ``control`` the comparison judges the lower-precision control's first
    choices in place of the served tokens (``check.compare``), so a sound
    check reads ``correct`` false."""
    import torch
    w = spec.workload(bench, workload)
    cell = cell or spec.cell(workload)
    cfg = cfg or spec.config(w["config"])
    mix = mix or spec.traffic(w["traffic"])
    reference = spec.reference(cfg)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from repro_torch.kernels import paged_attention as b3
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)       # the context, before its stats
        torch.cuda.reset_peak_memory_stats(device)
    system = System(cfg, cell, seed, device=device, model_cfg=model_cfg,
                    fault=fault)
    if cuda:
        b3.reset_launches()
    run = serve(system, cfg, cell, mix, seed, seconds, traced=traced,
                t_process0=t_process0)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)}
    if traced and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
    metrics = {}
    for m in spec.metrics_for(bench, workload, traced):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra = info(run)
    extra["b3_launches"] = (b3.launches["paged_attention"]
                            + b3.launches["paged_attention_unseal"]
                            if cuda else None)
    system.close()
    chk = cell["check"]
    picked = check.sample(run.records, seed, chk["min_tokens"],
                          chk["min_requests"], chk["max_requests"],
                          run.t_end)
    cmp = check.compare(reference, cfg, seed, picked, device=device,
                        control=control)
    extra["check"] = cmp
    w0, w1 = run.t_zero, run.t_end
    due = [r for r in run.records if r.submitted and w0 <= r.t_due < w1]
    checks = judge(cmp, chk, sum(1 for r in run.records if r.failed),
                   extra["b3_launches"],
                   "control_max_logit_gap" if control else "max_logit_gap",
                   decode_path(cell))
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": len(due),
              "failed": sum(1 for r in due if r.failed),
              "metrics": metrics, "device": dev}
    if traced and run.summary is not None:
        result["breakdown"] = trace.breakdown(run.summary)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    result["_info"] = extra
    return result


def emit(result: dict) -> None:
    """Print the record line, then the result as the last line of standard
    output, and each number compared beside its limit as the last lines of
    standard error."""
    extra = result.pop("_info", None)
    if extra is not None:
        print(json.dumps({"info": extra}, default=float), flush=True)
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)

