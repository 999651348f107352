"""repro_torch.tracing on the paged serving path (smoke deepseek-7b, sealed
weights, kernel decode, on the CPU): a tracer changes no token and no
audit line, its spans nest at the layer boundaries, the prefill spans
count the prompts, each span is also a profiler range, and with no tracer
active nothing records."""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import smoke_config
from repro_torch.core import SealingKey, TrustDomain
from repro_torch.core.sealing import tree_leaves_with_names
from repro_torch.models import build_model
from repro_torch.runtime import Engine, GenerationRequest, SamplingParams

PROMPTS = [np.arange(1, 4), np.arange(5, 11), np.arange(2, 10)]
SAMPLED = SamplingParams(temperature=0.8, seed=3)
NEW = 4


@pytest.fixture(scope="module")
def model():
    m = build_model(smoke_config("deepseek-7b"), device="cpu")
    return m, m.init_params(0)


def _serve(model, tracer=None):
    """Seal, load and serve PROMPTS (the last one sampled) under
    ``tracer``: (tokens, audit, engine)."""
    m, params = model
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"seal"),
                     io_key=SealingKey.generate(b"io"), device="cpu")

    def serve():
        loaded = td.load_sealed(td.seal_params(params), m.abstract_params())
        eng = Engine(m, loaded, trust_domain=td, kv_backend="paged",
                     page_size=8, kv_decode="kernel", max_slots=2,
                     max_len=64, prefill_buckets=(4, 8), device="cpu")
        reqs = [eng.submit(GenerationRequest(
            prompt=p.astype(np.int32), max_new_tokens=NEW,
            **({"params": SAMPLED} if i == 2 else {})))
            for i, p in enumerate(PROMPTS)]
        eng.run()
        return [list(r.output) for r in reqs], eng

    if tracer is None:
        toks, eng = serve()
    else:
        with tracing.active(tracer):
            toks, eng = serve()
    return toks, [(e.kind, e.detail) for e in td.audit], eng


@pytest.fixture(scope="module")
def runs(model):
    """The run without a tracer; the run with one, under the profiler;
    the tracer; the profiler's ranges of the program's names."""
    tracer = tracing.Tracer()
    bare = _serve(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _serve(model, tracer)
    ranges = sorted((e.start_ns(), e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(tracing.PREFIXES))
    return bare, traced, tracer, ranges


def _ancestors(spans, s):
    while s.parent is not None:
        s = spans[s.parent]
        yield s.name


def test_a_tracer_changes_no_token_and_no_audit_line(runs):
    (toks, audit, _), (ttoks, taudit, eng), tracer, _ = runs
    assert all(len(t) == NEW for t in toks)
    assert ttoks == toks and taudit == audit
    assert eng.kv.decode_mode == "kernel"
    assert tracer.spans and all(s.t1 >= s.t0 for s in tracer.spans)


@pytest.mark.parametrize("child, where", [
    ("kv:decode_launch", {"engine:step"}),
    ("kv:decode_wait", {"engine:step"}),
    ("kv:insert_prefill", {"engine:prefill"}),
    ("engine:emit", {"engine:step"}),
    ("engine:kv_events", {"engine:step"}),
    ("engine:admit", {"engine:step"}),
    ("engine:prefill", {"engine:admit"}),
    ("engine:first_token", {"engine:prefill"}),
    ("td:frame", {"engine:emit", "engine:prefill"}),
])
def test_spans_nest_at_the_layer_boundaries(runs, child, where):
    spans = runs[2].spans
    found = [s for s in spans if s.name == child]
    assert found
    for s in found:
        assert where & set(_ancestors(spans, s)), (child, s.parent)
        parent = spans[s.parent]
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1


def test_mac_counts_land_on_the_sealing_spans(model, runs):
    tracer = runs[2]
    owners = {s.name for s in tracer.spans if "td:mac_s" in s.attrs}
    assert owners == {"td:frame", "td:seal_params", "td:load_sealed"}
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves_with_names(model[1]))
    weights = [s for s in tracer.spans
               if s.name in ("td:seal_params", "td:load_sealed")]
    assert len(weights) == 2
    for s in weights:
        assert 0 < s.attrs["td:mac_s"] <= s.t1 - s.t0
        assert s.attrs["td:mac_bytes"] >= nbytes
    # ingress MACs run in submit, outside every span: totals only
    assert tracer.counters["td:mac_bytes"] > sum(
        s.attrs.get("td:mac_bytes", 0) for s in tracer.spans)


def test_prefill_spans_count_the_prompts(runs):
    spans = runs[2].spans
    pre = [s for s in spans if s.name == "engine:prefill"]
    assert sorted(r for s in pre for r in s.attrs["rids"]) == [0, 1, 2]
    assert sum(s.attrs["prompt_tokens"] for s in pre) == sum(
        len(p) for p in PROMPTS)
    for s in pre:
        assert s.attrs["rows"] == len(s.attrs["rids"])
        assert s.attrs["bucket"] in (4, 8)
        assert s.rid == (s.attrs["rids"][0] if s.attrs["rows"] == 1
                         else None)
    steps = [s for s in spans if s.name == "engine:step"]
    assert sum(s.attrs["produced"] for s in steps) == NEW * len(PROMPTS) - sum(
        1 for s in pre for _ in s.attrs["rids"])
    assert sum(s.attrs["admitted"] for s in steps) == len(PROMPTS)


def test_each_span_is_a_profiler_range(runs):
    """Each span, in order, is a range of its name on the profiler's own
    clock, which encloses it (the range opens before the span reads its
    start and closes after its end); over the run the ranges last what the
    spans last, to the profiler's own cost of a range."""
    tracer, ranges = runs[2], runs[3]
    assert [n for _, _, n in ranges] == [s.name for s in tracer.spans]
    host = [s.t1 - s.t0 for s in tracer.spans]
    dev = [ns * 1e-9 for _, ns, _ in ranges]
    for d, h, s in zip(dev, host, tracer.spans):
        # to the two clocks' resolution and the profiler's conversion of
        # its counter to nanoseconds
        assert d >= h * (1 - 1e-4) - 5e-6, s.name
    assert sum(dev) <= 1.1 * sum(host)


def test_no_tracer_records_nothing():
    assert tracing.current() is None
    with tracing.span("engine:step", rows=3) as sp:
        assert sp is tracing.NOOP and not sp
        sp.set(rows=4)
        sp.times(0.0, 1.0)
    tracer = tracing.Tracer()
    with tracing.active(tracer):
        with tracing.span("engine:step") as outer:
            with tracing.span("kv:decode_wait", rid=7):
                tracer.count("n", 2)
            tracer.count("n", 1)
        assert outer
    tracer.count("n", 5)
    with tracing.span("engine:emit"):
        pass
    step, wait = tracer.spans
    assert (wait.parent, wait.rid, wait.attrs) == (0, 7, {"n": 2})
    assert step.parent is None and step.attrs == {"n": 1}
    assert tracer.counters == {"n": 8}
