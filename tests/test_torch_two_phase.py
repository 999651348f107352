"""repro_torch's two-phase serving against repro.runtime.engine: step-level
continuous batching (``slot-cb``, ``paged-cb``) and disaggregated prefill
with the sealed plan-to-plan handoff (``slot-2plan``, ``paged-2plan``, one
and two rows a crossing) on the canonical scenario and on the long-prompt
burst of tests/conftest.py: tokens, ``ServeStats`` (handoffs, backfills),
``ChannelStats``, the audit log (``handoff x{n} rids=...``) and page tables
at every step, each request equal to its solo run. Also the reference's
validation errors, its backfill case, and the prefill plan's contract."""

import numpy as np
import pytest
import torch

from _torch_ref import REF_TRIES, reference_run
from conftest import (CANONICAL_CONFIGS, CANONICAL_ENGINE, burst_requests,
                      check_pool_invariants)
from repro_torch.runtime import ComputePlan, ShardedPlan, SingleDevicePlan
from repro_torch.runtime.plan import PrefillOnlyPlan
from test_torch_sampled_serving import (CHANNEL_FIELDS, STAT_FIELDS,  # noqa
                                        Side, _canonical, _spec_gen,
                                        assert_same_run, models, solo_refs)

TWO_PHASE = [("slot-cb", 1), ("paged-cb", 1), ("slot-2plan", 1),
             ("slot-2plan", 2), ("paged-2plan", 1), ("paged-2plan", 2)]
PHASE_STATS = ("handoffs", "handoff_bytes", "backfilled_requests")
PHASE_REQ = ("n_handoffs", "handoff_bytes", "backfilled", "phase")
# The reference's two-plan engine is not rerun-stable under load (ROADMAP.md
# queue C): for that configuration alone, a reference run whose tokens differ
# from the port's is rerun (tests/_torch_ref.py). Every other configuration
# is compared on a single reference run.
UNSTABLE_REFERENCE = ("paged-2plan",)


def _kw(name, handoff_batch):
    kw = dict(CANONICAL_CONFIGS[name])
    if handoff_batch > 1:
        kw["handoff_batch"] = handoff_batch
    return kw


def _assert_same_phases(j, t):
    """The two-phase counters of two runs agree: per request, per run and
    per engine."""
    (jreqs, jeng, _), (treqs, teng, _) = j, t
    for f in PHASE_REQ:
        assert [getattr(r, f) for r in treqs] == \
            [getattr(r, f) for r in jreqs], f
    tstats, jstats = teng.scheduler.stats(), jeng.scheduler.stats()
    for f in PHASE_STATS:
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert teng.handoff_crossings == jeng.handoff_crossings
    assert teng.backfills == jeng.backfills


@pytest.mark.parametrize("name,handoff_batch", TWO_PHASE)
def test_canonical_two_phase_scenario_identical(models, solo_refs, name,
                                                handoff_batch):
    kw = _kw(name, handoff_batch)
    port, ref = Side(True, models), Side(False, models)
    t = _canonical(port, **kw)
    j = reference_run(lambda: _canonical(ref, **kw), t,
                      tries=REF_TRIES if name in UNSTABLE_REFERENCE else 1)
    assert_same_run(j, t)
    _assert_same_phases(j, t)
    assert [list(r.output) for r in t[0]] == solo_refs
    if "2plan" in name:
        n = len(t[0])
        assert t[1].scheduler.stats().handoffs == n
        assert n / handoff_batch <= t[1].handoff_crossings <= n
        if handoff_batch > 1:
            assert t[1].handoff_crossings < n   # some crossing carried two


def _burst(side, **kw):
    """conftest.run_burst_scenario with every step's page table recorded
    (and on the port the pool invariants checked)."""
    eng = side.engine(**dict(CANONICAL_ENGINE, **kw))
    reqs = [eng.submit(_spec_gen(side, s)) for s in burst_requests()]
    tables = []
    while not eng.idle and len(tables) < 5000:
        eng.step()
        paged = hasattr(eng.kv, "table")
        tables.append(eng.kv.table.copy() if paged else None)
        if paged and side.port:
            check_pool_invariants(eng.kv)
    assert all(r.finished for r in reqs)
    return reqs, eng, tables


@pytest.fixture(scope="module")
def burst_solo(models):
    port = Side(True, models)
    eng = port.engine(**CANONICAL_ENGINE)
    return [eng.generate(_spec_gen(port, s)).tokens for s in burst_requests()]


@pytest.mark.parametrize("name,handoff_batch", TWO_PHASE)
def test_burst_two_phase_scenario_identical(models, burst_solo, name,
                                            handoff_batch):
    kw = _kw(name, handoff_batch)
    port, ref = Side(True, models), Side(False, models)
    t = _burst(port, **kw)
    j = reference_run(lambda: _burst(ref, **kw), t,
                      tries=REF_TRIES if name in UNSTABLE_REFERENCE else 1)
    (treqs, teng, ttables), (jreqs, jeng, jtables) = t, j
    assert [r.output for r in treqs] == [r.output for r in jreqs] == burst_solo
    tstats, jstats = teng.run(), jeng.run()
    for f in STAT_FIELDS:
        assert getattr(tstats, f) == getattr(jstats, f), f
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    for f in CHANNEL_FIELDS:
        assert getattr(tch, f) == getattr(jch, f), f
    assert ([(e.kind, e.detail) for e in teng.td.audit]
            == [(e.kind, e.detail) for e in jeng.td.audit])
    assert len(ttables) == len(jtables)
    for step, (a, b) in enumerate(zip(ttables, jtables)):
        assert a is None and b is None or np.array_equal(a, b), \
            f"page table differs after step {step}"
    _assert_same_phases(j, t)
    if "2plan" in name:
        assert tstats.handoffs == len(treqs) and tstats.handoff_bytes > 0
        assert tch.seal_bytes >= tstats.handoff_bytes
        assert tch.restore_bytes >= tstats.handoff_bytes
        assert tstats.backfilled_requests == 0
        assert all(r.phase == "done" for r in teng.scheduler.finished)


def _error(side, **kw):
    with pytest.raises(ValueError) as e:
        side.engine(**dict(CANONICAL_ENGINE, **kw))
    return str(e.value)


BAD_ARGUMENTS = [
    dict(continuous_batching=True, prefill_plan="dedicated"),
    dict(step_tokens=16),
    dict(prefill_plan="remote"),
    dict(continuous_batching=True, step_tokens=4),
    dict(prefill_plan="dedicated", handoff_batch=0),
    dict(handoff_batch=2),
    dict(kv_backend="paged", page_size=8, page_store=True),
    dict(kv_backend="paged", page_size=8, store_budget_pages=4),
    dict(kv_backend="paged", page_size=8, prefix_sharing=True,
         page_store="fifo"),
    dict(kv_backend="paged", page_size=8, prefix_sharing=True,
         store_budget_pages=-1),
    dict(page_store=True),
]


@pytest.mark.parametrize("kw", BAD_ARGUMENTS,
                         ids=lambda kw: ",".join(sorted(kw)))
def test_validation_errors_match_reference(models, kw):
    """The reference's ValueError, word for word, for the same bad
    two-phase and store arguments."""
    assert _error(Side(True, models), **kw) == _error(Side(False, models),
                                                      **kw)


def _ready_store_with_budget(side):
    from repro.runtime.pagestore import SealedPageStore as J
    from repro_torch.runtime.pagestore import SealedPageStore as T
    store = (T if side.port else J)()
    return _error(side, kv_backend="paged", page_size=8, prefix_sharing=True,
                  page_store=store, store_budget_pages=4)


def test_ready_store_with_budget_raises_as_reference(models):
    assert _ready_store_with_budget(Side(True, models)) == \
        _ready_store_with_budget(Side(False, models))


def _backfill(s):
    """tests/test_differential.py's interleaved-prefill case: a short
    request backfills the leftover step budget while the long one waits
    for a fresh budget."""
    sp = lambda seed: dict(temperature=0.9, top_k=16, seed=seed)  # noqa
    eng = s.engine(**dict(CANONICAL_ENGINE, continuous_batching=True,
                          step_tokens=8))
    filler = eng.submit(s.gen(np.arange(1, 5), sp(400), max_new_tokens=8))
    eng.step()
    long = eng.submit(s.gen(np.arange(1, 13), sp(401), max_new_tokens=6))
    short = eng.submit(s.gen(np.arange(1, 4), sp(402), max_new_tokens=5))
    eng.step()
    running = list(eng.scheduler.running.values())
    assert short in running and long not in running
    assert short.backfilled and eng.backfills >= 1
    eng.run(max_steps=50_000)
    return ([r.output for r in (filler, long, short)], eng.backfills,
            [(e.kind, e.detail) for e in eng.td.audit])


def test_backfill_case_matches_reference(models):
    assert _backfill(Side(True, models)) == _backfill(Side(False, models))


def test_prefill_plan_shares_weights_and_has_no_decode(models):
    """The dedicated plan reuses the decode plan's weight tensors (no copy
    on one device), runs inline on the CPU, and compiles no decode step."""
    port = Side(True, models)
    eng = port.engine(prefill_plan="dedicated")
    assert isinstance(eng.prefill_plan, PrefillOnlyPlan)
    assert eng.prefill_plan.stream is None
    assert (eng.prefill_params["embedding"]["table"].data_ptr()
            == eng.params["embedding"]["table"].data_ptr())
    with pytest.raises(RuntimeError, match="no decode step"):
        eng.prefill_plan.compile_decode(lambda: None)
    tokens = torch.ones((1, 8), dtype=torch.int32)
    logits, cache, ready = eng._prefill_stream_fn(
        eng.prefill_params, tokens, port.model.init_cache(1, 64))
    assert ready is None and int(cache["pos"][0]) == 8
    ref_logits, _ = port.model.prefill(eng.params, {"tokens": tokens},
                                       port.model.init_cache(1, 64))
    assert torch.equal(logits, ref_logits)


def test_compute_plan_subclasses_are_accepted(models):
    """``repro_torch.runtime.ComputePlan`` is the base of every plan, as the
    reference's is, and an engine takes any subclass as its plan and as its
    dedicated prefill plan: served through two subclasses, a request gets
    the default engine's tokens."""
    from repro.runtime import ComputePlan as JComputePlan
    from repro.runtime import PrefillOnlyPlan as JPrefillOnlyPlan
    assert issubclass(JPrefillOnlyPlan, JComputePlan)
    for cls in (SingleDevicePlan, PrefillOnlyPlan, ShardedPlan):
        assert issubclass(cls, ComputePlan)

    class CountingPlan(ComputePlan):
        name = "counting"
        decodes = 0

        def compile_decode(self, fn):
            step = super().compile_decode(fn)

            def counted(*args):
                CountingPlan.decodes += 1
                return step(*args)
            return counted

    class OwnPrefillPlan(PrefillOnlyPlan):
        name = "own-prefill"

    port = Side(True, models)
    want = port.engine().generate(port.gen(max_new_tokens=5))
    eng = port.engine(plan=CountingPlan(port.model),
                      prefill_plan=OwnPrefillPlan(port.model))
    assert eng.prefill_plan.name == "own-prefill"
    assert eng.generate(port.gen(max_new_tokens=5)).tokens == want.tokens
    assert CountingPlan.decodes > 0
