"""repro_torch's engine with seeded sampling against repro.runtime: the
canonical scenario as tests/conftest.py defines it (temperature 0.9, top_k
16, seeds 100-106) on the slot, paged and paged-kernel backends, the
reference's request-API sampling cases, ``Engine.stream`` and
``Engine.prompt_budget``. Tokens are a pure function of (prompt, sampling
params, seed): both packages must produce the same ones, and every port
request must equal its solo run."""

import numpy as np
import pytest
import jax

from conftest import (CANONICAL_ENGINE, canonical_requests,
                      check_pool_invariants)
from repro.configs import smoke_config
from repro.core import SealingKey as JKey
from repro.core import TrustDomain as JTD
from repro.models import build_model as jbuild
from repro.runtime import Engine as JEngine
from repro.runtime import GenerationRequest as JGen
from repro.runtime import SamplingParams as JSampling
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import SealingKey as TKey
from repro_torch.core import TrustDomain as TTD
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import Engine as TEngine
from repro_torch.runtime import GenerationRequest as TGen
from repro_torch.runtime import SamplingParams as TSampling

CONFIGS = {
    "slot": dict(kv_backend="slot"),
    "paged": dict(kv_backend="paged", page_size=8),
    "paged-kernel": dict(kv_backend="paged", page_size=8, kv_decode="kernel"),
}
PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(scope="module")
def models():
    jm = jbuild(smoke_config("deepseek-7b"))
    jp = jm.init_params(jax.random.key(0))
    tm = tbuild(tsmoke("deepseek-7b"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


class Side:
    """One package's engine factory and request constructors."""

    def __init__(self, port, models):
        jm, jp, tm, tp = models
        self.port = port
        self.model, self.params = (tm, tp) if port else (jm, jp)
        self.TD, self.Key, self.Engine, self.Gen, self.SP = (
            (TTD, TKey, TEngine, TGen, TSampling) if port
            else (JTD, JKey, JEngine, JGen, JSampling))
        self.dev = {"device": "cpu"} if port else {}

    def td(self):
        return self.TD("tdx", sealing_key=self.Key.generate(b"seal"),
                       io_key=self.Key.generate(b"io"), **self.dev)

    def engine(self, td=None, **kw):
        kw.setdefault("max_slots", 2)
        kw.setdefault("max_len", 64)
        kw.setdefault("prefill_len", 8)
        return self.Engine(self.model, self.params,
                           trust_domain=td or self.td(), **kw, **self.dev)

    def gen(self, prompt=PROMPT, params=None, **kw):
        return self.Gen(prompt=np.asarray(prompt, np.int32),
                        params=self.SP(**(params or {})), **kw)


def _spec_gen(side, spec):
    prompt, mnt, prio, seed = spec
    return side.gen(prompt, dict(temperature=0.9, top_k=16, seed=seed),
                    max_new_tokens=mnt, priority=prio)


def _canonical(side, **kw):
    """conftest.run_canonical_scenario on one engine, with every step's page
    table recorded and, on the port, the pool invariants checked."""
    eng = side.engine(**dict(CANONICAL_ENGINE, **kw))
    low, high = canonical_requests()
    tables = []

    def step():
        eng.step()
        paged = hasattr(eng.kv, "table")
        tables.append(eng.kv.table.copy() if paged else None)
        if paged and side.port:
            check_pool_invariants(eng.kv)
    reqs = [eng.submit(_spec_gen(side, s)) for s in low]
    for _ in range(3):
        step()
    reqs += [eng.submit(_spec_gen(side, s)) for s in high]
    while not eng.idle and len(tables) < 5000:
        step()
    assert all(r.finished for r in reqs)
    return reqs, eng, tables


@pytest.fixture(scope="module")
def solo_refs(models):
    """Each canonical request served alone, one after another on a port
    slot engine: tokens are a function of (prompt, params, seed) only, so
    every configuration's outputs must equal these."""
    port = Side(True, models)
    eng = port.engine(**CANONICAL_ENGINE)
    low, high = canonical_requests()
    return [eng.generate(_spec_gen(port, s)).tokens for s in low + high]


STAT_FIELDS = ("total_tokens", "total_requests", "preemptions",
               "sealed_bytes", "dropped_requests", "aborted_requests",
               "deadline_misses", "shared_pages", "cow_copies")
CHANNEL_FIELDS = ("messages_in", "messages_out", "bytes_in", "bytes_out",
                  "tokens_out", "seal_events", "seal_bytes", "restore_events",
                  "restore_bytes")


def assert_same_run(j, t):
    """Two _canonical results agree in tokens, finish reasons, ServeStats,
    ChannelStats, the audit log and every step's page table."""
    (jreqs, jeng, jtables), (treqs, teng, ttables) = j, t
    assert [list(r.output) for r in treqs] == [list(r.output) for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    assert [r.n_preemptions for r in treqs] == \
        [r.n_preemptions for r in jreqs]
    assert [r.seed for r in treqs] == [r.seed for r in jreqs]
    tstats, jstats = teng.run(), jeng.run()
    assert tstats.preemptions > 0
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


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_sampled_canonical_scenario_identical(models, solo_refs, config):
    kw = CONFIGS[config]
    port, ref = Side(True, models), Side(False, models)
    t = _canonical(port, **kw)
    assert_same_run(_canonical(ref, **kw), t)
    assert [list(r.output) for r in t[0]] == solo_refs


def _seeded_reproducible(s):
    sp = dict(temperature=0.8, top_k=8, seed=123)
    outs = [s.engine().generate(s.gen(params=sp, max_new_tokens=8)).tokens
            for _ in range(2)]
    assert outs[0] == outs[1] and len(outs[0]) == 8
    return outs[0]


def _different_seeds_diverge(s):
    eng = s.engine()
    outs = [eng.generate(s.gen(params=dict(temperature=5.0, seed=sd),
                               max_new_tokens=10)).tokens
            for sd in (1, 2, 3)]
    assert len({tuple(o) for o in outs}) > 1
    return outs


def _preempted(s, sp, steps=3):
    """A seeded request forced through a seal/restore preemption, beside
    its solo run."""
    eng = s.engine(max_slots=1)
    ref = eng.generate(s.gen(params=sp, max_new_tokens=10)).tokens
    low = eng.submit(s.gen(params=sp, max_new_tokens=10))
    for _ in range(steps):
        eng.step()
    eng.submit(s.gen(np.full(8, 7, np.int32), max_new_tokens=3, priority=9))
    eng.run()
    assert low.n_preemptions == 1
    assert low.output == ref
    return ref


def _seeded_across_preemption(s):
    return _preempted(s, dict(temperature=0.9, top_k=16, seed=42))


def _penalized_across_preemption(s):
    return _preempted(s, dict(temperature=1.2, top_k=16, seed=21,
                              repetition_penalty=2.0, presence_penalty=1.0),
                      steps=4)


def _biased_across_preemption(s):
    return _preempted(s, dict(temperature=1.2, top_k=16, seed=21,
                              logit_bias={5: 6.0, 9: -4.0}), steps=4)


def _penalties_change_output(s):
    eng = s.engine()
    free = eng.generate(s.gen(params=dict(temperature=1.5, seed=4),
                              max_new_tokens=12)).tokens
    pen = eng.generate(s.gen(
        params=dict(temperature=1.5, seed=4, presence_penalty=-30.0),
        max_new_tokens=12)).tokens
    assert pen != free and pen[1] == pen[0]
    return free, pen


def _bias_forces_and_bans(s):
    sp = lambda b: dict(temperature=1.2, seed=5, logit_bias=b)
    eng = s.engine()
    forced = eng.generate(s.gen(params=sp({7: 1000.0}),
                                max_new_tokens=6)).tokens
    assert forced == [7] * 6
    banned = eng.generate(s.gen(params=sp({7: -1000.0}),
                                max_new_tokens=8)).tokens
    assert 7 not in banned
    return forced, banned


def _unseeded_gets_recorded_seed(s):
    eng = s.engine()
    out = eng.generate(s.gen(params=dict(temperature=1.0), max_new_tokens=4))
    assert out.seed is not None
    replay = eng.generate(s.gen(
        params=dict(temperature=1.0, seed=out.seed), max_new_tokens=4))
    assert replay.tokens == out.tokens
    return None       # the seed itself is drawn fresh on each side


def _greedy_top_p_and_sampled_coexist(s):
    eng = s.engine()
    ref = eng.generate(s.gen(max_new_tokens=6)).tokens
    greedy_req = eng.submit(s.gen(max_new_tokens=6))
    mate = eng.submit(s.gen(np.full(8, 3, np.int32), max_new_tokens=6,
                            params=dict(temperature=1.5, top_p=0.7, seed=7)))
    eng.run()
    assert greedy_req.output == ref
    return mate.output


REQUEST_API = {
    "test_seeded_request_is_reproducible": _seeded_reproducible,
    "test_different_seeds_diverge": _different_seeds_diverge,
    "test_seeded_output_identical_across_preemption":
        _seeded_across_preemption,
    "test_penalized_output_identical_across_preemption":
        _penalized_across_preemption,
    "test_biased_output_identical_across_preemption":
        _biased_across_preemption,
    "test_penalties_change_output_and_reproduce": _penalties_change_output,
    "test_bias_forces_and_bans_tokens": _bias_forces_and_bans,
    "test_unseeded_sampled_request_gets_recorded_seed":
        _unseeded_gets_recorded_seed,
    "test_top_p_and_greedy_coexist_in_one_batch":
        _greedy_top_p_and_sampled_coexist,
}


@pytest.mark.parametrize("case", sorted(REQUEST_API))
def test_request_api_sampling_cases(models, case):
    """tests/test_request_api.py's sampling cases (same names), each holding
    on the port and giving the reference's tokens."""
    fn = REQUEST_API[case]
    assert fn(Side(True, models)) == fn(Side(False, models))


def test_stream_frames_and_eager_submit(models):
    """tests/test_serving_v2.py's streaming cases on the port: one frame per
    token with the plain tokens, and stream() submitting eagerly."""
    s = Side(True, models)
    sp = dict(temperature=0.9, top_k=16, seed=3)
    plain = s.engine().generate(s.gen(params=sp, max_new_tokens=7)).tokens
    eng = s.engine()
    toks = list(eng.stream(s.gen(params=sp, max_new_tokens=7)))
    assert toks == plain
    assert eng.td.channel.stats.messages_out == len(toks) == 7
    assert len([e for e in eng.td.audit if e.kind == "egress_frame"]) == 7
    eng = s.engine()
    seen = []
    it = eng.stream(s.gen(max_new_tokens=3,
                          on_token=lambda r, t: seen.append(t)))
    assert eng.run().total_requests == 1    # served by run(), not the loop
    assert list(it) == eng.scheduler.finished[0].output == seen
    with pytest.raises(TypeError):
        eng.stream({"prompt": PROMPT})


def test_prompt_budget_is_submit_boundary(models):
    for side in (Side(True, models), Side(False, models)):
        budgets = []
        for buckets, mnt, extra in [((8, 16), 4, {}), ((8, 16), 20, {}),
                                    ((16,), 12, {}), ((16,), 30, {}),
                                    ((8, 16), 16, dict(kv_backend="paged",
                                                       num_pages=4))]:
            eng = side.engine(max_len=32, prefill_buckets=buckets, **extra)
            budget = eng.prompt_budget(mnt)
            budgets.append(budget)
            if budget == 0:
                continue
            eng.submit(side.gen(np.ones(budget, np.int32),
                                max_new_tokens=mnt))
            with pytest.raises(ValueError, match="KV positions"):
                eng.submit(side.gen(np.ones(budget + 1, np.int32),
                                    max_new_tokens=mnt))
        if side.port:
            port_budgets = budgets
    assert port_budgets == budgets
    assert port_budgets[3] == 0 and port_budgets[4] == 32 - 16 + 1
