"""repro_torch's fleet against repro.fleet: the scenarios of
tests/test_fleet.py on the smoke deepseek-7b model, the port's weights
converted 1:1 from the reference's. Tenant key domains and their release
gating, envelopes that open only on the addressed worker, a two-worker
fleet equal to the solo runs, a kill mid-decode equal to the reference's
kill run (tokens, FleetStats, channel_totals() and the audit's migrate
lines), a kill on the sharing backend (detached seals), drain and respawn,
the worker state machine, a cross-tenant restore failing MAC without a
leak in both packages, a tenant budget, a migrant's deadline abort on the
survivor, migrants crossing the packages both ways, and the launcher's
fleet report lines."""

import contextlib
import dataclasses
import io
import re
import sys

import jax
import numpy as np
import pytest
import torch

import repro.fleet as jfleet
import repro_torch.fleet as tfleet
from conftest import check_pool_invariants
from repro.configs import smoke_config
from repro.core import attestation as jatt
from repro.core.sealing import IntegrityError as JIntegrityError
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.runtime import api as japi
from repro.runtime import engine as jengine
from repro.runtime import scheduler as jsched
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import SealingKey as TKey
from repro_torch.core import TrustDomain as TTD
from repro_torch.core import attestation as tatt
from repro_torch.core.sealing import IntegrityError as TIntegrityError
from repro_torch.core.sealing import seal_tensor, unseal_tensor
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import api as tapi
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import scheduler as tsched
from test_fleet import ENGINE_KW, fleet_specs
from test_torch_sealing import to_jax_blob, to_torch_blob

SHARE_KW = dict(max_slots=2, max_len=96, prefill_buckets=(32,),
                kv_backend="paged", page_size=8, prefix_sharing=True)
SOLO_KW = dict(max_slots=1, max_len=64, prefill_buckets=(4, 8))
MASTER = b"fleet-master-secret-0123456789ab"


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config("deepseek-7b")
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.key(0))
    tm = tbuild(tsmoke("deepseek-7b"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


class Pkg:
    """One package's fleet: workers, gateway, orchestrator, requests."""

    def __init__(self, port, models):
        jm, jp, tm, tp = models
        self.port = port
        self.model, self.params = (tm, tp) if port else (jm, jp)
        self.fleet = tfleet if port else jfleet
        self.api = tapi if port else japi
        self.eng = tengine if port else jengine
        self.dev = {"device": "cpu"} if port else {}
        self.IntegrityError = TIntegrityError if port else JIntegrityError

    def gen(self, prompt, mnt=6, seed=1, tenant=None, **kw):
        return self.api.GenerationRequest(
            prompt=np.asarray(prompt, np.int32), max_new_tokens=mnt,
            params=self.api.SamplingParams(temperature=0.9, top_k=16,
                                           seed=seed),
            tenant=tenant, **kw)

    def requests(self, specs=None):
        return [self.gen(p.copy(), mnt, seed, tenant)
                for p, mnt, seed, tenant in (specs or fleet_specs())]

    def worker(self, name, kw=ENGINE_KW):
        return self.fleet.EngineWorker(name, self.model, self.params,
                                       engine_kw=dict(kw, **self.dev))

    def engine(self, **kw):
        return self.eng.Engine(self.model, self.params, **kw, **self.dev)

    def make_fleet(self, n=2, tenants=("a", "b"), kw=ENGINE_KW,
                   master=None, **orch_kw):
        workers = [self.worker(f"w{i}", kw) for i in range(n)]
        gateway = self.fleet.Gateway(master_secret=master, config_repr="test")
        for t in tenants:
            gateway.register_tenant(t)
        return gateway, self.fleet.Orchestrator(gateway, workers, **orch_kw), \
            workers


def assert_no_leaks(eng):
    assert eng.slots.num_active == 0
    assert eng.kv.free_physical_pages == eng.kv.num_pages
    check_pool_invariants(eng.kv)


def _solo(pkg, specs, **kw):
    out = []
    for p, mnt, seed, _ in specs:
        eng = pkg.engine(**dict(SOLO_KW, **kw))
        out.append(list(eng.generate(pkg.gen(p.copy(), mnt, seed)).tokens))
    return out


@pytest.fixture(scope="module")
def solo(models):
    """Each fleet request alone on an uncontended one-slot port engine."""
    return _solo(Pkg(True, models), fleet_specs())


# -- key domains and the gateway ---------------------------------------------

def test_tenant_domains_derive_and_gate_like_reference():
    k = TKey.generate(b"m" * 32)
    a1, a2, b = k.derive("tenant/a"), k.derive("tenant/a"), k.derive("tenant/b")
    assert (a1.key, a1.mac_key) == (a2.key, a2.mac_key)
    assert a1.key != b.key and a1.mac_key != b.mac_key and a1.key != k.key
    blob = seal_tensor(a1, "kv/x", np.arange(8, dtype=np.float32))
    with pytest.raises(TIntegrityError):
        unseal_tensor(b, blob)
    assert torch.equal(unseal_tensor(a2, blob),
                       torch.arange(8, dtype=torch.float32))
    # two enclaves, one master: each quote-gated release lands on the same
    # per-tenant material, the reference's bytes
    got = []
    for _ in range(2):
        td = TTD("tdx", device="cpu")
        v = td.make_verifier("cfg")
        got.append(v.release_tenant_key(td.quote(v.challenge(), "cfg"),
                                        MASTER, "a"))
    assert got[0] == got[1] == tatt.derive_tenant_material(MASTER, "a") == \
        jatt.derive_tenant_material(MASTER, "a")
    assert tatt.derive_tenant_material(MASTER, "b") != got[0]
    td = TTD("tdx", device="cpu")
    bad = tatt.Verifier(td.root, "0" * 64)
    with pytest.raises(tatt.AttestationError):
        bad.release_tenant_key(td.quote(bad.challenge(), "cfg"), MASTER, "a")
    v = td.make_verifier("cfg")
    q = td.quote(v.challenge(), "cfg")
    v.release_tenant_key(q, MASTER, "a")
    with pytest.raises(tatt.AttestationError):          # replayed quote
        v.release_tenant_key(q, MASTER, "a")


def test_gateway_admission_releases_the_reference_keys(models):
    port, ref = Pkg(True, models), Pkg(False, models)
    tg, _, (w0, w1) = port.make_fleet(master=MASTER)
    jg, _, (j0, _) = ref.make_fleet(master=MASTER)
    assert w0.state == w1.state == tfleet.READY
    # 3 tenants (a, b and the orchestrator's default) x 2 workers, each on
    # its own fresh quote
    assert dataclasses.asdict(tg.stats) == dataclasses.asdict(jg.stats)
    assert tg.stats.keys_released == 6 and tg.stats.attested_workers == 2
    for t in ("a", "b", "default"):
        assert w0.tenant_keys[t] == w1.tenant_keys[t]
        assert w0.tenant_keys[t].key == j0.tenant_keys[t].key
        assert w0.tenant_keys[t].mac_key == j0.tenant_keys[t].mac_key
    assert w0.tenant_keys["a"].key != w0.tenant_keys["b"].key
    assert w0.transport.key != w1.transport.key
    assert [e.kind for e in w0.td.audit] == [e.kind for e in j0.td.audit]


def test_bad_measurement_is_rejected_dead(models):
    port = Pkg(True, models)
    w = port.worker("wx")
    gateway = tfleet.Gateway(config_repr="test")
    with pytest.raises(tatt.AttestationError):
        gateway.admit(w, expected_measurement="0" * 64)
    assert w.state == tfleet.DEAD and gateway.stats.rejected_quotes == 1
    assert w.transport is None and not w.tenant_keys
    with pytest.raises(KeyError):               # no transport key released
        gateway.envelope_seal("wx", "a", np.arange(4, dtype=np.int32))


def test_envelope_only_opens_on_the_addressed_worker(models):
    gateway, _, (w0, w1) = Pkg(True, models).make_fleet()
    prompt = np.arange(1, 9, dtype=np.int32)
    env = gateway.envelope_seal("w0", "a", prompt)
    got = w0.open_envelope(env)
    assert got.dtype == np.int32 and np.array_equal(got, prompt)
    with pytest.raises(TIntegrityError):        # addressed to w0, not w1
        w1.open_envelope(env)
    env2 = gateway.envelope_seal("w0", "a", prompt)
    assert env2.eid == env.eid + 1
    flipped = env2.sealed_prompt.ciphertext.clone()
    flipped.view(-1)[0] ^= 1                    # in-transit tamper
    env2.sealed_prompt.ciphertext = flipped
    with pytest.raises(TIntegrityError):
        w0.open_envelope(env2)
    with pytest.raises(KeyError):
        gateway.envelope_seal("w0", "nobody", prompt)


# -- serving ------------------------------------------------------------------

def test_two_worker_fleet_matches_solo(models, solo):
    _, orch, workers = Pkg(True, models).make_fleet()
    handles = [orch.submit(g) for g in Pkg(True, models).requests()]
    orch.run()
    assert [list(h.output) for h in handles] == solo
    for w in workers:
        assert_no_leaks(w.engine)
    assert orch.stats.migrations == 0


def _kill_run(pkg, specs=None, kw=ENGINE_KW, steps=3, **orch_kw):
    """The fleet serves ``specs``; after ``steps`` fleet steps the busiest
    worker is killed and the fleet runs to the end."""
    _, orch, workers = pkg.make_fleet(kw=kw, **orch_kw)
    handles = [orch.submit(g) for g in pkg.requests(specs)]
    for _ in range(steps):
        orch.step()
    victim = max(orch.ready_workers(), key=lambda w: w.load())
    survivor = next(w for w in workers if w is not victim)
    assert any(not h.finished for h in handles)
    restores0 = survivor.td.channel.stats.restore_events
    orch.kill(victim.name)
    assert victim.state == pkg.fleet.DEAD
    stats = orch.run()
    assert survivor.td.channel.stats.restore_events > restores0
    return handles, orch, workers, stats


def _migrate_lines(workers):
    return [(w.name, e.kind, e.detail) for w in workers for e in w.td.audit
            if e.kind.startswith("migrate")]


def _assert_same_fleet_run(t, j):
    (th, torch_orch, tw, tstats), (jh, jorch, jw, jstats) = t, j
    assert [list(h.output) for h in th] == [list(h.output) for h in jh]
    assert dataclasses.asdict(torch_orch.stats) == \
        dataclasses.asdict(jorch.stats)
    assert torch_orch.channel_totals() == jorch.channel_totals()
    assert _migrate_lines(tw) == _migrate_lines(jw)
    for f in ("total_requests", "total_tokens", "migrations",
              "migrated_bytes", "preemptions", "sealed_bytes"):
        assert getattr(tstats, f) == getattr(jstats, f), f


def test_kill_mid_decode_matches_reference_kill_run(models, solo):
    """The acceptance scenario: a worker fails mid-decode; every in-flight
    request still completes on the survivor with its solo tokens, priced in
    FleetStats and the survivor's ChannelStats exactly as the reference
    prices it."""
    t = _kill_run(Pkg(True, models))
    j = _kill_run(Pkg(False, models))
    _assert_same_fleet_run(t, j)
    handles, orch, workers, stats = t
    assert [list(h.output) for h in handles] == solo
    assert orch.stats.migrations > 0 and orch.stats.migrated_bytes > 0
    assert stats.migrations == orch.stats.migrations
    assert stats.migrated_bytes == orch.stats.migrated_bytes
    assert sum(h.n_migrations for h in handles) == orch.stats.migrations
    assert any(kind == "migrate_in" for _, kind, _ in _migrate_lines(workers))
    for w in workers:
        assert_no_leaks(w.engine)


def test_kill_on_sharing_backend_seals_detached(models):
    """A migrant off a prefix-sharing pool is sealed by value: no
    by-reference entry (``/sharedkeys``) crosses, the survivor restores the
    copies as private pages, tokens equal the solo runs and the reference's
    kill run, and neither pool leaks."""
    rng = np.random.default_rng(5)
    head = rng.integers(1, 100, 24).astype(np.int32)
    specs = [(np.concatenate([head, rng.integers(1, 100, 8).astype(np.int32)]),
              6, 70 + i, "ab"[i % 2]) for i in range(4)]
    port = Pkg(True, models)
    seen = []
    real = tengine.Engine.import_sealed_state

    def spy(self, migrants, queued=()):
        seen.extend(migrants)
        return real(self, migrants, queued)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine.Engine, "import_sealed_state", spy)
        t = _kill_run(port, specs, kw=SHARE_KW, placement="tenant_affinity")
    j = _kill_run(Pkg(False, models), specs, kw=SHARE_KW,
                  placement="tenant_affinity")
    _assert_same_fleet_run(t, j)
    handles, orch, workers, _ = t
    assert seen and orch.stats.migrations == len(seen)
    assert not any(n.endswith("/sharedkeys") for p in seen for n in p.sealed)
    assert sum(w.engine.kv.shared_page_maps for w in workers) > 0
    solo = _solo(port, specs, max_len=96, prefill_buckets=(32,))
    assert [list(h.output) for h in handles] == solo
    for w in workers:
        assert_no_leaks(w.engine)


def test_drain_then_respawn(models, solo):
    port = Pkg(True, models)
    _, orch, workers = port.make_fleet(
        worker_factory=lambda name: port.worker(name))
    handles = [orch.submit(g) for g in port.requests()]
    for _ in range(2):
        orch.step()
    orch.drain("w0")
    assert workers[0].state == tfleet.DEAD and orch.stats.drains == 1
    with pytest.raises(RuntimeError, match="draining"):
        workers[0].engine.submit(port.gen(np.arange(1, 5)))
    orch.run()
    assert [list(h.output) for h in handles] == solo
    spawned = orch.respawn("w0")                # a new enclave, attested
    assert spawned is not workers[0] and spawned.state == tfleet.READY
    assert spawned.tenant_keys["a"] == workers[1].tenant_keys["a"]
    assert spawned.engine.model is workers[1].engine.model
    h = orch.submit(port.gen(np.arange(1, 6, dtype=np.int32), tenant="a"))
    orch.run()
    assert h.finished and orch.stats.respawns == 1
    for w in (spawned, workers[1]):
        assert_no_leaks(w.engine)


def test_worker_state_machine(models):
    port = Pkg(True, models)
    w = port.worker("w9")
    assert w.state == tfleet.ATTESTING
    assert tfleet.WORKER_STATES == jfleet.WORKER_STATES
    gateway = tfleet.Gateway(config_repr="test")
    gateway.admit(w)
    assert w.state == tfleet.READY
    orch = tfleet.Orchestrator(gateway, [w])
    with pytest.raises(ValueError, match="already live"):
        orch.add_worker(port.worker("w9"))      # the name keys the nonces
    with pytest.raises(ValueError, match="placement"):
        tfleet.Orchestrator(gateway, [], placement="random")
    orch.kill("w9")
    assert w.state == tfleet.DEAD
    orch.add_worker(port.worker("w9"))          # a dead name may return
    assert sorted(tfleet.PLACEMENTS) == sorted(jfleet.orchestrator.PLACEMENTS)


def _respawn_seal_names(pkg):
    """Kill w0 mid-decode, respawn the name, put new work on it and drain
    it: the sealed names of both exports, as ``{(key_id, name):
    ciphertext bytes}`` per export."""
    exports = []
    real = pkg.fleet.EngineWorker.export_state

    def spy(self):
        migrants, queued = real(self)
        exports.append({(p.key.key_id(), st.name):
                        np.asarray(st.ciphertext).tobytes()
                        for p in migrants for st in p.sealed.values()})
        return migrants, queued
    _, orch, _ = pkg.make_fleet(master=MASTER,
                                worker_factory=lambda name: pkg.worker(name))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pkg.fleet.EngineWorker, "export_state", spy)
        for g in pkg.requests():
            orch.submit(g)
        for _ in range(3):
            orch.step()
        orch.kill("w0")
        orch.respawn("w0")
        for g in pkg.requests():
            orch.submit(g)
        for _ in range(3):
            orch.step()
        orch.drain("w0")
        orch.run()
    assert len(exports) == 2
    return exports


def test_respawned_name_repeats_migration_nonces_as_the_reference_does(
        models):
    """A fault of the reference, kept by the port (ROADMAP.md queue C):
    a respawned worker is a fresh enclave whose stream ids start over, the
    tenant keys are the same on every worker, and the nonce is
    sha256(key_id | name), so the respawned w0's drain seals other
    plaintexts under names, and so ChaCha20 keystreams, that the dead
    w0's kill export already used. The port gives the same colliding names
    as the reference."""
    names = []
    for port in (True, False):
        killed, drained = _respawn_seal_names(Pkg(port, models))
        shared = sorted(set(killed) & set(drained))
        assert shared, "no sealed name repeats across the respawn"
        assert all(n.startswith("kvmigrate/w0/") for _, n in shared)
        assert any(killed[k] != drained[k] for k in shared), \
            "a repeated name seals other plaintext under one keystream"
        names.append(shared)
    assert names[0] == names[1]


def _store_routes(pkg):
    """Two prompts served at once (the second goes to the less loaded
    worker), then each again, second first: store-affinity placement sends
    each back to the worker whose content index and store hold its pages,
    where least-loaded would break the tie by name."""
    _, orch, workers = pkg.make_fleet(kw=dict(SHARE_KW, page_store=True),
                                      placement="store_affinity")
    rng = np.random.default_rng(9)
    p1, p2 = (rng.integers(1, 100, 32).astype(np.int32) for _ in range(2))
    routes = []

    def submit(prompt, seed):
        h = orch.submit(pkg.gen(prompt.copy(), seed=seed, tenant="a"))
        routes.append(next(w.name for w in workers
                           if any(r is h for _, _, r in
                                  w.engine.scheduler.queue)))
    submit(p1, 1)
    submit(p2, 2)
    orch.run()
    submit(p2, 3)
    orch.run()
    submit(p1, 4)
    orch.run()
    return routes


def test_store_affinity_routes_like_reference(models):
    routes = _store_routes(Pkg(True, models))
    assert routes == _store_routes(Pkg(False, models)) == \
        ["w0", "w1", "w1", "w0"]


@pytest.mark.parametrize("port", [True, False], ids=["port", "reference"])
def test_cross_tenant_restore_fails_mac_without_leaking(models, solo, port):
    """Tenant a's migrated KV presented under tenant b's domain fails MAC
    (isolation by key derivation, in both packages), the failed restore
    leaves the destination pool untouched, and the same blob then restores
    under the right domain and finishes with its solo tokens."""
    pkg = Pkg(port, models)
    _, _, (w0, w1) = pkg.make_fleet()
    p, mnt, seed, _ = fleet_specs()[0]
    req = w0.engine.submit(pkg.gen(p.copy(), mnt, seed, tenant="a"))
    for _ in range(2):
        w0.engine.step()
    assert req.output and not req.finished
    migrants, _ = w0.export_state()
    assert len(migrants) == 1
    blob = migrants[0]
    assert blob.prefix.startswith("kvmigrate/w0/")
    with pytest.raises(pkg.IntegrityError):
        w1.engine.restore_slot(blob.sealed, blob.req,
                               key=w1.tenant_keys["b"], prefix=blob.prefix)
    assert_no_leaks(w1.engine)
    w1.engine.import_sealed_state([blob])
    w1.engine.run()
    assert req.finished and list(req.output) == solo[0]
    assert_no_leaks(w1.engine)


def test_tenant_budget_holds_then_serves(models):
    """5 tokens/s (a burst of 5): the first 6-token request overdraws the
    bucket to -1, so the second waits about 1.2 s at the gateway, a window
    no loaded test host closes between two submits."""
    port = Pkg(True, models)
    _, orch, _ = port.make_fleet(n=1, tenant_budgets={"a": 5.0})
    h1 = orch.submit(port.gen(np.arange(1, 5), mnt=6, seed=1, tenant="a"))
    h2 = orch.submit(port.gen(np.arange(1, 5), mnt=6, seed=2, tenant="a"))
    assert h1 is not None and h2 is None
    assert orch.stats.held_budget == 1
    orch.run()
    handles = list(orch.handles.values())
    assert len(handles) == 2 and all(h.finished for h in handles)
    with pytest.raises(KeyError, match="unknown tenant"):
        orch.submit(port.gen(np.arange(1, 5), tenant="nobody"))


def _deadline_abort(pkg):
    """w1 holds two long requests in its two slots; a migrant from w0 (on
    tenant a, on_deadline="abort") waits in w1's restore queue, its
    deadline passes there, and the next step discards it unrestored.
    Returns (the migrant, w1's other requests, w1's engine, the key and
    prefix each discard_sealed call got, the migrant's own key/prefix)."""
    _, _, (w0, w1) = pkg.make_fleet()
    busy = [w1.engine.submit(pkg.gen(np.full(6, 3 + i, np.int32), mnt=12,
                                     seed=80 + i, tenant="b"))
            for i in range(2)]
    for _ in range(2):
        w1.engine.step()
    p, mnt, seed, _ = fleet_specs()[0]
    req = w0.engine.submit(pkg.gen(p.copy(), mnt, seed, tenant="a",
                                   deadline_s=1e6, on_deadline="abort"))
    for _ in range(2):
        w0.engine.step()
    migrants, _ = w0.export_state()
    w1.engine.import_sealed_state(migrants)
    calls = []
    real = w1.engine.kv.discard_sealed

    def spy(key, sealed, prefix):
        calls.append((key.key, prefix))
        return real(key, sealed, prefix)
    w1.engine.kv.discard_sealed = spy
    req.gen.deadline_s = 1e-9               # expires while it waits on w1
    w1.engine.run()
    m = migrants[0]
    return req, busy, w1.engine, calls, (m.key.key, m.prefix)


def test_migrant_deadline_abort_discards_under_its_key(models):
    t = _deadline_abort(Pkg(True, models))
    j = _deadline_abort(Pkg(False, models))
    (treq, tbusy, teng, tcalls, tmine), (jreq, jbusy, jeng, jcalls, jmine) = \
        t, j
    assert treq.finish_reason == jreq.finish_reason == "aborted"
    assert list(treq.output) == list(jreq.output) and treq.output
    assert [list(r.output) for r in tbusy] == [list(r.output) for r in jbusy]
    # the migrant's blob is discarded under its tenant key and kvmigrate/
    # prefix, not the survivor's own key and kvslot/ space
    assert tcalls == [tmine] and tmine[1].startswith("kvmigrate/w0/")
    assert [p for _, p in jcalls] == [tmine[1]]
    tstats, jstats = teng.run(), jeng.run()
    for f in ("aborted_requests", "deadline_misses", "total_tokens",
              "migrations", "migrated_bytes"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert [(e.kind, e.detail) for e in teng.td.audit
            if e.kind in ("abort_deadline", "migrate_in")] == \
        [(e.kind, e.detail) for e in jeng.td.audit
         if e.kind in ("abort_deadline", "migrate_in")]
    assert_no_leaks(teng)


# -- migrants crossing the packages --------------------------------------------

def _cross(obj, api, sched):
    """A request (and its GenerationRequest) rebuilt in the other package,
    field for field."""
    g = obj.gen
    gen = api.GenerationRequest(**{
        f.name: getattr(g, f.name) for f in dataclasses.fields(g)})
    gen.params = api.SamplingParams(**dataclasses.asdict(g.params))
    gen.frame = api.FramePolicy(**dataclasses.asdict(g.frame))
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
              if f.name != "gen"}
    return sched.Request(gen=gen, **fields)


@pytest.mark.parametrize("to_port", [True, False],
                         ids=["reference-to-port", "port-to-reference"])
def test_migrant_crosses_packages(models, solo, to_port):
    """With both gateways on one master secret, a migrant one package's
    worker exports imports into the other's and finishes with the
    reference's tokens (each request's solo run)."""
    src, dst = Pkg(not to_port, models), Pkg(to_port, models)
    _, _, (a0, _) = src.make_fleet(master=MASTER)
    _, _, (_, b1) = dst.make_fleet(master=MASTER)
    p, mnt, seed, _ = fleet_specs()[1]
    req = a0.engine.submit(src.gen(p.copy(), mnt, seed, tenant="b"))
    for _ in range(2):
        a0.engine.step()
    (m,), _ = a0.export_state()
    key = b1.tenant_keys["b"]
    assert (key.key, key.mac_key) == (m.key.key, m.key.mac_key)
    blob = to_torch_blob if to_port else to_jax_blob
    moved = dst.eng.PreemptedRequest(
        {n: blob(st) for n, st in m.sealed.items()},
        _cross(m.req, dst.api, tsched if to_port else jsched),
        key=key, prefix=m.prefix)
    b1.engine.import_sealed_state([moved])
    b1.engine.run()
    assert moved.req.finished and moved.req.output[:len(req.output)] == \
        list(req.output)
    assert list(moved.req.output) == solo[1]
    assert moved.req.n_migrations == 1
    assert_no_leaks(b1.engine)


# -- the launcher ---------------------------------------------------------------

def _report(main, argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue().splitlines()


def test_launcher_fleet_mode_prints_reference_lines(monkeypatch):
    argv = ["--arch", "deepseek-7b", "--smoke", "--requests", "6",
            "--max-new-tokens", "6", "--slots", "2", "--workers", "2",
            "--tenants", "2", "--kill-worker-at", "3", "--kv-backend",
            "paged", "--page-size", "8", "--sample-temp", "0.9", "--top-k",
            "16", "--seed", "5"]
    jlines = _report(jserve.main, argv, monkeypatch)
    tlines = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    label = re.compile(r"^[^0-9(]*")
    assert [label.match(l).group(0) for l in tlines] == \
        [label.match(l).group(0) for l in jlines]
    for prefix in ("[fleet] killed", "fleet:", "migration:",
                   "fleet boundary:"):
        want = [l for l in jlines if l.startswith(prefix)]
        assert want and [l for l in tlines if l.startswith(prefix)] == want
    assert [l.split(" in ")[0] for l in tlines if l.startswith("served")] == \
        ["served 6 requests / 36 tokens"]
