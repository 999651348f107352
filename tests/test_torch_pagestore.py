"""repro_torch's sealed-page store against repro.runtime.pagestore and the
store tier of repro.runtime.paged: the store's unit cases from
tests/test_pagestore.py driven through both classes (victims, counters,
``describe()``), ``store_restore_savings`` float for float, the canonical
``paged-store`` configuration rerun twice on one engine (tokens, stats,
channel, audit, page tables at every step, store counters), store blobs
crossing both packages, cross-domain misses and a tampered entry failing
before any page moves."""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import (CANONICAL_CONFIGS, CANONICAL_ENGINE, canonical_requests,
                      check_pool_invariants)
import repro.core.overheads as j_over
import repro.core.sealing as j_seal
import repro.runtime.pagestore as j_store
import repro_torch.core.overheads as t_over
import repro_torch.core.sealing as t_seal
import repro_torch.runtime.pagestore as t_store
from repro.roofline.analysis import HBM_BW as J_HBM_BW
from test_torch_sampled_serving import (CHANNEL_FIELDS, STAT_FIELDS,  # noqa
                                        Side, _spec_gen, models)
from test_torch_sealing import to_jax_blob, to_torch_blob

STORE = CANONICAL_CONFIGS["paged-store"]
STORE_FIELDS = ("hits", "misses", "publishes", "republish_noops",
                "evictions", "restored_bytes", "published_bytes",
                "evicted_bytes", "resident_pages")


def _pkg(port: bool):
    """One package's store, sealing and pricing names."""
    st, se = (t_store, t_seal) if port else (j_store, j_seal)
    return types.SimpleNamespace(
        port=port, Store=st.SealedPageStore, Entry=st.StoreEntry,
        cost=st._cost, lru=st._lru, POLICIES=st.POLICIES,
        seal=se.seal_tensor, unseal=se.unseal_tensor, name=se.shared_page_name,
        IntegrityError=se.IntegrityError,
        A=se.SealingKey.generate(b"tenant-a"),
        B=se.SealingKey.generate(b"tenant-b"))


def ck(i: int) -> bytes:
    return bytes([i]) * 16


def blobs_for(s, key, content_key, fill=1.0):
    data = np.full((4, 8), fill, np.float32)
    return {kp: s.seal(key, s.name(content_key, kp), data)
            for kp in ("/l0/k", "/l0/v")}


def counters(store):
    return {f: getattr(store, f) for f in STORE_FIELDS} | {
        "describe": store.describe()}


def _roundtrip(s):
    store = s.Store()
    blobs = blobs_for(s, s.A, ck(1), fill=3.0)
    assert store.publish(s.A, ck(1), blobs, tokens=8) == []
    got = store.lookup(s.A, ck(1))
    assert got is blobs
    plain = [np.asarray(s.unseal(s.A, st)).tolist() for st in got.values()]
    return store.contains(s.A, ck(1)), plain, counters(store)


def _miss(s):
    store = s.Store()
    return store.lookup(s.A, ck(9)), counters(store)


def _republish(s):
    store = s.Store()
    blobs = blobs_for(s, s.A, ck(1))
    store.publish(s.A, ck(1), blobs, tokens=8)
    again = blobs_for(s, s.A, ck(1))
    evicted = store.publish(s.A, ck(1), again, tokens=8)
    assert store.lookup(s.A, ck(1)) is blobs
    return evicted, [b.mac for b in again.values()], counters(store)


def _bad_arguments(s):
    out = []
    for kw in (dict(policy="fifo"), dict(budget_pages=-1)):
        with pytest.raises(ValueError) as e:
            s.Store(**kw)
        out.append(str(e.value))
    return out, sorted(s.POLICIES)


def _lru_eviction(s):
    store = s.Store(budget_pages=2, policy="lru")
    for i in (1, 2):
        store.publish(s.A, ck(i), blobs_for(s, s.A, ck(i)), tokens=8)
    store.lookup(s.A, ck(1))
    evicted = store.publish(s.A, ck(3), blobs_for(s, s.A, ck(3)), tokens=8)
    return ([e.content_key for e in evicted],
            [store.contains(s.A, ck(i)) for i in (1, 2, 3)], counters(store))


def _cost_sheds_cheap(s):
    store = s.Store(budget_pages=2, policy="cost")
    store.publish(s.A, ck(1), blobs_for(s, s.A, ck(1)), tokens=64)
    store.publish(s.A, ck(2), blobs_for(s, s.A, ck(2)), tokens=0)
    evicted = store.publish(s.A, ck(3), blobs_for(s, s.A, ck(3)), tokens=64)
    return [e.content_key for e in evicted], counters(store)


def _cost_chooser(s):
    hot = s.Entry(ck(1), "d", {}, 1024, 8, hits=9, stamp=1, net_saving_s=1e-4)
    cold = s.Entry(ck(2), "d", {}, 1024, 64, hits=0, stamp=2,
                   net_saving_s=5e-4)
    fresh = s.Entry(ck(3), "d", {}, 1024, 64, hits=0, stamp=3,
                    net_saving_s=5e-4)
    return [e.content_key for e in (s.cost([hot, cold]), s.lru([hot, cold]),
                                    s.cost([cold, fresh]))]


def _positive_saving(s):
    store = s.Store(policy="cost", profile="tdx")
    store.publish(s.A, ck(1), blobs_for(s, s.A, ck(1)), tokens=64)
    entry = next(iter(store._domains[s.A.key_id()].values()))
    # the port prices device memory at the H100's rate, so the saving's
    # value differs from the reference's; its sign is the policy's verdict
    return entry.net_saving_s > 0, entry.n_bytes, entry.tokens


def _domain_isolation(s):
    store = s.Store()
    store.publish(s.A, ck(1), blobs_for(s, s.A, ck(1)), tokens=8)
    miss = (store.contains(s.B, ck(1)), store.lookup(s.B, ck(1)))
    blob = next(iter(store.lookup(s.A, ck(1)).values()))
    with pytest.raises(s.IntegrityError):
        s.unseal(s.B, blob)
    return miss, counters(store)


def _budget_spans_domains(s):
    store = s.Store(budget_pages=2)
    store.publish(s.A, ck(1), blobs_for(s, s.A, ck(1)), tokens=8)
    store.publish(s.B, ck(1), blobs_for(s, s.B, ck(1)), tokens=8)
    count = store.resident_count(s.A, [ck(1), ck(2)])
    evicted = store.publish(s.A, ck(2), blobs_for(s, s.A, ck(2)), tokens=8)
    return count, [(e.domain == s.B.key_id(), e.content_key)
                   for e in evicted], counters(store)


STORE_CASES = {
    "test_publish_contains_lookup_roundtrip": _roundtrip,
    "test_lookup_miss_counts_and_returns_none": _miss,
    "test_republish_is_a_membership_noop": _republish,
    "test_rejects_unknown_policy_and_negative_budget": _bad_arguments,
    "test_lru_evicts_least_recently_touched": _lru_eviction,
    "test_cost_policy_sheds_cheap_to_recompute_first": _cost_sheds_cheap,
    "test_cost_chooser_weights_observed_hits": _cost_chooser,
    "test_publish_prices_a_positive_saving_for_real_pages": _positive_saving,
    "test_other_domain_is_a_clean_miss_not_a_mac_failure": _domain_isolation,
    "test_budget_spans_domains_but_entries_do_not": _budget_spans_domains,
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_cases_match_reference(case):
    """tests/test_pagestore.py's store cases (same names) on both classes:
    the same victims, counters and ``describe()``."""
    fn = STORE_CASES[case]
    assert fn(_pkg(True)) == fn(_pkg(False))


SAVINGS_ARGS = [
    (0, 0, 0, "tdx", {}),
    (4, 65536, 256, "tdx", {}),
    (4, 65536, 4, "tdx", dict(prefill_token_s=1e-9)),
    (4, 65536, 4096, "tdx", dict(prefill_token_s=1e-3)),
    (6, 6 * 8_388_608, 96, "cgpu", {}),
    (1, 8192, 8, "sgx", dict(prefill_token_s=3e-4)),
]


@pytest.mark.parametrize("args", SAVINGS_ARGS)
def test_store_restore_savings_matches_reference(args, monkeypatch):
    """With the port's memory rate set to the reference's, the port returns
    the reference's floats and line; at the H100's rate only the memory
    terms move."""
    *pos, kw = args
    ref = j_over.store_restore_savings(*pos, **kw)
    h100 = t_over.store_restore_savings(*pos, **kw)
    with monkeypatch.context() as m:
        m.setattr(t_over, "HBM_BYTES_PER_S", J_HBM_BW)
        got = t_over.store_restore_savings(*pos, **kw)
    assert got[2] == ref[2]
    for a, b in zip(got[:2], ref[:2]):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.t_plain_s, a.t_tee_s, a.overhead, a.per_term) == \
                (b.t_plain_s, b.t_tee_s, b.overhead, b.per_term)
    if ref[0] is None:
        assert h100 == (None, None, ref[2])
    else:
        assert h100[0].t_plain_s == pytest.approx(
            ref[0].t_plain_s * J_HBM_BW / t_over.HBM_BYTES_PER_S, rel=1e-12)


def _store_epochs(side, store=None, epochs=2, **kw):
    """The canonical scenario ``epochs`` times on one ``paged-store``
    engine, with every step's page table recorded (and on the port the
    pool invariants checked). Returns (per-epoch requests, engine, tables,
    per-epoch (pages written, store hits))."""
    opts = dict(CANONICAL_ENGINE, **STORE, **kw)
    if store is not None:
        opts["page_store"] = store
    eng = side.engine(**opts)
    low, high = canonical_requests()
    tables, runs, marks = [], [], []

    def step():
        eng.step()
        tables.append(eng.kv.table.copy())
        if side.port:
            check_pool_invariants(eng.kv)
    for _ in range(epochs):
        written, hits = eng.kv.pages_written, eng.kv.store_hits
        reqs = [eng.submit(_spec_gen(side, s)) for s in low]
        for _ in range(3):
            step()
        reqs += [eng.submit(_spec_gen(side, s)) for s in high]
        while not eng.idle and len(tables) < 5000:
            step()
        assert all(r.finished for r in reqs)
        runs.append(reqs)
        marks.append((eng.kv.pages_written - written,
                      eng.kv.store_hits - hits))
    return runs, eng, tables, marks


def test_canonical_store_scenario_rerun_identical(models):
    port, ref = Side(True, models), Side(False, models)
    t = _store_epochs(port)
    j = _store_epochs(ref)
    (truns, teng, ttables, tmarks), (jruns, jeng, jtables, jmarks) = t, j
    for tr, jr in zip(truns, jruns):
        assert [r.output for r in tr] == [r.output for r in jr]
        assert [r.finish_reason for r in tr] == [r.finish_reason for r in jr]
        assert [r.n_preemptions for r in tr] == \
            [r.n_preemptions for r in jr]
    # the warm epoch restores from the store instead of re-prefilling, and
    # its tokens are the cold epoch's
    assert [r.output for r in truns[1]] == [r.output for r in truns[0]]
    assert tmarks == jmarks
    assert tmarks[1][1] > 0 and tmarks[1][0] < tmarks[0][0]
    tstats, jstats = teng.run(), jeng.run()
    for f in STAT_FIELDS + ("store_hits", "store_restored_bytes",
                            "store_evictions"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    for f in CHANNEL_FIELDS + ("store_hits", "store_restored_bytes",
                               "store_evictions"):
        assert getattr(tch, f) == getattr(jch, f), f
    assert ([(e.kind, e.detail) for e in teng.td.audit]
            == [(e.kind, e.detail) for e in jeng.td.audit])
    assert len(ttables) == len(jtables)
    for step, (a, b) in enumerate(zip(ttables, jtables)):
        assert np.array_equal(a, b), f"page table differs after step {step}"
    for f in ("store_hits", "store_restored_pages", "store_restored_bytes",
              "pages_written", "shared_page_maps", "cow_copies"):
        assert getattr(teng.kv, f) == getattr(jeng.kv, f), f
    assert counters(teng.kv.page_store) == counters(jeng.kv.page_store)


def test_store_kernel_decode_equals_gather_decode(models):
    """The port's table-walking decode over store-restored pages gives its
    gather decode's tokens, tables and store traffic."""
    port = Side(True, models)
    gruns, geng, gtables, gmarks = _store_epochs(port)
    kruns, keng, ktables, kmarks = _store_epochs(port, kv_decode="kernel")
    assert keng.kv.decode_mode == "kernel"
    assert [[r.output for r in run] for run in kruns] == \
        [[r.output for r in run] for run in gruns]
    assert kmarks == gmarks and kmarks[1][1] > 0
    assert all(np.array_equal(a, b) for a, b in zip(ktables, gtables))
    assert counters(keng.kv.page_store) == counters(geng.kv.page_store)


def _sharer(side, seed, n=10):
    return side.gen(params=dict(temperature=0.9, top_k=16, seed=seed),
                    max_new_tokens=n)


def _published(side, store=None):
    """One finished sharer on a store engine: its full prompt page is
    published when its last mapping drops. Returns (engine, the entries of
    the engine's domain)."""
    eng = side.engine(kv_backend="paged", page_size=8, prefix_sharing=True,
                      page_store=store if store is not None else True)
    first = eng.submit(_sharer(side, 1))
    eng.run()
    dom = eng.kv.page_store._domains[eng.td.sealing_key.key_id()]
    return eng, first, dom


def test_store_blobs_cross_packages(models):
    """A page published by either package carries the same name and
    header, opens in the other package (MAC and all) to the same bits it
    opens to at home, and holds the other package's KV within f32 rounding
    (the two models' prefill rows differ in the last bits); a store filled
    with the other package's blobs serves a hit with the same tokens."""
    port, ref = Side(True, models), Side(False, models)
    teng, tfirst, tdom = _published(port)
    jeng, jfirst, jdom = _published(ref)
    assert sorted(tdom) == sorted(jdom) and tdom
    tkey, jkey = teng.td.sealing_key, jeng.td.sealing_key
    for ck_ in tdom:
        tb, jb = tdom[ck_].blobs, jdom[ck_].blobs
        assert sorted(tb) == sorted(jb)
        for kp in tb:
            assert tb[kp].header() == (f"{jb[kp].name}|{jb[kp].shape}|"
                                       f"{jb[kp].dtype}|{jb[kp].n_bytes}"
                                       ).encode()
            home_t = t_seal.unseal_tensor(tkey, tb[kp]).numpy()
            home_j = np.asarray(j_seal.unseal_tensor(jkey, jb[kp]))
            assert np.array_equal(
                home_t, np.asarray(j_seal.unseal_tensor(jkey,
                                                        to_jax_blob(tb[kp]))))
            assert np.array_equal(
                home_j, t_seal.unseal_tensor(tkey, to_torch_blob(jb[kp]))
                .numpy())
            np.testing.assert_allclose(home_t, home_j, rtol=1e-5, atol=1e-5)
    # each package's engine hits a store holding the other's blobs
    tstore, jstore = t_store.SealedPageStore(), j_store.SealedPageStore()
    for ck_ in jdom:
        tstore.publish(tkey, ck_, {kp: to_torch_blob(b)
                                   for kp, b in jdom[ck_].blobs.items()},
                       tokens=8)
        jstore.publish(jkey, ck_, {kp: to_jax_blob(b)
                                   for kp, b in tdom[ck_].blobs.items()},
                       tokens=8)
    outs = []
    for side, store in ((port, tstore), (ref, jstore)):
        eng = side.engine(kv_backend="paged", page_size=8,
                          prefix_sharing=True, page_store=store)
        again = eng.submit(_sharer(side, 1))
        eng.run()
        assert eng.kv.store_hits >= 1
        outs.append(again.output)
    assert outs[0] == outs[1] == tfirst.output == jfirst.output


def test_cross_domain_lookup_is_a_clean_miss(models):
    """Two port engines with distinct sealing keys share one store: the
    second one's lookups miss (never a MAC failure), and the first one's
    blobs fail MAC under the second one's key."""
    port = Side(True, models)
    store = t_store.SealedPageStore()
    eng_a, a, dom = _published(port, store)
    td_b = port.TD("tdx", sealing_key=port.Key.generate(b"other"),
                   io_key=port.Key.generate(b"io"), device="cpu")
    eng_b = port.engine(td=td_b, kv_backend="paged", page_size=8,
                        prefix_sharing=True, page_store=store)
    b = eng_b.submit(_sharer(port, 1))
    eng_b.run()
    assert eng_b.kv.store_hits == 0 and store.misses >= 1
    assert b.output == a.output
    blob = next(iter(next(iter(dom.values())).blobs.values()))
    with pytest.raises(t_seal.IntegrityError):
        t_seal.unseal_tensor(td_b.sealing_key, blob)
    check_pool_invariants(eng_a.kv)
    check_pool_invariants(eng_b.kv)


def test_tampered_store_entry_fails_before_any_page_moves(models):
    """One flipped ciphertext bit in a store entry: every consumer's
    admission fails with an integrity error before a page or refcount
    moves, on both packages."""
    for side in (Side(True, models), Side(False, models)):
        store = (t_store if side.port else j_store).SealedPageStore()
        eng, _, dom = _published(side, store)
        blob = next(iter(next(iter(dom.values())).blobs.values()))
        if side.port:
            blob.ciphertext[0, 0] ^= 1
        else:
            ct = np.asarray(blob.ciphertext).copy()
            ct[0, 0] ^= 1
            blob.ciphertext = jnp.asarray(ct)
        err = t_seal.IntegrityError if side.port else j_seal.IntegrityError
        for seed in (5, 6):
            consumer = side.engine(
                td=side.TD("tdx", sealing_key=eng.td.sealing_key,
                           io_key=side.Key.generate(b"io"), **side.dev),
                kv_backend="paged", page_size=8, prefix_sharing=True,
                page_store=store)
            consumer.submit(_sharer(side, seed))
            with pytest.raises(err):
                consumer.run()
            assert consumer.kv.free_physical_pages == consumer.kv.num_pages
            assert consumer.kv.store_hits == 0
            if side.port:
                check_pool_invariants(consumer.kv)
