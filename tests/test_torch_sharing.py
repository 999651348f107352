"""repro_torch's prefix sharing, on-demand pages and copy-on-write against
repro.runtime.paged: the canonical ``paged-sharing`` configuration under
gather and kernel decode (tokens, page tables at every step, the audit log
and the sharing counters, with the pool invariants after every port step),
the reference's sharing cases from tests/test_paged_kv.py and
tests/test_differential.py, and sealed state with shared pages (meta v2 and
``/sharedkeys``) crossing both packages."""

import numpy as np
import pytest

from conftest import CANONICAL_CONFIGS, check_pool_invariants
from repro.core.sealing import IntegrityError as JIntegrityError
from repro.core.sealing import unseal_tensor as j_unseal
from repro.runtime.paged import prefix_page_keys as j_keys
from repro_torch.core.sealing import IntegrityError as TIntegrityError
from repro_torch.core.sealing import unseal_tensor as t_unseal
from repro_torch.runtime.paged import prefix_page_keys as t_keys
from test_torch_sampled_serving import (PROMPT, Side, _canonical,  # noqa
                                        assert_same_run, models, solo_refs)
from test_torch_sealing import to_jax_blob, to_torch_blob

SHARING = CANONICAL_CONFIGS["paged-sharing"]


@pytest.mark.parametrize("kv_decode", ["gather", "kernel"])
def test_canonical_sharing_scenario_identical(models, solo_refs,
                                              kv_decode):
    kw = dict(SHARING, kv_decode=kv_decode)
    port, ref = Side(True, models), Side(False, models)
    t, j = _canonical(port, **kw), _canonical(ref, **kw)
    assert_same_run(j, t)
    tkv, jkv = t[1].kv, j[1].kv
    assert tkv.decode_mode == kv_decode and tkv.on_demand
    for f in ("shared_page_maps", "cow_copies", "pages_written",
              "fused_restore_pages"):
        assert getattr(tkv, f) == getattr(jkv, f), f
    assert tkv.shared_page_maps > 0 and tkv.cow_copies > 0
    assert [list(r.output) for r in t[0]] == solo_refs


def test_prefix_page_keys_match_reference():
    rng = np.random.default_rng(0)
    for n, ps, written, salt in [(16, 4, 16, b""), (16, 4, 10, b""),
                                 (128, 16, 128, b"llama2-7b|16|256"),
                                 (96, 16, 90, b"x")]:
        toks = rng.integers(0, 32000, n).astype(np.int32)
        assert t_keys(toks, ps, written, salt) == j_keys(toks, ps, written,
                                                         salt)


def _sharing(s, **kw):
    kw.setdefault("kv_backend", "paged")
    kw.setdefault("page_size", 8)
    kw.setdefault("prefix_sharing", True)
    return s.engine(**kw)


def _share_and_release(s):
    eng = _sharing(s)
    a = eng.submit(s.gen(max_new_tokens=6))
    b = eng.submit(s.gen(max_new_tokens=6))
    eng.step()
    assert eng.kv.shared_page_maps == 1
    phys = [int(eng.kv.table[sl, 0]) for sl in (0, 1)]
    assert phys[0] == phys[1] and eng.kv._page_ref[phys[0]] == 2
    eng.run()
    assert a.output == b.output
    assert eng.kv.free_physical_pages == eng.kv.num_pages
    assert not eng.kv._index and not eng.kv._parked
    return a.output


def _opt_out(s):
    eng = _sharing(s)
    eng.submit(s.gen(max_new_tokens=4, share_prefix=False))
    eng.submit(s.gen(max_new_tokens=4, share_prefix=False))
    eng.run()
    assert eng.kv.shared_page_maps == 0
    r = eng.submit(s.gen(max_new_tokens=4, share_prefix=False))
    eng.step()
    assert not eng.kv._index
    eng.run()
    return r.output


def _resident_prefix(s):
    """Residency lowers the demand admission charges, not the capacity."""
    eng = _sharing(s, max_slots=3, num_pages=4)
    with pytest.raises(ValueError, match="KV positions"):
        eng.submit(s.gen(max_new_tokens=26))
    keepers = [eng.submit(s.gen(max_new_tokens=12)) for _ in range(2)]
    eng.step()
    assert eng.kv.free_physical_pages == 1
    need = eng.effective_kv_need(PROMPT, 4)
    assert need == (11, 3)
    warm = eng.submit(s.gen(max_new_tokens=4))
    cold = eng.submit(s.gen(max_new_tokens=4, share_prefix=False))
    eng.step()
    assert any(r is warm for r in eng.scheduler.running.values())
    assert all(r is not cold for r in eng.scheduler.running.values())
    eng.run(max_steps=2000)
    assert warm.output == cold.output
    return need, warm.kv_need, [r.output for r in keepers + [warm]]


def _shared_head(s):
    p16 = np.arange(1, 17, dtype=np.int32)
    eng = _sharing(s, prefill_buckets=(16,))
    a = eng.submit(s.gen(p16, max_new_tokens=10))
    b = eng.submit(s.gen(p16, max_new_tokens=10))
    for _ in range(3):
        eng.step()
    assert eng.kv.evictable_tail_pages(0) == 1
    with pytest.raises(ValueError, match="shared prefix"):
        eng.kv.seal_tail_pages(eng.td.sealing_key, 0, "kvslot/x/0", 2)
    eng.partial_preempt(0, 1)
    eng.run()
    assert a.output == b.output
    return a.output, [(e.kind, e.detail) for e in eng.td.audit]


def _paused_victim_reclaimed(s):
    """The lone live slot whole-seals a paused victim when it needs the
    pages (tests/test_paged_kv.py), under sampled requests."""
    sp = dict(temperature=0.9, top_k=16, seed=7)
    pa, pb = np.arange(1, 9), np.arange(11, 19)
    eng = _sharing(s, num_pages=4)
    a = eng.submit(s.gen(pa, sp, max_new_tokens=20))
    for _ in range(10):
        eng.step()
    b = eng.submit(s.gen(pb, sp, max_new_tokens=20, priority=5))
    eng.run(max_steps=2000)
    solo = s.engine(max_slots=1)
    refs = [solo.generate(s.gen(p, sp, max_new_tokens=20)).tokens
            for p in (pa, pb)]
    assert [a.output, b.output] == refs
    return refs, [(e.kind, e.detail) for e in eng.td.audit]


def _construction(s):
    with pytest.raises(ValueError, match="paged"):
        s.engine(prefix_sharing=True)
    with pytest.raises(ValueError, match="ondemand"):
        _sharing(s, kv_alloc="reserve")
    with pytest.raises(ValueError, match="alloc"):
        _sharing(s, prefix_sharing=False, kv_alloc="lazy")
    eng = _sharing(s)
    plain = _sharing(s, prefix_sharing=False)
    tiny = _sharing(s, prefix_sharing=False, num_pages=4)
    ondemand = _sharing(s, prefix_sharing=False, kv_alloc="ondemand")
    assert eng.kv.supports_sharing and eng.kv.on_demand
    assert not plain.kv.supports_sharing and not plain.kv.on_demand
    assert ondemand.kv.on_demand and not ondemand.kv.supports_sharing
    return (tiny.kv.request_capacity, tiny.prompt_budget(16),
            plain.prompt_budget(16), eng.prompt_budget(16))


CASES = {
    "test_identical_prompts_share_and_release_cleanly": _share_and_release,
    "test_share_prefix_opt_out_stays_private": _opt_out,
    "test_resident_prefix_relaxes_admission_not_capacity": _resident_prefix,
    "test_shared_head_not_partially_evictable": _shared_head,
    "test_lone_live_slot_reclaims_pages_from_paused_victim":
        _paused_victim_reclaimed,
    "test_construction_flags_and_prompt_budget": _construction,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharing_cases_match_reference(models, case):
    """tests/test_paged_kv.py's TestPrefixSharing cases (same names), each
    holding on the port and giving the reference's results."""
    fn = CASES[case]
    assert fn(Side(True, models)) == fn(Side(False, models))


def _sharer(s, seed, n=10):
    return s.gen(params=dict(temperature=0.9, top_k=16, seed=seed),
                 max_new_tokens=n)


def _seal_both_sharers(s):
    """tests/test_differential.py's helper: two requests sharing their whole
    prompt page, both sealed out; the second seal parks the page."""
    eng = _sharing(s)
    eng.submit(_sharer(s, 1))
    eng.submit(_sharer(s, 2))
    for _ in range(2):
        eng.step()
    sealed_a = eng.seal_slot(0)
    assert not eng.kv._parked
    sealed_b = eng.seal_slot(1)
    (key,) = eng.kv._parked
    assert eng.kv._sealed_refs[key] == 2
    return eng, [sealed_a, sealed_b], key


def test_tampered_sharedkeys_and_parked_page_fail_without_leak(models):
    s = Side(True, models)
    eng, sealed_reqs, key = _seal_both_sharers(s)
    sealed, req = sealed_reqs[0]
    keys_blob = next(st for n, st in sealed.items() if "/sharedkeys" in n)
    good_mac, keys_blob.mac = keys_blob.mac, b"\x00" * 32
    with pytest.raises(TIntegrityError, match="sharedkeys"):
        eng.restore_slot(sealed, req)
    assert eng.slots.num_active == 0
    assert eng.kv.free_physical_pages == eng.kv.num_pages
    check_pool_invariants(eng.kv)
    keys_blob.mac = good_mac
    parked = next(iter(eng.kv._parked[key].values()))
    parked.ciphertext[0, 0] ^= 1
    for sealed, req in sealed_reqs:
        with pytest.raises(TIntegrityError):
            eng.restore_slot(sealed, req)
        assert eng.slots.num_active == 0
        assert eng.kv.free_physical_pages == eng.kv.num_pages
        check_pool_invariants(eng.kv)
    parked.ciphertext[0, 0] ^= 1
    # the untampered state still restores (remat, then re-link) and
    # finishes as each request's solo run
    for sealed, req in sealed_reqs:
        eng.restore_slot(sealed, req)
        check_pool_invariants(eng.kv)
    assert eng.kv.shared_page_maps == 2
    eng.run()
    check_pool_invariants(eng.kv)
    assert not eng.kv._parked and not eng.kv._sealed_refs
    solo = s.engine(max_slots=1)
    for i, (_, req) in enumerate(sealed_reqs):
        assert req.output == solo.generate(_sharer(s, i + 1)).tokens


def test_shared_blobs_cross_packages(models):
    """Sealed state with shared pages crosses both ways: the same names,
    meta v2 and /sharedkeys bytes; a port blob restores in the reference
    engine and a reference blob in the port engine (each pool holding the
    same parked content), and both finish with the same tokens."""
    port, ref = Side(True, models), Side(False, models)
    teng, tsealed, tkey = _seal_both_sharers(port)
    jeng, jsealed, jkey = _seal_both_sharers(ref)
    assert tkey == jkey
    kkey, jkkey = port.Key.generate(b"seal"), ref.Key.generate(b"seal")
    for (ts, _), (js, _) in zip(tsealed, jsealed):
        assert sorted(ts) == sorted(js)
        for name in ts:
            if name.endswith(("/meta", "/sharedkeys")):
                a = t_unseal(kkey, ts[name]).numpy()
                assert np.array_equal(a, np.asarray(j_unseal(jkkey, js[name])))
                assert np.array_equal(
                    a, np.asarray(j_unseal(jkkey, to_jax_blob(ts[name]))))
                assert np.array_equal(
                    a, t_unseal(kkey, to_torch_blob(js[name])).numpy())
        meta = t_unseal(kkey, next(v for n, v in ts.items()
                                   if n.endswith("/meta"))).tolist()
        assert meta[1:4] == [2, 1, 0]   # 2 pages, 1 shared: ordinal 0
    for (ts, treq), (js, jreq) in zip(tsealed, jsealed):
        jeng.restore_slot({n: to_jax_blob(v) for n, v in ts.items()}, jreq)
        teng.restore_slot({n: to_torch_blob(v) for n, v in js.items()}, treq)
        check_pool_invariants(teng.kv)
    teng.run()
    jeng.run()
    assert [r.output for _, r in tsealed] == [r.output for _, r in jsealed]
    check_pool_invariants(teng.kv)
    with pytest.raises(JIntegrityError):       # blobs keep their MACs
        bad = to_jax_blob(tsealed[0][0][next(n for n in tsealed[0][0]
                                             if n.endswith("/meta"))])
        bad.mac = b"\x01" * 32
        j_unseal(jkkey, bad)
