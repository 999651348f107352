"""repro_torch's paged KV backend against repro.runtime.paged, reservation
mode, on the smoke deepseek-7b model with the reference's weights: the
greedy canonical scenario under gather and kernel decode (tokens, stats,
audit, page tables step by step, pool invariants), the seal/restore cycle
with ciphertext-resident pages, sealed page blobs crossing both packages,
partial (tail) eviction, and the launcher's paged report lines."""

import contextlib
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import reference_run, run_tokens
from conftest import CANONICAL_ENGINE, canonical_requests, check_pool_invariants
from repro.configs import smoke_config
from repro.core import SealingKey as JKey
from repro.core import TrustDomain as JTD
from repro.core.sealing import unseal_tensor as j_unseal
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.runtime import Engine as JEngine
from repro.runtime import GenerationRequest as JGen
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import SealingKey as TKey
from repro_torch.core import TrustDomain as TTD
from repro_torch.core.sealing import IntegrityError
from repro_torch.core.sealing import unseal_tensor as t_unseal
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import Engine as TEngine
from repro_torch.runtime import GenerationRequest as TGen
from repro_torch.runtime.kvcache import make_backend, tail_blob_names
from test_torch_sealing import to_jax_blob, to_torch_blob

PAGED = dict(kv_backend="paged", page_size=8)


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config("deepseek-7b")
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.key(0))
    tm = tbuild(tsmoke("deepseek-7b"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _engine(port, models, **kw):
    jm, jp, tm, tp = models
    TD, Key, Engine = (TTD, TKey, TEngine) if port else (JTD, JKey, JEngine)
    dev = {"device": "cpu"} if port else {}
    td = TD("tdx", sealing_key=Key.generate(b"seal"),
            io_key=Key.generate(b"io"), **dev)
    return Engine(tm if port else jm, tp if port else jp, trust_domain=td,
                  **kw, **dev)


def _gen(port, prompt, max_new_tokens, priority=0):
    return (TGen if port else JGen)(prompt=np.asarray(prompt, np.int32),
                                    max_new_tokens=max_new_tokens,
                                    priority=priority)


def _step(eng, port, tables):
    eng.step()
    tables.append(eng.kv.table.copy())
    if port:
        check_pool_invariants(eng.kv)


def _canonical(port, models, kv_decode):
    """The canonical scenario with temperature 0, every step's page table
    recorded and (on the port) the pool invariants checked."""
    eng = _engine(port, models, **PAGED, kv_decode=kv_decode,
                  **CANONICAL_ENGINE)
    low, high = canonical_requests()
    tables = []
    reqs = [eng.submit(_gen(port, *s[:3])) for s in low]
    for _ in range(3):
        _step(eng, port, tables)
    reqs += [eng.submit(_gen(port, *s[:3])) for s in high]
    while not eng.idle and len(tables) < 5000:
        _step(eng, port, tables)
    assert all(r.finished for r in reqs)
    return reqs, eng, tables


@pytest.mark.parametrize("kv_decode", ["gather", "kernel"])
def test_canonical_paged_scenario_identical(models, kv_decode):
    """The port twice (equal tokens and tables: the side under test must not
    flip), then the reference, replayed until its tokens equal the port's
    at most REF_TRIES times (its emulated walk is not rerun-stable under
    load, ROADMAP.md queue C); the last replay is compared in full."""
    treqs, teng, ttables = _canonical(True, models, kv_decode)
    again = _canonical(True, models, kv_decode)
    assert run_tokens(again) == [list(r.output) for r in treqs]
    assert len(again[2]) == len(ttables)
    for step, (a, t) in enumerate(zip(again[2], ttables)):
        assert np.array_equal(a, t), f"port rerun's table differs at {step}"
    jreqs, jeng, jtables = reference_run(
        lambda: _canonical(False, models, kv_decode),
        (treqs, teng, ttables))
    assert teng.kv.decode_mode == kv_decode
    assert [list(r.output) for r in treqs] == [list(r.output) for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert [r.n_preemptions for r in treqs] == [r.n_preemptions for r in jreqs]
    tstats, jstats = teng.scheduler.stats(), jeng.scheduler.stats()
    assert tstats.preemptions > 0
    for f in ("total_tokens", "total_requests", "preemptions", "sealed_bytes",
              "dropped_requests", "aborted_requests", "deadline_misses"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    for f in ("messages_in", "messages_out", "bytes_in", "bytes_out",
              "tokens_out", "seal_events", "seal_bytes", "restore_events",
              "restore_bytes"):
        assert getattr(tch, f) == getattr(jch, f), f
    assert ([(e.kind, e.detail) for e in teng.td.audit]
            == [(e.kind, e.detail) for e in jeng.td.audit])
    assert len(ttables) == len(jtables)
    for step, (t, j) in enumerate(zip(ttables, jtables)):
        assert np.array_equal(t, j), f"page table differs after step {step}"
    assert teng.kv.fused_restore_pages == jeng.kv.fused_restore_pages
    assert teng.kv.pages_written == jeng.kv.pages_written


def _cycle(port, models, kv_decode, *, tamper=False, after=None):
    """Prefill + decode a greedy request, whole-slot seal it, release,
    restore into a fresh slot, then decode 6 steps straight against the
    backend (tests/test_paged_kernel.py's cycle). Returns (tokens, backend,
    sealed dict)."""
    eng = _engine(port, models, max_slots=2, max_len=64,
                  prefill_buckets=(4, 8), kv_decode=kv_decode, **PAGED)
    kv = eng.kv
    prompt = np.random.default_rng(42).integers(1, 250, 20)
    eng.submit(_gen(port, prompt, 24))
    for _ in range(14):
        eng.step()
    key = (TKey if port else JKey).generate(b"cycle")
    slot = next(s for s in range(2) if eng._active_mask[s])
    last = int(eng._last_token[slot])
    sealed = kv.seal(key, slot, "ckpt")
    pos = int(kv.pos[slot])
    kv.release(slot)
    s2 = kv.acquire(999, 64)
    if tamper:
        st = sealed[next(n for n in sealed if n.endswith("/p0"))]
        st.ciphertext[0, 0] ^= 1
        free = list(kv._free_pages)
        with pytest.raises(IntegrityError, match="/p0"):
            kv.restore(key, sealed, s2, "ckpt", pos)
        assert not kv._cipher_pages and kv._free_pages == free
        assert not kv.table[s2].any() and kv.allocated_pages(s2) == 0
        return None, kv, sealed
    kv.restore(key, sealed, s2, "ckpt", pos)
    if after is not None:
        after(kv, s2)
    toks, out = np.zeros(2, np.int32), []
    toks[s2] = last
    for _ in range(6):
        nt = kv.decode(eng.params, toks, None, 0, [s2])
        toks[s2] = nt[s2]
        out.append(int(nt[s2]))
    return out, kv, sealed


@pytest.fixture(scope="module")
def cycles(models):
    return {"jax": _cycle(False, models, "gather"),
            "gather": _cycle(True, models, "gather"),
            "kernel": _cycle(True, models, "kernel")}


def test_restore_admits_ciphertext_and_matches_gather(cycles):
    (j, _, _), (g, gkv, _), (k, kkv, _) = (cycles[m] for m in
                                           ("jax", "gather", "kernel"))
    assert g == k == j
    assert gkv.fused_restore_pages == 0 and not gkv._cipher_pages
    # pos 22, page 8: pages 0 and 1 are full (ciphertext-resident), page 2
    # is the partial tail (decrypted on the host path)
    assert kkv.fused_restore_pages == 2 and len(kkv._cipher_pages) == 2
    assert kkv.fused_restore_bytes == 2 * sum(
        t[:, 0].numel() * t.element_size() for t in kkv._pools.values())


def test_tampered_page_fails_before_any_page_moves(models):
    _cycle(True, models, "kernel", tamper=True)


def test_materialize_on_reseal(models, cycles):
    """Sealing a slot that holds ciphertext-resident pages decrypts them in
    place first (through the ChaCha20 wrapper): the pool then holds the
    sealed pages' plaintext bits, and decoding still agrees."""
    seen = {}

    def reseal(kv, slot):
        kv.seal(TKey.generate(b"second"), slot, "ckpt2")
        seen["cipher"] = set(kv._cipher_pages)
        seen["ev"] = [e for e in kv.drain_events() if e[0] == "materialize"]
        seen["pages"] = [int(p) for p in kv.table[slot, :2]]
    out, kv, sealed = _cycle(True, models, "kernel", after=reseal)
    assert seen["cipher"] == set() and len(seen["ev"]) == 2
    assert out == cycles["gather"][0]
    key = TKey.generate(b"cycle")
    for path, pool in kv._pools.items():
        for j, phys in enumerate(seen["pages"]):
            assert torch.equal(pool[:, phys],
                               t_unseal(key, sealed[f"ckpt{path}/p{j}"]))


def test_page_blobs_cross_packages(cycles):
    """The port seals under the reference's names and meta, and a page
    blob sealed by either package unseals in the other."""
    _, _, jsealed = cycles["jax"]
    _, _, tsealed = cycles["gather"]
    assert sorted(tsealed) == sorted(jsealed)
    jkey, tkey = JKey.generate(b"cycle"), TKey.generate(b"cycle")
    assert (t_unseal(tkey, to_torch_blob(jsealed["ckpt/meta"])).tolist()
            == t_unseal(tkey, tsealed["ckpt/meta"]).tolist()
            == np.asarray(j_unseal(jkey, jsealed["ckpt/meta"])).tolist()
            == [22, 3, 0])
    name = "ckpt['layers']['slot_0']['k']/p1"
    port_page = t_unseal(tkey, tsealed[name])
    assert np.array_equal(np.asarray(j_unseal(jkey, to_jax_blob(tsealed[name]))),
                          port_page.numpy())
    ref_page = np.asarray(j_unseal(jkey, jsealed[name]))
    assert np.array_equal(t_unseal(tkey, to_torch_blob(jsealed[name])).numpy(),
                          ref_page)
    assert port_page.shape == ref_page.shape == (2, 8, 2, 16)


def _partial(port, models, scenario):
    """tests/test_paged_kv.py's partial-eviction scenarios on one engine
    (pool of 8 pages): an explicit tail eviction and resume, one triggered
    by a high-priority arrival that is short only on pages, and a
    whole-seal of a paused slot that grafts the tail blob back."""
    prompt = np.arange(1, 9)
    slots = 1 if scenario == "paused_whole_seal" else 2
    eng = _engine(port, models, max_slots=slots, max_len=64, prefill_len=8,
                  num_pages=8, **PAGED)
    tables = []
    low = eng.submit(_gen(port, prompt, 10))
    for _ in range(3):
        _step(eng, port, tables)        # pos 11: 2 pages allocated
    assert eng.kv.allocated_pages(0) == 2
    reqs = [low]
    if scenario == "round_trip":
        eng.partial_preempt(0, 1)
        assert eng.kv.allocated_pages(0) == 1 and 0 in eng._paused
    elif scenario == "page_pressure":
        # needs 6 pages, 5 unreserved: a shortfall of 1 page
        reqs.append(eng.submit(_gen(port, np.full(8, 7), 41, priority=5)))
    else:
        eng.partial_preempt(0, 1)
        sealed, req = eng.seal_slot(0)
        assert tail_blob_names(sealed) == [(f"kvslot/{req.stream_id}/0", "")]
        assert eng.kv.free_page_reserve == eng.kv.num_pages
        eng.restore_slot(sealed, req)
        assert eng.kv.allocated_pages(0) == 2
    while not eng.idle and len(tables) < 300:
        _step(eng, port, tables)
    assert all(r.finished for r in reqs)
    audit = [(e.kind, e.detail) for e in eng.td.audit]
    return [list(r.output) for r in reqs], audit, tables


@pytest.mark.parametrize("scenario", ["round_trip", "page_pressure",
                                      "paused_whole_seal"])
def test_partial_eviction_matches_reference(models, scenario):
    tout, taudit, ttables = _partial(True, models, scenario)
    jout, jaudit, jtables = _partial(False, models, scenario)
    assert tout == jout
    assert taudit == jaudit
    assert all(np.array_equal(t, j) for t, j in zip(ttables, jtables))
    # one tail seal, and one tail restore unless the whole restore grafts it
    partials = [d for _, d in taudit if "partial" in d]
    assert len(partials) == (1 if scenario == "paused_whole_seal" else 2)


def test_backend_construction(models):
    _, _, tm, _ = models
    kv = make_backend("paged", tm, max_slots=2, max_len=64, page_size=8)
    assert kv.max_pages == 8 and kv.num_pages == 16
    assert kv.pages_for(8) == 1 and kv.pages_for(9) == 2
    assert kv.free_physical_pages == 16 and kv.request_capacity == 64
    # k and v pools [L=2, 16 + 1 null page, 8, hk=2, hd=16] f32
    assert kv.cache_nbytes() == 2 * (2 * 17 * 8 * 2 * 16 * 4)
    for bad, err in ((dict(page_size=7), "multiple"), (dict(page_size=0),
                                                       "page_size"),
                     (dict(decode="fast"), "decode"),
                     (dict(alloc="lazy"), "alloc")):
        with pytest.raises(ValueError, match=err):
            make_backend("paged", tm, max_slots=2, max_len=64,
                         **{"page_size": 8, **bad})
    with pytest.raises(ValueError, match="kv_decode"):
        make_backend("slot", tm, max_slots=2, max_len=64, decode="kernel")


def _report(main, argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("extra", [[], [
    "--prefix-sharing", "--shared-prefix-len", "8", "--sample-temp", "0.9",
    "--top-k", "16", "--seed", "3"]])
def test_serve_paged_report_lines(monkeypatch, extra):
    argv = ["--arch", "deepseek-7b", "--smoke", "--requests", "3",
            "--max-new-tokens", "4", "--slots", "2", "--kv-backend", "paged",
            "--page-size", "8", "--num-pages", "12", "--kv-decode",
            "kernel"] + extra
    jlines = _report(jserve.main, argv, monkeypatch)
    tlines = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    label = re.compile(r"^[^0-9(]*")
    assert [label.match(l).group(0) for l in tlines] == \
        [label.match(l).group(0) for l in jlines]
    for prefix in ("boundary:", "frame coalescing:", "kv decode:",
                   "prefix sharing:"):
        assert [l for l in tlines if l.startswith(prefix)] == \
            [l for l in jlines if l.startswith(prefix)]
    assert "kv decode: mode=kernel | fused-unseal 0 pages / 0 B admitted " \
        "as ciphertext" in tlines
    if extra:
        (line,) = [l for l in tlines if l.startswith("prefix sharing:")]
        assert not line.startswith("prefix sharing: 0 ")


@pytest.mark.parametrize("kv_decode", ["gather", "kernel"])
def test_decode_logits_match_slot_path(models, kv_decode):
    """One decode step's logits on a paged backend equal the dense slot
    path's for the same prefilled cache (f32: gather bit for bit, the
    kernel path within 1e-4)."""
    _, _, tm, tp = models
    prompt = torch.as_tensor(np.arange(3, 19, dtype=np.int32)[None])
    with torch.inference_mode():
        _, dense = tm.prefill(tp, {"tokens": prompt}, tm.init_cache(1, 64))
        kv = make_backend("paged", tm, max_slots=1, max_len=64, page_size=8,
                          decode=kv_decode)
        kv.insert_prefill(dense, [kv.acquire(0, 24)], 16)
        tok = np.array([7], np.int32)
        paged = kv.decode_logits(tp, tok, [0])
        ref, _ = tm.decode_step(tp, torch.as_tensor(tok[:, None]), dense)
    assert kv.pos[0] == 17
    if kv_decode == "gather":
        assert torch.equal(paged, ref)
    else:
        torch.testing.assert_close(paged, ref, rtol=1e-4, atol=1e-4)
