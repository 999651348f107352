"""repro_torch's serving engine and launcher against repro.runtime: the
greedy canonical scenario (tests/conftest.py) on both engines must make the
same tokens, scheduling decisions, seals and boundary crossings. Also the
import boundary: the port never imports jax or the reference package."""

import ast
import contextlib
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import CANONICAL_ENGINE, canonical_requests
from repro.configs import smoke_config
from repro.core import SealingKey as JKey
from repro.core import TrustDomain as JTD
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.roofline.analysis import HBM_BW as J_HBM_BW
from repro.runtime import Engine as JEngine
from repro.runtime import GenerationRequest as JGen
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import SealingKey as TKey
from repro_torch.core import TrustDomain as TTD
import repro_torch.core.overheads as t_over
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import Engine as TEngine
from repro_torch.runtime import GenerationRequest as TGen
from repro_torch.runtime import SamplingParams as TSampling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config("deepseek-7b")
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.key(0))
    tm = tbuild(tsmoke("deepseek-7b"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _canonical(port: bool, model, params):
    """The canonical scenario with temperature 0 (greedy), fixed keys."""
    TD, Key, Engine, Gen = ((TTD, TKey, TEngine, TGen) if port
                            else (JTD, JKey, JEngine, JGen))
    kw = {"device": "cpu"} if port else {}
    td = TD("tdx", sealing_key=Key.generate(b"seal"),
            io_key=Key.generate(b"io"), **kw)
    eng = Engine(model, params, trust_domain=td, kv_backend="slot",
                 **CANONICAL_ENGINE, **kw)
    low, high = canonical_requests()

    def gen(spec):
        prompt, mnt, prio, _ = spec
        return Gen(prompt=np.asarray(prompt, np.int32), max_new_tokens=mnt,
                   priority=prio)

    reqs = [eng.submit(gen(s)) for s in low]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(gen(s)) for s in high]
    stats = eng.run(max_steps=50_000)
    assert all(r.finished for r in reqs)
    audit = [(e.kind, e.detail) for e in td.audit]
    return reqs, stats, td.channel.stats, audit


def test_canonical_greedy_scenario_identical(models):
    jm, jp, tm, tp = models
    jreqs, jstats, jch, jaudit = _canonical(False, jm, jp)
    treqs, tstats, tch, taudit = _canonical(True, tm, tp)
    assert tstats.preemptions > 0
    assert [list(r.output) for r in treqs] == [list(r.output) for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert [r.n_preemptions for r in treqs] == [r.n_preemptions for r in jreqs]
    assert [r.sealed_bytes for r in treqs] == [r.sealed_bytes for r in jreqs]
    for f in ("total_tokens", "total_requests", "preemptions", "sealed_bytes",
              "dropped_requests", "aborted_requests", "deadline_misses"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    for f in ("messages_in", "messages_out", "bytes_in", "bytes_out",
              "tokens_out", "seal_events", "seal_bytes", "restore_events",
              "restore_bytes"):
        assert getattr(tch, f) == getattr(jch, f), f
    # every boundary event in the same order with the same detail: seals
    # name the same slot, rid, stream and epoch; frames the same seq
    assert taudit == jaudit


def test_sealed_kv_names_match_reference(models):
    """A preempted slot seals under the reference's names, and the blob
    opens in the reference (same key): the KV cache layouts agree."""
    from repro.core.sealing import unseal_tensor as j_unseal
    from test_torch_sealing import to_jax_blob
    jm, jp, tm, tp = models
    td = TTD("tdx", sealing_key=TKey.generate(b"kv"), device="cpu")
    eng = TEngine(tm, tp, trust_domain=td, kv_backend="slot",
                  **CANONICAL_ENGINE, device="cpu")
    req = eng.submit(TGen(prompt=np.arange(1, 6, dtype=np.int32),
                          max_new_tokens=6))
    eng.step()
    sealed, _ = eng.seal_slot(0)
    prefix = f"kvslot/{req.stream_id}/0"
    assert sorted(sealed) == sorted(prefix + p for p in (
        "['layers']['slot_0']['k']", "['layers']['slot_0']['v']", "['pos']"))
    k = j_unseal(JKey.generate(b"kv"),
                 to_jax_blob(sealed[prefix + "['layers']['slot_0']['k']"]))
    assert k.shape == (2, 1, CANONICAL_ENGINE["max_len"], 2, 16)
    assert int(np.asarray(j_unseal(JKey.generate(b"kv"),
                                   to_jax_blob(sealed[prefix + "['pos']"])))[0]) == 9


def test_reject_infeasible_matches_reference(models):
    jm, jp, tm, tp = models
    out = []
    for Engine, Gen, m, p, kw in ((JEngine, JGen, jm, jp, {}),
                                  (TEngine, TGen, tm, tp, {"device": "cpu"})):
        eng = Engine(m, p, reject_infeasible=True, step_time_hint_s=0.01,
                     **CANONICAL_ENGINE, **kw)
        reqs = [eng.submit(Gen(prompt=np.arange(1, 5, dtype=np.int32),
                               max_new_tokens=n, deadline_s=0.05))
                for n in (2, 20)]
        eng.run()
        out.append([(r.finish_reason, list(r.output)) for r in reqs])
    assert out[0] == out[1]
    assert out[1][1][0] == "rejected"


def _slo_run(port: bool, model, params, mode: str):
    """Deadline and admission paths, with time passing simulated by moving
    a request's submit time back (no sleeps, so both engines see the same
    expiry at the same step)."""
    TD, Key, Engine, Gen = ((TTD, TKey, TEngine, TGen) if port
                            else (JTD, JKey, JEngine, JGen))
    kw = {"device": "cpu"} if port else {}
    td = TD("tdx", sealing_key=Key.generate(b"slo"), io_key=Key.generate(b"o"),
            **kw)
    extra = (dict(admission_order="priority", rate_budgets={5: 1e6})
             if mode == "rate" else {})
    eng = Engine(model, params, trust_domain=td, kv_backend="slot",
                 **CANONICAL_ENGINE, **extra, **kw)
    on_deadline = "abort" if mode == "abort" else "drop"
    specs = [(np.arange(1, 5), 6, 0), (np.arange(2, 10), 5, 5),
             (np.arange(3, 8), 4, 0)]
    reqs = [eng.submit(Gen(prompt=p.astype(np.int32), max_new_tokens=n,
                           priority=prio, deadline_s=30.0,
                           on_deadline=on_deadline))
            for p, n, prio in specs]
    eng.step()
    if mode != "rate":
        # queued request 2 expires (drop), or running request 0 (abort)
        reqs[2 if mode == "drop" else 0].t_submit -= 100.0
    stats = eng.run(max_steps=1000)
    return ([(r.finish_reason, list(r.output)) for r in reqs],
            (stats.dropped_requests, stats.aborted_requests,
             stats.deadline_misses),
            [(e.kind, e.detail) for e in td.audit if e.kind != "drop_deadline"
             and e.kind != "abort_deadline"])


@pytest.mark.parametrize("mode", ["drop", "abort", "rate"])
def test_slo_paths_match_reference(models, mode):
    jm, jp, tm, tp = models
    ref = _slo_run(False, jm, jp, mode)
    port = _slo_run(True, tm, tp, mode)
    assert port == ref
    expect = {"drop": "dropped", "abort": "aborted", "rate": "length"}[mode]
    assert port[0][2 if mode == "drop" else 0][0] == expect


def test_out_of_slice_options_raise(models):
    _, _, tm, tp = models
    kw = dict(CANONICAL_ENGINE, device="cpu")
    paged = dict(kv_backend="paged", page_size=8)
    # dp and tp meshes serve the decoder families; neither package serves
    # the encdec family on a mesh
    assert TEngine(tm, tp, **kw,
                   mesh="dp=2,tp=2").plan.tensor_parallel.tp == 2
    encdec = tbuild(tsmoke("whisper-small"), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="neither package serves this family"):
        TEngine(encdec, None, **kw, mesh="dp=2,tp=2")
    assert TEngine(tm, tp, **kw, mesh="dp=2").plan.dp == 2
    # the store and two-phase serving are in the slice
    store = TEngine(tm, tp, **kw, **paged, prefix_sharing=True,
                    page_store=True).kv
    assert store.page_store is not None and store.store_key is not None
    assert TEngine(tm, tp, **kw, **paged, prefix_sharing=True,
                   store_budget_pages=4).kv.page_store.budget_pages == 4
    assert TEngine(tm, tp, **kw, continuous_batching=True)._step_tokens == 10
    assert TEngine(tm, tp, **kw, **paged, prefill_plan="dedicated",
                   handoff_batch=2).prefill_plan is not None
    with pytest.raises(ValueError, match="requires prefix_sharing"):
        TEngine(tm, tp, **kw, **paged, page_store=True)
    # the paged backend is in the slice, with sharing and on-demand pages;
    # its options need kv_backend="paged"
    for decode in ("gather", "kernel"):
        assert TEngine(tm, tp, **kw, **paged, num_pages=12,
                       kv_decode=decode).kv.num_pages == 12
    for opts in (dict(prefix_sharing=True), dict(kv_alloc="ondemand")):
        assert TEngine(tm, tp, **kw, **paged, **opts).kv.on_demand
    with pytest.raises(ValueError, match="kv_backend='paged'"):
        TEngine(tm, tp, **kw, prefix_sharing=True)
    eng = TEngine(tm, tp, **kw)
    req = eng.submit(TGen(prompt=np.arange(1, 5, dtype=np.int32),
                          params=TSampling(temperature=0.9, seed=1)))
    assert req.seed == 1       # seeded sampling is in the slice
    eng.drain()                # fleet drain is in the slice: new work is
    with pytest.raises(RuntimeError, match="draining"):   # refused
        eng.submit(TGen(prompt=np.arange(1, 5, dtype=np.int32)))
    if torch.cuda.is_available():
        with pytest.raises(ValueError):    # model on the CPU, engine on the card
            TEngine(tm, tp, **CANONICAL_ENGINE)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(tm, tp, **CANONICAL_ENGINE)


def _report(main, argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue().splitlines()


def test_serve_prints_reference_report_lines(monkeypatch):
    argv = ["--arch", "deepseek-7b", "--smoke", "--requests", "3",
            "--max-new-tokens", "4", "--slots", "2"]
    jlines = _report(jserve.main, argv, monkeypatch)
    tlines = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    label = re.compile(r"^[^0-9(]*")
    assert [label.match(l).group(0) for l in tlines] == \
        [label.match(l).group(0) for l in jlines]
    # counts and boundary traffic agree exactly (timings do not)
    for prefix in ("boundary:", "frame coalescing:"):
        assert [l for l in tlines if l.startswith(prefix)] == \
            [l for l in jlines if l.startswith(prefix)]
    served = [l.split(" in ")[0] for l in tlines if l.startswith("served")]
    assert served == [l.split(" in ")[0] for l in jlines
                      if l.startswith("served")] == ["served 3 requests / 12 tokens"]


EXACT_LINES = ("boundary:", "frame coalescing:", "epoch ", "store hits:",
               "prefix sharing:", "sealed handoff:", "continuous batching:",
               "sealed-KV traffic:", "store restore-vs-recompute")


@pytest.mark.parametrize("flags,shown", [
    (["--page-store", "--store-policy", "cost", "--store-budget-pages", "8",
      "--epochs", "2"], ("epoch 1:", "store hits:")),
    (["--continuous-batching"], ("continuous batching:",)),
    (["--prefill-plan", "dedicated", "--handoff-batch", "2"],
     ("sealed handoff:",)),
], ids=["store", "continuous", "two-plan"])
def test_serve_store_and_two_phase_report_lines(monkeypatch, flags, shown):
    """The store and two-phase flags print the reference launcher's lines;
    counts, bytes, boundary traffic and, with the port's memory rate set to
    the reference's, the store pricing line agree exactly (timings do
    not)."""
    argv = ["--arch", "deepseek-7b", "--smoke", "--requests", "3",
            "--max-new-tokens", "4", "--slots", "2", "--kv-backend", "paged",
            "--page-size", "8"] + flags
    monkeypatch.setattr(t_over, "HBM_BYTES_PER_S", J_HBM_BW)
    jlines = _report(jserve.main, argv, monkeypatch)
    tlines = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    label = re.compile(r"^[^0-9(]*")
    assert [label.match(l).group(0) for l in tlines] == \
        [label.match(l).group(0) for l in jlines]
    for prefix in EXACT_LINES:
        assert [l for l in tlines if l.startswith(prefix)] == \
            [l for l in jlines if l.startswith(prefix)], prefix
    for prefix in shown:
        assert any(l.startswith(prefix) for l in tlines), prefix


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("kind,kw,want", [
    ("slot", {}, 65_544), ("paged", {"page_size": 8}, 69_632),
    ("paged", {}, 73_728)], ids=["slot", "paged8", "paged16"])
def test_cache_nbytes_matches_reference(models, kind, kw, want):
    """``cache_nbytes`` of each backend, and the module's ``cache_bytes``
    of the slot backend's cache, equal the reference's on smoke
    deepseek-7b (2 slots x 64 positions)."""
    from repro.runtime import kvcache as jkv
    from repro_torch.runtime import kvcache as tkv
    jm, _, tm, _ = models
    jb = jkv.make_backend(kind, jm, max_slots=2, max_len=64, **kw)
    tb = tkv.make_backend(kind, tm, max_slots=2, max_len=64, **kw)
    assert tb.cache_nbytes() == jb.cache_nbytes() == want
    if kind == "slot":
        assert tkv.cache_bytes(tb.cache) == jkv.cache_bytes(jb.cache) == want


def test_store_resident_pages_default_matches_reference(models):
    """A backend without a page store serves no page from one: the base
    class's default answers 0, as the reference's does."""
    from repro.runtime import kvcache as jkv
    from repro_torch.runtime import kvcache as tkv
    jm, _, tm, _ = models
    keys = [b"k0", b"k1"]
    jb = jkv.make_backend("slot", jm, max_slots=2, max_len=64)
    tb = tkv.make_backend("slot", tm, max_slots=2, max_len=64)
    assert tb.store_resident_pages(keys) == jb.store_resident_pages(keys) == 0
    assert tb.store_resident_pages(None) == 0


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path.relative_to(ROOT)} imports {mod}"

