"""repro_torch's RAG path against repro.rag and repro.data on the corpus of
tests/test_rag.py: the byte tokenizer and the synthetic corpus (equal
output), BM25 (equal index and scores), the cache-free trunk and the dense
encoder on the reference's weights (f32 within 1e-5; the default bf16
encoder within 2e-3, one bf16 rounding of a unit-norm embedding; the same
ranking in f32, and in bf16 up to near ties: two documents whose reference
scores lie within twice the tolerance may swap), and RAGPipeline in its
three modes: the reference's hits, and the reference's answer tokens from
a converted engine."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.core import TrustDomain as JTD
from repro.data.pipeline import synthetic_text as j_text
from repro.data.tokenizer import ByteTokenizer as JTok
from repro.models import build_model as jbuild
from repro.rag import pipeline as jpipe
from repro.rag.bm25 import BM25Index as JBM25
from repro.rag.bm25 import tokenize as j_tokenize
from repro.rag.dense import DenseRetriever as JDense
from repro.rag.dense import encoder_config as j_enc
from repro.runtime import Engine as JEngine
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import TrustDomain as TTD
from repro_torch.data import ByteTokenizer as TTok
from repro_torch.data import synthetic_text as t_text
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.rag import pipeline as tpipe
from repro_torch.rag.bm25 import BM25Index as TBM25
from repro_torch.rag.bm25 import tokenize as t_tokenize
from repro_torch.rag.dense import DenseRetriever as TDense
from repro_torch.rag.dense import encoder_config as t_enc

F32_TOL = 1e-5
BF16_TOL = 2e-3
QUERIES = ["confidential enclave attestation llama",
           "inference token decode", "inference throughput enclave",
           "sealed keystream memory encryption"]
MODES = ["bm25", "bm25+rerank", "dense"]
# the engine's vocabulary must hold the tokenizer's ids (BOS is 257): the
# smoke configs' 256 would send BOS past the embedding table (the
# reference's jnp.take fills that row with NaN, ROADMAP.md queue C)
ENGINE_VOCAB = JTok.vocab_size
ENGINE_KW = dict(max_slots=2, max_len=96, prefill_len=16)


@pytest.fixture(scope="module")
def corpus():
    docs = {f"d{i}": j_text(i, 5) for i in range(15)}
    docs["needle"] = ("confidential enclave attestation protects llama "
                      "inference throughput inside trusted hardware")
    return docs


def test_tokenizer_and_corpus_equal_reference():
    jt, tt = JTok(), TTok()
    assert (tt.vocab_size, tt.pad_id, tt.bos_id, tt.eos_id) == \
        (jt.vocab_size, jt.pad_id, jt.bos_id, jt.eos_id)
    for text in ("", "hello, world", "naïve — ünïcode ✓", j_text(3, 4)):
        for bos in (True, False):
            for eos in (True, False):
                a = jt.encode(text, bos=bos, eos=eos)
                b = tt.encode(text, bos=bos, eos=eos)
                assert a.dtype == b.dtype and np.array_equal(a, b)
        ids = jt.encode(text, eos=True)
        assert tt.decode(ids) == jt.decode(ids) == text
    for seed in (0, 7, 14):
        assert t_text(seed, 5) == j_text(seed, 5)


def test_bm25_equals_reference(corpus):
    j, t = JBM25().build(corpus), TBM25().build(corpus)
    assert t.doc_ids == j.doc_ids and t.doc_len == j.doc_len
    assert dict(t.df) == dict(j.df) and t.avg_len == j.avg_len
    for q in QUERIES + ["", "zebra"]:
        assert t_tokenize(q) == j_tokenize(q)
        assert t.search(q, top_k=10) == j.search(q, top_k=10)
    assert t.search(QUERIES[0], top_k=3)[0][0] == "needle"


def _encoders(dtype=None):
    """The reference's encoder (its seed-0 weights) and the port's, on the
    same weights converted 1:1."""
    jc, tc = j_enc(), t_enc()
    if dtype is not None:
        jc, tc = (dataclasses.replace(c, dtype=dtype) for c in (jc, tc))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    j = JDense(jc)
    t = TDense(tc, device="cpu")
    t.params = params_from_jax(jax.tree.map(np.asarray, j.params), "cpu")
    return j, t


def _same_hits(th, jh, tol):
    """The port's hits are the reference's: the same documents, scores
    within ``tol``, and the same order except for near ties (two documents
    whose reference scores are within 2 * tol may swap; none at tol 0)."""
    ref = dict(jh)
    assert sorted(d for d, _ in th) == sorted(ref)
    for d, s in th:
        assert abs(s - ref[d]) <= tol, (d, s, ref[d])
    order = [d for d, _ in th]
    if tol == 0:
        assert order == [d for d, _ in jh]
    for a, b in zip(order, order[1:]):
        assert ref[a] >= ref[b] - 2 * tol, (a, b, ref[a], ref[b])


def test_trunk_and_forward_match_reference_f32():
    j, t = _encoders("float32")
    toks = np.random.default_rng(4).integers(0, 259, (3, 24)).astype(np.int32)
    jx, jaux = j.model._impl._trunk(j.params, toks)
    tx, taux = t.model._impl._trunk(t.params, torch.from_numpy(toks))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=F32_TOL,
                               atol=F32_TOL)
    assert float(taux) == float(jaux) == 0.0
    jl, _ = j.model._impl.forward(j.params, toks)
    tl, _ = t.model._impl.forward(t.params, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (3, 24, 259)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), (None, BF16_TOL)])
def test_dense_embeddings_and_ranking_match_reference(corpus, dtype, tol):
    j, t = _encoders(dtype)
    j.build(corpus)
    t.build(corpus)
    assert t.doc_ids == j.doc_ids
    np.testing.assert_allclose(t.embeddings.numpy(),
                               np.asarray(j.embeddings), rtol=0, atol=tol)
    norms = torch.linalg.norm(t.embeddings, dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    for q in QUERIES:
        _same_hits(t.search(q, top_k=16), j.search(q, top_k=16), tol)


@pytest.fixture
def converted_encoder(monkeypatch):
    """The port's pipelines build their dense retriever on the reference
    encoder's weights."""
    src = JDense()
    params = jax.tree.map(np.asarray, src.params)

    def make(device=None):
        r = TDense(device=device)
        r.params = params_from_jax(params, r.device)
        return r
    monkeypatch.setattr(tpipe, "DenseRetriever", make)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_hits_match_reference(corpus, converted_encoder, mode):
    jtd = JTD("tdx")
    ttd = TTD("tdx", device="cpu")
    j = jpipe.RAGPipeline(corpus, mode=mode, trust_domain=jtd)
    t = tpipe.RAGPipeline(corpus, mode=mode, trust_domain=ttd)
    tol = 0.0 if mode == "bm25" else BF16_TOL
    for q in QUERIES:
        _same_hits(t.retrieve(q, 5), j.retrieve(q, 5), tol)
        jr, tr = j.query(q), t.query(q)
        assert tr.query == jr.query == q
        _same_hits(tr.retrieved, jr.retrieved, tol)
        assert tr.answer_tokens == jr.answer_tokens == []
    # the corpus and each query crossed the bounce buffer sealed
    for f in ("messages_in", "bytes_in", "messages_out"):
        assert getattr(ttd.channel.stats, f) == getattr(jtd.channel.stats, f)
    assert ttd.channel.stats.messages_in == len(corpus) + len(QUERIES)


@pytest.fixture(scope="module")
def engines():
    """A greedy engine of each package on the same weights: smoke
    deepseek-7b with a vocabulary that holds the tokenizer's ids."""
    cfg = dataclasses.replace(smoke_config("deepseek-7b"),
                              vocab_size=ENGINE_VOCAB)
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.key(0))
    tm = tbuild(dataclasses.replace(tsmoke("deepseek-7b"),
                                    vocab_size=ENGINE_VOCAB), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jeng = JEngine(jm, jp, trust_domain=JTD("tdx"), **ENGINE_KW)
    teng = tpipe.Engine(tm, tp, trust_domain=TTD("tdx", device="cpu"),
                        device="cpu", **ENGINE_KW)
    return jeng, teng


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_answers_match_reference(corpus, converted_encoder, engines,
                                          mode):
    jeng, teng = engines
    j = jpipe.RAGPipeline(corpus, mode=mode, engine=jeng)
    t = tpipe.RAGPipeline(corpus, mode=mode, engine=teng)
    q = "which enclave protects patient records?"
    jr, tr = j.query(q, top_k=2, max_new_tokens=6), \
        t.query(q, top_k=2, max_new_tokens=6)
    _same_hits(tr.retrieved, jr.retrieved,
               0.0 if mode == "bm25" else BF16_TOL)
    prompt = t.prompt_for(q, tr.retrieved, 6)
    assert len(prompt) == teng.prompt_budget(6) < len(
        TTok().encode(f"context: {corpus[tr.retrieved[0][0]]}"))
    assert len(tr.answer_tokens) == 6
    assert tr.answer_tokens == jr.answer_tokens
