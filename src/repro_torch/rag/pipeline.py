"""End-to-end RAG pipeline under a TrustDomain (port of
``repro.rag.pipeline``; paper §VI, Fig 14).

Three retrieval modes, as in the paper's BEIR evaluation:
  * bm25            — keyword ranking
  * bm25+rerank     — BM25 candidates reranked by dense cosine (a
                      cross-encoder stand-in)
  * dense           — SBERT-style dense retrieval

The whole pipeline (index, retriever state, generation) lives inside the
trust domain: the corpus and the queries enter through the encrypted
bounce buffer, and the generator is the confidential Engine. The dense
encoder runs on the trust domain's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.confidential import TrustDomain
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.rag.bm25 import BM25Index
from repro_torch.rag.dense import DenseRetriever
from repro_torch.runtime.api import GenerationRequest
from repro_torch.runtime.engine import Engine


@dataclasses.dataclass
class RAGResult:
    query: str
    retrieved: List[Tuple[str, float]]
    answer_tokens: List[int]
    retrieval_s: float
    generation_s: float


class RAGPipeline:
    def __init__(self, docs: Dict[str, str], *, mode: str = "bm25",
                 engine: Optional[Engine] = None,
                 trust_domain: Optional[TrustDomain] = None,
                 rerank_candidates: int = 20):
        assert mode in ("bm25", "bm25+rerank", "dense")
        self.mode = mode
        self.td = trust_domain or (engine.td if engine else TrustDomain("none"))
        self.engine = engine
        self.tok = ByteTokenizer()
        self.rerank_candidates = rerank_candidates
        self.docs = docs
        # the index is built inside the trust domain (the corpus crosses
        # the bounce buffer sealed)
        if self.td.confidential:
            sealed = {k: self.td.channel.host_send(
                np.frombuffer(v.encode(), np.uint8)) for k, v in docs.items()}
            docs = {k: bytes(self.td.channel.device_recv(s)).decode()
                    for k, s in sealed.items()}
        self.bm25 = BM25Index().build(docs) if mode != "dense" else None
        self.dense = (DenseRetriever(device=self.td.device).build(docs)
                      if mode in ("dense", "bm25+rerank") else None)

    def retrieve(self, query: str, top_k: int = 5) -> List[Tuple[str, float]]:
        if self.mode == "bm25":
            return self.bm25.search(query, top_k)
        if self.mode == "dense":
            return self.dense.search(query, top_k)
        # bm25 candidates -> dense rerank
        cands = self.bm25.search(query, self.rerank_candidates)
        scored = self.dense.search(query, len(self.dense.doc_ids))
        rank = {d: s for d, s in scored}
        reranked = sorted(cands, key=lambda x: -rank.get(x[0], -1e9))
        return [(d, rank.get(d, 0.0)) for d, _ in reranked[:top_k]]

    def prompt_for(self, query: str, hits: List[Tuple[str, float]],
                   max_new_tokens: int) -> np.ndarray:
        """The generation prompt: the hits' heads as context, then the
        question, trimmed from the front to ``engine.prompt_budget`` (the
        engine refuses prompts that cannot fit its KV cache; the question
        sits at the tail)."""
        context = " ".join(self.docs[d][:200] for d, _ in hits)
        prompt = self.tok.encode(f"context: {context} question: {query}")
        limit = self.engine.prompt_budget(max_new_tokens)
        if limit <= 0:
            raise ValueError(
                f"engine (max_len={self.engine.max_len}, buckets="
                f"{self.engine.prefill_buckets}) cannot serve "
                f"{max_new_tokens} new tokens for any prompt")
        return prompt[-limit:] if len(prompt) > limit else prompt

    def query(self, query: str, top_k: int = 3,
              max_new_tokens: int = 16) -> RAGResult:
        q = self.td.ingress(np.frombuffer(query.encode(), np.uint8))
        query_clear = bytes(q).decode()
        t0 = time.monotonic()
        hits = self.retrieve(query_clear, top_k)
        t1 = time.monotonic()
        answer: List[int] = []
        if self.engine is not None:
            prompt = self.prompt_for(query_clear, hits, max_new_tokens)
            answer = self.engine.generate(GenerationRequest(
                prompt=prompt, max_new_tokens=max_new_tokens)).tokens
        t2 = time.monotonic()
        return RAGResult(query_clear, hits, answer, t1 - t0, t2 - t1)
