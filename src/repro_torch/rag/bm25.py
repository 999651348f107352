"""BM25 retrieval (Robertson/Okapi), a copy of ``repro.rag.bm25``: the
ranking model the paper runs inside TDX through Elasticsearch (§VI). The
index lives inside the trust domain, so document contents never leave it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


@dataclasses.dataclass
class BM25Index:
    k1: float = 1.2
    b: float = 0.75

    def __post_init__(self):
        self.doc_tokens: List[List[str]] = []
        self.doc_ids: List[str] = []
        self.df: Dict[str, int] = defaultdict(int)
        self.tf: List[Counter] = []
        self.doc_len: List[int] = []

    # -- build ---------------------------------------------------------------
    def add(self, doc_id: str, text: str) -> None:
        toks = tokenize(text)
        self.doc_ids.append(doc_id)
        self.doc_tokens.append(toks)
        counts = Counter(toks)
        self.tf.append(counts)
        self.doc_len.append(len(toks))
        for term in counts:
            self.df[term] += 1

    def build(self, docs: Dict[str, str]) -> "BM25Index":
        for doc_id, text in docs.items():
            self.add(doc_id, text)
        return self

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def avg_len(self) -> float:
        return sum(self.doc_len) / max(len(self.doc_len), 1)

    # -- query ---------------------------------------------------------------
    def idf(self, term: str) -> float:
        df = self.df.get(term, 0)
        return math.log((self.n_docs - df + 0.5) / (df + 0.5) + 1.0)

    def score(self, query: str, doc_idx: int) -> float:
        toks = tokenize(query)
        score = 0.0
        dl = self.doc_len[doc_idx]
        for term in toks:
            f = self.tf[doc_idx].get(term, 0)
            if f == 0:
                continue
            denom = f + self.k1 * (1 - self.b + self.b * dl / self.avg_len)
            score += self.idf(term) * f * (self.k1 + 1) / denom
        return score

    def search(self, query: str, top_k: int = 10) -> List[Tuple[str, float]]:
        scores = [(self.doc_ids[i], self.score(query, i))
                  for i in range(self.n_docs)]
        scores.sort(key=lambda x: (-x[1], x[0]))
        return scores[:top_k]
