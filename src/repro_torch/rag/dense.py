"""Dense retrieval (port of ``repro.rag.dense``): an SBERT-style encoder and
cosine similarity (paper §VI).

The encoder is a small dense trunk of the port's own model, run without a
cache over the whole sequence; a text's embedding is its hidden states
mean-pooled over the positions and normalised. Enough to exercise the
systems path the paper measures: embed the corpus inside the TEE, keep the
index there, score queries by cosine similarity on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import build_model


def encoder_config(d_model: int = 64, num_layers: int = 2) -> ModelConfig:
    return ModelConfig(
        name="sbert-tiny", family="dense", num_layers=num_layers,
        d_model=d_model, num_heads=4, num_kv_heads=4, head_dim=d_model // 4,
        d_ff=4 * d_model, vocab_size=ByteTokenizer.vocab_size,
        parallel=ParallelConfig(remat="none"),
    )


class DenseRetriever:
    """Random encoder weights from ``seed`` (the port's own init), on
    ``device``: the card unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: Optional[ModelConfig] = None, max_len: int = 64,
                 seed: int = 0, device=None):
        self.cfg = cfg or encoder_config()
        self.model = build_model(self.cfg, device=device)
        self.device = self.model.device
        self.params = self.model.init_params(seed)
        self.tok = ByteTokenizer()
        self.max_len = max_len
        self.doc_ids: List[str] = []
        self.embeddings: Optional[torch.Tensor] = None

    @torch.inference_mode()
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Mean-pooled hidden state, normalised: the sentence embedding."""
        x, _ = self.model._impl._trunk(params, tokens)
        emb = x.float().mean(dim=1)
        return emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-9)

    def _encode(self, texts: List[str]) -> torch.Tensor:
        batch = np.zeros((len(texts), self.max_len), np.int32)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)[:self.max_len]
            batch[i, :len(ids)] = ids
        return self._embed(self.params,
                           torch.as_tensor(batch, device=self.device))

    # -- index ---------------------------------------------------------------
    def build(self, docs: Dict[str, str]) -> "DenseRetriever":
        self.doc_ids = list(docs.keys())
        self.embeddings = self._encode([docs[d] for d in self.doc_ids])
        return self

    def search(self, query: str, top_k: int = 10) -> List[Tuple[str, float]]:
        q = self._encode([query])[0]
        sims = torch.einsum("d,nd->n", q, self.embeddings).cpu().numpy()
        order = np.argsort(-sims)
        return [(self.doc_ids[i], float(sims[i])) for i in order[:top_k]]
