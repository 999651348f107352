"""Retrieval-augmented generation inside the trust domain (port of
``repro.rag``): BM25, a dense encoder, and the pipeline that feeds the
confidential Engine."""

from repro_torch.rag.bm25 import BM25Index, tokenize
from repro_torch.rag.dense import DenseRetriever, encoder_config
from repro_torch.rag.pipeline import RAGPipeline, RAGResult

__all__ = ["BM25Index", "tokenize", "DenseRetriever", "encoder_config",
           "RAGPipeline", "RAGResult"]
