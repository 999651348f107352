"""Data path (port of ``repro.data``): the byte-level tokenizer and the
deterministic synthetic corpus."""

from repro_torch.data.corpus import synthetic_text
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "synthetic_text"]
