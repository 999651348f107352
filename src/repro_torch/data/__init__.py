"""Data path (port of ``repro.data``): the byte-level tokenizer, the
deterministic synthetic corpus and the packed LM batches of training."""

from repro_torch.data.pipeline import PackedLMDataset, synthetic_text, take
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "PackedLMDataset", "synthetic_text", "take"]
