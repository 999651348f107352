"""Training data pipeline (a copy of ``repro.data.pipeline``): a
deterministic synthetic corpus, or a file's text, packed into fixed-length
LM batches with next-token labels.

Plain numpy, seeded: the same seed gives the same text and batches
bit-equal to the reference's, so a resumed run sees exactly the batches
the lost run would have.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer

_WORDS = (
    "confidential inference enclave attestation throughput latency batch "
    "tensor trusted execution environment memory encryption keystream "
    "roofline collective shard pipeline expert decode prefill token cache "
    "llama whisper jamba rwkv deepseek qwen mistral chameleon dbrx model"
).split()


def synthetic_text(seed: int, n_sentences: int = 1000) -> str:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sentences):
        n = int(rng.integers(4, 12))
        out.append(" ".join(rng.choice(_WORDS, n)) + ".")
    return " ".join(out)


class PackedLMDataset:
    """Infinite iterator of {"tokens": [b, s], "labels": [b, s]} int32."""

    def __init__(self, text: Optional[str] = None, *, path: Optional[str] = None,
                 batch_size: int = 8, seq_len: int = 128, seed: int = 0):
        self.tok = ByteTokenizer()
        if path is not None:
            text = Path(path).read_text()
        if text is None:
            text = synthetic_text(seed)
        ids = self.tok.encode(text, bos=False)
        # pack into one long stream, wrap around
        need = batch_size * (seq_len + 1)
        reps = max(1, -(-need // len(ids)))
        self.stream = np.tile(ids, reps + 1)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self._cursor = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b, s = self.batch_size, self.seq_len
        rows = []
        for _ in range(b):
            start = self._cursor % (len(self.stream) - s - 1)
            rows.append(self.stream[start:start + s + 1])
            self._cursor += s + 1
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def state(self) -> int:
        return self._cursor

    def restore(self, cursor: int) -> None:
        self._cursor = cursor


def take(it, n: int):
    return list(itertools.islice(it, n))
