"""The deterministic synthetic corpus of ``repro.data.pipeline`` (its
``synthetic_text``, copied: the same text for the same seed). The packed
LM batches of that module wait for the training port (ROADMAP.md queue A
item 20)."""

from __future__ import annotations

import numpy as np

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
