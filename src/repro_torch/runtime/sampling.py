"""Token sampling (port of ``repro.runtime.sampling``): greedy only.

Seeded sampling (temperature, top-k, top-p, penalties, logit bias) draws
from ``jax.random`` threefry keys in the reference; it needs a bit-exact
port of threefry, ``fold_in`` and ``categorical`` and arrives with
ROADMAP.md queue A item 6.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [b, v] -> token ids [b] (first index among equal maxima)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
