"""Weights made from the seed, on the device, in the type they are served
in (bf16), by the benchmark and never by the program.

Every leaf is named by the benchmark (``"attn.wq"``, ``"embedding.table"``)
and every layer of a stacked leaf draws from a generator seeded with
(seed, leaf, layer), so the reference can make one layer again, alone and
bit for bit, long after the program's copy is gone. A draw is one
``torch.randn`` call on the device a layer (tens of millions of values),
then one scale: matrices by 1/sqrt(fan-in), the embedding by 0.02, norm
scales around 1.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

# leaf -> (shape of one layer's slice from the config, fan-in or None)
LAYER_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_gate",
                "ffn.w_up", "ffn.w_down", "pre_norm.scale", "post_norm.scale")
GLOBAL_LEAVES = ("embedding.table", "final_norm.scale")
EMBED_STD = 0.02
NORM_STD = 0.1


def leaf_shape(cfg: dict, leaf: str) -> Tuple[Tuple[int, ...], float]:
    """(shape of one layer's slice, the scale of its unit normal)."""
    d, h, hk, hd, ff, v = (cfg["hidden_size"], cfg["num_attention_heads"],
                           cfg["num_key_value_heads"], cfg["head_dim"],
                           cfg["intermediate_size"], cfg["vocab_size"])
    table = {
        "attn.wq": ((d, h, hd), d ** -0.5),
        "attn.wk": ((d, hk, hd), d ** -0.5),
        "attn.wv": ((d, hk, hd), d ** -0.5),
        "attn.wo": ((h, hd, d), (h * hd) ** -0.5),
        "ffn.w_gate": ((d, ff), d ** -0.5),
        "ffn.w_up": ((d, ff), d ** -0.5),
        "ffn.w_down": ((ff, d), ff ** -0.5),
        "pre_norm.scale": ((d,), NORM_STD),
        "post_norm.scale": ((d,), NORM_STD),
        "final_norm.scale": ((d,), NORM_STD),
        "embedding.table": ((v, d), EMBED_STD),
    }
    return table[leaf]


def leaf_seed(seed: int, leaf: str, layer: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}|{leaf}|{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def dtype_of(cfg: dict) -> torch.dtype:
    """The type the configuration serves its weights in."""
    return getattr(torch, cfg["torch_dtype"])


def make(cfg: dict, seed: int, leaf: str, layer: int = -1, *, device,
         out: torch.Tensor = None) -> torch.Tensor:
    """One layer's slice of ``leaf`` (``layer`` -1 for a global leaf), made
    on ``device`` in the configuration's type; written into ``out`` when
    given."""
    shape, scale = leaf_shape(cfg, leaf)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, leaf,
                                                               layer))
    if out is None:
        out = torch.empty(shape, dtype=dtype_of(cfg), device=device)
    out.normal_(0.0, 1.0, generator=gen).mul_(scale)
    if leaf.endswith("norm.scale"):
        out.add_(1.0)
    return out


def stacked(cfg: dict, seed: int, leaf: str, *, device) -> torch.Tensor:
    """Every layer's slice of ``leaf``, stacked ``[layers, ...]``."""
    shape, _ = leaf_shape(cfg, leaf)
    n = cfg["num_hidden_layers"]
    full = torch.empty((n, *shape), dtype=dtype_of(cfg), device=device)
    for i in range(n):
        make(cfg, seed, leaf, i, device=device, out=full[i])
    return full
