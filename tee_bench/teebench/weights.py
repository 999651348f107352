"""Weights made from the seed, on the device, in the type they are served
in, by the benchmark and never by the program.

Which leaves a model has and how each is made is its configuration's
reference's declaration (``leaves(cfg)``, see ``spec``): one model layer's
shape, its type (the configuration's ``torch_dtype`` unless the leaf names
another), its initialisation and its input (fan-in) axes. Every leaf is
named by the benchmark (``"attn.wq"``, ``"moe.experts.w_gate"``,
``"embedding.table"``) and every model layer of a stacked leaf draws from a
generator seeded with (seed, leaf, layer), so the reference can make one
layer again, alone and bit for bit, long after the program's copy is gone.
A draw is one call on the device a layer (tens of millions of values),
then one scale:

* ``"fan_in"``: a unit normal over the square root of the input axes' size;
* ``"norm"``: a norm scale, 1 plus a normal of std 0.1;
* a named rule: ``RULES`` here (``"embedding"``: a normal of std 0.02), or
  the reference's own ``RULES``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from teebench import spec

EMBED_STD = 0.02
NORM_STD = 0.1


@dataclasses.dataclass(frozen=True)
class Leaf:
    """How one leaf is made: one model layer's ``shape``, its ``init``
    (``"fan_in"``, ``"norm"`` or a rule's name), its input axes (the
    fan-in; the fp8 control scales per output channel over them; none for
    a vector) and its type (None: the configuration's ``torch_dtype``)."""
    shape: Tuple[int, ...]
    init: str
    inputs: Tuple[int, ...] = ()
    dtype: Optional[str] = None


Rule = Callable[[torch.Tensor, torch.Generator, Leaf], None]


def _fan_in(out: torch.Tensor, gen: torch.Generator, leaf: Leaf) -> None:
    fan = math.prod(leaf.shape[a] for a in leaf.inputs)
    out.normal_(0.0, 1.0, generator=gen).mul_(fan ** -0.5)


def _norm(out: torch.Tensor, gen: torch.Generator, leaf: Leaf) -> None:
    out.normal_(0.0, 1.0, generator=gen).mul_(NORM_STD).add_(1.0)


def _embedding(out: torch.Tensor, gen: torch.Generator, leaf: Leaf) -> None:
    out.normal_(0.0, 1.0, generator=gen).mul_(EMBED_STD)


RULES: Dict[str, Rule] = {"fan_in": _fan_in, "norm": _norm,
                          "embedding": _embedding}


def describe(cfg: dict, leaf: str) -> Leaf:
    """``leaf`` as the configuration's reference declares it."""
    table = spec.reference(cfg).leaves(cfg)
    if leaf not in table:
        raise KeyError(f"reference {cfg['reference']!r} declares no leaf "
                       f"{leaf!r} (it has {sorted(table)})")
    return table[leaf]


def _rule(cfg: dict, name: str) -> Rule:
    own = getattr(spec.reference(cfg), "RULES", {})
    return own[name] if name in own else RULES[name]


def leaf_seed(seed: int, leaf: str, layer: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}|{leaf}|{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def dtype_of(cfg: dict, leaf: Leaf) -> torch.dtype:
    """The type ``leaf`` is served in."""
    return getattr(torch, leaf.dtype or cfg["torch_dtype"])


def make(cfg: dict, seed: int, leaf: str, layer: int = -1, *, device,
         out: torch.Tensor = None) -> torch.Tensor:
    """Model layer ``layer``'s slice of ``leaf`` (-1 for a global leaf),
    made on ``device`` in its type; written into ``out`` when given."""
    desc = describe(cfg, leaf)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, leaf,
                                                               layer))
    if out is None:
        out = torch.empty(desc.shape, dtype=dtype_of(cfg, desc),
                          device=device)
    _rule(cfg, desc.init)(out, gen, desc)
    return out


def stacked(cfg: dict, seed: int, leaf: str, layers: Sequence[int], *,
            device) -> torch.Tensor:
    """The slices of ``leaf`` for model layers ``layers``, stacked
    ``[len(layers), ...]``."""
    desc = describe(cfg, leaf)
    full = torch.empty((len(layers), *desc.shape),
                       dtype=dtype_of(cfg, desc), device=device)
    for i, layer in enumerate(layers):
        make(cfg, seed, leaf, layer, device=device, out=full[i])
    return full
