"""Gradient compression: int8 quantization with error feedback (port of
``repro.distributed.compression``).

Cuts the gradient bytes a data-parallel all-reduce moves 4x where the link
is the bottleneck. Error feedback keeps the scheme convergent: the
quantization residual is carried into the next step (Seide et al. /
EF-SGD), so the compression noise is zero-mean over time.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.sealing import tree_leaves_with_names, tree_map

Params = Any


class CompressionState(NamedTuple):
    error: Params  # residual feedback, f32, same structure as grads


def init_compression_state(params: Params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: add the residual, quantize to int8 (what would cross the
    wire), dequantize, and compute the new residual."""
    gf = g.float() + err
    q, scale = _q8(gf)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def make_grad_compressor(state: Optional[CompressionState] = None):
    """Returns (transform(grads) -> grads', get_state()) for
    ``make_train_step``'s ``grad_transform``: the error term is threaded
    through a host-side cell updated each call."""
    cell = {"state": state}

    @torch.no_grad()
    def transform(grads: Params) -> Params:
        if cell["state"] is None:
            cell["state"] = init_compression_state(grads)
        pairs = tree_map(compress_decompress, grads, cell["state"].error)
        cell["state"] = CompressionState(tree_map(lambda pr: pr[1], pairs))
        return tree_map(lambda pr: pr[0], pairs)

    return transform, lambda: cell["state"]


def compressed_bytes(grads: Params) -> Tuple[int, int]:
    """(raw_bytes, wire_bytes) for reporting the link savings."""
    leaves = [leaf for _, leaf in tree_leaves_with_names(grads)]
    raw = sum(l.numel() * l.element_size() for l in leaves)
    wire = sum(l.numel() * 1 + 4 for l in leaves)  # int8 + scale
    return raw, wire
