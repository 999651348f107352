"""Compute/communication overlap: ring collective matmuls (port of
``repro.distributed.overlap``).

All-gather -> matmul and matmul -> reduce-scatter, decomposed into a ring
of (chunk matmul, ppermute) steps so the transfer of chunk i+1 can run
under the matmul of chunk i. Both take the per-shard lists of a
:class:`~repro_torch.distributed.collectives.Group` (every shard's on
logical shards, the rank's own on a rank) and return one output per local
shard; wrap them in :func:`~repro_torch.distributed.collectives.shard_map`
for global arrays. They are checked against their one-shot equivalents.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.distributed.collectives import (Group, Parts, axis_index,
                                                 axis_size, ppermute)


def _ring_perm(group: Group, shift: int = 1):
    n = axis_size(group)
    return [(i, (i + shift) % n) for i in range(n)]


def all_gather_matmul(x_local: Parts, w: Parts, group: Group) -> Parts:
    """y = all_gather(x) @ w, ring-overlapped.

    x_local: each shard's rows ``[m_l, k]``; w: ``[k, n]`` (replicated or the
    shard's TP block). Returns ``[m_l * p, n]`` per shard: each ring step
    multiplies the chunk it holds while the next chunk moves."""
    p = axis_size(group)
    m_l = x_local[0].shape[0]
    dtype = torch.promote_types(x_local[0].dtype, w[0].dtype)
    outs = [torch.zeros((m_l * p, wi.shape[1]), dtype=dtype,
                        device=wi.device) for wi in w]
    chunks = list(x_local)
    for step in range(p):
        ys = [c @ wi for c, wi in zip(chunks, w)]          # compute...
        if step + 1 < p:
            chunks = ppermute(chunks, group, _ring_perm(group))
        for out, y, idx in zip(outs, ys, axis_index(group)):  # ...data moves
            src = (idx - step) % p                         # whose rows we held
            out[src * m_l:(src + 1) * m_l] = y.to(dtype)
    return outs


def matmul_reduce_scatter(x: Parts, w_local: Parts, group: Group) -> Parts:
    """y_local = reduce_scatter(x @ w) over the contraction shards.

    x: each shard's ``[m, k_l]``; w_local: ``[k_l, n]`` (both K-sharded).
    The full result is ``sum_p x_p @ w_p``, ``[m, n]``; shard ``idx`` keeps
    rows ``[idx*m_l, (idx+1)*m_l)``. A partial-sum buffer travels the ring,
    each shard adding its contribution for the buffer's eventual owner."""
    p = axis_size(group)
    m = x[0].shape[0]
    assert m % p == 0, (m, p)
    m_l = m // p

    def local_chunk(xi, wi, owner):
        return xi[owner * m_l:(owner + 1) * m_l] @ wi

    # each buffer starts as the shard's contribution for shard idx+p-1;
    # after p-1 hops, each shard adding its own, it reaches its owner whole
    bufs: List[torch.Tensor] = [
        local_chunk(xi, wi, (idx + p - 1) % p)
        for xi, wi, idx in zip(x, w_local, axis_index(group))]
    for step in range(p - 1):
        bufs = ppermute(bufs, group, _ring_perm(group))
        bufs = [b + local_chunk(xi, wi, (idx + p - 2 - step) % p)
                for b, xi, wi, idx in zip(bufs, x, w_local,
                                          axis_index(group))]
    return bufs
