"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.distributed.pipeline``).

Stage ``s`` of ``S`` holds its slice of the stacked stage params ``[S,
...]`` and microbatches flow through a (compute, then shift) schedule of
``M + S - 1`` steps with the classic ``S - 1`` bubble. The pipe axis is a
collective group (:mod:`repro_torch.distributed.collectives`): a
``LocalGroup(S)`` runs every stage in this process, a ``RankGroup`` one
stage a rank. The shift is the differentiable ``ppermute`` (its backward
the reverse shift) and the last stage's outputs reach every shard through
the differentiable ``psum`` of zero-padded emits, so autograd gives the
backward pass and the same function trains.

Over ranks each rank's autograd graph must reach every send and receive
of the schedule, or a rank would skip its part of a backward shift. The
stage inputs and the emits are ``torch.where`` selections, as the
reference's ``jnp.where`` are: stage 0 selects its injected microbatch
over the carry it received, and the other stages select zeros over their
outputs, so every shift stays on a path to the loss on every rank.
Nothing wires GPipe into a model, in the reference or here.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.core.sealing import tree_map
from repro_torch.distributed.collectives import Group, ppermute, psum

Params = Any


def _ring(group: Group):
    n = group.size
    return [(i, (i + 1) % n) for i in range(n)]


def gpipe_local(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                stage_params: List[Params], microbatches: torch.Tensor,
                group: Group) -> List[torch.Tensor]:
    """The schedule over ``group``'s local shards: ``stage_params[j]`` is
    local shard ``group.local[j]``'s stage params, ``microbatches`` ``[M,
    mb, ...]`` (the same on every rank; only stage 0 consumes them).
    Returns, for each local shard, ``[M, mb, ...]`` outputs: the last
    stage's, zeros elsewhere."""
    s = group.size
    m = microbatches.shape[0]
    dev = microbatches.device
    first = [torch.tensor(i == 0, device=dev) for i in group.local]
    last = [torch.tensor(i == s - 1, device=dev) for i in group.local]
    carry = [torch.zeros_like(microbatches[0]) for _ in group.local]
    emits: List[List[torch.Tensor]] = [[] for _ in group.local]
    for t in range(m + s - 1):
        inject = microbatches[min(t, m - 1)]
        ys = [stage_fn(p, torch.where(f, inject, c))
              for p, f, c in zip(stage_params, first, carry)]
        # the last stage finishes microbatch t - (s - 1) at step t
        if t - (s - 1) >= 0:
            for e, y, lst in zip(emits, ys, last):
                e.append(torch.where(lst, y, torch.zeros_like(y)))
        if t < m + s - 2:       # the last shift's carry is never read
            carry = ppermute(ys, group, _ring(group))
    return [torch.stack(e).to(microbatches.dtype) for e in emits]


def make_gpipe(group: Group,
               stage_fn: Callable[[Params, torch.Tensor], torch.Tensor]):
    """``pipelined(stacked_params, microbatches) -> [M, mb, ...]``: the
    schedule over ``group`` (the reference's ``make_gpipe`` under
    ``shard_map``, its stage params sharded over the pipe axis and its
    inputs and outputs replicated). ``stacked_params`` is a tensor or a
    tree of tensors with the stage on dim 0; each local shard takes its
    stage's slice (a view, so gradients reach the stacked params). The
    result is every rank's: the last stage's outputs, broadcast by the
    sum of the emits."""

    def pipelined(stacked_params: Params,
                  microbatches: torch.Tensor) -> torch.Tensor:
        local = [tree_map(lambda x, i=i: x[i], stacked_params)
                 for i in group.local]
        return psum(gpipe_local(stage_fn, local, microbatches, group), group)

    return pipelined
