"""Collectives over a mesh axis (the port's counterpart of what
``repro.distributed.compat`` gives ``overlap.py`` and ``plan.py``:
``shard_map``, ``axis_size``, ``axis_index``, ``ppermute``, ``all_gather``).

Three groups share one interface. A collective takes the list of
per-shard tensors this process holds, in the order of ``group.local`` (the
shard indices it computes), and returns what every one of them receives:

  * :class:`LocalGroup` -- ``n`` logical shards in one process, on one
    device: ``local`` is every shard, and a collective is a sum or a
    concatenation in device memory;
  * :class:`RankGroup` -- one shard per process of a ``torch.distributed``
    group: ``local`` is this rank's index in the group. The backend is
    NCCL when each rank has a card of its own and gloo otherwise (the CPU,
    or ranks sharing one card: NCCL refuses two ranks on one device);
    gloo's traffic is staged through host memory explicitly. A failed
    collective raises; nothing falls back;
  * :class:`DryGroup` -- one rank's view of ``n`` ranks with nothing
    behind the others (the dry run, ``launch/dryrun.py``): what the rank
    receives is built from the shapes alone (an all-gather concatenates
    ``n`` blocks, an all-reduce returns a tensor of its input's shape), in
    the ops a :class:`RankGroup` runs, so fake tensors pass through it.
    It counts bytes as :class:`RankGroup` does and times nothing.

The all-reduce of both groups is an all-gather followed by a sum in rank
order, so a result has the same bits whichever group computed it and
every rank holds identical values. Each group counts the bytes it moves
into one shard and times every collective (CUDA events on the card, the
host clock on the CPU and around gloo's host staging); :meth:`Group.take`
hands the records over and clears them.

Three differentiable collectives carry tensor-parallel training (the
Megatron operators), each giving the same gradient on logical shards and
on ranks:

  * :func:`copy_to` -- a replicated tensor handed to every local shard:
    the identity going forward; going backward the shards' cotangents
    summed in rank order (the all-reduce). Every replicated value that
    feeds per-shard compute goes through it: were the shards to share the
    tensor, autograd would sum their cotangents in an order of its own on
    logical shards, and a rank would keep only its own part;
  * :func:`psum` -- the all-reduce going forward, the identity going
    backward;
  * :func:`all_gather` -- the shards' blocks concatenated going forward;
    going backward each shard takes its own block of the (replicated)
    cotangent.

A backward collective counts its bytes as its forward call was counted.
Over ranks every rank builds the same graph, so the backward pass (remat's
recompute included) issues its gloo calls in one order everywhere.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Parts = List[torch.Tensor]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def mark_seconds(mark) -> float:
    """A collective's seconds from its time mark: host-clock seconds as
    they are, a pair of CUDA events read once the second has passed."""
    if isinstance(mark, float):
        return mark
    start, end = mark
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def take_all(groups) -> Tuple[int, List[Any]]:
    """:meth:`Group.take` of each distinct group: the bytes summed, the
    time marks in order."""
    nbytes, marks = 0, []
    for g in {id(g): g for g in groups}.values():
        b, m = g.take()
        nbytes += b
        marks += m
    return nbytes, marks


def rank_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right (the all-reduce's fixed
    order)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class Group:
    """One mesh axis's collectives; see the module docstring."""

    kind = "?"
    size = 1
    local: List[int] = [0]

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        # (bytes into one shard, a mark: host seconds or a CUDA event pair)
        self._records: List[Tuple[int, Any]] = []
        # False while a process runs a second data shard's copy of the same
        # collectives (logical shards): timed, its bytes not counted again
        self.counting = True

    # -- accounting ---------------------------------------------------------
    def _record(self, nbytes: int, mark) -> None:
        self._records.append((nbytes if self.counting else 0, mark))

    def _timed(self, nbytes: int, fn: Callable[[], Any], events: bool):
        if events and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self._record(nbytes, (start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        self._record(nbytes, time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def counted(self, on: bool):
        """Count this group's bytes (or not) inside the block."""
        was, self.counting = self.counting, on
        try:
            yield
        finally:
            self.counting = was

    def take(self) -> Tuple[int, List[Any]]:
        """(bytes moved into one shard, time marks) since the last take."""
        records, self._records = self._records, []
        return sum(b for b, _ in records), [m for _, m in records]

    # -- the interface --------------------------------------------------------
    def all_gather_list(self, parts: Parts) -> Parts:
        """Every shard's tensor, in rank order."""
        raise NotImplementedError

    def all_gather(self, parts: Parts, dim: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every shard's tensor concatenated along ``dim``, in rank order
        (into ``out`` when given)."""
        raise NotImplementedError

    def all_reduce(self, parts: Parts) -> torch.Tensor:
        """The sum of every shard's tensor, in rank order."""
        raise NotImplementedError

    def ppermute(self, parts: Parts,
                 perm: Sequence[Tuple[int, int]]) -> Parts:
        """Shard ``dst`` receives shard ``src``'s tensor for each ``(src,
        dst)`` of ``perm``; returns what the local shards receive."""
        raise NotImplementedError

    def broadcast(self, t: Optional[torch.Tensor], src: int, shape,
                  dtype) -> torch.Tensor:
        """Shard ``src``'s tensor (``t`` where this process holds ``src``;
        ``shape``/``dtype`` describe it everywhere)."""
        raise NotImplementedError

    def barrier(self) -> None:
        """Wait until every shard of the group reaches this point."""

    @property
    def measures(self) -> str:
        """What a collective's measured time is on this group."""
        raise NotImplementedError


class DryGroup(Group):
    """One rank's view of ``n`` ranks with no data behind the others: the
    rank is shard ``index``, and every other shard's tensor is an empty
    one of the rank's own shape and dtype. The results have the shapes and
    the ops of :class:`RankGroup`'s (an all-reduce is an all-gather and a
    sum in rank order), so a step under ``FakeTensorMode`` lowers to the
    program a rank runs, and the bytes into one shard are counted alike,
    and also by kind (``kinds``: all_gather, all_reduce, ppermute,
    broadcast; cleared by the caller). Nothing is timed: a mark is 0
    seconds."""

    kind = "dry"

    def __init__(self, n: int, device, index: int = 0):
        super().__init__(device)
        self.size = int(n)
        self.local = [int(index)]
        self.kinds: Dict[str, int] = {}

    def _count(self, kind: str, nbytes: int) -> None:
        self._record(nbytes, 0.0)
        if self.counting:
            self.kinds[kind] = self.kinds.get(kind, 0) + nbytes

    def _others(self, part: torch.Tensor, kind: str) -> Parts:
        self._count(kind, (self.size - 1) * _nbytes(part))
        return [part if i == self.local[0] else torch.empty_like(part)
                for i in range(self.size)]

    def all_gather_list(self, parts: Parts) -> Parts:
        (part,) = parts
        if self.size == 1:
            return [part]
        return self._others(part, "all_gather")

    def all_gather(self, parts: Parts, dim: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.size == 1:
            return parts[0] if out is None else out.copy_(parts[0])
        return torch.cat(self.all_gather_list(parts), dim=dim, out=out)

    def all_reduce(self, parts: Parts) -> torch.Tensor:
        if self.size == 1:
            return parts[0]
        (part,) = parts
        return rank_sum(self._others(part, "all_reduce"))

    def ppermute(self, parts: Parts, perm) -> Parts:
        (part,) = parts
        got = sum(1 for _, dst in perm if dst == self.local[0])
        self._count("ppermute", _nbytes(part) * got)
        return [torch.zeros_like(part)]

    def broadcast(self, t, src, shape, dtype):
        self._count("broadcast", _numel(shape) * dtype.itemsize)
        if self.local[0] == src:
            return t
        return torch.empty(shape, dtype=dtype, device=self.device)

    @property
    def measures(self) -> str:
        return "nothing: a dry run moves no data and times nothing"


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class LocalGroup(Group):
    """``n`` logical shards in one process on one device."""

    kind = "local"

    def __init__(self, n: int, device):
        super().__init__(device)
        self.size = int(n)
        self.local = list(range(self.size))

    def all_gather_list(self, parts: Parts) -> Parts:
        self._record((self.size - 1) * _nbytes(parts[0]), 0.0)
        return list(parts)

    def all_gather(self, parts: Parts, dim: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.size == 1:
            return parts[0] if out is None else out.copy_(parts[0])
        return self._timed((self.size - 1) * _nbytes(parts[0]),
                           lambda: torch.cat(parts, dim=dim, out=out),
                           events=True)

    def all_reduce(self, parts: Parts) -> torch.Tensor:
        if self.size == 1:
            return parts[0]
        return self._timed((self.size - 1) * _nbytes(parts[0]),
                           lambda: rank_sum(parts), events=True)

    def ppermute(self, parts: Parts, perm) -> Parts:
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for src, dst in perm:
            out[dst] = parts[src]
        self._record(_nbytes(parts[0]), 0.0)
        return [o if o is not None else torch.zeros_like(parts[i])
                for i, o in enumerate(out)]

    @property
    def measures(self) -> str:
        return ("the weight gather's copy and the reductions' sums in device "
                "memory, one device, no link")


def choose_backend(device: torch.device, devices: Sequence[str]) -> str:
    """The process-group backend of a mesh over ranks: NCCL when the ranks
    are on the card, one card each; gloo on the CPU or when ranks share a
    card (NCCL refuses two ranks on one device). ``devices`` lists every
    rank's device."""
    if device.type == "cuda" and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


class RankGroup(Group):
    """One shard per process: ``ranks`` (global ranks, in group order) of
    an initialized ``torch.distributed`` world, ``pg`` their process
    group."""

    def __init__(self, pg, ranks: Sequence[int], backend: str, device):
        super().__init__(device)
        import torch.distributed as dist

        self.pg = pg
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.kind = backend
        self.local = [self.ranks.index(dist.get_rank())]
        # gloo moves host tensors: a card's tensors are staged through host
        # memory by the group itself
        self._stage = backend == "gloo" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._stage else t.to(self.device)

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._stage else t

    def _gather(self, part: torch.Tensor) -> Parts:
        import torch.distributed as dist

        src = self._out(part.contiguous())
        got = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(got, src, group=self.pg)
        return [self._in(g) for g in got]

    def all_gather_list(self, parts: Parts) -> Parts:
        (part,) = parts
        if self.size == 1:
            return [part]
        return self._timed((self.size - 1) * _nbytes(part),
                           lambda: self._gather(part),
                           events=self.kind == "nccl")

    def all_gather(self, parts: Parts, dim: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.size == 1:
            return parts[0] if out is None else out.copy_(parts[0])
        return torch.cat(self.all_gather_list(parts), dim=dim, out=out)

    def all_reduce(self, parts: Parts) -> torch.Tensor:
        if self.size == 1:
            return parts[0]
        return rank_sum(self.all_gather_list(parts))

    def ppermute(self, parts: Parts, perm) -> Parts:
        import torch.distributed as dist

        (part,) = parts
        me = self.local[0]
        send_to = [dst for src, dst in perm if src == me]
        recv_from = [src for src, dst in perm if dst == me]

        def run():
            src_t = self._out(part.contiguous())
            got = torch.zeros_like(src_t)
            ops = [dist.P2POp(dist.isend, src_t, self.ranks[d], self.pg)
                   for d in send_to]
            ops += [dist.P2POp(dist.irecv, got, self.ranks[s], self.pg)
                    for s in recv_from]
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return [self._in(got)]

        return self._timed(_nbytes(part) * len(recv_from), run,
                           events=self.kind == "nccl")

    def broadcast(self, t, src, shape, dtype):
        import torch.distributed as dist

        if self.local[0] == src:
            buf = self._out(t.contiguous())
        else:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if self._stage else self.device)

        def run():
            dist.broadcast(buf, self.ranks[src], group=self.pg)
            return self._in(buf)

        return self._timed(_nbytes(buf), run, events=self.kind == "nccl")

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.pg)

    @property
    def measures(self) -> str:
        if self.kind == "nccl":
            return "NCCL over the link between the cards"
        if self._stage:
            return "gloo through host memory, ranks sharing one card, no link"
        return "gloo between processes on the host"


# ---------------------------------------------------------------------------
# the reference's shard_map vocabulary over a group
# ---------------------------------------------------------------------------

def axis_size(group: Group) -> int:
    return group.size


def axis_index(group: Group) -> List[int]:
    """The shard index of each local shard (one for a rank)."""
    return list(group.local)


class _PPermute(torch.autograd.Function):
    """``group.ppermute`` with the reverse permutation as its backward."""

    @staticmethod
    def forward(ctx, group, perm, *parts):
        ctx.group, ctx.perm = group, list(perm)
        return tuple(o.view_as(o) for o in group.ppermute(list(parts), perm))

    @staticmethod
    def backward(ctx, *grads):
        back = [(dst, src) for src, dst in ctx.perm]
        return (None, None, *ctx.group.ppermute(
            [g.contiguous() for g in grads], back))


class _PSum(torch.autograd.Function):
    """``group.all_reduce`` of the local parts into one replicated tensor;
    each part's gradient is the result's (a replicated value's cotangent
    reaches every shard once)."""

    @staticmethod
    def forward(ctx, group, *parts):
        ctx.n = len(parts)
        return group.all_reduce(list(parts)).clone()

    @staticmethod
    def backward(ctx, grad):
        return (None, *[grad] * ctx.n)


class _CopyTo(torch.autograd.Function):
    """A replicated tensor as one tensor a local shard; the gradient is
    the shards' cotangents all-reduced (summed in rank order)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group, ctx.counting = group, group.counting
        return tuple(x.view_as(x) for _ in group.local)

    @staticmethod
    def backward(ctx, *grads):
        with ctx.group.counted(ctx.counting):
            return None, ctx.group.all_reduce([g.contiguous() for g in grads])


class _AllGather(torch.autograd.Function):
    """``group.all_gather`` along ``dim``; each local part's gradient is
    its own block of the result's."""

    @staticmethod
    def forward(ctx, group, dim, *parts):
        ctx.group, ctx.dim = group, dim
        out = group.all_gather(list(parts), dim)
        return out.view_as(out) if out is parts[0] else out

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.group.size
        return (None, None, *[grad.narrow(ctx.dim, i * n, n)
                              for i in ctx.group.local])


def ppermute(parts: Parts, group: Group, perm) -> Parts:
    """Shard ``dst`` receives shard ``src``'s tensor for each ``(src,
    dst)``; differentiable: the gradient travels the reverse permutation
    (over ranks a send and a receive in the backward pass too, so every
    rank runs its backward in step)."""
    return list(_PPermute.apply(group, list(perm), *parts))


def psum(parts: Parts, group: Group) -> torch.Tensor:
    """The sum of every shard's tensor, in rank order, as one replicated
    tensor (every rank holds it); differentiable, each local part's
    gradient being the result's."""
    return _PSum.apply(group, *parts)


def all_gather(parts: Parts, group: Group, dim: int = 0) -> torch.Tensor:
    """Every shard's tensor concatenated along ``dim``, in rank order;
    differentiable, each local part's gradient being its block of the
    result's (whose cotangent is replicated: what follows the gather runs
    alike on every shard)."""
    return _AllGather.apply(group, dim, *parts)


def copy_to(x: torch.Tensor, group: Group) -> Parts:
    """The replicated ``x`` once a local shard, for per-shard compute:
    the identity going forward; going backward the local shards'
    cotangents all-reduced into ``x``'s (Megatron's "f")."""
    return list(_CopyTo.apply(group, x))


def split(x: torch.Tensor, group: Group, dim: Optional[int]) -> Parts:
    """The local shards' blocks of ``x`` along ``dim`` (``x`` itself for
    each when ``dim`` is None: replicated)."""
    if dim is None:
        return [x for _ in group.local]
    n = x.shape[dim] // group.size
    return [x.narrow(dim, i * n, n) for i in group.local]


def shard_map(f, group: Group, in_dims: Sequence[Optional[int]],
              out_dim: Optional[int]):
    """``f(*per-shard lists) -> per-shard list`` over ``group``: each input
    split along its entry of ``in_dims`` (None: replicated), the outputs
    concatenated along ``out_dim`` into the global array (every rank gets
    it whole), or the first shard's output when ``out_dim`` is None
    (replicated)."""
    def run(*arrays):
        outs = f(*[split(a, group, d) for a, d in zip(arrays, in_dims)])
        if out_dim is None:
            return outs[0]
        return all_gather(outs, group, out_dim)
    return run
