"""Serving meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is a ``("data", "model")`` grid of shards with a
collective group for each axis (:mod:`repro_torch.distributed.collectives`):

  * **logical shards** (no process group initialized): every shard lives
    on ONE physical torch device, the card or the CPU in tests, and the
    groups are :class:`~repro_torch.distributed.collectives.LocalGroup`\\ s.
    The reference builds its host mesh by forcing N virtual XLA devices onto
    one host; the port keeps every shard on one device instead;
  * **ranks** (``torch.distributed`` initialized with world size ``data *
    model``, one device per rank): rank ``r`` sits at ``(r // model, r %
    model)``, the row-major device order of jax's ``make_mesh``, and the
    groups are :class:`~repro_torch.distributed.collectives.RankGroup`\\ s
    over the rank's row (``model``) and column (``data``). The backend is
    NCCL when every rank has a card of its own, gloo otherwise.

Not ported: ``ensure_host_devices`` (the port needs no forced device count
and never re-execs itself) and ``make_production_mesh`` (the 16x16 TPU pod
of ``dryrun.py``, ROADMAP.md queue A item 19).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (Group, LocalGroup,
                                                 RankGroup, choose_backend)

AXES = ("data", "model")


class Mesh:
    """Axis sizes (``shape``, keyed by ``axis_names``), the device this
    process's shards live on, and a collective group per axis
    (``groups["data"]``, ``groups["model"]``). ``coords`` is this rank's
    ``(data, model)`` position, None for logical shards."""

    axis_names: Tuple[str, ...] = AXES

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 groups: Dict[str, Group], coords=None, backend=None,
                 world=None):
        self.shape = {a: int(shape[a]) for a in AXES}
        self.device = device
        self.groups = groups
        self.coords = coords
        self.backend = backend
        self.world = world
        # every shard in row-major order (a ("data", "model") spec entry)
        self.flat = world if world is not None else LocalGroup(
            self.shape["data"] * self.shape["model"], device)

    @property
    def size(self) -> int:
        """Shards (the product of the axis sizes)."""
        return self.shape["data"] * self.shape["model"]

    @property
    def spans_ranks(self) -> bool:
        return self.coords is not None

    def group(self, axis) -> Group:
        """The collective group of a spec entry: ``"data"``, ``"model"``,
        or both in row-major order."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if isinstance(axis, tuple):
            if axis != AXES:
                raise ValueError(f"no group runs over the axes {axis} in "
                                 f"that order; the mesh's order is {AXES}")
            return self.flat
        return self.groups[axis]

    def rank_of(self, data: int, model: int) -> int:
        """The global rank at ``(data, model)``."""
        return data * self.shape["model"] + model

    def describe(self) -> str:
        if not self.spans_ranks:
            return f"{self.size} shards on 1 physical device, {self.device}"
        return (f"{self.size} ranks over {self.backend}, one {self.device.type}"
                f" device each; this is rank {self.rank_of(*self.coords)} at "
                f"data {self.coords[0]}, model {self.coords[1]}")


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Union[None, str, torch.device] = None) -> Mesh:
    """A ``data x model`` mesh on ``device`` (the card unless the caller
    asks for the CPU, as ``resolve_device`` decides): over the ranks of the
    initialized ``torch.distributed`` world, whose size must be ``data *
    model``, else logical shards on the one device. A list of devices is
    refused: a mesh spans ranks, one device each."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    if isinstance(device, (list, tuple)):
        raise ValueError(
            f"a mesh takes one device per process, not {len(device)}: it "
            f"spans ranks, one device each (launch {len(device)} ranks with "
            f"torchrun and give each its device), or logical shards on one "
            f"device")
    dev = resolve_device(device)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return Mesh({"data": data, "model": model}, dev,
                    {"data": LocalGroup(data, dev),
                     "model": LocalGroup(model, dev)})
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(
            f"mesh dp={data},tp={model} needs {data * model} ranks but "
            f"torch.distributed has {world}; launch {data * model} ranks "
            f"(torchrun --nproc-per-node {data * model}) or shrink the mesh")
    rank = dist.get_rank()
    devices = [None] * world
    dist.all_gather_object(devices, str(dev))
    backend = choose_backend(dev, devices)
    coords = (rank // model, rank % model)
    groups: Dict[str, Group] = {}
    # every rank creates every subgroup, in one order
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        pg = dist.new_group(ranks, backend=backend)
        if d == coords[0]:
            groups["model"] = RankGroup(pg, ranks, backend, dev)
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        pg = dist.new_group(ranks, backend=backend)
        if m == coords[1]:
            groups["data"] = RankGroup(pg, ranks, backend, dev)
    pg = dist.new_group(list(range(world)), backend=backend)
    return Mesh({"data": data, "model": model}, dev, groups, coords=coords,
                backend=backend, world=RankGroup(pg, list(range(world)),
                                                 backend, dev))


def join_world(device=None):
    """Under torchrun (``WORLD_SIZE`` above 1): join the world (gloo for
    the default group; a mesh's own groups pick NCCL or gloo), take this
    rank's card unless ``device`` names one, and silence every rank but 0.
    Returns ``(rank, device)``, the rank None outside torchrun."""
    if int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return None, device
    import torch.distributed as dist

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % max(torch.cuda.device_count(), 1)}"
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    return rank, device


def shared_keys():
    """Rank 0's sealing and channel key material, broadcast to every rank
    (inside the trust boundary): the ranks' trust domains seal and unseal
    each other's rows and checkpoints."""
    import torch.distributed as dist
    from repro_torch.core.sealing import SealingKey

    seeds = [os.urandom(32), os.urandom(32)]
    dist.broadcast_object_list(seeds, src=0)
    return dict(sealing_key=SealingKey.generate(seeds[0]),
                io_key=SealingKey.generate(seeds[1]))
