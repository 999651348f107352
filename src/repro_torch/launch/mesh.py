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

  * **a dry mesh** (:func:`make_dry_mesh`, :func:`make_production_mesh`):
    one rank's view of a mesh that does not exist here, its groups
    :class:`~repro_torch.distributed.collectives.DryGroup`\\ s, for the dry
    run (``launch/dryrun.py``), which lowers a step under fake tensors.
    Its axes may lead with ``"pod"``: ``("pod", "data", "model")``.

Not ported: ``ensure_host_devices`` (the port needs no forced device count
and never re-execs itself).
"""

from __future__ import annotations

import itertools
import math
import os
import sys
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (DryGroup, Group,
                                                 LocalGroup, RankGroup,
                                                 choose_backend)

AXES = ("data", "model")


class Mesh:
    """Axis sizes (``shape``, keyed by ``axis_names``: ``("data",
    "model")``, or ``("pod", "data", "model")`` on a dry mesh), the device
    this process's shards live on, and a collective group per axis
    (``groups["data"]``, ``groups["model"]``; a dry mesh also keys a group
    by each tuple of its axes). ``coords`` is this rank's position, one
    index an axis, None for logical shards."""

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 groups: Dict[Any, Group], coords=None, backend=None,
                 world=None, axis_names: Tuple[str, ...] = AXES):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.device = device
        self.groups = groups
        self.coords = coords
        self.backend = backend
        self.world = world
        # every shard in row-major order (a spec entry naming every axis)
        self.flat = world if world is not None else LocalGroup(
            self.size, device)

    @property
    def size(self) -> int:
        """Shards (the product of the axis sizes)."""
        return math.prod(self.shape.values())

    @property
    def name(self) -> str:
        """The axis sizes joined by ``x`` ("16x16", "2x16x16")."""
        return "x".join(str(self.shape[a]) for a in self.axis_names)

    @property
    def spans_ranks(self) -> bool:
        return self.coords is not None

    def group(self, axis) -> Group:
        """The collective group of a spec entry: an axis, or a tuple of
        axes in the mesh's order (every axis: :attr:`flat`)."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if isinstance(axis, tuple):
            if axis == self.axis_names:
                return self.flat
            if axis not in self.groups:
                raise ValueError(f"no group runs over the axes {axis} in "
                                 f"that order; the mesh's order is "
                                 f"{self.axis_names}")
        return self.groups[axis]

    def rank_of(self, data: int, model: int) -> int:
        """The global rank at ``(data, model)``."""
        return data * self.shape["model"] + model

    def describe(self) -> str:
        if self.backend == "dry":
            return (f"one rank's view of {self.size} ranks ({self.name} over "
                    f"{', '.join(self.axis_names)}), fake tensors on "
                    f"{self.device}")
        if not self.spans_ranks:
            return f"{self.size} shards on 1 physical device, {self.device}"
        return (f"{self.size} ranks over {self.backend}, one {self.device.type}"
                f" device each; this is rank {self.rank_of(*self.coords)} at "
                f"data {self.coords[0]}, model {self.coords[1]}")


def make_dry_mesh(shape: Dict[str, int], device="cuda") -> Mesh:
    """One rank's view (the rank at every axis's 0) of a mesh of
    ``shape`` (axis name -> size, in mesh order: ``data`` and ``model``,
    led by ``pod`` or not), with a
    :class:`~repro_torch.distributed.collectives.DryGroup` for each axis
    and each tuple of axes in that order. The dry run's fake tensors
    allocate nothing of the model and carry ``device`` as it is named
    (indexing a fake CUDA tensor takes a CUDA device guard, so naming
    ``cuda`` needs a torch built with CUDA and a card visible)."""
    names = tuple(shape)
    if names not in (AXES, ("pod",) + AXES):
        raise ValueError(f"a dry mesh's axes are {AXES}, led by 'pod' or "
                         f"not, not {names}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)   # what fake tensors on "cuda" carry
    groups: Dict[Any, Group] = {}
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            size = math.prod(int(shape[a]) for a in axes)
            groups[axes[0] if r == 1 else axes] = DryGroup(size, dev)
    return Mesh(dict(shape), dev, groups, coords=(0,) * len(names),
                backend="dry", world=groups[names], axis_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """The production mesh as a dry mesh (:func:`make_dry_mesh`): 16 x 16
    = 256 chips over ``("data", "model")``, or two pods of them, 2 x 16 x
    16 = 512 over ``("pod", "data", "model")`` when ``multi_pod``."""
    if multi_pod:
        return make_dry_mesh({"pod": 2, "data": 16, "model": 16}, device)
    return make_dry_mesh({"data": 16, "model": 16}, device)


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
