"""Serving meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is a ``("data", "model")`` grid of logical shards over ONE
physical torch device: the card, or the CPU in tests. The reference builds
its host mesh by forcing N virtual XLA devices onto one host; the port keeps
every shard on one device instead. The weights still sit at rest in
per-shard chunks, the plan's gather still copies them every step (counted
and timed), and the row-to-shard map still decides the sealed names
(:class:`~repro_torch.runtime.plan.ShardedPlan`). Compute that spans several
cards is ROADMAP.md queue A item 21.

Not ported: ``ensure_host_devices`` (the port needs no forced device count
and never re-execs itself) and ``make_production_mesh`` (the 16x16 TPU pod
of ``dryrun.py``, ROADMAP.md queue A item 19).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device

AXES = ("data", "model")


class Mesh:
    """Axis sizes (``shape``, keyed by ``axis_names``) and the one physical
    device every shard lives on."""

    axis_names: Tuple[str, ...] = AXES

    def __init__(self, shape: Dict[str, int], device: torch.device):
        self.shape = {a: int(shape[a]) for a in AXES}
        self.device = device

    @property
    def size(self) -> int:
        """Logical shards (the product of the axis sizes)."""
        return self.shape["data"] * self.shape["model"]


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Union[None, str, torch.device] = None) -> Mesh:
    """A ``data x model`` mesh on ``device``, the one device every shard
    lives on: the card unless the caller asks for the CPU, as
    ``resolve_device`` decides. A list of devices is refused: a mesh over
    several cards is ROADMAP.md queue A item 21."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            f"a mesh over {len(device)} devices is not ported yet (ROADMAP.md "
            f"queue A item 21); a mesh's shards live on one device")
    return Mesh({"data": data, "model": model}, resolve_device(device))
