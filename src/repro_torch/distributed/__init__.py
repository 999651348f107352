"""Distributed layer (port of ``repro.distributed``): the sharding rules
the mesh engine places weights and caches by. The reference's overlap
collectives, pipeline, compression and fault tolerance wait for ROADMAP.md
queue A items 19 and 20."""

from repro_torch.distributed import sharding

__all__ = ["sharding"]
