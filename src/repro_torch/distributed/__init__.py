"""Distributed layer (port of ``repro.distributed``): the sharding rules
the mesh engine places weights and caches by and the train state's specs,
gradient compression, and fault tolerance. The reference's overlap
collectives and pipeline wait for ROADMAP.md queue A item 21."""

from repro_torch.distributed import sharding

__all__ = ["sharding"]
