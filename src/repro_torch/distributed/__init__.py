"""Distributed layer (port of ``repro.distributed``): the sharding rules
the mesh engine places weights and caches by and the train state's specs,
the collectives of a mesh axis over logical shards or ranks, the dense
family's tensor-parallel compute, the ring collective matmuls, gradient
compression, and fault tolerance. The reference's pipeline schedule waits
for ROADMAP.md queue A item 21 part 2."""

from repro_torch.distributed import (collectives, overlap, sharding,
                                     tensor_parallel)
from repro_torch.distributed.collectives import (LocalGroup, RankGroup,
                                                 shard_map)

__all__ = ["collectives", "overlap", "sharding", "tensor_parallel",
           "LocalGroup", "RankGroup", "shard_map"]
