"""Distributed layer (port of ``repro.distributed``): the sharding rules
the mesh engine places weights and caches by and the sharded trainer its
state and batch, placement onto a mesh's shards and gathering back, the
collectives of a mesh axis over logical shards or ranks (differentiable
``ppermute`` and ``psum`` among them), the dense family's tensor-parallel
compute, the ring collective matmuls, the GPipe schedule, gradient
compression, and fault tolerance with elastic rescale."""

from repro_torch.distributed import (collectives, overlap, pipeline,
                                     sharding, tensor_parallel)
from repro_torch.distributed.collectives import (LocalGroup, RankGroup,
                                                 shard_map)
from repro_torch.distributed.pipeline import gpipe_local, make_gpipe
from repro_torch.distributed.sharding import Placed, gather, place

__all__ = ["collectives", "overlap", "pipeline", "sharding",
           "tensor_parallel", "LocalGroup", "RankGroup", "shard_map",
           "gpipe_local", "make_gpipe", "Placed", "gather", "place"]
