"""Serving runtime (port of ``repro.runtime``): request-object API, engine,
compute plans (one device, or a mesh of data and tensor-parallel shards,
logical on one device or ranks of a process group), slot and
paged KV backends with the per-shard sealing wrapper, the sealed-page
store, scheduler, seeded sampling.

Typical use::

    from repro_torch.runtime import Engine, GenerationRequest

    req = engine.submit(GenerationRequest(prompt=tokens, max_new_tokens=64))
    engine.run()
    out = req.result()          # RequestOutput
"""

from repro_torch.runtime.api import (FINISH_ABORTED, FINISH_DROPPED,
                                     FINISH_LENGTH, FINISH_REJECTED,
                                     FINISH_STOP, FramePolicy,
                                     GenerationRequest, RequestOutput,
                                     SamplingParams)
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.kvcache import (KVBackend, ShardedKVBackend,
                                         SlotDenseBackend, SlotState,
                                         make_backend)
from repro_torch.runtime.pagestore import SealedPageStore
from repro_torch.runtime.plan import (ComputePlan, PrefillOnlyPlan,
                                      ShardedPlan, ShardedWeights,
                                      SingleDevicePlan, parse_mesh)
from repro_torch.runtime.scheduler import (Request, Scheduler, ServeStats,
                                           stats_from_requests)

__all__ = [
    "FINISH_ABORTED", "FINISH_DROPPED", "FINISH_LENGTH", "FINISH_REJECTED",
    "FINISH_STOP",
    "FramePolicy", "GenerationRequest", "RequestOutput", "SamplingParams",
    "Engine", "KVBackend", "ShardedKVBackend", "SlotDenseBackend",
    "SlotState", "make_backend",
    "ComputePlan", "PrefillOnlyPlan", "SealedPageStore", "ShardedPlan",
    "ShardedWeights", "SingleDevicePlan", "parse_mesh",
    "Request", "Scheduler", "ServeStats", "stats_from_requests",
]
