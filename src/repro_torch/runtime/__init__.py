"""Serving runtime (port of ``repro.runtime``): request-object API, engine,
compute plans, slot and paged KV backends, the sealed-page store,
scheduler, seeded sampling.

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
from repro_torch.runtime.kvcache import (KVBackend, SlotDenseBackend,
                                         SlotState, make_backend)
from repro_torch.runtime.pagestore import SealedPageStore
from repro_torch.runtime.plan import PrefillOnlyPlan, SingleDevicePlan
from repro_torch.runtime.scheduler import (Request, Scheduler, ServeStats,
                                           stats_from_requests)

__all__ = [
    "FINISH_ABORTED", "FINISH_DROPPED", "FINISH_LENGTH", "FINISH_REJECTED",
    "FINISH_STOP",
    "FramePolicy", "GenerationRequest", "RequestOutput", "SamplingParams",
    "Engine", "KVBackend", "SlotDenseBackend", "SlotState", "make_backend",
    "PrefillOnlyPlan", "SealedPageStore", "SingleDevicePlan",
    "Request", "Scheduler", "ServeStats", "stats_from_requests",
]
