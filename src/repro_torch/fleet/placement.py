"""Placement policies (port of ``repro.fleet.placement``): which READY
worker gets a request.

A policy is ``(workers, gen) -> EngineWorker`` over a non-empty list of
ready workers. Ties break on the worker's name, so placement is
reproducible for a given submission order.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from repro_torch.fleet.worker import EngineWorker
from repro_torch.runtime.api import GenerationRequest


def least_loaded(workers: List[EngineWorker],
                 gen: GenerationRequest) -> EngineWorker:
    """Lowest effective KV demand wins (net of resident shared pages)."""
    return min(workers, key=lambda w: (w.load(), w.name))


def tenant_affinity(workers: List[EngineWorker],
                    gen: GenerationRequest) -> EngineWorker:
    """Prefer a worker already serving this tenant: its content index
    likely holds the tenant's shared prompt prefixes, so the request maps
    pages instead of writing them. Least-loaded over the whole pool when no
    worker serves the tenant yet (or the request has no tenant)."""
    if gen.tenant is not None:
        serving = [w for w in workers if w.serves_tenant(gen.tenant)]
        if serving:
            return least_loaded(serving, gen)
    return least_loaded(workers, gen)


def store_affinity(workers: List[EngineWorker],
                   gen: GenerationRequest) -> EngineWorker:
    """Prefer the worker whose live page index and sealed-page store hold
    the most pages of this prompt (by content key only, never page data),
    so a recurring prompt restores MAC-verified pages instead of a cold
    prefill. Least-loaded on an all-cold prompt or among equally warm
    workers."""
    def coverage(w: EngineWorker) -> int:
        kv = getattr(w.engine, "kv", None)
        if kv is None or not getattr(kv, "supports_sharing", False):
            return 0
        prompt = np.asarray(gen.prompt, np.int32)
        keys = kv.page_keys(prompt, len(prompt))
        if not keys:
            return 0
        return kv.resident_pages(keys) + kv.store_resident_pages(keys)
    cover = {w.name: coverage(w) for w in workers}
    best = max(cover.values())
    if best > 0:
        return least_loaded([w for w in workers if cover[w.name] == best],
                            gen)
    return least_loaded(workers, gen)


PLACEMENTS: Dict[str, Callable[[List[EngineWorker], GenerationRequest],
                               EngineWorker]] = {
    "least_loaded": least_loaded,
    "tenant_affinity": tenant_affinity,
    "store_affinity": store_affinity,
}
