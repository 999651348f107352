"""Fleet orchestrator (port of ``repro.fleet.orchestrator``): routing,
tenant budgets, failure and drain migration.

The orchestrator sits outside every trust domain: it sees only envelopes,
sealed migration blobs and encrypted egress frames, never plaintext.

  * routing: each submitted request is stamped with its tenant, its prompt
    is envelope-encrypted by the gateway to the placement-chosen worker,
    and that worker's engine admits it through its own admission gates;
  * tenant budgets: a token bucket per tenant (the engines' ``_RateBucket``)
    holds a tenant's overflow here, before any boundary crossing, and
    releases it as the budget refills;
  * failure and drain: ``kill()`` models an enclave loss whose sealed
    snapshot survives; ``drain()`` is its graceful twin. Both export the
    worker's state under the per-tenant key domains and hand it to
    surviving workers: sealed migrants join their restore queues and finish
    with the tokens they would have had alone (seeded sampling; the request
    object travels), queued requests re-queue. Migration is priced per
    request (``n_migrations``/``migrated_bytes`` -> ``ServeStats``) and per
    fleet (:class:`FleetStats`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.core.sealing import sealed_nbytes
from repro_torch.fleet.gateway import Gateway
from repro_torch.fleet.placement import PLACEMENTS
from repro_torch.fleet.worker import DEAD, DRAINING, READY, EngineWorker
from repro_torch.runtime.api import GenerationRequest
from repro_torch.runtime.engine import _RateBucket
from repro_torch.runtime.scheduler import (Request, ServeStats,
                                           stats_from_requests)


@dataclasses.dataclass
class FleetStats:
    submitted: int = 0
    held_budget: int = 0     # submissions parked on a tenant budget
    migrations: int = 0      # sealed cross-worker KV moves
    migrated_bytes: int = 0  # ciphertext bytes those moves carried
    requeued: int = 0        # queued (KV-less) requests moved on drain/kill
    kills: int = 0
    drains: int = 0
    respawns: int = 0


class Orchestrator:
    def __init__(self, gateway: Gateway, workers: List[EngineWorker], *,
                 placement: str = "least_loaded",
                 tenant_budgets: Optional[Dict[str, float]] = None,
                 default_tenant: str = "default",
                 worker_factory=None):
        """``tenant_budgets`` maps tenant -> tokens/s; tenants named there
        are registered. ``worker_factory(name) -> EngineWorker`` enables
        :meth:`respawn`. Every worker passed in is attested (and receives
        every tenant key domain) before any traffic routes."""
        try:
            self._placement = PLACEMENTS[placement]
        except KeyError:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"pick from {sorted(PLACEMENTS)}") from None
        self.gateway = gateway
        self._factory = worker_factory
        self.default_tenant = default_tenant
        gateway.register_tenant(default_tenant)
        for tenant in (tenant_budgets or {}):
            gateway.register_tenant(tenant)
        self._tenant_buckets = {t: _RateBucket(rate)
                                for t, rate in (tenant_budgets or {}).items()}
        self.workers: Dict[str, EngineWorker] = {}
        for w in workers:
            self.add_worker(w)
        self._pending: List[GenerationRequest] = []
        self.handles: Dict[int, Request] = {}    # id(gen) -> routed Request
        self.stats = FleetStats()

    # -- fleet membership -----------------------------------------------------
    def add_worker(self, worker: EngineWorker) -> None:
        if worker.name in self.workers and \
                self.workers[worker.name].state != DEAD:
            raise ValueError(f"worker name {worker.name!r} is already live "
                             f"(names key the migration nonce namespace)")
        self.gateway.admit(worker)
        self.workers[worker.name] = worker

    def ready_workers(self) -> List[EngineWorker]:
        return [w for w in self.workers.values() if w.state == READY]

    # -- submission / routing -------------------------------------------------
    def submit(self, gen: GenerationRequest) -> Optional[Request]:
        """Route one request into the fleet. Returns the live ``Request``
        handle, or None when the tenant's budget holds it at the gateway;
        it routes once the bucket refills (``handles`` then maps the
        submitted object to its handle)."""
        if gen.tenant is None:
            gen.tenant = self.default_tenant
        if gen.tenant not in self.gateway.tenants:
            raise KeyError(f"unknown tenant {gen.tenant!r} — register it on "
                           f"the gateway first")
        self.stats.submitted += 1
        bucket = self._tenant_buckets.get(gen.tenant)
        if bucket is not None and not bucket.can(gen.max_new_tokens):
            self._pending.append(gen)
            self.stats.held_budget += 1
            return None
        return self._route(gen)

    def _route(self, gen: GenerationRequest) -> Request:
        ready = self.ready_workers()
        if not ready:
            raise RuntimeError("no READY worker to route to")
        bucket = self._tenant_buckets.get(gen.tenant)
        if bucket is not None:
            bucket.charge(gen.max_new_tokens)
        worker = self._placement(ready, gen)
        env = self.gateway.envelope_seal(worker.name, gen.tenant, gen.prompt)
        gen.prompt = worker.open_envelope(env)
        req = worker.engine.submit(gen)
        self.handles[id(gen)] = req
        return req

    # -- serving loop ---------------------------------------------------------
    def step(self) -> int:
        """One fleet tick: retry budget-held submissions, then advance every
        live worker's engine one step. Returns tokens produced fleet-wide."""
        if self._pending:
            still = []
            for gen in self._pending:
                bucket = self._tenant_buckets.get(gen.tenant)
                if bucket is None or bucket.can(gen.max_new_tokens):
                    self._route(gen)
                else:
                    still.append(gen)
            self._pending = still
        produced = 0
        for w in self.workers.values():
            if w.state in (READY, DRAINING) and not w.engine.idle:
                produced += w.engine.step()
        return produced

    @property
    def idle(self) -> bool:
        return not self._pending and all(
            w.engine.idle for w in self.workers.values()
            if w.state in (READY, DRAINING))

    def run(self, max_steps: int = 10_000) -> ServeStats:
        steps = 0
        while not self.idle and steps < max_steps:
            produced = self.step()
            steps += 1
            if produced == 0 and (self._pending or not self.idle):
                # budget-held or rate-gated everywhere: let buckets refill
                time.sleep(1e-3)
        return self.fleet_stats()

    # -- failure / drain / respawn --------------------------------------------
    def kill(self, name: str) -> None:
        """Forced worker failure: the enclave is lost mid-flight, but its
        sealed snapshot (ciphertext under the per-tenant domains) survives
        and moves to surviving workers, where in-flight requests finish
        with the same tokens."""
        worker = self.workers[name]
        migrants, queued = worker.export_state()
        worker.state = DEAD
        self.stats.kills += 1
        self._redistribute(migrants, queued, exclude=name)

    def drain(self, name: str) -> None:
        """Graceful evacuation (host maintenance): stop admitting, seal the
        worker's state out under the tenant domains, move it, retire."""
        worker = self.workers[name]
        worker.state = DRAINING
        worker.engine.drain()
        migrants, queued = worker.export_state()
        self.stats.drains += 1
        self._redistribute(migrants, queued, exclude=name)
        worker.state = DEAD

    def _redistribute(self, migrants, queued, exclude: str) -> None:
        survivors = [w for w in self.ready_workers() if w.name != exclude]
        if not survivors and (migrants or queued):
            raise RuntimeError("no surviving READY worker to adopt the "
                               "exported state")
        for p in migrants:
            target = self._placement(survivors, p.req.gen)
            target.engine.import_sealed_state([p])
            self.stats.migrations += 1
            self.stats.migrated_bytes += sealed_nbytes(p.sealed)
        for req in queued:
            target = self._placement(survivors, req.gen)
            target.engine.import_sealed_state([], [req])
            self.stats.requeued += 1

    def respawn(self, name: str) -> EngineWorker:
        """Replace a DEAD worker: the factory builds a fresh one (a new
        TrustDomain: a respawn is a new enclave), the gateway attests it and
        releases every tenant domain to it again."""
        if not callable(self._factory):
            raise RuntimeError("no worker_factory configured")
        worker = self._factory(name)
        self.add_worker(worker)
        self.stats.respawns += 1
        return worker

    # -- observability --------------------------------------------------------
    def fleet_stats(self) -> ServeStats:
        reqs = []
        for w in self.workers.values():
            reqs += w.engine.scheduler.finished + w.engine.scheduler.dropped
        return stats_from_requests(reqs)

    def channel_totals(self) -> Dict[str, int]:
        """Boundary counters summed over every worker's TrustDomain."""
        totals = {"messages_in": 0, "messages_out": 0, "tokens_out": 0,
                  "seal_events": 0, "seal_bytes": 0,
                  "restore_events": 0, "restore_bytes": 0,
                  "store_hits": 0, "store_restored_bytes": 0,
                  "store_evictions": 0}
        for w in self.workers.values():
            ch = w.td.channel.stats
            for k in totals:
                totals[k] += getattr(ch, k)
        return totals
