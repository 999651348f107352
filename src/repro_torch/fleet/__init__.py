"""Multi-tenant confidential serving fleet (port of ``repro.fleet``):
attested gateway -> orchestrator -> engine workers.

  * :class:`~repro_torch.fleet.gateway.Gateway`: the key broker at the front
    door. It verifies each worker's attestation quote before admitting it,
    releases per-tenant key domains (derived from its master secret, so a
    tenant's sealed KV fails MAC under another tenant's domain), and
    envelope-encrypts prompts to exactly one attested worker.
  * :class:`~repro_torch.fleet.worker.EngineWorker`: one
    :class:`~repro_torch.runtime.engine.Engine` in its own
    :class:`~repro_torch.core.confidential.TrustDomain`, stepping through
    ATTESTING -> READY -> DRAINING -> DEAD.
  * :class:`~repro_torch.fleet.orchestrator.Orchestrator`: routes requests
    over the fleet with a placement policy
    (:mod:`repro_torch.fleet.placement`), holds tenants to their token
    budgets, and on a worker's failure or drain migrates its in-flight KV,
    sealed under the tenant domains in a ``kvmigrate/{worker}/...`` nonce
    namespace, to a survivor, where every request finishes with the tokens
    it would have had alone.

Workers that share one card share one copy of the weights.
"""

from repro_torch.fleet.gateway import Envelope, Gateway, GatewayStats
from repro_torch.fleet.orchestrator import FleetStats, Orchestrator
from repro_torch.fleet.placement import (PLACEMENTS, least_loaded,
                                         tenant_affinity)
from repro_torch.fleet.worker import (ATTESTING, DEAD, DRAINING, READY,
                                      EngineWorker, WORKER_STATES)

__all__ = [
    "Envelope", "Gateway", "GatewayStats",
    "FleetStats", "Orchestrator",
    "PLACEMENTS", "least_loaded", "tenant_affinity",
    "ATTESTING", "READY", "DRAINING", "DEAD", "WORKER_STATES",
    "EngineWorker",
]
