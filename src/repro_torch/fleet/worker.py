"""One attested engine worker (port of ``repro.fleet.worker``): an Engine in
its own TrustDomain, plus the surfaces the gateway and orchestrator use.

State machine (the orchestrator drives the transitions)::

    ATTESTING --admit (quote verifies)--> READY
        |                                   |  drain()/kill()
        +--admit fails (bad quote)--+       v
                                    +--> DRAINING/DEAD

A worker holds three kinds of key material:

  * its domain's own sealing key, for local preemption and handoff blobs;
    it never leaves the worker, so those blobs restore nowhere else;
  * a gateway transport key, released only after this worker's quote
    verified, which opens prompt envelopes addressed to this worker;
  * per-tenant key domains, released per (worker, tenant) after a fresh
    quote each, for sealed-KV migration blobs. The material derives from
    the gateway's master secret, so every attested worker holds the same
    tenant domain and a migrant sealed on one restores on another, while
    one tenant's blob fails MAC under another tenant's domain.

The worker's engine runs where ``engine_kw["device"]`` says (the card by
default), and its TrustDomain seals and unseals there too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.confidential import TrustDomain
from repro_torch.core.sealing import SealingKey, unseal_tensor
from repro_torch.runtime.engine import Engine, PreemptedRequest
from repro_torch.runtime.scheduler import Request

ATTESTING = "attesting"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"
WORKER_STATES = (ATTESTING, READY, DRAINING, DEAD)


class EngineWorker:
    """One fleet worker: ``Engine`` + ``TrustDomain`` + released keys.

    ``name`` must be unique among live workers: it is part of the
    migration nonce namespace (``kvmigrate/{name}/...``), which is what
    keeps two workers' migration seals apart under the shared tenant key
    domains. Workers given the same ``params`` share them (no copy)."""

    def __init__(self, name: str, model, params, *, tee: str = "tdx",
                 engine_kw: Optional[Dict[str, Any]] = None):
        kw = dict(engine_kw or {})
        self.name = name
        self.td = TrustDomain(tee, device=kw.get("device"))
        self.engine = Engine(model, params, trust_domain=self.td, **kw)
        self.state = ATTESTING
        self.tenant_keys: Dict[str, SealingKey] = {}
        self.transport: Optional[SealingKey] = None

    def __repr__(self):
        return f"EngineWorker({self.name!r}, state={self.state})"

    # -- attestation-released material --------------------------------------
    def quote(self, nonce: str, config_repr: str = ""):
        return self.td.quote(nonce, config_repr)

    def install_transport(self, material: bytes) -> None:
        """Adopt the gateway's envelope-transport key (received over the
        attested channel the key release models)."""
        self.transport = SealingKey.generate(material)

    def install_tenant_key(self, tenant: str, material: bytes) -> None:
        self.tenant_keys[tenant] = self.td.adopt_tenant_material(tenant,
                                                                 material)

    def key_for(self, req: Request) -> SealingKey:
        """The sealing domain a migration of ``req`` must use: its tenant's
        fleet-shared key domain. A tenant this worker holds no released key
        for cannot migrate; a tenant-less request falls back to the worker
        key, which only a single-worker deployment may use."""
        tenant = req.gen.tenant
        if tenant is None:
            return self.td.sealing_key
        try:
            return self.tenant_keys[tenant]
        except KeyError:
            raise KeyError(f"worker {self.name!r} holds no released key "
                           f"domain for tenant {tenant!r}") from None

    # -- envelopes -----------------------------------------------------------
    def open_envelope(self, env) -> np.ndarray:
        """Unwrap a gateway prompt envelope: the content key unseals under
        this worker's transport key (an envelope addressed to another
        worker, or tampered in transit, fails MAC before any plaintext
        exists), then the prompt unseals under the content key."""
        if self.transport is None:
            raise RuntimeError(f"worker {self.name!r} is not attested — no "
                               f"transport key released")
        blob = unseal_tensor(self.transport,
                             env.key_blob).cpu().numpy().tobytes()
        content = SealingKey(blob[:32], blob[32:])
        return unseal_tensor(content, env.sealed_prompt).cpu().numpy()

    # -- placement inputs ----------------------------------------------------
    def _live_requests(self) -> List[Request]:
        e = self.engine
        live = list(e.scheduler.running.values())
        live += [r for _, _, r in e.scheduler.queue]
        live += [p.req for p in e._preempted]
        live += [i.req for i in e._inflight.values()]
        return live

    def load(self) -> int:
        """Effective KV demand parked on this worker (the least-loaded
        metric). ``kv_need`` is already net of resident shared pages on a
        prefix-sharing backend, so affinity traffic reads as cheap."""
        return sum(r.kv_need for r in self._live_requests())

    def serves_tenant(self, tenant: str) -> bool:
        return any(r.gen.tenant == tenant for r in self._live_requests())

    # -- migration -----------------------------------------------------------
    def export_state(self) -> Tuple[List[PreemptedRequest], List[Request]]:
        """Seal all live state out under the per-tenant key domains, in this
        worker's own ``kvmigrate/{name}`` namespace (see
        :meth:`Engine.export_sealed_state`)."""
        return self.engine.export_sealed_state(
            key_for=self.key_for, namespace=f"kvmigrate/{self.name}")
