"""The fleet's attested front door (port of ``repro.fleet.gateway``): quote
verification, per-tenant key release, and prompt envelopes.

The gateway holds the master secret and an expected measurement; a worker
gets key material only by presenting a fresh, correctly signed quote over
that measurement. Three releases, each gated on its own quote:

  1. admission: a transport key for prompt envelopes (per worker);
  2. tenant domains: ``derive_tenant_material(master, tenant)`` per
     (worker, tenant). Deterministic in (master, tenant), so every attested
     worker derives the same tenant sealing domain (what lets a sealed-KV
     migrant cross workers), while two tenants' domains are unrelated and a
     cross-tenant restore fails MAC;
  3. envelopes: each prompt is sealed under a fresh content key, and the
     content key rides sealed under the target worker's transport key, so
     only the worker it was addressed to can open it. The envelope is
     sealed on that worker's device (the card, for a worker on the card).

A worker whose quote fails is marked DEAD and counted in
``GatewayStats.rejected_quotes``; it never sees a key.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.core import attestation
from repro_torch.core.attestation import AttestationError
from repro_torch.core.sealing import SealedTensor, SealingKey, seal_tensor
from repro_torch.fleet.worker import DEAD, READY, EngineWorker


@dataclasses.dataclass
class GatewayStats:
    attested_workers: int = 0
    rejected_quotes: int = 0
    keys_released: int = 0      # per-tenant key-domain releases
    envelopes: int = 0
    envelope_bytes: int = 0


@dataclasses.dataclass
class Envelope:
    """One prompt, encrypted to one attested worker for one tenant."""
    eid: int
    tenant: str
    worker: str
    sealed_prompt: SealedTensor
    key_blob: SealedTensor


class Gateway:
    def __init__(self, master_secret: Optional[bytes] = None,
                 config_repr: str = ""):
        self._master = master_secret or os.urandom(32)
        self.config_repr = config_repr
        self.tenants: set = set()
        self._verifiers: Dict[str, attestation.Verifier] = {}
        self._transport: Dict[str, SealingKey] = {}
        self._device: Dict[str, object] = {}
        self._eid = 0    # gateway-global envelope counter (nonce freshness
                         # under each per-worker transport key)
        self.stats = GatewayStats()

    # -- attestation / key release -------------------------------------------
    def admit(self, worker: EngineWorker,
              expected_measurement: Optional[str] = None) -> None:
        """Attest one worker and release its keys: verify a fresh quote
        against the expected measurement (default: the worker's current
        self-measurement; pass a pinned one to model a tampered worker),
        release the envelope transport key, then one tenant key domain per
        registered tenant, each on its own fresh quote."""
        expected = (expected_measurement
                    if expected_measurement is not None
                    else worker.td.measurement(self.config_repr))
        v = attestation.Verifier(worker.td.root, expected)
        transport_material = os.urandom(32)
        try:
            q = worker.quote(v.challenge(), self.config_repr)
            v.release_key(q, transport_material)
        except AttestationError:
            self.stats.rejected_quotes += 1
            worker.state = DEAD
            raise
        worker.install_transport(transport_material)
        self._verifiers[worker.name] = v
        self._transport[worker.name] = SealingKey.generate(transport_material)
        self._device[worker.name] = worker.td.device
        for tenant in sorted(self.tenants):
            self._release_tenant(worker, tenant)
        worker.state = READY
        self.stats.attested_workers += 1

    def register_tenant(self, tenant: str, workers=()) -> None:
        """Add a tenant; release its key domain to any already-attested
        workers passed in (later admissions pick it up themselves)."""
        if tenant in self.tenants:
            return
        self.tenants.add(tenant)
        for w in workers:
            if w.name in self._verifiers:
                self._release_tenant(w, tenant)

    def _release_tenant(self, worker: EngineWorker, tenant: str) -> None:
        v = self._verifiers[worker.name]
        q = worker.quote(v.challenge(), self.config_repr)
        material = v.release_tenant_key(q, self._master, tenant)
        worker.install_tenant_key(tenant, material)
        self.stats.keys_released += 1

    # -- prompt envelopes -----------------------------------------------------
    def envelope_seal(self, worker_name: str, tenant: str,
                      prompt: np.ndarray) -> Envelope:
        """Encrypt a prompt to exactly one attested worker: a fresh content
        key seals the tokens; the content key rides sealed under that
        worker's transport key. Any other worker, and any tamper, fails MAC
        before plaintext exists."""
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        try:
            transport = self._transport[worker_name]
        except KeyError:
            raise KeyError(f"worker {worker_name!r} is not attested — no "
                           f"transport key was released") from None
        device = self._device[worker_name]
        eid = self._eid
        self._eid += 1
        content = SealingKey.generate()
        sealed_prompt = seal_tensor(content, f"envelope/{eid}/prompt",
                                    np.asarray(prompt, np.int32),
                                    device=device)
        key_blob = seal_tensor(
            transport, f"envelope/{eid}/key",
            np.frombuffer(content.key + content.mac_key, np.uint8).copy(),
            device=device)
        self.stats.envelopes += 1
        self.stats.envelope_bytes += sealed_prompt.n_bytes + key_blob.n_bytes
        return Envelope(eid, tenant, worker_name, sealed_prompt, key_blob)
