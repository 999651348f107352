"""Attestation: measurement, quotes, verification, key release.

Protocol structure follows SGX/TDX remote attestation (paper §II): the
enclave produces a *measurement* (hash chain over code + config + sealed
model digest), a hardware key signs a *quote* over (measurement, verifier
nonce, user data), and the verifier releases the model-sealing key only
after the quote checks out against the expected measurement.

The hardware root of trust is simulated (an HMAC key standing in for the
CPU's attestation key — DESIGN.md §8); everything above it is faithful,
including the freshness nonce and measurement binding.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import os
from pathlib import Path
from typing import Dict, Optional


class AttestationError(Exception):
    pass


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def measure_code(root: Optional[Path] = None) -> str:
    """Hash chain over the framework's own source files (MRENCLAVE analogue)."""
    root = root or Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for p in sorted(root.rglob("*.py")):
        h.update(str(p.relative_to(root)).encode())
        h.update(hashlib.sha256(p.read_bytes()).digest())
    return h.hexdigest()


def measurement(code_hash: str, config_repr: str, model_digest: str) -> str:
    h = hashlib.sha256()
    for part in (code_hash, config_repr, model_digest):
        h.update(part.encode())
        h.update(b"|")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# quotes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Quote:
    measurement: str
    nonce: str
    user_data: str
    platform: str        # "tdx" | "sgx" | "cgpu" | "tpu_cc"
    signature: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Quote":
        return cls(**json.loads(s))


class HardwareRoot:
    """Simulated per-device attestation key + the vendor's verification
    service that knows the corresponding public side."""

    def __init__(self, platform: str, device_secret: Optional[bytes] = None):
        self.platform = platform
        self._secret = device_secret or os.urandom(32)

    def quote(self, meas: str, nonce: str, user_data: str = "") -> Quote:
        payload = f"{meas}|{nonce}|{user_data}|{self.platform}".encode()
        sig = hmac.new(self._secret, payload, hashlib.sha256).hexdigest()
        return Quote(meas, nonce, user_data, self.platform, sig)

    def verify(self, q: Quote) -> bool:
        payload = f"{q.measurement}|{q.nonce}|{q.user_data}|{q.platform}".encode()
        expect = hmac.new(self._secret, payload, hashlib.sha256).hexdigest()
        return hmac.compare_digest(expect, q.signature)


# ---------------------------------------------------------------------------
# verifier / key broker
# ---------------------------------------------------------------------------

def derive_tenant_material(master: bytes, tenant: str) -> bytes:
    """Per-tenant key material from the broker's master secret. Deterministic
    (same master + tenant -> same bytes on every release), so every attested
    worker a tenant's traffic lands on derives the same sealing domain and
    sealed KV can migrate between them — while two tenants' materials are
    unrelated under the hash."""
    return hashlib.sha256(b"tenant|" + tenant.encode() + b"|" + master).digest()


class Verifier:
    """Client-side: checks quotes and releases sealing keys (key broker)."""

    def __init__(self, root: HardwareRoot, expected_measurement: str):
        self.root = root
        self.expected = expected_measurement
        self._nonces: Dict[str, bool] = {}
        self._released: Dict[str, bytes] = {}

    def challenge(self) -> str:
        nonce = os.urandom(16).hex()
        self._nonces[nonce] = False
        return nonce

    def verify(self, q: Quote) -> None:
        if q.nonce not in self._nonces:
            raise AttestationError("unknown or replayed nonce")
        if self._nonces[q.nonce]:
            raise AttestationError("nonce already used (replay)")
        if not self.root.verify(q):
            raise AttestationError("quote signature invalid")
        if q.measurement != self.expected:
            raise AttestationError(
                f"measurement mismatch: got {q.measurement[:16]}..., "
                f"expected {self.expected[:16]}...")
        self._nonces[q.nonce] = True

    def release_key(self, q: Quote, key_material: bytes) -> bytes:
        """Release the model sealing key only after successful attestation."""
        self.verify(q)
        self._released[q.nonce] = key_material
        return key_material

    def release_tenant_key(self, q: Quote, master: bytes,
                           tenant: str) -> bytes:
        """Release ONE tenant's key domain to an attested worker (the fleet
        gateway's per-tenant key-release flow): the quote is verified like
        any other release — fresh nonce, valid signature, expected
        measurement — and only the derived per-tenant material leaves the
        broker, never the master secret. An unattested or mis-measured
        worker gets :class:`AttestationError`, not a key."""
        self.verify(q)
        material = derive_tenant_material(master, tenant)
        self._released[q.nonce] = material
        return material
