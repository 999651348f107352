"""TrustDomain — the paper's contribution as a first-class framework feature
(port of ``repro.core.confidential``).

A :class:`TrustDomain` is the deployment-level object that turns a plain
PyTorch inference stack into a *confidential* one (cLLM):

  1. models are loaded only from sealed checkpoints (ChaCha20 + HMAC,
     on-device unseal kernel),
  2. the domain attests itself (measurement -> quote) and the client-side
     :class:`~repro_torch.core.attestation.Verifier` releases the sealing key only
     on a valid quote,
  3. prompt/response token I/O crosses the boundary through an encrypted
     :class:`~repro_torch.core.bounce.BounceBuffer`,
  4. every boundary crossing is recorded in an audit log, and the calibrated
     overhead model prices the configuration for capacity planning.

Modes mirror the paper's platforms: "none" (bare), "vm", "sgx", "tdx",
"cgpu", "tpu_cc". Crypto is real in all confidential modes; the mode selects
the overhead profile used for modeled numbers and which boundary mechanisms
are active.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import tracing
from repro_torch.core import attestation, bounce, overheads, sealing
from repro_torch.device import resolve_device

Params = Any


@dataclasses.dataclass
class AuditEvent:
    ts: float
    kind: str
    detail: str


class TrustDomain:
    def __init__(self, mode: str = "tdx",
                 sealing_key: Optional[sealing.SealingKey] = None,
                 io_key: Optional[sealing.SealingKey] = None,
                 platform_secret: Optional[bytes] = None,
                 device=None):
        """``device`` is where sealing, unsealing and the token channel run:
        the card unless the caller passes ``device="cpu"``."""
        if mode != "none" and mode not in overheads.PROFILES:
            raise ValueError(f"unknown TEE mode '{mode}'")
        self.mode = mode
        self.confidential = mode != "none"
        self.sealing_key = sealing_key or sealing.SealingKey.generate()
        self.io_key = io_key or sealing.SealingKey.generate()
        self.device = resolve_device(device)
        self.channel = bounce.BounceBuffer(self.io_key, self.device)
        self.root = attestation.HardwareRoot(mode if self.confidential else "none",
                                             platform_secret)
        self.audit: List[AuditEvent] = []
        self._model_digest = ""
        self._code_hash: Optional[str] = None
        self._tenant_keys: Dict[str, sealing.SealingKey] = {}

    # -- audit ---------------------------------------------------------------
    def _log(self, kind: str, detail: str = ""):
        self.audit.append(AuditEvent(time.monotonic(), kind, detail))

    # -- sealing -------------------------------------------------------------
    def seal_params(self, params: Params, prefix: str = "params") -> Dict[str, sealing.SealedTensor]:
        with tracing.span("td:seal_params"):
            sealed = sealing.seal_tree(self.sealing_key, params, prefix)
        self._model_digest = sealing.tree_digest(sealed)
        self._log("seal", f"{len(sealed)} tensors, digest={self._model_digest[:12]}")
        return sealed

    def load_sealed(self, sealed: Dict[str, sealing.SealedTensor],
                    treedef_like: Params, prefix: str = "params") -> Params:
        if not self.confidential:
            raise RuntimeError("load_sealed requires a confidential mode")
        with tracing.span("td:load_sealed"):
            params = sealing.unseal_tree(self.sealing_key, sealed,
                                         treedef_like, prefix)
        self._model_digest = sealing.tree_digest(sealed)
        self._log("unseal", f"{len(sealed)} tensors")
        return params

    # -- attestation ---------------------------------------------------------
    def measurement(self, config_repr: str = "") -> str:
        if self._code_hash is None:
            self._code_hash = attestation.measure_code()
        return attestation.measurement(self._code_hash, config_repr,
                                       self._model_digest)

    def quote(self, nonce: str, config_repr: str = "") -> attestation.Quote:
        q = self.root.quote(self.measurement(config_repr), nonce)
        self._log("quote", f"nonce={nonce[:8]}")
        return q

    def make_verifier(self, config_repr: str = "") -> attestation.Verifier:
        """Client-side verifier pinned to this domain's current measurement."""
        return attestation.Verifier(self.root, self.measurement(config_repr))

    # -- tenant key domains --------------------------------------------------
    def tenant_key(self, tenant: str) -> sealing.SealingKey:
        """The sealing-key domain for one tenant's KV/egress inside this
        worker. Derived (never stored) from the domain's sealing key with an
        HKDF-style label, so a blob sealed for tenant A fails MAC — not just
        decryption — under tenant B's domain or under the worker key itself.
        Workers attested by the same gateway receive identical tenant
        material, so the same derivation yields the same domain fleet-wide
        and sealed KV migrates across workers without re-keying."""
        k = self._tenant_keys.get(tenant)
        if k is None:
            k = self.sealing_key.derive(f"tenant/{tenant}")
            self._tenant_keys[tenant] = k
            self._log("tenant_key", f"derived domain for tenant={tenant}")
        return k

    def adopt_tenant_material(self, tenant: str, material: bytes) -> sealing.SealingKey:
        """Install a gateway-released per-tenant material as this worker's
        domain for ``tenant`` (fleet path: material comes from
        ``Verifier.release_tenant_key`` after this worker attested, so every
        worker in the fleet lands on the *same* tenant domain)."""
        k = sealing.SealingKey.generate(material)
        self._tenant_keys[tenant] = k
        self._log("tenant_key", f"adopted released domain for tenant={tenant}")
        return k

    # -- boundary I/O ----------------------------------------------------------
    def ingress(self, tokens: np.ndarray) -> np.ndarray:
        """Host -> trust domain. Encrypted in confidential modes."""
        if not self.confidential:
            return tokens
        sealed = self.channel.host_send(tokens)
        out = self.channel.device_recv(sealed)
        self._log("ingress", f"{sealed.n_bytes}B")
        return out

    def egress(self, tokens: np.ndarray) -> np.ndarray:
        """Trust domain -> host."""
        if not self.confidential:
            return tokens
        sealed = self.channel.device_send(tokens)
        out = self.channel.host_recv(sealed)
        self._log("egress", f"{sealed.n_bytes}B")
        return out

    def egress_tokens(self, stream_id: int, tokens) -> List[int]:
        """Trust domain -> host, streaming: ONE encrypted frame carrying
        ``tokens`` (a FramePolicy flush — 1 token per frame in the
        SecureChat-style default, N when coalescing). Each frame pays the
        fixed per-crossing cost the cgpu profile's ``fixed_boundary_s``
        models, so ``ChannelStats`` sees crossings (messages_out) and the
        tokens they amortize over (tokens_out) separately."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if not self.confidential:
            return [int(t) for t in toks]
        with tracing.span("td:frame"):
            frame = self.channel.device_send_frame(stream_id, toks)
            out = self.channel.host_recv_frame(frame)
        self._log("egress_frame",
                  f"stream={stream_id} seq={frame.seq} n={toks.size} "
                  f"{frame.sealed.n_bytes}B")
        return [int(t) for t in out]

    def egress_token(self, stream_id: int, token: int) -> int:
        """Single-token convenience wrapper over :meth:`egress_tokens`."""
        return self.egress_tokens(stream_id, [token])[0]

    def record_seal(self, n_bytes: int, n_tensors: int, detail: str = "") -> None:
        """Account one sealed-KV eviction: ``n_bytes`` of ciphertext left the
        domain (page-granular backends move far less of it than whole-slot
        ones — the measurable difference serve_bench reports)."""
        self.channel.stats.seal_events += 1
        self.channel.stats.seal_bytes += int(n_bytes)
        self._log("seal_kv", f"{n_tensors} tensors {n_bytes}B {detail}".strip())

    def record_restore(self, n_bytes: int, n_tensors: int, detail: str = "") -> None:
        self.channel.stats.restore_events += 1
        self.channel.stats.restore_bytes += int(n_bytes)
        self._log("restore_kv", f"{n_tensors} tensors {n_bytes}B {detail}".strip())

    def record_store_hit(self, n_bytes: int, n_tensors: int,
                         detail: str = "") -> None:
        """Account one persistent-store restore: content-named ciphertext
        re-entered the domain instead of the prefill recomputing it —
        priced as a restore crossing (restore_events/bytes) plus the store
        counters the hit-rate and breakeven reports read."""
        self.channel.stats.restore_events += 1
        self.channel.stats.restore_bytes += int(n_bytes)
        self.channel.stats.store_hits += 1
        self.channel.stats.store_restored_bytes += int(n_bytes)
        self._log("store_hit",
                  f"{n_tensors} tensors {n_bytes}B {detail}".strip())

    def record_store_evict(self, n_bytes: int, n_tensors: int,
                           detail: str = "") -> None:
        """Account one store retention eviction. No boundary crossing —
        the host simply forgets ciphertext it was caching — so only the
        store counter moves (plus an audit line: what the retention policy
        sheds is part of the deployment's measurable behavior)."""
        self.channel.stats.store_evictions += 1
        self._log("store_evict",
                  f"{n_tensors} tensors {n_bytes}B {detail}".strip())

    def record_collective(self, n_bytes: int, seconds: float,
                          steps: int = 1) -> None:
        """Account ``steps`` decode steps' cross-device collective traffic
        (a mesh-spanning engine): ``n_bytes`` moved per device over the
        interconnect, taking a *measured* ``seconds`` (the ShardedPlan's
        shard_map all-gather probe). This is the traffic link_tax applies to;
        no audit event per step — the counters are the product."""
        self.channel.stats.collective_steps += int(steps)
        self.channel.stats.collective_bytes += int(n_bytes)
        self.channel.stats.collective_s += float(seconds)

    def open_stream(self) -> int:
        """Allocate a never-reused egress stream id (see BounceBuffer)."""
        return self.channel.open_stream()

    def close_stream(self, stream_id: int) -> None:
        """Release a finished request's per-stream channel state."""
        if self.confidential:
            self.channel.close_stream(stream_id)

    # -- overhead model -----------------------------------------------------
    def predict_overhead(self, terms: overheads.RooflineTerms,
                         **kw) -> Optional[overheads.OverheadBreakdown]:
        if not self.confidential:
            return None
        return overheads.predict(terms, self.mode, **kw)
