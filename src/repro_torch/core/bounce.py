"""Encrypted bounce buffer for host<->device token I/O (port of
``repro.core.bounce``; frames sealed by either package open in the other).

NVIDIA cGPUs route every PCIe transfer through an encrypted+authenticated
bounce buffer (paper §V-A) — the main cGPU overhead source, amortized by
batch/input size (Insight 10). We implement the same structure for the
host<->GPU boundary: prompts enter and tokens leave the trust domain only as
ciphertext; both sides seal and unseal on the channel's device, so on the
card every frame goes through the ChaCha20 kernel.

The channel keeps byte/crypto counters so benchmarks can attribute boundary
costs exactly (fig04/fig11 harnesses).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.sealing import (IntegrityError, SealingKey,
                                      SealedTensor, seal_tensor,
                                      unseal_tensor)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ChannelStats:
    """Boundary-crossing counters. ``messages_out`` counts *crossings*
    (frames — the unit Insight 10's fixed cost is paid per); ``tokens_out``
    counts the tokens those frames carried. With per-token streaming the two
    are equal; a coalescing FramePolicy drives messages_out/tokens_out
    toward 1/N, which is exactly the amortization curve serve_bench plots."""
    messages_in: int = 0
    messages_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    tokens_out: int = 0
    # sealed-KV traffic (preemption evictions/restores): ciphertext that
    # leaves/re-enters the domain outside the token channel. Counted apart
    # from messages so crossings_per_token stays a pure egress metric.
    seal_events: int = 0
    seal_bytes: int = 0
    restore_events: int = 0
    restore_bytes: int = 0
    # cross-device collective traffic inside the domain (mesh-spanning
    # engines): bytes each device moved over the interconnect per decode
    # step, and the *measured* time those collectives took on the real mesh
    # (a shard_map all-gather probe, not the closed-form roofline estimate).
    # This is the traffic the encrypted-interconnect tax (link_tax) applies
    # to — overheads.predict(collective_s=stats.collective_s / steps) prices
    # it from observation instead of the model.
    collective_steps: int = 0
    collective_bytes: int = 0
    collective_s: float = 0.0
    # persistent sealed-page store (prefix-cache tier): hits re-enter the
    # domain as content-named ciphertext (also counted in restore_*, the
    # boundary they cross); evictions are host-side forgetting — no
    # crossing, tracked for the retention experiments.
    store_hits: int = 0
    store_restored_bytes: int = 0
    store_evictions: int = 0

    @property
    def crossings_per_token(self) -> float:
        return self.messages_out / self.tokens_out if self.tokens_out else 0.0

    @property
    def seal_bytes_per_event(self) -> float:
        return self.seal_bytes / self.seal_events if self.seal_events else 0.0

    @property
    def collective_s_per_step(self) -> float:
        return (self.collective_s / self.collective_steps
                if self.collective_steps else 0.0)

    def reset(self):
        self.messages_in = self.messages_out = 0
        self.bytes_in = self.bytes_out = 0
        self.tokens_out = 0
        self.seal_events = self.seal_bytes = 0
        self.restore_events = self.restore_bytes = 0
        self.collective_steps = self.collective_bytes = 0
        self.collective_s = 0.0
        self.store_hits = self.store_restored_bytes = 0
        self.store_evictions = 0


@dataclasses.dataclass
class TokenFrame:
    """One streamed egress message: the token(s) a request released together.

    Frames are the unit the paper's cGPU fixed cost is paid per (Insight 10):
    streaming one token per frame maximizes boundary crossings, which is
    exactly what ``ChannelStats`` must see to price the deployment honestly;
    a coalescing FramePolicy packs N tokens into one frame to amortize it.
    ``(stream_id, seq)`` is bound into the sealed tensor's name, so the nonce
    is unique per frame and the host side can detect replay or reordering.
    """
    stream_id: int
    seq: int
    sealed: SealedTensor

    @staticmethod
    def frame_name(stream_id: int, seq: int) -> str:
        return f"egress/s{stream_id}/{seq}"


class BounceBuffer:
    """Symmetric encrypted channel. ``host_*`` runs outside the trust domain,
    ``device_*`` inside. Sequence numbers make each message's nonce unique.
    Frames are sealed and opened on ``device`` (the card by default)."""

    def __init__(self, key: SealingKey, device=None):
        self.key = key
        self.device = resolve_device(device)
        self.stats = ChannelStats()
        self._seq_in = 0
        self._seq_out = 0
        self._stream_seq: Dict[int, int] = {}   # stream id -> next send seq
        self._stream_recv: Dict[int, int] = {}  # stream id -> next expected seq
        self._next_stream = 0                   # ids never reused (nonce safety)
        # closed streams, compact: ids below the watermark are closed;
        # out-of-order closures wait in the set until it advances. The set
        # stays small while streams close roughly in open order — one
        # never-closed stream pins the watermark and the set tracks every
        # later closure, so abandon streams with close_stream, not silence.
        self._closed_lo = 0
        self._closed_set: set = set()

    # host -> device
    def host_send(self, tokens: np.ndarray) -> SealedTensor:
        name = f"ingress/{self._seq_in}"
        self._seq_in += 1
        sealed = seal_tensor(self.key, name, tokens, device=self.device)
        self.stats.messages_in += 1
        self.stats.bytes_in += sealed.n_bytes
        return sealed

    def device_recv(self, sealed: SealedTensor) -> np.ndarray:
        return unseal_tensor(self.key, sealed).cpu().numpy()

    # device -> host
    def device_send(self, tokens: np.ndarray) -> SealedTensor:
        name = f"egress/{self._seq_out}"
        self._seq_out += 1
        sealed = seal_tensor(self.key, name, tokens, device=self.device)
        self.stats.messages_out += 1
        self.stats.bytes_out += sealed.n_bytes
        return sealed

    def host_recv(self, sealed: SealedTensor) -> np.ndarray:
        return unseal_tensor(self.key, sealed).cpu().numpy()

    def open_stream(self) -> int:
        """Allocate a channel-global stream id. The channel — not the caller —
        owns the namespace: per-engine request ids restart at 0, and two
        engines sharing one TrustDomain must never land on the same
        ``egress/sN/M`` name (ChaCha20 nonce reuse)."""
        sid = self._next_stream
        self._next_stream += 1
        return sid

    def _stream_closed(self, stream_id: int) -> bool:
        return stream_id < self._closed_lo or stream_id in self._closed_set

    # device -> host, streaming: one frame per FramePolicy flush (1..N tokens)
    def device_send_frame(self, stream_id: int, tokens: np.ndarray) -> TokenFrame:
        if self._stream_closed(stream_id):
            raise IntegrityError(
                f"stream {stream_id} is closed; sending would restart its "
                f"seq at 0 and reuse a nonce")
        tokens = np.asarray(tokens, np.int32)
        seq = self._stream_seq.get(stream_id, 0)
        self._stream_seq[stream_id] = seq + 1
        name = TokenFrame.frame_name(stream_id, seq)
        sealed = seal_tensor(self.key, name, tokens, device=self.device)
        self.stats.messages_out += 1
        self.stats.bytes_out += sealed.n_bytes
        self.stats.tokens_out += int(tokens.size)
        return TokenFrame(stream_id, seq, sealed)

    def host_recv_frame(self, frame: TokenFrame) -> np.ndarray:
        if self._stream_closed(frame.stream_id):
            raise IntegrityError(
                f"stream {frame.stream_id} is closed "
                f"(replayed frame from a finished request)")
        expect = TokenFrame.frame_name(frame.stream_id, frame.seq)
        if frame.sealed.name != expect:
            raise IntegrityError(
                f"frame name mismatch: got '{frame.sealed.name}', "
                f"expected '{expect}'")
        # strict in-order receive per stream: a verbatim-replayed or
        # reordered frame carries a stale seq and is rejected even though
        # its MAC verifies.
        want = self._stream_recv.get(frame.stream_id, 0)
        if frame.seq != want:
            raise IntegrityError(
                f"stream {frame.stream_id}: got frame seq {frame.seq}, "
                f"expected {want} (replayed or reordered frame)")
        out = unseal_tensor(self.key, frame.sealed).cpu().numpy()
        # advance only after the MAC verified: a forged frame must not burn
        # the seq and lock out the authentic one behind it.
        self._stream_recv[frame.stream_id] = want + 1
        return out

    def close_stream(self, stream_id: int) -> None:
        """Retire a finished stream: its per-stream seq state is dropped
        (bounded memory in a long-running server) while the closed-watermark
        keeps its frames permanently unreplayable and its id unsendable."""
        self._stream_seq.pop(stream_id, None)
        self._stream_recv.pop(stream_id, None)
        self._closed_set.add(stream_id)
        while self._closed_lo in self._closed_set:
            self._closed_set.discard(self._closed_lo)
            self._closed_lo += 1

    def roundtrip(self, tokens: np.ndarray) -> Tuple[np.ndarray, SealedTensor]:
        """Convenience: host->device one message (tests/benchmarks)."""
        sealed = self.host_send(tokens)
        return self.device_recv(sealed), sealed
