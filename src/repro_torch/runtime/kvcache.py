"""KV-cache backends (port of ``repro.runtime.kvcache``, slot-dense only).

The engine sees one :class:`KVBackend` interface; this slice ports the
dense slot layout (:class:`SlotDenseBackend`): a fixed
``[L, max_slots, max_len, ...]`` cache, one slot per in-flight sequence,
sealed preemption of whole slots. The paged backend, its page store and the
sharded wrapper arrive with ROADMAP.md queue A items 10, 11 and 18.

Cache trees follow the model layout contract: top-level key "pos" is
batch-major [b]; every other leaf is layer-stacked with batch at axis 1
([L, b, ...]). ``insert_slot``/``insert_rows``/``extract_slot`` are the
dense splice primitives; they update the cache in place where the reference
rebuilt it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sealing import (SealedTensor, SealingKey, seal_tree,
                                      unseal_tree)
from repro_torch.runtime import sampling
from repro_torch.runtime.plan import SingleDevicePlan

Cache = Any
Params = Any


@dataclasses.dataclass
class SlotState:
    """Slot bookkeeping + the ``[slots]``-shaped per-sequence sampling rows
    (each sequence samples with its own temperature/top-k/top-p/PRNG key).
    Owned by the KV backend — a backend maps sequences to whatever physical
    layout it likes, but every live sequence holds exactly one row here.
    The arrays are host-side numpy mirrors, copied verbatim from the
    reference; the port's engine serves greedy requests only (seeded
    sampling: ROADMAP.md queue A item 6), so its rows stay greedy. A
    released row resets to greedy (temp 0, top_p 1) so stale settings can
    never leak into the next occupant."""
    free: List[int]
    active: dict  # slot -> request id
    temp: np.ndarray    # [slots] f32; <= 0 → greedy
    top_k: np.ndarray   # [slots] i32; 0 → unrestricted
    top_p: np.ndarray   # [slots] f32; >= 1 → unrestricted
    key: np.ndarray     # [slots, 2] u32 per-request base PRNG keys
    rep_pen: np.ndarray   # [slots] f32; 1.0 → no repetition penalty
    presence: np.ndarray  # [slots] f32; 0.0 → no presence penalty
    # [slots, vocab] i32 counts of *generated* tokens, tracked ONLY for
    # slots whose request actually penalizes (greedy/unpenalized rows stay
    # zero, so their churn never invalidates anything). Rebuilt from
    # Request.output after a sealed restore, so seeded requests re-sample
    # identically. Allocated lazily on the first penalized ``set_sampling``
    # (engines that never see a penalty never pay max_slots x vocab ints).
    # ``hist_version`` bumps on the BULK mutations (row rebuild/clear) so
    # the engine's device mirror knows when an incremental update stream
    # was broken and a re-upload is due — per-token ``note_token`` counts
    # are mirrored incrementally instead of re-shipping the whole matrix
    # every decode step.
    vocab: int = 0
    hist: Optional[np.ndarray] = None
    hist_version: int = 0
    # [slots, vocab] f32 additive logit-bias rows, lazily allocated like
    # ``hist`` on the first ``set_sampling(..., logit_bias=...)``. Bias is
    # static per request (no per-token stream), so the device mirror is
    # version-triggered only: ``bias_version`` bumps whenever any row
    # changes and the engine re-uploads the whole matrix then.
    bias: Optional[np.ndarray] = None
    bias_version: int = 0

    @classmethod
    def create(cls, max_slots: int, vocab: int = 0) -> "SlotState":
        return cls(free=list(range(max_slots)), active={},
                   temp=np.zeros(max_slots, np.float32),
                   top_k=np.zeros(max_slots, np.int32),
                   top_p=np.ones(max_slots, np.float32),
                   key=np.zeros((max_slots, 2), np.uint32),
                   rep_pen=np.ones(max_slots, np.float32),
                   presence=np.zeros(max_slots, np.float32),
                   vocab=vocab)

    def acquire(self, request_id: int) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop(0)
        self.active[slot] = request_id
        return slot

    def release(self, slot: int) -> None:
        rid = self.active.pop(slot, None)
        if rid is not None:
            self.free.append(slot)
            self.clear_sampling(slot)

    def set_sampling(self, slot: int, temp: float, top_k: int, top_p: float,
                     key: np.ndarray, rep_pen: float = 1.0,
                     presence: float = 0.0,
                     logit_bias: Optional[Dict[int, float]] = None) -> None:
        self.temp[slot] = temp
        self.top_k[slot] = top_k
        self.top_p[slot] = top_p
        self.key[slot] = key
        self.rep_pen[slot] = rep_pen
        self.presence[slot] = presence
        if self.penalized(slot) and self.hist is None and self.vocab > 0:
            self.hist = np.zeros((len(self.temp), self.vocab), np.int32)
        self._set_bias_row(slot, logit_bias)

    def _set_bias_row(self, slot: int,
                      logit_bias: Optional[Dict[int, float]]) -> None:
        """Densify a request's sparse bias map into its slot row. A request
        without a map keeps (or resets to) the zero row; the matrix itself
        only exists once some request has biased."""
        if logit_bias:
            if self.bias is None:
                self.bias = np.zeros((len(self.temp), self.vocab), np.float32)
            self.bias[slot] = 0.0
            for tok, val in logit_bias.items():
                self.bias[slot, int(tok)] = np.float32(val)
            self.bias_version += 1
        elif self.bias is not None and self.bias[slot].any():
            self.bias[slot] = 0.0
            self.bias_version += 1

    def penalized(self, slot: int) -> bool:
        """Does this slot's request use a non-neutral penalty? Only such
        slots have their token history tracked."""
        return bool(self.rep_pen[slot] != 1.0 or self.presence[slot] != 0.0)

    def clear_sampling(self, slot: int) -> None:
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.key[slot] = 0
        self.rep_pen[slot] = 1.0
        self.presence[slot] = 0.0
        if self.hist is not None and self.hist[slot].any():
            # bump only when the row actually changes: routine churn of
            # greedy/unpenalized slot-mates (whose rows are already zero)
            # must not force a full [slots, vocab] mirror re-upload.
            self.hist[slot] = 0
            self.hist_version += 1
        if self.bias is not None and self.bias[slot].any():
            self.bias[slot] = 0.0
            self.bias_version += 1

    def note_token(self, slot: int, token: int) -> bool:
        """Count one generated token into the penalty history — only for a
        penalized slot (others keep zero rows so their churn stays free).
        Incremental: does NOT bump hist_version — the caller mirrors the
        increment itself. Returns whether the token was counted."""
        if self.hist is None or not self.penalized(slot):
            return False
        self.hist[slot, int(token)] += 1
        return True

    def set_hist(self, slot: int, tokens: Sequence[int]) -> None:
        """Rebuild a slot's penalty history (sealed restore: the token list
        travels with the request, not with the cache). Unpenalized slots
        keep zero rows; no version bump when the row is unchanged (fresh
        admission into an already-clean row)."""
        if self.hist is None:
            return
        if not self.penalized(slot):
            if self.hist[slot].any():          # defensive: never stale
                self.hist[slot] = 0
                self.hist_version += 1
            return
        if not (len(tokens) or self.hist[slot].any()):
            return
        self.hist[slot] = 0
        for t in tokens:
            self.hist[slot, int(t)] += 1
        self.hist_version += 1

    @property
    def any_sampled(self) -> bool:
        return bool((self.temp > 0).any())

    @property
    def any_top_p(self) -> bool:
        return bool(((self.temp > 0) & (self.top_p < 1.0)).any())

    @property
    def any_rep_pen(self) -> bool:
        return bool(((self.temp > 0) & (self.rep_pen != 1.0)).any())

    @property
    def any_presence(self) -> bool:
        return bool(((self.temp > 0) & (self.presence != 0.0)).any())

    @property
    def any_bias(self) -> bool:
        return self.bias is not None and bool(self.bias.any())

    @property
    def max_top_k(self) -> int:
        return int(self.top_k.max()) if len(self.top_k) else 0

    @property
    def num_active(self) -> int:
        return len(self.active)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (prefill row padding; kept from the
    reference so admission groups stay shaped as there)."""
    p = 1
    while p < n:
        p *= 2
    return p


def host_upload(x, device, dtype=None) -> torch.Tensor:
    """Host -> device copy of a small host array (slot tables, token
    columns). The reference copied into a runtime-owned buffer to dodge an
    XLA:CPU alignment nondeterminism; torch has none, so this is a plain
    copy."""
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)


def _splice(batched: Cache, src: Cache, fn) -> None:
    for k, big in batched.items():
        if isinstance(big, dict):
            _splice(big, src[k], fn)
        else:
            fn(k == "pos", big, src[k])


@torch.inference_mode()
def insert_slot(batched: Cache, single: Cache, slot: int) -> Cache:
    """Write a b=1 cache into batch slot ``slot`` of the batched cache, in
    place; returns the batched cache."""
    def upd(is_pos, big, small):
        if is_pos:
            big[slot] = small[0]
        else:                       # [L, 1, ...] into [L, B, ...] at axis 1
            big[:, slot] = small[:, 0].to(big.dtype)
    _splice(batched, single, upd)
    return batched


@torch.inference_mode()
def insert_rows(batched: Cache, src: Cache, slots: torch.Tensor) -> Cache:
    """Scatter the first k rows of a b>=k cache into batch slots ``slots``
    (int64 [k], distinct) in place, one indexed copy per leaf for the whole
    prefill group; returns the batched cache."""
    k = slots.shape[0]

    def upd(is_pos, big, small):
        if is_pos:
            big[slots] = small[:k]
        else:                       # [L, k, ...] rows into [L, B, ...]
            big[:, slots] = small[:, :k].to(big.dtype)
    _splice(batched, src, upd)
    return batched


@torch.inference_mode()
def extract_slot(batched: Cache, slot: int) -> Cache:
    """Inverse of insert_slot: a copy of slot ``slot`` as a b=1 cache."""
    def get(key, big):
        if isinstance(big, dict):
            return {k: get(k, v) for k, v in big.items()}
        if key == "pos":
            return big[slot:slot + 1].clone()
        return big[:, slot:slot + 1].clone()
    return {k: get(k, v) for k, v in batched.items()}


# ---------------------------------------------------------------------------
# backend protocol
# ---------------------------------------------------------------------------

class KVBackend:
    """One live KV store behind the engine. A backend owns

      * the device cache (whatever physical layout),
      * the slot <-> sequence mapping and per-sequence sampling rows
        (:class:`SlotState`),
      * the decode step over its layout, and
      * the seal/restore format a preemption moves across the boundary.

    The engine speaks tokens: every capacity question is asked in "KV
    positions this request may write" (``n_tokens``), and the backend maps
    that onto slots, pages, or whatever it accounts in.
    """

    name: str = "?"

    def __init__(self, model, max_slots: int, max_len: int,
                 plan: Optional[SingleDevicePlan] = None):
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.plan = plan or SingleDevicePlan(model)
        self.device = self.plan.device
        self.slots = SlotState.create(max_slots, model.cfg.vocab_size)

    # -- capacity -----------------------------------------------------------
    @property
    def request_capacity(self) -> int:
        """Most KV positions a single request may occupy."""
        return self.max_len

    def can_admit(self, n_tokens: int) -> bool:
        """Beyond a free slot, is there KV room for ``n_tokens`` positions?"""
        return True

    def can_restore(self, n_tokens: int) -> bool:
        """Room to re-admit a sealed-out sequence of ``n_tokens`` positions
        (a free slot is checked separately via ``slots.free``)."""
        return True

    def admission_check(self, need: int) -> Tuple[bool, int]:
        """(fits, effective_need): can ``need`` worst-case KV positions ever
        be served, and what does the request effectively demand?"""
        return need <= self.request_capacity, need

    # -- sequence lifecycle ---------------------------------------------------
    def acquire(self, rid: int, n_tokens: int) -> Optional[int]:
        return self.slots.acquire(rid)

    def release(self, slot: int) -> None:
        self.slots.release(slot)

    # -- device compute -------------------------------------------------------
    def fresh_prefill_cache(self, rows: int) -> Cache:
        """A zeroed ``rows``-sequence dense cache for one prefill call."""
        return self.model.init_cache(rows, self.max_len)

    def insert_prefill(self, prefilled: Cache, slots: List[int],
                       written_len: int) -> None:
        """Splice a prefilled dense group into backend storage."""
        raise NotImplementedError

    def decode(self, params: Params, tokens: np.ndarray) -> np.ndarray:
        """One batched greedy decode step over all ``max_slots`` rows.
        Returns the next token per row."""
        raise NotImplementedError

    # -- sealing --------------------------------------------------------------
    def seal(self, key: SealingKey, slot: int,
             prefix: str) -> Dict[str, SealedTensor]:
        """Encrypt slot ``slot``'s KV for eviction across the trust boundary.
        ``prefix`` must be unique per (stream, seal epoch) — it derives the
        nonces. Does NOT release the slot."""
        raise NotImplementedError

    def restore(self, key: SealingKey, sealed: Dict[str, SealedTensor],
                slot: int, prefix: str) -> None:
        """Inverse of :meth:`seal` into freshly-acquired slot ``slot``."""
        raise NotImplementedError


class SlotDenseBackend(KVBackend):
    """The dense ``[L, max_slots, max_len, ...]`` layout. Sealing moves the
    victim's whole ``max_len`` extent regardless of how many positions hold
    live tokens."""

    name = "slot"

    def __init__(self, model, max_slots: int, max_len: int,
                 plan: Optional[SingleDevicePlan] = None):
        super().__init__(model, max_slots, max_len, plan)
        self.cache = model.init_cache(max_slots, max_len)

        def _decode(params, tokens, cache):
            logits, cache = model.decode_step(params, tokens, cache)
            return sampling.greedy(logits)

        self._decode_fn = self.plan.compile_decode(_decode)

    def insert_prefill(self, prefilled: Cache, slots: List[int],
                       written_len: int) -> None:
        # one indexed copy per leaf for the whole group
        insert_rows(self.cache, prefilled,
                    host_upload(slots, self.device, torch.int64))

    def decode(self, params, tokens) -> np.ndarray:
        next_tokens = self._decode_fn(
            params, host_upload(tokens[:, None], self.device), self.cache)
        return next_tokens.cpu().numpy()

    def seal(self, key, slot, prefix) -> Dict[str, SealedTensor]:
        return seal_tree(key, extract_slot(self.cache, slot), prefix=prefix)

    def restore(self, key, sealed, slot, prefix) -> None:
        single_like = self.model.abstract_cache(1, self.max_len)
        insert_slot(self.cache, unseal_tree(key, sealed, single_like,
                                            prefix=prefix), slot)


def make_backend(kind: str, model, *, max_slots: int, max_len: int,
                 plan: Optional[SingleDevicePlan] = None) -> KVBackend:
    """Factory behind ``Engine(kv_backend=...)``: ``"slot"`` only here."""
    if kind == "slot":
        return SlotDenseBackend(model, max_slots, max_len, plan)
    if kind == "paged":
        raise NotImplementedError(
            "the paged KV backend is not ported yet (ROADMAP.md queue A "
            "item 10)")
    raise ValueError(f"unknown kv backend {kind!r} (want 'slot' or 'paged')")
