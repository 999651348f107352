"""KV-cache backends (port of ``repro.runtime.kvcache``).

The engine sees one :class:`KVBackend` interface. The dense slot layout
(:class:`SlotDenseBackend`) keeps a fixed ``[L, max_slots, max_len, ...]``
cache, one slot per in-flight sequence, and seals whole slots. The paged
layout (:class:`~repro_torch.runtime.paged.PagedKVBackend`) keeps a page
pool and a page table, seals per page, can evict a victim's tail pages
only, and (``prefix_sharing=True``) maps equal prompt prefixes onto shared
pages with copy-on-write and step-time page grants. On a mesh
(:class:`~repro_torch.runtime.plan.ShardedPlan`) either layout is wrapped by
:class:`ShardedKVBackend`, which tags every sealed name with the shard the
slot's row belongs to (``/s{shard}``).

Cache trees follow the model layout contract: top-level key "pos" is
batch-major [b]; every other leaf is layer-stacked with batch at axis 1
([L, b, ...]). ``insert_slot``/``insert_rows``/``extract_slot`` are the
dense splice primitives; they update the cache in place where the reference
rebuilt it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sealing import (IntegrityError, SealedTensor,
                                      SealingKey, dtype_name, dtype_of,
                                      seal_tensor, seal_tree,
                                      tree_leaves_with_names,
                                      tree_map_with_names, unseal_tensor,
                                      unseal_tree)
from repro_torch.kernels.ops import TILE_BYTES
from repro_torch.runtime import sampling
from repro_torch.runtime.plan import ComputePlan, SingleDevicePlan

Cache = Any
Params = Any


@dataclasses.dataclass
class SlotState:
    """Slot bookkeeping + the ``[slots]``-shaped per-sequence sampling rows
    (each sequence samples with its own temperature/top-k/top-p/PRNG key).
    Owned by the KV backend — a backend maps sequences to whatever physical
    layout it likes, but every live sequence holds exactly one row here.
    The arrays are host-side numpy mirrors, copied verbatim from the
    reference; the engine snapshots them into a ``sampling.SamplingState``
    of device tensors each step. A released row resets to greedy (temp 0,
    top_p 1) so stale settings can never leak into the next occupant."""
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


def cache_bytes(cache: Cache) -> int:
    """Bytes of every tensor in a cache tree."""
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves_with_names(cache))


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
    supports_partial = False   # page-granular (tail) eviction available?
    supports_sharing = False   # content-indexed prefix page sharing on?
    on_demand = False          # step-time page grants (vs admission reserve)

    def __init__(self, model, max_slots: int, max_len: int,
                 plan: Optional[ComputePlan] = None):
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

    def can_restore(self, n_tokens: int,
                    n_pages: Optional[int] = None) -> bool:
        """Room to re-admit a sealed-out sequence of ``n_tokens`` positions
        (a free slot is checked separately via ``slots.free``). ``n_pages``
        is the page count the sequence held at seal time."""
        return True

    def page_keys(self, tokens: np.ndarray,
                  written_len: int) -> Optional[List[bytes]]:
        """Content keys for a prompt's prefill pages, or None when the
        backend does no prefix sharing."""
        return None

    def resident_pages(self, page_keys: Optional[Sequence[Any]]) -> int:
        """How many of these content keys are resident in the sharing
        index right now (0 without sharing)."""
        return 0

    def store_resident_pages(self, page_keys: Optional[Sequence[Any]]
                             ) -> int:
        """How many of these content keys the persistent page store could
        serve beyond the live index (0 without a store)."""
        return 0

    @property
    def free_physical_pages(self) -> int:
        """Free pages an on-demand grant can draw on (page backends)."""
        return 0

    def step_page_need(self, slot: int) -> int:
        """Pages the next decode step takes for this slot's append (fresh
        page or copy-on-write); summed by the engine's step-time grant."""
        return 0

    def evictable_tail_pages(self, slot: int) -> int:
        """Tail pages a partial eviction may seal off this slot."""
        return 0

    def admission_check(self, need: int,
                        page_keys: Optional[Sequence[Any]] = None
                        ) -> Tuple[bool, int]:
        """(fits, effective_need): can ``need`` worst-case KV positions ever
        be served, and what does the request effectively demand once
        resident shared pages are discounted?"""
        return need <= self.request_capacity, need

    def prompt_budget(self, max_new_tokens: int,
                      buckets: Sequence[int]) -> int:
        """Longest prompt a submit will accept for ``max_new_tokens``,
        counting prefill-bucket padding (a short prompt still fills its
        whole left-padded bucket). Prefix sharing does not raise this
        bound: every page of one sequence holds its own table mapping,
        shared or not; it lowers the effective demand
        (:meth:`admission_check`)."""
        cand = self.request_capacity - max_new_tokens + 1  # last token: no KV
        if cand >= buckets[-1]:
            return cand
        fits = [b for b in buckets if b <= cand]
        return fits[-1] if fits else 0

    # -- sequence lifecycle ---------------------------------------------------
    def acquire(self, rid: int, n_tokens: int) -> Optional[int]:
        return self.slots.acquire(rid)

    def release(self, slot: int) -> None:
        self.slots.release(slot)

    # -- device compute -------------------------------------------------------
    def fresh_prefill_cache(self, rows: int) -> Cache:
        """A zeroed ``rows``-sequence dense cache for one prefill call, as
        the plan holds it."""
        return self.plan.place_dense_cache(
            self.model.init_cache(rows, self.max_len))

    def insert_prefill(self, prefilled: Cache, slots: List[int],
                       written_len: int,
                       page_keys: Optional[List[Any]] = None) -> None:
        """Splice a prefilled dense group into backend storage.
        ``page_keys`` (sharing backends) has one entry per slot: the
        prompt's content keys, or None for a request that opted out."""
        raise NotImplementedError

    def drain_events(self) -> List[Tuple[str, int, int]]:
        """(kind, nbytes, n_tensors) boundary traffic generated outside an
        explicit seal/restore call (page materialization on the paged
        backend). The engine drains this into TrustDomain accounting."""
        return []

    def discard_sealed(self, key: SealingKey, sealed: Dict[str, SealedTensor],
                       prefix: str, suffix: str = "") -> None:
        """A sealed dict is spent (restored in full, or dropped unrestored
        by a deadline abort): release the references it holds (shared-page
        sealed refcounts on the sharing backend). Default: nothing."""

    def decode(self, params: Params, tokens: np.ndarray,
               state: Optional[sampling.SamplingState], kmax: int,
               write_slots: Sequence[int]) -> np.ndarray:
        """One batched decode+sample step over all ``max_slots`` rows:
        greedy when ``state`` is None, else :func:`sampling.sample` with the
        static top-k bound ``kmax``. ``write_slots`` are the slots genuinely
        appending a KV position this step (active, not paused); a backend
        may route other rows' writes to a scratch location. Returns the
        sampled token per row."""
        raise NotImplementedError

    def cache_nbytes(self) -> int:
        raise NotImplementedError

    # -- sealing --------------------------------------------------------------
    def seal(self, key: SealingKey, slot: int, prefix: str,
             suffix: str = "") -> Dict[str, SealedTensor]:
        """Encrypt slot ``slot``'s KV for eviction across the trust boundary.
        ``prefix`` must be unique per (stream, seal epoch) — it derives the
        nonces; ``suffix`` lands after the leaf path in every name (the
        sharded wrapper's per-shard ``/s{shard}`` tag). Does NOT release the
        slot."""
        raise NotImplementedError

    def restore(self, key: SealingKey, sealed: Dict[str, SealedTensor],
                slot: int, prefix: str, n_tokens: int,
                suffix: str = "") -> None:
        """Inverse of :meth:`seal` into freshly-acquired slot ``slot``."""
        raise NotImplementedError


class SlotDenseBackend(KVBackend):
    """The dense ``[L, max_slots, max_len, ...]`` layout. Sealing moves the
    victim's whole ``max_len`` extent regardless of how many positions hold
    live tokens."""

    name = "slot"

    def __init__(self, model, max_slots: int, max_len: int,
                 plan: Optional[ComputePlan] = None):
        super().__init__(model, max_slots, max_len, plan)
        self.cache = self.plan.place_dense_cache(
            model.init_cache(max_slots, max_len))
        decode_step = self.plan.decode_step

        def _decode(params, tokens, cache, state, kmax):
            logits, cache = decode_step(params, tokens, cache)
            return sampling.pick(logits, state, kmax)

        self._decode_fn = self.plan.compile_decode(_decode)

    def insert_prefill(self, prefilled: Cache, slots: List[int],
                       written_len: int, page_keys=None) -> None:
        # one indexed copy per leaf for the whole group
        insert_rows(self.cache, prefilled,
                    host_upload(slots, self.device, torch.int64))

    def decode(self, params, tokens, state, kmax, write_slots) -> np.ndarray:
        next_tokens = self._decode_fn(
            params, host_upload(tokens[:, None], self.device), self.cache,
            state, kmax)
        return next_tokens.cpu().numpy()

    def cache_nbytes(self) -> int:
        return cache_bytes(self.cache)

    def seal(self, key, slot, prefix, suffix="") -> Dict[str, SealedTensor]:
        return seal_tree(key, extract_slot(self.cache, slot), prefix=prefix,
                         suffix=suffix)

    def restore(self, key, sealed, slot, prefix, n_tokens,
                suffix="") -> None:
        single_like = self.model.abstract_cache(1, self.max_len)
        insert_slot(self.cache, unseal_tree(key, sealed, single_like,
                                            prefix=prefix, suffix=suffix),
                    slot)


# sealed-name anatomy for the shard tag and partial-eviction meta blobs
_SUFFIX_RE = re.compile(r"/s(\d+)$")
_PAGEMETA_RE = re.compile(r"^(?P<prefix>.*)/pagemeta(?P<suffix>/s\d+)?$")


def tail_blob_names(sealed: Dict[str, SealedTensor]
                    ) -> List[Tuple[str, str]]:
    """(prefix, suffix) of every partial-eviction tail blob riding in a
    sealed dict (a paused victim that was whole-sealed carries its earlier
    tail under its own epoch prefix and, under a mesh, shard suffix)."""
    return [(m.group("prefix"), m.group("suffix") or "")
            for m in map(_PAGEMETA_RE.match, sealed) if m]


class RankSealer:
    """Whole-blob sealing on a mesh over ranks: every blob is sealed once,
    whole, by one rank, and unsealed by one rank.

    A seal gathers the blob's model blocks over ``model`` (a rank holds its
    KV heads of a row or page), the owner seals the whole tensor under its
    name, and the ciphertext and MAC are broadcast, so every rank's engine
    holds the same sealed dict: the blob's bytes are a single-device
    engine's, and no name and key ever seal two plaintexts (two ranks
    sealing their own head slices under one name would reuse a ChaCha20
    keystream). An unseal runs on the owner, which broadcasts whether every
    MAC held and then each plaintext; each rank keeps its own block
    (:meth:`mine`). Every rank calls every method in the same order."""

    def __init__(self, plan):
        self.mesh, self.tp = plan.mesh, plan.tp
        self.world = plan.mesh.world
        self.me = self.world.local[0]

    def owner(self, shard: int = 0) -> int:
        """The world rank at model coordinate 0 of data shard ``shard``."""
        return self.mesh.rank_of(shard, 0)

    def mine(self, whole: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's model block of a whole tensor along ``dim`` (-1:
        the tensor itself)."""
        if dim < 0:
            return whole
        n = whole.shape[dim] // self.tp
        return whole.narrow(dim, self.mesh.coords[1] * n, n)

    def seal(self, key: SealingKey, name: str, local, dim: int,
             owner: int) -> SealedTensor:
        """Seal the whole of ``local`` (this rank's block along ``dim``, or
        the whole tensor or array when ``dim`` is -1) on ``owner``."""
        if isinstance(local, np.ndarray):
            local = torch.from_numpy(np.ascontiguousarray(local)).to(
                self.mesh.device)
        full = (local if dim < 0 else self.mesh.groups["model"].all_gather(
            [local.contiguous()], dim))
        sealer = self.me == owner
        st = seal_tensor(key, name, full) if sealer else None
        n_bytes = full.numel() * full.element_size()
        words = (n_bytes + (-n_bytes) % TILE_BYTES) // 4
        ct = self.world.broadcast(st.ciphertext if sealer else None, owner,
                                  (16, words // 16), torch.int32)
        mac = self.world.broadcast(
            torch.frombuffer(bytearray(st.mac), dtype=torch.uint8)
            if sealer else None, owner, (32,), torch.uint8)
        return st if sealer else SealedTensor(
            name=name, ciphertext=ct, mac=bytes(mac.cpu().numpy()),
            shape=tuple(full.shape), dtype=dtype_name(full.dtype),
            n_bytes=n_bytes)

    def unseal(self, key: SealingKey, blobs: Dict[Any, SealedTensor],
               owner: int) -> Dict[Any, torch.Tensor]:
        """Every blob's whole plaintext on every rank, unsealed on
        ``owner``; a failed MAC there raises on every rank."""
        full, err = {}, None
        if self.me == owner:
            try:
                full = {k: unseal_tensor(key, st) for k, st in blobs.items()}
            except Exception as e:      # every rank must learn of it
                err = e
        ok = self.world.broadcast(torch.tensor([err is None],
                                               dtype=torch.uint8),
                                  owner, (1,), torch.uint8)
        if err is not None:
            raise err
        if not bool(ok[0]):
            raise IntegrityError(f"an unseal of {len(blobs)} blobs failed "
                                 f"on rank {owner}")
        return {k: self.world.broadcast(full.get(k), owner, tuple(st.shape),
                                        dtype_of(st.dtype))
                for k, st in blobs.items()}


class ShardedKVBackend:
    """Mesh wrapper around either layout: compute and placement live in the
    backend's :class:`~repro_torch.runtime.plan.ShardedPlan`; the wrapper
    keeps *sealing* correct per shard. Every seal gains a ``/s{shard}`` name
    suffix recording which data shard the slot's row belongs to (hosts
    sealing under one prefix stay in disjoint nonce namespaces), and
    restore recovers the tag from the sealed names themselves, so a
    preemption round-trips bit for bit even when the sequence re-lands on
    another shard. Everything else delegates to the wrapped backend.

    On logical shards the one cache holds every head, so a row seals as on
    one device. Over ranks every blob is sealed whole by one rank
    (:class:`RankSealer`). The slot layout's row is sealed by the rank at
    model coordinate 0 of the row's data shard (only that data shard's
    ranks computed it) and restored by the rank at model coordinate 0 of
    the target row's data shard. The paged layout seals and restores
    inside the backend (``PagedKVBackend``), whose pool every data shard
    keeps whole and equal: by the rank at model coordinate 0 of the data
    shard its ``/s{shard}`` tag names, and a content-named (shared) page
    by rank 0."""

    def __init__(self, inner: KVBackend):
        self.inner = inner
        if not inner.plan.is_sharded:
            raise ValueError("ShardedKVBackend wants a backend built on a "
                             "ShardedPlan")
        self._sealer = (RankSealer(inner.plan)
                        if inner.plan.ranks and inner.name == "slot" else None)

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    def _suffix_for(self, slot: int) -> str:
        shard = self.inner.plan.shard_of_slot(slot, self.inner.max_slots)
        return f"/s{shard}"

    @staticmethod
    def _detect_suffix(sealed: Dict[str, SealedTensor], prefix: str) -> str:
        for name in sealed:
            if name.startswith(prefix):
                m = _SUFFIX_RE.search(name)
                if m:
                    return m.group(0)
        return ""

    def seal(self, key, slot, prefix, suffix=None, detach=False):
        suffix = suffix or self._suffix_for(slot)
        if self._sealer is not None:
            return self._seal_over_ranks(key, slot, prefix, suffix)
        kw = {"detach": detach} if detach else {}
        return self.inner.seal(key, slot, prefix, suffix=suffix, **kw)

    def restore(self, key, sealed, slot, prefix, n_tokens, suffix=None):
        if suffix is None:
            suffix = self._detect_suffix(sealed, prefix)
        if self._sealer is not None:
            return self._restore_over_ranks(key, sealed, slot, prefix, suffix)
        return self.inner.restore(key, sealed, slot, prefix, n_tokens,
                                  suffix=suffix)

    def seal_tail_pages(self, key, slot, prefix, n_pages, suffix=None):
        return self.inner.seal_tail_pages(
            key, slot, prefix, n_pages,
            suffix=suffix or self._suffix_for(slot))

    def restore_tail_pages(self, key, sealed, slot, prefix, reserve=True,
                           suffix=None):
        if suffix is None:
            suffix = self._detect_suffix(sealed, prefix)
        return self.inner.restore_tail_pages(key, sealed, slot, prefix,
                                             reserve=reserve, suffix=suffix)

    def discard_sealed(self, key, sealed, prefix, suffix=None):
        if suffix is None:
            suffix = self._detect_suffix(sealed, prefix)
        return self.inner.discard_sealed(key, sealed, prefix, suffix=suffix)

    # -- the slot layout's rows over ranks ----------------------------------------
    def _owner(self, slot: int) -> int:
        """The world rank at model coordinate 0 of the slot's data shard."""
        plan = self.inner.plan
        return plan.mesh.rank_of(
            plan.shard_of_slot(slot, self.inner.max_slots), 0)

    def _seal_over_ranks(self, key, slot, prefix, suffix):
        sealer, owner = self._sealer, self._owner(slot)
        row = extract_slot(self.inner.cache, slot)
        dims = self.inner.plan.kv_dims(
            self.inner.model.abstract_cache(1, self.inner.max_len))
        return {prefix + path + suffix: sealer.seal(
                    key, prefix + path + suffix, leaf, dims[path], owner)
                for path, leaf in tree_leaves_with_names(row)}

    def _restore_over_ranks(self, key, sealed, slot, prefix, suffix):
        sealer = self._sealer
        like = self.inner.model.abstract_cache(1, self.inner.max_len)
        dims = self.inner.plan.kv_dims(like)
        full = sealer.unseal(key, {path: sealed[prefix + path + suffix]
                                   for path, _ in tree_leaves_with_names(like)},
                             self._owner(slot))
        insert_slot(self.inner.cache, tree_map_with_names(
            lambda p, _: sealer.mine(full[p], dims[p]), like), slot)


def make_backend(kind: str, model, *, max_slots: int, max_len: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 plan: Optional[ComputePlan] = None,
                 prefix_sharing: bool = False,
                 alloc: Optional[str] = None,
                 decode: str = "gather",
                 page_store: Any = None,
                 store_budget_pages: Optional[int] = None) -> KVBackend:
    """Factory behind ``Engine(kv_backend=...)``. With a sharded ``plan``
    the chosen layout is wrapped for per-shard sealing. ``prefix_sharing``,
    ``alloc``, ``decode`` and ``page_store`` are paged-only."""
    if kind == "slot":
        if (prefix_sharing or alloc is not None or decode != "gather"
                or page_store or store_budget_pages is not None):
            raise ValueError("prefix_sharing / kv_alloc / kv_decode / "
                             "page_store need kv_backend='paged' (the dense "
                             "slot layout has no pages to share, grant, "
                             "table-walk, or store)")
        kv: KVBackend = SlotDenseBackend(model, max_slots, max_len, plan)
    elif kind == "paged":
        from repro_torch.runtime.paged import PagedKVBackend
        kv = PagedKVBackend(model, max_slots, max_len,
                            page_size=page_size, num_pages=num_pages,
                            plan=plan, prefix_sharing=prefix_sharing,
                            alloc=alloc, decode=decode,
                            page_store=page_store,
                            store_budget_pages=store_budget_pages)
    else:
        raise ValueError(
            f"unknown kv backend {kind!r} (want 'slot' or 'paged')")
    if kv.plan.is_sharded:
        return ShardedKVBackend(kv)   # type: ignore[return-value]
    return kv
