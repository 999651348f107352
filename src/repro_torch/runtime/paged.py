"""Paged KV backend (port of ``repro.runtime.paged``).

Layout. Every cache leaf with a sequence-length axis (attention ``k``/``v``,
MLA ``ckv``/``krope``) is stored as a pool ``[L, num_pages + 1, page_size,
...]``: physical page 0 is the null page (the write target of rows that
are not appending), pages ``1..num_pages`` are allocatable. A host-side
``[max_slots, max_pages]`` int32 page table maps each sequence's logical
pages to physical ones (entry 0 = unmapped); positions live host-side too.
Leaves without a length axis (Mamba ``conv``/``ssm``, RWKV rows) stay
slot-dense ``[L, max_slots, ...]``: a decode step advances only the rows
that append, so a paused row's state stays frozen bit for bit, and a seal
carries the slot's row of each under ``{prefix}{leaf}``. A model with no
length leaf at all has nothing to page (use the slot backend).

Allocation (``alloc=``). ``"reserve"`` (the default): admission reserves
``ceil(need / page_size)`` pages, the request's worst case, and physical
pages are mapped as positions are written, so an append can never fail
(allocated <= reserved <= num_pages). ``"ondemand"`` (implied by
``prefix_sharing``): admission promises only the prompt's pages, and the
engine grants each step's appends and copies (``step_page_need``), evicting
by slack when the pool runs dry.

Prefix sharing (``prefix_sharing=True``). A content index maps the running
hash of the prompt's token ids up to the end of each page
(:func:`prefix_page_keys`) to one physical page with a refcount equal to
its live table mappings. ``insert_prefill`` maps an index hit instead of
writing a copy; an append into an indexed page (only ever the partial
prompt page) copies it first while other mappings remain (copy-on-write),
or unregisters it when the writer is its sole user.

Decode (``decode=``). ``"gather"`` gathers each slot's pages into the dense
``[L, max_slots, max_len, ...]`` view the model's ``decode_step`` expects,
runs it, and writes the one appended position back into the pool in place.
``"kernel"`` runs the dense family's layer loop itself and attends through
``kernels/paged_attention.py`` (kernels B3 and B4 on the card), which walk
the page table without a gather: write-then-attend, as the gather path. It
takes one uniform attn + swiglu block (the dense and vlm families) on a
single-device plan, and refuses any other model or a mesh, as the reference
does.

Sealing. Preemption seals per page: each private page of each paged leaf
becomes its own ciphertext + MAC under ``{prefix}{leaf}/p{ordinal}``, with a
meta blob ``[pos, n_alloc, n_shared, (ordinal, refcount)...]``. Shared pages
seal by reference: their content keys ride in a ``/sharedkeys`` blob, and
restore re-links the resident page. A shared page's data crosses the
boundary only when its last live mapping drops while sealed references
remain: it is parked once under its content-derived name and brought back
by the first restore that needs it. In kernel mode a whole-slot restore
MAC-checks each full private page and places its ciphertext bits straight
into the pool with a sidecar row (nonce + live flag); B4 decrypts it on
every read. Any other reader of such a page (seal, partial eviction, an
append) first materializes it: decrypts it in place through the ChaCha20
kernel (B1). ``seal_tail_pages``/``restore_tail_pages`` evict and bring
back a victim's (private) tail pages only. Under a mesh every sealed name
ends in the slot's shard tag, ``/s{shard}`` (the ``suffix`` arguments,
which :class:`~repro_torch.runtime.kvcache.ShardedKVBackend` fills in).

Page store (``page_store=``). The persistent tier behind the content index
(:mod:`repro_torch.runtime.pagestore`): parking's content-named ciphertext,
retained past the last live or sealed reference. Aligned FULL pages
publish to the store when their data is already sealed (parking, the last
sealed reference's discard) or when their last mapping drops unsealed
(release, sole-user divergence: one fresh seal under the same canonical
name parking uses, so re-publishing resident content is a membership
no-op). ``insert_prefill``'s index misses and ``restore``'s
neither-resident-nor-parked case consult the store: a hit is MAC-verified
and decrypted before any page or refcount moves, then mapped like a shared
page. Store residency also discounts ``admission_check``'s effective need.
Entries are namespaced per sealing-key domain, so another tenant's lookups
are clean misses.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sealing import (IntegrityError, SealedTensor,
                                      SealingKey, nonce_words_for,
                                      seal_tensor, shared_page_name,
                                      tree_leaves_with_names, unseal_tensor,
                                      verify_mac)
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_unseal,
                                                 supports_fused_unseal)
from repro_torch.models import layers
from repro_torch.models.transformer import BLOCK, SLOT, _layer
from repro_torch.runtime import sampling
from repro_torch.runtime.kvcache import (_SUFFIX_RE, KVBackend, RankSealer,
                                        host_upload)
from repro_torch.runtime.pagestore import SealedPageStore
from repro_torch.runtime.plan import ComputePlan

Cache = Any
Params = Any

# cache-leaf names that carry a [.., max_len, ..] sequence axis at dim 2
_LENGTH_LEAVES = ("k", "v", "ckv", "krope")


def prefix_page_keys(tokens: np.ndarray, page_size: int, written_len: int,
                     salt: bytes = b"") -> List[bytes]:
    """Content keys for the pages covering ``tokens[:written_len]``: key j is
    the running sha256 of every token id up to the end of page j (KV at a
    position depends on all earlier tokens, so only a true prefix may
    share), truncated to 16 bytes; the last page may be partial."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32)[:written_len])
    h = hashlib.sha256(salt)
    keys = []
    for j in range(-(-int(written_len) // page_size)):
        h.update(toks[j * page_size:(j + 1) * page_size].tobytes())
        keys.append(h.digest()[:16])
    return keys


def _with_leaves(tree: Cache, fn, path: str = "") -> Cache:
    """Rebuild a nested dict, each leaf replaced by ``fn(keystr, leaf)``."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, fn, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return fn(path, tree)


class PagedKVBackend(KVBackend):
    """See module docstring; constructed via ``Engine(kv_backend="paged")``
    or ``kvcache.make_backend("paged", ...)``."""

    name = "paged"
    supports_partial = True

    def __init__(self, model, max_slots: int, max_len: int, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 plan: Optional[ComputePlan] = None,
                 prefix_sharing: bool = False, alloc: Optional[str] = None,
                 decode: str = "gather", page_store: Any = None,
                 store_budget_pages: Optional[int] = None):
        super().__init__(model, max_slots, max_len, plan)
        if decode not in ("gather", "kernel"):
            raise ValueError(f"decode must be 'gather' or 'kernel', "
                             f"got {decode!r}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        if alloc is None:
            alloc = "ondemand" if prefix_sharing else "reserve"
        if alloc not in ("reserve", "ondemand"):
            raise ValueError(f"alloc must be 'reserve' or 'ondemand', "
                             f"got {alloc!r}")
        if prefix_sharing and alloc != "ondemand":
            # copy-on-write turns a shared mapping into a private page at
            # step time, which no admission-time worst case can cover
            raise ValueError("prefix_sharing requires alloc='ondemand'")
        # the persistent sealed-page store: a ready SealedPageStore (which
        # backends may share), True, or a policy name; store_budget_pages
        # alone implies an LRU store
        if page_store is False:
            page_store = None
        if page_store is None and store_budget_pages is not None:
            page_store = "lru"
        if page_store is not None and not prefix_sharing:
            raise ValueError(
                "page_store requires prefix_sharing=True (the store is the "
                "tier behind the content index — without page keys there is "
                "nothing to address it by)")
        if page_store is True:
            page_store = "lru"
        if isinstance(page_store, str):
            page_store = SealedPageStore(budget_pages=store_budget_pages,
                                         policy=page_store)
        elif page_store is not None and store_budget_pages is not None:
            raise ValueError(
                "store_budget_pages configures a store the backend "
                "constructs; a ready SealedPageStore carries its own budget")
        self.page_store = page_store
        self.store_key: Optional[SealingKey] = None
        self.store_hits = 0             # pages served from the store
        self.store_restored_pages = 0
        self.store_restored_bytes = 0
        self.on_demand = alloc == "ondemand"
        self.prefix_sharing = prefix_sharing
        self.supports_sharing = prefix_sharing
        self.page_size = page_size
        self.max_pages = max_len // page_size
        if num_pages is None:
            num_pages = max_slots * self.max_pages   # dense-equivalent pool
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._key_salt = f"{model.cfg.name}|{page_size}|{max_len}".encode()

        # classify leaves once: length leaves move to pool layout, the
        # recurrent-state rest stays slot-dense
        template = model.abstract_cache(max_slots, max_len)
        template.pop("pos")
        self._pools: Dict[str, torch.Tensor] = {}
        self._dense: Dict[str, torch.Tensor] = {}
        for path, leaf in tree_leaves_with_names(template):
            if (path.endswith(tuple(f"[{k!r}]" for k in _LENGTH_LEAVES))
                    and leaf.dim() >= 3 and leaf.shape[2] == max_len):
                self._pools[path] = torch.zeros(
                    (leaf.shape[0], num_pages + 1, page_size,
                     *leaf.shape[3:]), dtype=leaf.dtype, device=self.device)
            else:
                self._dense[path] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                                device=self.device)
        if not self._pools:
            raise ValueError(
                f"model {model.cfg.name} has no sequence-length KV leaves to "
                f"page; use kv_backend='slot' for pure-state families")
        leaves = {**self._pools, **self._dense}
        whole = _with_leaves(template, lambda p, _: leaves[p])
        self.blocks = self.plan.place_paged_cache(whole, tuple(self._pools))
        placed = dict(tree_leaves_with_names(self.blocks))
        self._pools = {p: placed[p] for p in self._pools}
        self._dense = {p: placed[p] for p in self._dense}
        # over ranks: the dim of a page [L, page, ...] (a pool's dim less
        # one) or of a slot's row [L, 1, ...] over which this rank holds
        # only its model block (-1: whole), and the sealer every blob goes
        # through (see _seal_blob)
        dims = self.plan.kv_dims(whole)
        del whole, leaves
        self._kv_dim = {p: dims[p] - 1 if p in self._pools and dims[p] > 0
                        else dims[p] for p in placed}
        self._sealer = (RankSealer(self.plan)
                        if getattr(self.plan, "ranks", False) else None)

        # host-side sequence state
        self.pos = np.zeros(max_slots, np.int32)           # live KV positions
        self.table = np.zeros((max_slots, self.max_pages), np.int32)
        self._free_pages: List[int] = list(range(1, num_pages + 1))
        self._alloc = np.zeros(max_slots, np.int32)        # pages mapped
        self._reserved = np.zeros(max_slots, np.int32)     # pages promised
        self._reserve_free = num_pages
        # on-demand admission promises: pages pledged to an admitted but not
        # yet prefilled slot, so a batched admission group cannot overcommit
        # the free list between acquire() and insert_prefill()
        self._promised = np.zeros(max_slots, np.int32)
        self._promised_total = 0
        # prefix sharing: _page_ref counts live table mappings per physical
        # page (a private page holds 1); _index/_page_key is the content
        # index both ways; _sealed_refs counts sealed-out requests whose
        # meta references a content key; _parked holds the content-named
        # ciphertext of pages whose last live mapping dropped while sealed
        # references remain; _partial_keys are keys of pages that part-fill
        # (registered past written_len), never published to the store (a
        # content property: the chain hash covers the same truncated run).
        self._page_ref = np.zeros(num_pages + 1, np.int32)
        self._index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self._sealed_refs: Dict[bytes, int] = {}
        self._parked: Dict[bytes, Dict[str, SealedTensor]] = {}
        self._partial_keys: set = set()
        self._seal_key_cache: Optional[SealingKey] = None
        self._events: List[Tuple[str, int, int]] = []  # (kind, nbytes, n)
        self.shared_page_maps = 0     # mappings served by an index hit
        self.cow_copies = 0           # tail-page copy-on-write events
        self.pages_written = 0        # physical pages taken + written

        # ciphertext-resident pages (kernel mode): _cipher_pages holds the
        # physical pages whose pool bits are ciphertext, _crypt maps each
        # paged leaf to its [num_pages+1, 4] uint32 sidecar (nonce words
        # 0-2, live flag word 3), _crypt_key is the key they were sealed
        # under.
        self.decode_mode = decode
        self._cipher_pages: set = set()
        self._crypt: Dict[str, np.ndarray] = {}
        self._crypt_key: Optional[SealingKey] = None
        self.supports_fused = False
        self._fused_bpp = 0
        self.fused_restore_pages = 0
        self.fused_restore_bytes = 0
        self._page_shape = {p: (t.shape[0], page_size) + tuple(t.shape[3:])
                            for p, t in self._pools.items()}
        self._page_dtype = {p: t.dtype for p, t in self._pools.items()}
        if decode == "kernel":
            self._init_kernel_decode(model)
            self._decode_fn = self.plan.compile_decode(self._decode_kernel)
        else:
            self._decode_fn = self.plan.compile_decode(self._decode_gather)

    # -- decode ---------------------------------------------------------------
    def _decode_gather(self, params, tokens, table, pos, write_phys,
                       write_off):
        """Gather every slot's pages into the dense view, run the model's
        ``decode_step`` on it, and write the appended position (at ``pos``)
        back into the pool at (write_phys, write_off). The model steps a
        copy of each slot-dense leaf, and only the rows that append
        (``write_phys > 0``) take its new rows: a paused row's recurrent
        state stays where its sealed tail left it. Returns the logits."""
        b = self.max_slots
        view = {p: pool[:, table.long()].reshape(pool.shape[0], b,
                                                 self.max_len,
                                                 *pool.shape[3:])
                for p, pool in self._pools.items()}
        view.update({p: leaf.clone() for p, leaf in self._dense.items()})
        cache = _with_leaves(self.blocks, lambda p, _: view[p])
        cache["pos"] = pos.clone()
        logits, _ = self.plan.decode_step(params, tokens, cache)
        rows = torch.arange(b, device=pos.device)
        at = pos.long().clamp(max=self.max_len - 1)
        # over ranks a data shard stepped its rows only: every rank takes
        # every row's writes, so each rank's pool stays whole
        share = self.plan.share_rows
        for p, pool in self._pools.items():
            pool[:, write_phys, write_off] = share(view[p][:, rows, at])
        stepped = write_phys > 0
        for p, leaf in self._dense.items():
            mask = stepped.reshape(1, b, *([1] * (leaf.dim() - 2)))
            leaf.copy_(torch.where(mask, share(view[p]), leaf))
        return logits

    def _init_kernel_decode(self, model) -> None:
        """Kernel mode's gate, page geometry and fused-unseal eligibility:
        the plan must be single-device and the model one uniform attn +
        swiglu block (the reference's gates, with its errors), pages must
        cover whole ChaCha20 blocks and be f32 or bf16, and every leaf must
        share one blocks-per-page (k and v do)."""
        if self.plan.is_sharded:
            raise ValueError(
                "decode='kernel' requires a single-device plan (the paged-"
                "attention kernel reads the local pool; use decode='gather' "
                "on meshes)")
        blocks_desc = getattr(model._impl, "blocks", None)
        if (not blocks_desc or len(blocks_desc) != 1
                or blocks_desc[0][2] != [("attn", "swiglu")]):
            raise ValueError(
                f"decode='kernel' supports the dense attention family only "
                f"(one uniform attn+swiglu block); {model.cfg.name} has "
                f"{blocks_desc!r} — use decode='gather'")
        self._k_path = next(p for p in self._pools if p.endswith("['k']"))
        self._v_path = next(p for p in self._pools if p.endswith("['v']"))
        page_bytes = {p: int(np.prod(t.shape[2:])) * t.element_size()
                      for p, t in self._pools.items()}
        self.supports_fused = (
            len(set(page_bytes.values())) == 1
            and all(supports_fused_unseal(t.dtype, page_bytes[p])
                    for p, t in self._pools.items()))
        self._fused_bpp = (next(iter(page_bytes.values())) // 64
                           if self.supports_fused else 0)
        for p in self._pools:
            self._crypt[p] = np.zeros((self.num_pages + 1, 4), np.uint32)

    def _decode_kernel(self, params, tokens, table, pos, write_phys,
                       write_off, crypts=None, key_words=None):
        """The dense family's ``decode_step`` with the gather + sdpa
        replaced by the table-walking kernels: per layer, append this
        step's k/v into the pool (idle rows write the null page), then
        attend through B3, or through B4 when ciphertext-resident pages
        exist (``crypts`` is then the k and v sidecars). Returns the
        logits."""
        impl, cfg = self.model._impl, self.model.cfg
        x = layers.embed(params["embedding"], tokens)        # [b, 1, d]
        positions = pos[:, None]
        valid = pos + 1
        kp, vp = self._pools[self._k_path], self._pools[self._v_path]
        for li in range(cfg.num_layers):
            lp = _layer(params[BLOCK], li)[SLOT]
            h = layers.rmsnorm(lp["pre_norm"], x, cfg.norm_eps)
            q, k, v = layers._qkv(lp["attn"], impl.acfg, h, positions)
            kl, vl = kp[li], vp[li]
            kl[write_phys, write_off] = k[:, 0].to(kl.dtype)
            vl[write_phys, write_off] = v[:, 0].to(vl.dtype)
            q0 = q[:, 0].contiguous()
            if crypts is None:
                out = paged_attention(q0, kl, vl, table, valid)
            else:
                out = paged_attention_unseal(
                    q0, kl, vl, table, valid, li, key_words, *crypts,
                    blocks_per_page=self._fused_bpp)
            x = x + torch.einsum("bshk,hkd->bsd", out.to(q.dtype)[:, None],
                                 lp["attn"]["wo"])
            h = layers.rmsnorm(lp["post_norm"], x, cfg.norm_eps)
            x = x + layers.swiglu(lp["ffn"], h)
        return impl._unembed(params, x)[:, 0]

    # -- page accounting ------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    @property
    def free_page_reserve(self) -> int:
        """Pages an admission may still promise: unreserved pages in reserve
        mode, unpromised free physical pages on demand."""
        if self.on_demand:
            return len(self._free_pages) - self._promised_total
        return self._reserve_free

    @property
    def free_physical_pages(self) -> int:
        return len(self._free_pages)

    def allocated_pages(self, slot: int) -> int:
        return int(self._alloc[slot])

    @property
    def request_capacity(self) -> int:
        # a sequence can neither outgrow max_len nor out-reserve the pool
        return min(self.max_len, self.num_pages * self.page_size)

    def page_keys(self, tokens: np.ndarray, written_len: int
                  ) -> Optional[List[bytes]]:
        """Content keys for a prompt's prefill pages (None when sharing is
        off)."""
        if not self.prefix_sharing:
            return None
        return prefix_page_keys(tokens, self.page_size, written_len,
                                self._key_salt)

    def resident_pages(self, page_keys: Optional[Sequence[bytes]]) -> int:
        """How many of these content keys are resident in the LIVE index
        now. Store residency is left out: admission's page promises size
        physical takes from this count, and a store hit still takes a fresh
        page; only the pricing discount (:meth:`admission_check`) sees the
        store."""
        if not page_keys:
            return 0
        return sum(1 for k in page_keys if k in self._index)

    def store_resident_pages(self, page_keys: Optional[Sequence[bytes]]
                             ) -> int:
        """How many of these content keys the store could serve beyond the
        live index: the admission discount's second tier."""
        if not page_keys or self.page_store is None:
            return 0
        skey = self._content_key()
        if skey is None:
            return 0
        return sum(1 for k in page_keys
                   if k not in self._index
                   and self.page_store.contains(skey, k))

    def admission_check(self, need: int, page_keys: Optional[Sequence[bytes]]
                        = None) -> Tuple[bool, int]:
        """(fits, effective_need). Sharing does not relax the capacity bound
        (every page of one sequence holds its own table mapping); it
        discounts the effective demand by the shared positions resident in
        the index or the store (a store hit skips the prefill recompute,
        though its page still takes a fresh physical page)."""
        resident = (self.resident_pages(page_keys)
                    + self.store_resident_pages(page_keys))
        eff = max(1, int(need) - resident * self.page_size)
        return need <= self.request_capacity, eff

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= self.free_page_reserve

    def can_restore(self, n_tokens: int,
                    n_pages: Optional[int] = None) -> bool:
        if not self.on_demand:
            return self.pages_for(n_tokens) <= self._reserve_free
        pages = n_pages if n_pages is not None else self.pages_for(n_tokens)
        # headroom: one page per active slot, so the restore is not evicted
        # straight back by the next step's appends
        return pages + len(self.slots.active) <= len(self._free_pages)

    def _take_pages(self, n: int) -> List[int]:
        assert n <= len(self._free_pages), \
            "page allocation exceeded reservation/grant — accounting bug"
        taken, self._free_pages = self._free_pages[:n], self._free_pages[n:]
        for p in taken:
            self._page_ref[p] = 1
            self._clear_crypt(p)
        return taken

    def _drop_ref(self, phys: int) -> None:
        """One table mapping of ``phys`` goes away; the page is freed (and
        unregistered, parked first if sealed references remain) only when
        its last mapping drops."""
        phys = int(phys)
        self._page_ref[phys] -= 1
        assert self._page_ref[phys] >= 0, "double-free — refcount bug"
        if self._page_ref[phys] == 0:
            self._unregister(phys)
            self._clear_crypt(phys)
            self._free_pages.append(phys)

    def bind_store_key(self, key: SealingKey) -> None:
        """Fix the key domain this backend's store traffic lives under (the
        engine binds its trust domain's sealing key at construction). Two
        engines sharing one store under different keys never see each
        other's entries: a cross-domain lookup is a clean miss."""
        self.store_key = key

    def _content_key(self) -> Optional[SealingKey]:
        """The key content-named blobs (parking and the store) seal under:
        the bound store key, else the last key seen. One selection for both
        tiers, so parked blobs and store entries are interchangeable."""
        return self.store_key or self._seal_key_cache

    def _seal_content_page(self, key: SealingKey, key_bytes: bytes,
                           phys: int) -> Dict[str, SealedTensor]:
        """Seal one resident page under its canonical content-derived name
        (same content => same name => same nonce and plaintext)."""
        pages = self._page_arrays([phys])
        return {kpath: self._seal_blob(key, shared_page_name(key_bytes, kpath),
                                       arr[:, 0], kpath)
                for kpath, arr in pages.items()}

    def _publish_store(self, skey: SealingKey, key_bytes: bytes,
                       blobs: Dict[str, SealedTensor]) -> None:
        """Hand content-named blobs to the store; the evictions its budget
        forces surface as events (no boundary crossing: the host forgets
        ciphertext)."""
        for e in self.page_store.publish(skey, key_bytes, blobs,
                                         tokens=self.page_size):
            self._events.append(("store_evict", e.n_bytes, len(e.blobs)))

    def _count_store_hit(self, n_bytes: int, n_blobs: int) -> None:
        """One page restored from the store (a restore crossing)."""
        self.store_hits += 1
        self.store_restored_pages += 1
        self.store_restored_bytes += n_bytes
        self._events.append(("store_hit", n_bytes, n_blobs))

    def _unregister(self, phys: int) -> None:
        """The page leaves the content index (its last mapping dropped, or
        its sole user is about to write into it): parked first while sealed
        references remain, and a full page published to the store (reusing
        the parked blobs when parking just sealed them, else sealed once
        here, a ``store_publish`` crossing)."""
        key = self._page_key.pop(phys, None)
        if key is None:
            return
        del self._index[key]
        if self._sealed_refs.get(key, 0) > 0:
            self._park(key, phys)
        if self.page_store is not None and key not in self._partial_keys:
            skey = self._content_key()
            if skey is not None and not self.page_store.contains(skey, key):
                blobs = self._parked.get(key)
                if blobs is None:
                    blobs = self._seal_content_page(skey, key, phys)
                    self._events.append(
                        ("store_publish",
                         sum(b.n_bytes for b in blobs.values()), len(blobs)))
                self._publish_store(skey, key, blobs)

    def _park(self, key_bytes: bytes, phys: int) -> None:
        """The last live mapping of a sealed-referenced shared page drops:
        its data crosses the boundary once, under its content-derived name
        (same content => same nonce and same plaintext, so parking the same
        content again can never pair one nonce with two plaintexts)."""
        key = self._content_key()
        assert key is not None, \
            "sealed refs exist but no sealing key was ever seen"
        if key_bytes in self._parked:
            return
        blobs = self._seal_content_page(key, key_bytes, phys)
        self._parked[key_bytes] = blobs
        self._events.append(("park", sum(b.n_bytes for b in blobs.values()),
                             len(blobs)))

    def drain_events(self) -> List[Tuple[str, int, int]]:
        """Boundary traffic generated outside an explicit seal/restore call
        (parking, re-materialization and in-place page decryption); the
        engine drains it into the TrustDomain accounting."""
        ev, self._events = self._events, []
        return ev

    # -- sequence lifecycle ---------------------------------------------------
    def acquire(self, rid: int, n_tokens: int) -> Optional[int]:
        need = self.pages_for(n_tokens) if n_tokens > 0 else 0
        if need > self.free_page_reserve:
            return None
        slot = self.slots.acquire(rid)
        if slot is None:
            return None
        if self.on_demand:
            # promise only the prompt's pages; decode pages are granted at
            # step time
            self._promised[slot] = need
            self._promised_total += need
        else:
            self._reserved[slot] = need
            self._reserve_free -= need
        return slot

    def release(self, slot: int) -> None:
        for j in range(int(self._alloc[slot])):
            self._drop_ref(self.table[slot, j])
        self.table[slot] = 0
        self._alloc[slot] = 0
        self._reserve_free += int(self._reserved[slot])
        self._reserved[slot] = 0
        self._promised_total -= int(self._promised[slot])
        self._promised[slot] = 0
        self.pos[slot] = 0
        self.slots.release(slot)

    # -- device compute -------------------------------------------------------
    @torch.inference_mode()
    def insert_prefill(self, prefilled: Cache, slots: List[int],
                       written_len: int,
                       page_keys: Optional[List[Optional[List[bytes]]]] = None
                       ) -> None:
        """Map each slot's prompt pages (slot by slot, in order): a page
        whose content key is resident (or registered by an earlier member
        of this group) maps the shared page; an index miss that the store
        holds takes a fresh page and gets the store's plaintext; any other
        takes a fresh page, registered under its key, and gets the
        prefilled rows copied in. Every store hit is unsealed (MAC-checked)
        before any page or refcount moves, so a tampered entry fails the
        whole group without a leak. Slot-dense leaves take the group's rows
        (row i into slot ``slots[i]``)."""
        n_pages = self.pages_for(written_len)
        skey = self._content_key() if self.page_store is not None else None
        # phase 1: plan every slot's pages without touching state; pending
        # holds keys an earlier group member registers at commit
        plans: List[List[Tuple[str, int, Optional[bytes], Any]]] = []
        pending: set = set()
        for i in range(len(slots)):
            keys = page_keys[i] if page_keys else None
            plan = []
            for j in range(n_pages):
                key = keys[j] if keys else None
                if key is not None and (key in self._index or key in pending):
                    plan.append(("hit", j, key, None))
                    continue
                if key is not None and skey is not None:
                    blobs = self.page_store.lookup(skey, key)
                    if blobs is not None:
                        plain = self._unseal_blobs(skey, blobs)
                        nb = sum(st.n_bytes for st in blobs.values())
                        plan.append(("store", j, key, (plain, nb)))
                        pending.add(key)
                        continue
                plan.append(("miss", j, key, None))
                if key is not None:
                    pending.add(key)
            plans.append(plan)
        # phase 2: commit: map hits, take pages for store hits and misses
        src_rows, page_ord, phys = [], [], []
        store_writes: Dict[int, Dict[str, torch.Tensor]] = {}
        for i, slot in enumerate(slots):
            taken = self._take_pages(sum(1 for pl in plans[i]
                                         if pl[0] != "hit"))
            for kind, j, key, data in plans[i]:
                if kind == "hit":
                    p = self._index[key]
                    self._page_ref[p] += 1
                    self.table[slot, j] = p
                    self.shared_page_maps += 1
                    continue
                p = taken.pop(0)
                self.table[slot, j] = p
                if key is not None:
                    self._index[key] = p
                    self._page_key[p] = key
                if kind == "store":
                    plain, nb = data
                    store_writes[p] = plain
                    self._count_store_hit(nb, len(plain))
                    continue
                if key is not None and (j + 1) * self.page_size > written_len:
                    self._partial_keys.add(key)
                src_rows.append(i)
                page_ord.append(j)
                phys.append(p)
            self._alloc[slot] = n_pages
            self.pos[slot] = written_len
            self._promised_total -= int(self._promised[slot])
            self._promised[slot] = 0
        # store-restored pages are not pages_written: that counter is the
        # prefill-write cost a warm store shrinks (store_restored_pages
        # counts the restores)
        self.pages_written += len(phys)
        self._scatter_pages(store_writes)
        idx = [torch.as_tensor(x, dtype=torch.long, device=self.device)
               for x in (src_rows, page_ord, phys, slots)]
        k = len(slots)
        for path, src in tree_leaves_with_names(prefilled):
            if path in self._dense:
                leaf = self._dense[path]
                leaf[:, idx[3]] = src[:, :k].to(leaf.dtype)
            elif path in self._pools and phys:
                pool = self._pools[path]
                pages = src.reshape(src.shape[0], src.shape[1],
                                    self.max_pages, self.page_size,
                                    *src.shape[3:])
                pool[:, idx[2]] = pages[:, idx[0], idx[1]].to(pool.dtype)

    def step_page_need(self, slot: int) -> int:
        """Physical pages decode() takes for this slot's next append: 1 for
        a fresh page at a page boundary, 1 for a copy-on-write of a page
        other live mappings still read, else 0."""
        ordinal = int(self.pos[slot]) // self.page_size
        if ordinal >= int(self._alloc[slot]):
            return 1
        p = int(self.table[slot, ordinal])
        return int(p in self._page_key and self._page_ref[p] > 1)

    @torch.inference_mode()
    def _prepare_write(self, slot: int) -> Tuple[int, int]:
        """The physical (page, offset) of this slot's append: a fresh page
        at a page boundary; a write into an indexed page copies it first
        while other mappings remain (copy-on-write, queued on the pool's
        stream ahead of the decode step that appends into the copy), or
        unregisters it when the writer is its sole user."""
        ordinal = int(self.pos[slot]) // self.page_size
        if ordinal >= int(self._alloc[slot]):
            assert ordinal == int(self._alloc[slot])
            assert self.on_demand or ordinal < int(self._reserved[slot])
            self.table[slot, ordinal] = self._take_pages(1)[0]
            self._alloc[slot] = ordinal + 1
            self.pages_written += 1
        p = int(self.table[slot, ordinal])
        if p in self._page_key:
            if self._page_ref[p] > 1:
                new = self._take_pages(1)[0]
                for pool in self._pools.values():
                    pool[:, new] = pool[:, p]
                self._page_ref[p] -= 1
                self.table[slot, ordinal] = new
                self.cow_copies += 1
                self.pages_written += 1
                p = new
            else:
                self._unregister(p)
        # backstop: an append never lands in ciphertext (restore admits only
        # FULL pages as ciphertext, so the next append maps a fresh page)
        if p in self._cipher_pages:
            self._materialize_page(p)
        return p, int(self.pos[slot]) % self.page_size

    def decode(self, params, tokens, state, kmax,
               write_slots: Sequence[int]) -> np.ndarray:
        logits = self.decode_logits(params, tokens, write_slots)
        return sampling.pick(logits, state, kmax).cpu().numpy()

    def decode_logits(self, params, tokens,
                      write_slots: Sequence[int]) -> torch.Tensor:
        """One decode step over every row, as :meth:`decode`, returning the
        f32 logits ``[max_slots, vocab]`` on the device instead of tokens."""
        write_phys = np.zeros(self.max_slots, np.int64)   # default: null page
        write_off = np.zeros(self.max_slots, np.int64)
        for s in write_slots:
            write_phys[s], write_off[s] = self._prepare_write(s)
        dev = self.device
        args = [params, host_upload(tokens[:, None], dev),
                host_upload(self.table, dev), host_upload(self.pos, dev),
                host_upload(write_phys, dev), host_upload(write_off, dev)]
        if self.decode_mode == "kernel" and self._cipher_pages:
            args += [tuple(host_upload(self._crypt[p].view(np.int32), dev)
                           for p in (self._k_path, self._v_path)),
                     self._crypt_key.key_words]
        logits = self._decode_fn(*args)
        for s in write_slots:
            self.pos[s] += 1
        return logits

    def cache_nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self._pools.values(), *self._dense.values()))

    # -- ciphertext-resident pages (fused-unseal restore path) ----------------
    def _admit_cipher_page(self, key: SealingKey, phys: int,
                           blobs: Dict[str, SealedTensor]
                           ) -> Dict[str, torch.Tensor]:
        """Admit a MAC-verified sealed page into the pool as raw ciphertext
        bits (the linear RFC 8439 stream in the page's plaintext layout) and
        arm its sidecar rows so B4 decrypts it on every read."""
        writes: Dict[str, torch.Tensor] = {}
        for kpath, st in blobs.items():
            raw = ops.unpack_u32(st.ciphertext, st.n_bytes)
            writes[kpath] = raw.view(self._page_dtype[kpath]).reshape(
                self._page_shape[kpath])
            self._crypt[kpath][phys, :3] = nonce_words_for(key, st.name)
            self._crypt[kpath][phys, 3] = 1
        self._cipher_pages.add(int(phys))
        self.fused_restore_pages += 1
        self.fused_restore_bytes += sum(st.n_bytes for st in blobs.values())
        return writes

    def _clear_crypt(self, phys: int) -> None:
        if phys in self._cipher_pages:
            self._cipher_pages.discard(phys)
            for kpath in self._crypt:
                self._crypt[kpath][phys] = 0

    @torch.inference_mode()
    def _materialize_page(self, phys: int) -> None:
        """Decrypt a ciphertext-resident page in place so other readers see
        plaintext: its words, packed as ``ops.pack_u32`` packs, XOR the
        keystream from counter 0 (layer l's blocks start at l *
        blocks_per_page, so one stream covers every layer) through the
        ChaCha20 wrapper, on the pool's device."""
        if phys not in self._cipher_pages:
            return
        writes: Dict[str, torch.Tensor] = {}
        nb = 0
        for kpath, pool in self._pools.items():
            page = pool[:, phys].contiguous()
            blocked, n = ops.pack_u32(page.reshape(-1).view(torch.uint8))
            ops.unseal_u32(self._crypt_key.key_words,
                           self._crypt[kpath][phys, :3], blocked, out=blocked)
            writes[kpath] = ops.unpack_u32(blocked, n).view(
                page.dtype).reshape(page.shape)
            nb += n
        self._clear_crypt(phys)
        self._scatter_pages({phys: writes})
        self._events.append(("materialize", nb, len(writes)))

    # -- sealing --------------------------------------------------------------
    def _page_arrays(self, phys: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The given physical pages of every paged leaf, keystr ->
        ``[L, n, page_size, ...]``, ciphertext-resident ones materialized
        first."""
        for p in phys:
            self._materialize_page(int(p))
        idx = torch.as_tensor(list(phys), dtype=torch.long, device=self.device)
        return {kpath: pool[:, idx] for kpath, pool in self._pools.items()}

    def _seal_pages(self, key: SealingKey, prefix: str,
                    ordinals: Sequence[int], phys: Sequence[int],
                    suffix: str = "") -> Dict[str, SealedTensor]:
        sealed: Dict[str, SealedTensor] = {}
        if not ordinals:
            return sealed
        for kpath, arr in self._page_arrays(phys).items():
            for j, ordinal in enumerate(ordinals):
                name = f"{prefix}{kpath}/p{ordinal}{suffix}"
                sealed[name] = self._seal_blob(key, name, arr[:, j], kpath,
                                               suffix)
        return sealed

    def _seal_meta(self, key: SealingKey, name: str, values,
                   suffix: str = "") -> SealedTensor:
        return self._seal_blob(key, name, np.asarray(values, np.int32),
                               suffix=suffix)

    def _unseal_meta(self, key: SealingKey, st: SealedTensor,
                     suffix: str = "") -> np.ndarray:
        return self._unseal_blobs(key, {0: st}, suffix)[0].cpu().numpy()

    # -- sealing over ranks ---------------------------------------------------
    def _owner(self, suffix: str) -> int:
        """The rank that seals and unseals a blob tagged ``suffix``: model
        coordinate 0 of the data shard the tag names, rank 0 for an
        untagged (content-named) blob."""
        m = _SUFFIX_RE.search(suffix)
        return self._sealer.owner(int(m.group(1)) if m else 0)

    def _seal_blob(self, key: SealingKey, name: str, x,
                   kpath: Optional[str] = None,
                   suffix: str = "") -> SealedTensor:
        """Seal one blob: a page or slot row of leaf ``kpath`` as this
        process holds it, or a host array. Over ranks the blob is sealed
        whole, once, by :meth:`_owner` (:class:`~repro_torch.runtime.
        kvcache.RankSealer`), and every rank gets its ciphertext."""
        if self._sealer is None:
            return seal_tensor(key, name, x, device=self.device)
        dim = self._kv_dim[kpath] if kpath is not None else -1
        return self._sealer.seal(key, name, x, dim, self._owner(suffix))

    def _unseal_blobs(self, key: SealingKey, blobs: Dict[Any, SealedTensor],
                      suffix: str = "") -> Dict[Any, torch.Tensor]:
        """Every blob's whole plaintext (MAC-checked); over ranks unsealed
        by :meth:`_owner` and broadcast."""
        if self._sealer is None:
            return {k: unseal_tensor(key, st) for k, st in blobs.items()}
        return self._sealer.unseal(key, blobs, self._owner(suffix))

    def _mine(self, kpath: str, whole: torch.Tensor) -> torch.Tensor:
        """This process's block of a whole page or row of leaf ``kpath``."""
        if self._sealer is None:
            return whole
        return self._sealer.mine(whole, self._kv_dim[kpath])

    def seal(self, key, slot, prefix, suffix: str = "",
             detach: bool = False) -> Dict[str, SealedTensor]:
        self._seal_key_cache = key
        n_alloc = int(self._alloc[slot])
        shared, private = [], []
        for j in range(n_alloc):
            # by-value seal for cross-pool migration (detach): shared pages
            # ship as private per-page ciphertext, so the blob needs neither
            # this pool's content index nor its parked blobs. The copies
            # restore as private pages on the destination; this pool's
            # residents, refcounts and _sealed_refs are left as they are.
            (shared if not detach and int(self.table[slot, j])
             in self._page_key else private).append(j)
        # meta v2: [pos, n_alloc, n_shared, (ordinal, refcount) per shared
        # page]; the content keys ride in their own sealed blob. The
        # refcount is the seal-time count (a diagnostic: it moves while
        # this request is out).
        meta = [int(self.pos[slot]), n_alloc, len(shared)]
        keys_cat = b""
        for j in shared:
            p = int(self.table[slot, j])
            k = self._page_key[p]
            meta += [j, int(self._page_ref[p])]
            keys_cat += k
            self._sealed_refs[k] = self._sealed_refs.get(k, 0) + 1
        meta_name = f"{prefix}/meta{suffix}"
        sealed = {meta_name: self._seal_meta(key, meta_name, meta, suffix)}
        if shared:
            keys_name = f"{prefix}/sharedkeys{suffix}"
            sealed[keys_name] = self._seal_blob(
                key, keys_name, np.frombuffer(keys_cat, np.uint8),
                suffix=suffix)
        sealed.update(self._seal_pages(
            key, prefix, private,
            [int(self.table[slot, j]) for j in private], suffix))
        for kpath, leaf in self._dense.items():
            name = f"{prefix}{kpath}{suffix}"
            sealed[name] = self._seal_blob(key, name, leaf[:, slot:slot + 1],
                                           kpath, suffix)
        return sealed

    def _shared_keys(self, key: SealingKey, sealed: Dict[str, SealedTensor],
                     name: str, suffix: str = "") -> List[bytes]:
        cat = self._unseal_meta(key, sealed[name], suffix).tobytes()
        return [cat[16 * i:16 * (i + 1)] for i in range(len(cat) // 16)]

    @torch.inference_mode()
    def restore(self, key, sealed, slot, prefix, n_tokens,
                suffix: str = "") -> None:
        # the reservation was re-made when the engine re-acquired the slot
        # (reserve mode); decrypt-then-commit: every MAC is verified before
        # any accounting state moves, so a tampered blob fails the restore
        # without leaking the slot, a page or a refcount.
        self._seal_key_cache = key
        meta = self._unseal_meta(key, sealed[f"{prefix}/meta{suffix}"],
                                 suffix)
        pos, n_alloc, n_shared = int(meta[0]), int(meta[1]), int(meta[2])
        shared_ords = [int(meta[3 + 2 * i]) for i in range(n_shared)]
        keys = (self._shared_keys(key, sealed,
                                  f"{prefix}/sharedkeys{suffix}", suffix)
                if n_shared else [])
        shared_set = set(shared_ords)
        ords = [j for j in range(n_alloc) if j not in shared_set]
        # kernel mode on a fused-capable pool: FULL private pages are
        # MAC-gated here but admitted as ciphertext; the partial tail page
        # (the next append writes into it) takes the host path.
        fused_set = (
            {j for j in ords if (j + 1) * self.page_size <= pos}
            if self.decode_mode == "kernel" and self.supports_fused
            else set())
        if fused_set:
            if (self._crypt_key is not None and self._cipher_pages
                    and self._crypt_key.key != key.key):
                # one key rides the decode step: flush residents sealed
                # under the previous key before switching
                for p in list(self._cipher_pages):
                    self._materialize_page(p)
            self._crypt_key = key
        # phase 1: MAC-verify everything (fused pages without decrypting;
        # the rest decrypted in one batch, over ranks on one rank)
        fused_blobs: Dict[int, Dict[str, SealedTensor]] = {}
        need: Dict[Tuple, SealedTensor] = {}
        for j in ords:
            blobs = {kpath: sealed[f"{prefix}{kpath}/p{j}{suffix}"]
                     for kpath in self._pools}
            if j in fused_set:
                for st in blobs.values():
                    verify_mac(key, st)
                fused_blobs[j] = blobs
            else:
                need.update({("p", j, kpath): st
                             for kpath, st in blobs.items()})
        # shared ordinals: re-link a page resident in the index, or bring
        # back (MAC-checked, here in phase 1) a parked one, or, third tier,
        # one the store outlived the parked blob with (a deadline abort
        # discarded the last sealed reference). Whatever is none of these
        # is lost content.
        relink: Dict[int, bytes] = {}
        remat: Dict[int, Tuple[str, bytes, Dict[str, torch.Tensor], int]] = {}
        for j, k in zip(shared_ords, keys):
            if k in self._index:
                relink[j] = k
                continue
            if k in self._parked:
                tier, blobs = "remat", self._parked[k]
            elif (self.page_store is not None
                  and self.page_store.contains(key, k)):
                tier, blobs = "store", self.page_store.lookup(key, k)
            else:
                raise IntegrityError(
                    f"shared page (ordinal {j}) is neither resident, "
                    f"parked, nor store-resident: sealed state references "
                    f"lost content")
            remat[j] = (tier, k, {}, sum(st.n_bytes for st in blobs.values()))
            need.update({("r", j, kpath): st for kpath, st in blobs.items()})
        need.update({("d", kpath): sealed[f"{prefix}{kpath}{suffix}"]
                     for kpath in self._dense})
        opened = self._unseal_blobs(key, need, suffix)
        pages = {j: {kpath: opened["p", j, kpath] for kpath in self._pools}
                 for j in ords if j not in fused_set}
        for j, (_, _, got, _) in remat.items():
            got.update({kpath: opened["r", j, kpath] for kpath in self._pools})
        dense_rows = {kpath: opened["d", kpath] for kpath in self._dense}
        # phase 2: commit: map, write, and account. Sealed references are
        # released by discard_sealed once the engine's whole restore
        # succeeded, so a rolled-back restore leaves parked blobs intact.
        assert self.on_demand or n_alloc <= int(self._reserved[slot]), \
            "restore into a smaller reservation — accounting bug"
        taken = iter(self._take_pages(len(ords) + len(remat)))
        writes: Dict[int, Dict[str, torch.Tensor]] = {}
        for j in ords:
            p = next(taken)
            self.table[slot, j] = p
            writes[p] = (self._admit_cipher_page(key, p, fused_blobs[j])
                         if j in fused_set else pages[j])
        for j in shared_ords:
            if j in relink:
                p = self._index[relink[j]]
                self._page_ref[p] += 1
                self.table[slot, j] = p
                self.shared_page_maps += 1
                continue
            tier, k, plain, nb = remat[j]
            p = next(taken)
            self.table[slot, j] = p
            self._index[k] = p
            self._page_key[p] = k
            writes[p] = plain
            if tier == "store":
                self._count_store_hit(nb, len(plain))
            else:
                self._events.append(("rematerialize", nb, len(plain)))
        self._alloc[slot] = n_alloc
        self.pos[slot] = pos
        # store-restored pages stay out of pages_written, as in
        # insert_prefill
        self.pages_written += len(writes) - sum(
            1 for tier, *_ in remat.values() if tier == "store")
        self._scatter_pages(writes)
        self._put_dense_rows(slot, dense_rows)

    def _put_dense_rows(self, slot: int,
                        rows: Dict[str, torch.Tensor]) -> None:
        """Write each slot-dense leaf's restored ``[L, 1, ...]`` row into
        slot ``slot``."""
        for kpath, row in rows.items():
            leaf = self._dense[kpath]
            row = self._mine(kpath, row)
            leaf[:, slot] = row[:, 0].to(leaf.device, leaf.dtype)

    def discard_sealed(self, key: SealingKey, sealed: Dict[str, SealedTensor],
                       prefix: str, suffix: str = "") -> None:
        """Release a spent sealed dict's shared-content references (after a
        fully successful restore, or when a sealed-out request is dropped
        unrestored): parked ciphertext dies with its last reference, handed
        to the store first when there is one (it is the store's canonical
        ciphertext, and admission may already have discounted a waiting
        request against it; a membership no-op when the release path
        already published it)."""
        name = f"{prefix}/sharedkeys{suffix}"
        if name not in sealed:
            return
        for k in self._shared_keys(key, sealed, name, suffix):
            if k in self._sealed_refs:
                self._sealed_refs[k] -= 1
                if self._sealed_refs[k] <= 0:
                    del self._sealed_refs[k]
                    blobs = self._parked.pop(k, None)
                    if (blobs is not None and self.page_store is not None
                            and k not in self._partial_keys):
                        skey = self._content_key()
                        if skey is not None:
                            self._publish_store(skey, k, blobs)

    @torch.inference_mode()
    def _scatter_pages(self, writes: Dict[int, Dict[str, torch.Tensor]]
                       ) -> None:
        """Write page tensors (``[L, page_size, ...]`` each) into the pool."""
        if not writes:
            return
        phys = list(writes)
        idx = torch.as_tensor(phys, dtype=torch.long, device=self.device)
        for kpath, pool in self._pools.items():
            pool[:, idx] = torch.stack(
                [self._mine(kpath, writes[p][kpath]).to(pool.device)
                 for p in phys], dim=1)

    # -- partial eviction -----------------------------------------------------
    def evictable_tail_pages(self, slot: int) -> int:
        """How many tail pages ``seal_tail_pages`` may take: trailing
        private pages only (a shared page cannot be torn out of other
        readers' tables), and the victim always keeps one resident page."""
        n_alloc = int(self._alloc[slot])
        trailing = 0
        for j in range(n_alloc - 1, -1, -1):
            if int(self.table[slot, j]) in self._page_key:
                break
            trailing += 1
        return max(0, min(trailing, n_alloc - 1))

    def seal_tail_pages(self, key: SealingKey, slot: int, prefix: str,
                        n_pages: int,
                        suffix: str = "") -> Dict[str, SealedTensor]:
        """Seal and free the ``n_pages`` most recent pages of ``slot``: the
        pages and their reservation go back to the pool while the victim
        keeps its slot and head pages. It must not decode until
        :meth:`restore_tail_pages` brings the delta back."""
        self._seal_key_cache = key
        n_alloc = int(self._alloc[slot])
        if not (0 < n_pages < n_alloc):
            raise ValueError(
                f"partial eviction wants 0 < n_pages < allocated "
                f"({n_alloc}), got {n_pages}")
        if n_pages > self.evictable_tail_pages(slot):
            raise ValueError(
                f"partial eviction of {n_pages} pages would cross into the "
                f"shared prefix (only {self.evictable_tail_pages(slot)} "
                f"trailing private pages)")
        ordinals = list(range(n_alloc - n_pages, n_alloc))
        phys = [int(p) for p in self.table[slot, ordinals]]
        meta_name = f"{prefix}/pagemeta{suffix}"
        sealed = {meta_name: self._seal_meta(key, meta_name,
                                             [ordinals[0], n_pages], suffix)}
        sealed.update(self._seal_pages(key, prefix, ordinals, phys, suffix))
        self.table[slot, ordinals] = 0
        self._alloc[slot] = n_alloc - n_pages
        for p in phys:
            self._drop_ref(p)
        if not self.on_demand:
            self._reserved[slot] -= n_pages
            self._reserve_free += n_pages
        return sealed

    def can_restore_tail(self, n_pages: int) -> bool:
        if not self.on_demand:
            return n_pages <= self._reserve_free
        # restore headroom as in can_restore, while other slots are live
        headroom = 1 if len(self.slots.active) > 1 else 0
        return n_pages + headroom <= len(self._free_pages)

    @torch.inference_mode()
    def restore_tail_pages(self, key: SealingKey,
                           sealed: Dict[str, SealedTensor], slot: int,
                           prefix: str, reserve: bool = True,
                           suffix: str = "") -> int:
        """Re-map and decrypt a partial eviction's pages into fresh physical
        pages; returns the page count. ``reserve=False`` skips re-reserving
        (the tail rides along a whole-slot restore whose ``acquire``
        already reserved the sequence's worst case)."""
        self._seal_key_cache = key
        meta = self._unseal_meta(key, sealed[f"{prefix}/pagemeta{suffix}"],
                                 suffix)
        start, n_pages = int(meta[0]), int(meta[1])
        if reserve and not self.on_demand:
            assert self.can_restore_tail(n_pages), \
                "restore_tail without can_restore_tail — accounting bug"
            self._reserved[slot] += n_pages
            self._reserve_free -= n_pages
        ordinals = list(range(start, start + n_pages))
        # decrypt first (MAC gate), then map and write
        plain = self._unseal_blobs(
            key, {(j, kpath): sealed[f"{prefix}{kpath}/p{j}{suffix}"]
                  for j in ordinals for kpath in self._pools}, suffix)
        pages = {j: {kpath: plain[j, kpath] for kpath in self._pools}
                 for j in ordinals}
        writes = {}
        for j, p in zip(ordinals, self._take_pages(n_pages)):
            self.table[slot, j] = p
            writes[p] = pages[j]
        self._alloc[slot] = start + n_pages
        self.pages_written += n_pages
        self._scatter_pages(writes)
        return n_pages
