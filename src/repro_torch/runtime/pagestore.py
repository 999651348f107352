"""Persistent content-addressed sealed-page store, the prefix-cache tier
(port of ``repro.runtime.pagestore``; plain Python over
:mod:`repro_torch.core.sealing`).

Prefix sharing (runtime/paged.py) only helps while something keeps a page
alive: a live table mapping holds plaintext in the pool, a sealed reference
parks ciphertext on the host. When the last reference drops, the parked
blob dies with it, and the next request carrying the same system prompt
pays a full prefill for content the domain already produced, sealed and
named.

The :class:`SealedPageStore` retains that ciphertext past the last
reference. It stores exactly the blobs parking mints, sealed under the
canonical content-derived name (:func:`repro_torch.core.sealing.shared_page_name`),
so identical content always seals to the same (nonce, plaintext) pair and
re-publishing a page the store already holds is a membership no-op: no new
ciphertext, no new nonce. The store holds ciphertext only; a hit is
MAC-verified on the way back into the pool like any other restore, so a
tampered entry fails closed before a single page moves.

Entries are namespaced per sealing-key domain (``SealingKey.key_id()``):
another tenant's lookup is a clean miss by construction, and a blob offered
across domains would fail the other domain's MAC key anyway.

Retention is budgeted in pages and pluggable:

* ``lru``: evict the least-recently-touched entry (publish and hit both
  refresh recency);
* ``cost``: evict the entry whose retention buys the least, scored by the
  ``overheads.predict``-priced restore-vs-recompute breakeven, weighted by
  observed hits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.overheads import store_restore_savings
from repro_torch.core.sealing import SealedTensor, SealingKey


@dataclasses.dataclass
class StoreEntry:
    """One retained page: content-named ciphertext plus retention state."""
    content_key: bytes                  # 16-byte prefix digest (the name)
    domain: str                         # SealingKey.key_id() namespace
    blobs: Dict[str, SealedTensor]      # kv leaf path -> sealed page
    n_bytes: int                        # plaintext bytes a hit restores
    tokens: int                         # prompt positions a hit avoids
    hits: int = 0
    stamp: int = 0                      # logical recency clock
    net_saving_s: float = 0.0           # priced recompute-minus-restore


def _lru(entries: Sequence[StoreEntry]) -> StoreEntry:
    return min(entries, key=lambda e: e.stamp)


def _cost(entries: Sequence[StoreEntry]) -> StoreEntry:
    # retention value = what keeping the page saves per future hit, scaled
    # by how often it actually hits (+1 so a never-hit entry still ranks by
    # its priced saving); recency breaks ties.
    return min(entries, key=lambda e: ((e.hits + 1) * e.net_saving_s, e.stamp))


POLICIES: Dict[str, Callable[[Sequence[StoreEntry]], StoreEntry]] = {
    "lru": _lru,
    "cost": _cost,
}


class SealedPageStore:
    """Content-addressed store of sealed KV pages, namespaced per key domain.

    ``budget_pages`` bounds total residency across all domains (None =
    unbounded); ``policy`` is ``"lru"``, ``"cost"``, or a callable picking
    the victim from a non-empty entry sequence. ``profile``/
    ``prefill_token_s`` feed the cost policy's restore-vs-recompute pricing
    (see :func:`repro_torch.core.overheads.store_restore_savings`).
    """

    def __init__(self, budget_pages: Optional[int] = None,
                 policy: "str | Callable" = "lru", profile: str = "tdx",
                 prefill_token_s: Optional[float] = None):
        if callable(policy):
            self._policy = policy
            self.policy = getattr(policy, "__name__", "custom")
        else:
            if policy not in POLICIES:
                raise ValueError(f"unknown store policy '{policy}' "
                                 f"(have {sorted(POLICIES)})")
            self._policy = POLICIES[policy]
            self.policy = policy
        if budget_pages is not None and budget_pages < 0:
            raise ValueError("store_budget_pages must be >= 0")
        self.budget_pages = budget_pages
        self.profile = profile
        self.prefill_token_s = prefill_token_s
        self._domains: Dict[str, Dict[bytes, StoreEntry]] = {}
        self._clock = 0
        # counters (the bench's hit-rate and retention rows read these)
        self.hits = 0
        self.misses = 0
        self.publishes = 0
        self.republish_noops = 0
        self.evictions = 0
        self.restored_bytes = 0
        self.published_bytes = 0
        self.evicted_bytes = 0

    # -- addressing ---------------------------------------------------------

    @property
    def resident_pages(self) -> int:
        return sum(len(d) for d in self._domains.values())

    def _domain(self, key: SealingKey) -> Dict[bytes, StoreEntry]:
        return self._domains.setdefault(key.key_id(), {})

    def contains(self, key: SealingKey, content_key: bytes) -> bool:
        """Membership under this key domain, without touching recency or
        counters — what admission discounts and republish checks use."""
        return content_key in self._domains.get(key.key_id(), {})

    def resident_count(self, key: SealingKey,
                       content_keys: Sequence[bytes]) -> int:
        dom = self._domains.get(key.key_id(), {})
        return sum(1 for k in content_keys if k in dom)

    # -- the two verbs ------------------------------------------------------

    def lookup(self, key: SealingKey,
               content_key: bytes) -> Optional[Dict[str, SealedTensor]]:
        """The consuming read: returns the sealed blobs (caller MAC-verifies
        by unsealing) or None. Domains are keyed by ``key.key_id()``, so a
        lookup under any other key — a different fleet tenant — is a clean
        miss however many domains hold this content key. Hits refresh
        recency; the entry is retained, not consumed."""
        entry = self._domains.get(key.key_id(), {}).get(content_key)
        if entry is None:
            self.misses += 1
            return None
        self._clock += 1
        entry.stamp = self._clock
        entry.hits += 1
        self.hits += 1
        self.restored_bytes += entry.n_bytes
        return entry.blobs

    def publish(self, key: SealingKey, content_key: bytes,
                blobs: Dict[str, SealedTensor], *,
                tokens: int = 0) -> List[StoreEntry]:
        """Retain sealed blobs under (key domain, content key).

        Re-publishing a resident key is a no-op by membership check alone —
        the content-derived name guarantees the caller's blobs are
        byte-identical to what the store holds, so nothing is re-sealed and
        no nonce is minted twice. Returns the entries evicted to stay
        within ``budget_pages`` (possibly including the fresh one when the
        budget is 0) so the caller can account them as events."""
        dom = self._domain(key)
        if content_key in dom:
            self.republish_noops += 1
            return []
        n_bytes = sum(st.n_bytes for st in blobs.values())
        self._clock += 1
        entry = StoreEntry(content_key=content_key, domain=key.key_id(),
                           blobs=blobs, n_bytes=n_bytes, tokens=tokens,
                           stamp=self._clock,
                           net_saving_s=self._net_saving(n_bytes, tokens))
        dom[content_key] = entry
        self.publishes += 1
        self.published_bytes += n_bytes
        evicted: List[StoreEntry] = []
        while (self.budget_pages is not None
               and self.resident_pages > self.budget_pages):
            victims = [e for d in self._domains.values() for e in d.values()]
            v = self._policy(victims)
            del self._domains[v.domain][v.content_key]
            self.evictions += 1
            self.evicted_bytes += v.n_bytes
            evicted.append(v)
        return evicted

    # -- pricing ------------------------------------------------------------

    def _net_saving(self, n_bytes: int, tokens: int) -> float:
        """Seconds a future hit on this entry saves (recompute minus
        restore), per the overhead model. <= 0 means recompute wins and the
        cost policy sheds the entry first."""
        restore, recompute, _ = store_restore_savings(
            1, n_bytes, tokens, self.profile,
            prefill_token_s=self.prefill_token_s)
        if restore is None or recompute is None:
            return 0.0
        return recompute.t_tee_s - restore.t_tee_s

    def describe(self) -> str:
        return (f"{self.resident_pages} resident pages in "
                f"{len(self._domains)} domains [policy={self.policy}, "
                f"budget={self.budget_pages}]: {self.hits} hits / "
                f"{self.misses} misses, {self.publishes} publishes "
                f"({self.republish_noops} republish no-ops), "
                f"{self.evictions} evictions")
