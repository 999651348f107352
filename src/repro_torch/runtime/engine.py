"""Inference engine (port of ``repro.runtime.engine``).

Dataflow per the paper's protected stack:
  prompt --(encrypted bounce buffer)--> bucketed batched prefill(slots)
  --> batched decode + sample loop --> tokens --(encrypted frames through
  the bounce buffer, 1..N tokens each per the request's FramePolicy)-->
  client.

This port serves on one device over the dense slot KV backend or the
paged one (gather or kernel decode; reservation or on-demand pages, with
prefix sharing, copy-on-write and the persistent sealed-page store):
bucketed left-padded batched prefill with chunked prompt tails, seeded
per-request sampling (temperature, top-k, top-p, penalties, logit bias),
priority/slack admission, per-priority rate budgets, sealed whole-slot
preemption and restore, page-granular partial preemption with paused
victims (paged), step-time page grants with evict-by-slack (on demand),
coalesced egress, streaming, drop/abort deadlines and admission-time
deadline feasibility. Scheduler decisions are the reference's, so the same
requests produce the same admissions, preemptions, seals, frames and
tokens. Every decoder family serves (dense, moe, hybrid, ssm, vlm; the
encoder-decoder has no token-in/token-out server, as in the reference).

Two-phase serving, as in the reference:

  * **Step-level continuous batching** (``continuous_batching=True``):
    each step's token budget (``step_tokens``, default ``largest bucket +
    max_slots``) splits between live decode rows (1 each) and prefill
    admissions (their bucket width); when the head's bucket does not fit
    the remainder, a smaller queued request backfills it
    (``Request.backfilled``) and the head keeps first claim on the next
    step's budget.
  * **Disaggregated prefill** (``prefill_plan="dedicated"``): prompts
    prefill on a :class:`~repro_torch.runtime.plan.PrefillOnlyPlan` (its
    own CUDA stream on the card, so the prefill overlaps the decode step
    issued after it) and are consumed at the top of the next step: the KV
    rows cross to the decode plan through a sealed handoff under
    ``kvhandoff/{stream}``, up to ``handoff_batch`` rows a crossing,
    accounted in ``ChannelStats`` like a preemption.

Decoded tokens are the same under every mode.

Fleet drain and migration: :meth:`Engine.drain` stops new submissions,
:meth:`Engine.export_sealed_state` seals every live request out under a
caller-chosen key (a fleet tenant's key domain) in a caller-named nonce
namespace, and :meth:`Engine.import_sealed_state` adopts another engine's
export.

Meshes: ``Engine(mesh="dp=N,tp=M")`` (or a ready plan, ``plan=``) runs on a
:class:`~repro_torch.runtime.plan.ShardedPlan`: the weights sit at rest in
per-shard chunks over ``data`` and are gathered every step, ``tp > 1``
splits the attention families' heads, ``d_ff`` and experts over ``model``
(numerically close to one device, not bitwise), each step's gather and collectives are
counted into ``ChannelStats.collective_*``, and the KV backend is wrapped
by :class:`~repro_torch.runtime.kvcache.ShardedKVBackend`, so sealed names
carry the row's ``/s{shard}`` tag. A dp-only mesh's tokens are the
single-device engine's.

On an initialized ``torch.distributed`` world of ``N * M`` ranks the mesh
spans the ranks and every rank runs this same engine loop on the same
requests: its plan computes its data shard's rows and its model shard's
heads, and the rows' logits are gathered over ``data``, so every rank
samples the same tokens and its scheduler stays in step (host decisions
are deterministic given identical logits and seeded sampling; decisions
that read the host clock -- rate budgets, deadlines, deadline feasibility
-- and the dedicated prefill plan are refused over ranks). Only global rank
0 sends egress frames. Each rank holds its own ``TrustDomain`` under the
same measurement and sealing key; only the rank at model coordinate 0 of a
row's data shard seals that row.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.confidential import TrustDomain
from repro_torch.core.sealing import (IntegrityError, seal_tree,
                                      sealed_nbytes, unseal_tree)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.runtime import sampling
from repro_torch.runtime.api import (FINISH_ABORTED, GenerationRequest,
                                     RequestOutput)
from repro_torch.runtime.kvcache import (KVBackend, SlotState, host_upload,
                                         make_backend, next_pow2,
                                         tail_blob_names)
from repro_torch.runtime.plan import (ComputePlan, PrefillOnlyPlan,
                                      ShardedPlan, SingleDevicePlan)
from repro_torch.runtime.scheduler import Request, Scheduler, ServeStats

Params = Any


@dataclasses.dataclass
class PreemptedRequest:
    """A sealed-out request waiting for a slot: KV as ciphertext only.

    ``key``/``prefix`` override the engine's defaults at restore time: a
    cross-worker migrant (fleet drain or failure) is sealed under a
    fleet-shared tenant key domain in a ``kvmigrate/{worker}/...`` nonce
    namespace instead of this worker's own key and ``kvslot/`` space.
    ``None`` means the local-preemption defaults."""
    sealed: Dict[str, Any]
    req: Request
    key: Optional[Any] = None
    prefix: Optional[str] = None


@dataclasses.dataclass
class InflightPrefill:
    """A request prefilling on the dedicated prefill plan: dispatched at
    admission (on the plan's stream on the card), its KV rows not yet
    handed to the decode plan. The slot is already reserved;
    :meth:`Engine._handoff_ready` consumes it at the next step. ``ready``
    is the event recorded after the prefill (None on the CPU)."""
    req: Request
    slot: int
    bucket: int
    logits: torch.Tensor
    cache: Any
    ready: Optional[Any] = None


@dataclasses.dataclass
class PausedSlot:
    """A partially-evicted running slot (paged backend): its tail pages are
    ciphertext outside the pool, the head pages stay resident, and the slot
    sits out of the decode batch until the delta is restored."""
    sealed: Dict[str, Any]
    prefix: str
    n_pages: int


class _RateBucket:
    """Token bucket for one priority class: refills at ``rate`` tokens/s up
    to ``burst``; admission charges a request's whole ``max_new_tokens`` up
    front (the KV reservation it will hold). A request larger than the burst
    is admitted on a full bucket and overdraws it (level goes negative), so
    nothing starves while the long-run rate still holds."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"rate budget must be > 0 tokens/s, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        self.level = self.burst
        self._t = time.monotonic()

    def _refill(self) -> None:
        now = time.monotonic()
        self.level = min(self.burst, self.level + (now - self._t) * self.rate)
        self._t = now

    def can(self, n: int) -> bool:
        self._refill()
        return self.level >= min(float(n), self.burst)

    def charge(self, n: int) -> None:
        self.level -= float(n)


class Engine:
    def __init__(self, model: Model, params: Params, *, max_slots: int = 4,
                 max_len: int = 512, trust_domain: Optional[TrustDomain] = None,
                 prefill_len: int = 64,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 batch_prefill: bool = True,
                 rate_budgets: Optional[Dict[int, float]] = None,
                 kv_backend: str = "slot", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_sharing: bool = False,
                 kv_alloc: Optional[str] = None,
                 kv_decode: str = "gather",
                 page_store: Any = None,
                 store_budget_pages: Optional[int] = None,
                 mesh: Optional[str] = None,
                 plan: Optional[ComputePlan] = None,
                 admission_order: str = "slack",
                 continuous_batching: bool = False,
                 step_tokens: Optional[int] = None,
                 prefill_plan: Union[None, str, ComputePlan] = None,
                 handoff_batch: int = 1,
                 reject_infeasible: bool = False,
                 step_time_hint_s: Optional[float] = None,
                 device=None):
        """Same arguments and defaults as the reference's engine, plus
        ``device`` (the card unless ``device="cpu"``; the model, and the
        trust domain if given, must live there too). ``prefill_buckets``
        supersedes the single static ``prefill_len``; ``batch_prefill=False``
        prefills one request per call. ``rate_budgets`` maps priority ->
        tokens/s. ``kv_backend`` is ``"slot"`` (dense) or ``"paged"`` (page
        pool + table; ``page_size``/``num_pages`` size it, ``num_pages=None``
        matches the dense footprint; ``kv_decode`` ``"gather"`` or
        ``"kernel"``, the table-walking paged-attention kernels).
        ``prefix_sharing`` (paged only) maps equal page-aligned prompt
        prefixes onto shared pages with copy-on-write; ``kv_alloc`` is
        ``"reserve"`` (worst-case admission reservations, the default) or
        ``"ondemand"`` (step-time grants, evicting by slack when the pool
        runs dry; implied by sharing). ``page_store`` (sharing only) is
        ``True``, a policy name (``"lru"``, ``"cost"``) or a ready
        :class:`~repro_torch.runtime.pagestore.SealedPageStore`;
        ``store_budget_pages`` alone implies an LRU store. Tokens are the
        same under all of these. ``admission_order`` is ``"slack"``
        (tightest deadline first, priority tiebreak) or ``"priority"``.
        ``continuous_batching`` (with ``step_tokens``) and ``prefill_plan``
        (``"dedicated"`` or a ready ``PrefillOnlyPlan``, with
        ``handoff_batch``) are the two-phase modes of the module docstring;
        they exclude each other. ``reject_infeasible`` refuses at ingest a
        request whose ``deadline_s`` is provably unmeetable at the fastest
        observed (or ``step_time_hint_s``) step time. ``mesh``
        (``"dp=N,tp=M"``) spans the engine over a mesh of logical shards on
        its device, or over the ranks of an initialized process group (see
        the module docstring); ``tp > 1`` runs every decoder family (dense,
        vlm, moe, jamba's hybrid and rwkv6's ssm: Mamba channels, rwkv6
        heads and their recurrent state split over ``model``), and on the
        encdec family raises ``NotImplementedError``. Equivalently pass a
        ready plan as ``plan``."""
        if plan is not None and mesh is not None:
            raise ValueError("pass mesh= or plan=, not both")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        if plan is None:
            plan = (ShardedPlan.from_spec(model, mesh) if mesh is not None
                    else SingleDevicePlan(model))
        self.plan = plan
        self._ranks = getattr(plan, "ranks", False)
        if self._ranks and (rate_budgets or reject_infeasible
                            or prefill_plan is not None):
            raise ValueError(
                "rate_budgets, reject_infeasible and prefill_plan are refused "
                "on a mesh over ranks: each rank decides on its own host "
                "clock (or plan), and the ranks' schedulers must stay in step")
        self.params = self.plan.place_params(params)
        self.max_slots = max_slots
        self.max_len = max_len
        self.prefill_len = prefill_len
        if prefill_buckets is None:
            prefill_buckets = (prefill_len,)
        self.prefill_buckets = tuple(sorted({int(b) for b in prefill_buckets}))
        if not self.prefill_buckets or min(self.prefill_buckets) < 1:
            raise ValueError(f"bad prefill buckets {self.prefill_buckets}")
        if max(self.prefill_buckets) >= max_len:
            raise ValueError("largest prefill bucket must leave decode room "
                             f"({self.prefill_buckets} vs max_len={max_len})")
        self.batch_prefill = batch_prefill
        self.td = trust_domain or TrustDomain("none", device=self.device)
        if self.td.device != self.device:
            raise ValueError(f"trust domain seals on {self.td.device}, "
                             f"engine runs on {self.device}")
        if self._ranks:
            key_id = torch.tensor(list(bytes.fromhex(
                self.td.sealing_key.key_id())), dtype=torch.uint8)
            if any(not torch.equal(k.cpu(), key_id) for k in
                   plan.mesh.world.all_gather_list([key_id])):
                raise ValueError(
                    "a mesh over ranks needs one sealing key on every rank: "
                    "their trust domains seal and unseal each other's rows")
        self.scheduler = Scheduler(order=admission_order)
        self.kv: KVBackend = make_backend(kv_backend, model,
                                          max_slots=max_slots, max_len=max_len,
                                          page_size=page_size,
                                          num_pages=num_pages, plan=self.plan,
                                          prefix_sharing=prefix_sharing,
                                          alloc=kv_alloc, decode=kv_decode,
                                          page_store=page_store,
                                          store_budget_pages=store_budget_pages)
        if getattr(self.kv, "page_store", None) is not None:
            # the store's key domain is this engine's trust domain, fixed
            # before any seal caches a key
            self.kv.bind_store_key(self.td.sealing_key)
        self._active_mask = np.zeros(max_slots, bool)
        self._last_token = np.zeros(max_slots, np.int32)
        self._preempted: List[PreemptedRequest] = []
        self._paused: Dict[int, PausedSlot] = {}
        self._buckets: Dict[int, _RateBucket] = {
            prio: _RateBucket(rate) for prio, rate in (rate_budgets or {}).items()}
        # over ranks every scheduler draws the same unseeded requests' seeds
        self._seed_rng = np.random.default_rng(
            int(plan.mesh.world.broadcast(
                torch.tensor([int.from_bytes(os.urandom(7), "little")]), 0,
                (1,), torch.int64)[0])
            if self._ranks else None)
        self._prefill_fn = self.plan.compile_prefill()
        self._vocab = model.cfg.vocab_size
        # device mirror of slots.hist while some slot penalizes: bulk host
        # changes re-upload it, per-token counts queue in _hist_pending and
        # land as one scatter-add per step (see _hist_device)
        self._hist_dev: Optional[torch.Tensor] = None
        self._hist_dev_version = -1
        self._hist_pending: List[Tuple[int, int]] = []
        # device mirror of slots.bias (static per request: version-checked)
        self._bias_dev: Optional[torch.Tensor] = None
        self._bias_dev_version = -1
        # -- two-phase serving --------------------------------------------
        if continuous_batching and prefill_plan is not None:
            raise ValueError(
                "continuous_batching applies to single-plan engines; a "
                "dedicated prefill_plan already decouples prefill from the "
                "decode step")
        if step_tokens is not None and not continuous_batching:
            raise ValueError(
                "step_tokens only makes sense with continuous_batching=True")
        if isinstance(prefill_plan, str):
            if prefill_plan != "dedicated":
                raise ValueError(
                    f"prefill_plan must be a ComputePlan or 'dedicated', "
                    f"got {prefill_plan!r}")
            prefill_plan = PrefillOnlyPlan(model)
        self.prefill_plan = prefill_plan
        if prefill_plan is not None:
            # same device: the plans share one copy of the weights
            self.prefill_params = prefill_plan.place_params(params)
            self._prefill_stream_fn = prefill_plan.compile_prefill()
        else:
            self.prefill_params = None
            self._prefill_stream_fn = None
        if continuous_batching:
            if step_tokens is None:
                step_tokens = self.prefill_buckets[-1] + max_slots
            if step_tokens < self.prefill_buckets[-1]:
                raise ValueError(
                    f"step_tokens={step_tokens} can never admit the largest "
                    f"prefill bucket ({self.prefill_buckets[-1]}) — the "
                    f"queue head would starve")
        self._continuous = continuous_batching or prefill_plan is not None
        self._step_tokens = step_tokens if continuous_batching else None
        self._budget_left: Optional[int] = None
        self._inflight: Dict[int, InflightPrefill] = {}
        self.backfills = 0   # out-of-order budget-backfill admissions
        self._handoff_batch = int(handoff_batch)
        if self._handoff_batch < 1:
            raise ValueError(f"handoff_batch must be >= 1, got {handoff_batch}")
        if self._handoff_batch > 1 and prefill_plan is None:
            raise ValueError(
                "handoff_batch only applies to disaggregated engines "
                "(prefill_plan=...) — there is no plan boundary to amortize")
        self.handoff_crossings = 0   # sealed plan-boundary crossings (each
                                     # carries up to handoff_batch rows)
        # -- admission-time deadline feasibility ---------------------------
        self._reject_infeasible = reject_infeasible
        self._step_time_hint_s = step_time_hint_s
        self._step_floor: Optional[float] = None  # fastest observed step
        # -- fleet migration -----------------------------------------------
        self._draining = False

    @property
    def slots(self) -> SlotState:
        """Per-sequence bookkeeping rows (owned by the KV backend)."""
        return self.kv.slots

    # -- request admission ----------------------------------------------------
    def submit(self, request: GenerationRequest) -> Request:
        """Admit one :class:`GenerationRequest`; returns the live
        :class:`Request` handle (``.finished``, ``.result()``)."""
        if not isinstance(request, GenerationRequest):
            raise TypeError("submit takes a GenerationRequest "
                            "(repro_torch.runtime.api)")
        if self._draining:
            raise RuntimeError(
                "engine is draining (drain()/export_sealed_state was "
                "called); route new work to another worker")
        gen = request
        gen.validate(self._vocab)
        if self._ranks and gen.deadline_s is not None:
            raise ValueError("deadlines are refused on a mesh over ranks: "
                             "each rank would expire them on its own clock")
        # worst-case KV positions: the padded prefill bucket (or the full
        # prompt when chunked past it) plus one per decode *input* — the
        # final sampled token is emitted but never fed back, so it writes no
        # KV. Past the backend's capacity, writes would clamp onto the last
        # cache row and silently corrupt the sequence — reject up front,
        # BEFORE the prompt crosses the boundary (a rejected request must
        # not skew ChannelStats). On a sharing backend kv_need is effective:
        # pages whose content is already resident charge nothing.
        bucket = self._bucket_for(len(gen.prompt))
        need = max(bucket, len(gen.prompt)) + gen.max_new_tokens - 1
        keys = None
        if self.kv.supports_sharing and gen.share_prefix:
            keys = self.kv.page_keys(self._padded_bucket(gen.prompt, bucket),
                                     bucket)
        fits, eff_need = self.kv.admission_check(need, keys)
        if not fits:
            raise ValueError(
                f"request needs up to {need} KV positions "
                f"(prompt {len(gen.prompt)} + {gen.max_new_tokens} new) "
                f"but the {self.kv.name} backend serves at most "
                f"{self.kv.request_capacity} (max_len={self.max_len}); "
                f"shorten the prompt or raise max_len")
        # deadline feasibility, decided BEFORE the prompt crosses the
        # boundary or a stream is held: a rejected request must cost the
        # domain nothing (no ingress message, no egress stream, no slot).
        rejected = self._reject_if_infeasible(gen)
        if rejected is not None:
            return rejected
        gen.prompt = self.td.ingress(gen.prompt)
        req = self.scheduler.submit(gen)
        req.kv_need = eff_need
        req.page_keys = keys
        req.ingress_messages = 1 if self.td.confidential else 0
        # resolve the sampling seed now, so the request is reproducible from
        # here on (across seal/restore preemption too)
        if not gen.params.is_greedy:
            req.seed = (gen.params.seed if gen.params.seed is not None
                        else int(self._seed_rng.integers(2 ** 31 - 1)))
        req.stream_id = self.td.open_stream()
        return req

    def prompt_budget(self, max_new_tokens: int) -> int:
        """Longest prompt submit() accepts for ``max_new_tokens`` (the
        backend's bound, with bucket padding). Prefix sharing never raises
        it; it lowers the effective demand :meth:`effective_kv_need`
        reports."""
        return self.kv.prompt_budget(max_new_tokens, self.prefill_buckets)

    def effective_kv_need(self, prompt: np.ndarray,
                          max_new_tokens: int) -> Tuple[int, int]:
        """(worst_case, effective) KV positions this prompt would charge at
        admission now: on a sharing engine the effective figure discounts
        the prompt's pages already resident in the content index."""
        prompt = np.asarray(prompt, np.int32)
        bucket = self._bucket_for(len(prompt))
        need = max(bucket, len(prompt)) + max_new_tokens - 1
        keys = None
        if self.kv.supports_sharing:
            keys = self.kv.page_keys(self._padded_bucket(prompt, bucket),
                                     bucket)
        _, eff = self.kv.admission_check(need, keys)
        return need, eff

    @staticmethod
    def _padded_bucket(prompt: np.ndarray, bucket: int) -> np.ndarray:
        """The tokens the prefill writes into the bucket, left-padded as
        _admit_batch lays them out (content keys hash what the cache
        holds)."""
        chunk = np.asarray(prompt[:bucket], np.int32)
        padded = np.zeros(bucket, np.int32)
        padded[bucket - len(chunk):] = chunk
        return padded

    def _admit_need(self, req: Request) -> int:
        """KV positions admission must cover now: the effective worst case
        under reservation; on demand, the prefill's own pages net of
        resident shared ones plus one page of append/CoW headroom (without
        it a fully resident prompt admits into a dry pool only to be
        evicted by its first append)."""
        if not self.kv.on_demand:
            return req.kv_need
        bucket = self._bucket_for(len(req.prompt))
        resident = self.kv.resident_pages(req.page_keys)
        return (max(0, bucket - resident * self.kv.page_size)
                + self.kv.page_size)

    def _bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket that fits the prompt, else the largest bucket
        (the tail past it is chunked through decode steps)."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        return self.prefill_buckets[-1]

    # -- admission-time deadline feasibility -----------------------------------
    def _step_time_lower(self) -> Optional[float]:
        """A defensible lower bound on one engine step's wall time: the
        fastest step observed so far and/or the modeled hint, whichever is
        smaller. None until either exists — feasibility then never
        rejects."""
        cands = [c for c in (self._step_floor, self._step_time_hint_s)
                 if c is not None]
        return min(cands) if cands else None

    def _reject_if_infeasible(self, gen: GenerationRequest
                              ) -> Optional[Request]:
        """Refuse ``gen`` at ingest when its deadline is provably unmeetable:
        even at the fastest step time, the serial steps it needs plus the
        queue ahead of it (optimistically packed across all slots) already
        exceed ``deadline_s``. Returns the finished rejected
        :class:`Request` (``finish_reason="rejected"``), or None."""
        if not self._reject_infeasible or gen.deadline_s is None:
            return None
        lo = self._step_time_lower()
        if lo is None:
            return None
        bucket = self._bucket_for(len(gen.prompt))
        tail = max(0, len(gen.prompt) - bucket)
        own_steps = 1 + tail + (gen.max_new_tokens - 1)
        ahead = sum(r.max_new_tokens for _, _, r in self.scheduler.queue)
        ahead += sum(max(0, r.max_new_tokens - len(r.output))
                     for r in self.scheduler.running.values())
        ahead += sum(max(0, p.req.max_new_tokens - len(p.req.output))
                     for p in self._preempted)
        est = lo * (own_steps + ahead / max(1, self.max_slots))
        if est <= gen.deadline_s:
            return None
        req = self.scheduler.reject(gen)
        self.td._log("reject_infeasible",
                     f"rid={req.rid} est>={est:.4f}s "
                     f"deadline={gen.deadline_s}s step_lo={lo:.6f}s")
        return req

    # -- sampling plumbing -----------------------------------------------------
    def _base_key(self, req: Request) -> np.ndarray:
        return sampling.prng_key(req.seed or 0)

    def _set_slot_sampling(self, slot: int, req: Request) -> None:
        p = req.gen.params
        if p.is_greedy:
            self.slots.clear_sampling(slot)
        else:
            self.slots.set_sampling(slot, p.temperature, p.top_k, p.top_p,
                                    self._base_key(req),
                                    p.repetition_penalty, p.presence_penalty,
                                    logit_bias=p.logit_bias)
            # the penalty history follows the request, not the cache: rebuilt
            # from its output (empty at first admission, the generated prefix
            # after a sealed restore)
            self.slots.set_hist(slot, req.output)

    def _static_kmax(self) -> int:
        """The active top-k maximum rounded up to a power of two."""
        k = self.slots.max_top_k
        return min(next_pow2(k), self._vocab) if k > 0 else 0

    def _sampling_state(self, steps: np.ndarray
                        ) -> Tuple[Optional[sampling.SamplingState], int]:
        """The step's (state, kmax): None on all-greedy steps, and the
        top-p, penalty and bias rows only when some slot uses them."""
        s, dev = self.slots, self.device
        rep = host_upload(s.rep_pen, dev) if s.any_rep_pen else None
        pres = host_upload(s.presence, dev) if s.any_presence else None
        if rep is None and pres is None:
            # no live penalties: drop the mirror and its queue
            hist = None
            self._hist_dev = None
            self._hist_pending.clear()
        else:
            hist = self._hist_device()
        if not s.any_bias:
            bias = None
            self._bias_dev = None
            self._bias_dev_version = -1
        else:
            bias = self._bias_device()
        if not s.any_sampled:
            return None, 0
        top_p = host_upload(s.top_p, dev) if s.any_top_p else None
        state = sampling.SamplingState(
            host_upload(s.temp, dev), host_upload(s.top_k, dev),
            host_upload(s.key, dev, torch.int64), host_upload(steps, dev),
            top_p=top_p, rep_pen=rep, presence=pres, hist=hist, bias=bias)
        return state, self._static_kmax()

    def _hist_device(self) -> torch.Tensor:
        """Device copy of the penalty history: a bulk host change (row
        rebuild or clear: admission, restore, release) re-uploads it;
        otherwise the per-token counts queued since the last step land as
        one scatter-add."""
        if (self._hist_dev is None
                or self._hist_dev_version != self.slots.hist_version):
            self._hist_dev = host_upload(self.slots.hist, self.device)
            self._hist_dev_version = self.slots.hist_version
            self._hist_pending.clear()
        elif self._hist_pending:
            rows = host_upload([s for s, _ in self._hist_pending],
                               self.device, torch.int64)
            toks = host_upload([t for _, t in self._hist_pending],
                               self.device, torch.int64)
            self._hist_dev.index_put_(
                (rows, toks), torch.ones_like(rows, dtype=torch.int32),
                accumulate=True)
            self._hist_pending.clear()
        return self._hist_dev

    def _bias_device(self) -> torch.Tensor:
        """Device copy of the logit-bias rows, re-uploaded when a biased
        request is admitted or released (``bias_version``)."""
        if (self._bias_dev is None
                or self._bias_dev_version != self.slots.bias_version):
            self._bias_dev = host_upload(self.slots.bias, self.device)
            self._bias_dev_version = self.slots.bias_version
        return self._bias_dev

    # -- egress ----------------------------------------------------------------
    def _flush_egress(self, req: Request) -> None:
        """Release the request's buffered tokens as ONE encrypted frame (the
        FramePolicy flush); the on_token callback fires per token as it
        becomes visible outside the domain."""
        if not req.egress_buf:
            return
        toks, req.egress_buf = req.egress_buf, []
        if self.td.confidential and self.plan.egresses:
            out = self.td.egress_tokens(req.stream_id, toks)
            req.egress_frames += 1
            req.egress_tokens += len(out)
        else:
            out = toks
        if req.on_token is not None:
            for t in out:
                req.on_token(req, int(t))

    def _emit_token(self, slot: int, tok: int) -> bool:
        """Record one generated token (in-domain), egress per the request's
        FramePolicy (coalesce window, flush-on-finish), and check
        termination. Returns True if the request finished."""
        req = self.scheduler.running[slot]
        self.scheduler.record_token(slot, int(tok))
        # penalty history (host), counted only for penalized slots; a
        # counted token is queued for the device mirror so both agree
        if (self.slots.note_token(slot, int(tok))
                and self._hist_dev is not None):
            self._hist_pending.append((slot, int(tok)))
        self._last_token[slot] = int(tok)
        done = req.done
        req.egress_buf.append(int(tok))
        if done or not self.td.confidential or len(req.egress_buf) >= req.coalesce:
            self._flush_egress(req)
        if done:
            # check immediately after recording: a max_new_tokens=1 request
            # (or EOS as the very first token) releases its slot without
            # paying for a wasted decode step.
            self.scheduler.finish(slot)
            self.kv.release(slot)
            self._active_mask[slot] = False
            self.td.close_stream(req.stream_id)
            return True
        return False

    # -- SLO admission ---------------------------------------------------------
    @property
    def _admit_filter(self):
        """Admissibility predicate for the scheduler queue — None when no
        rate budgets are configured (the O(1) heap peek)."""
        return self._admissible if self._buckets else None

    def _admissible(self, req: Request) -> bool:
        bucket = self._buckets.get(req.priority)
        return bucket is None or bucket.can(req.max_new_tokens)

    def _charge_budget(self, req: Request) -> None:
        bucket = self._buckets.get(req.priority)
        if bucket is not None:
            bucket.charge(req.max_new_tokens)

    def _drop_expired(self) -> None:
        for req in self.scheduler.drop_expired():
            self.td.close_stream(req.stream_id)
            self.td._log("drop_deadline",
                         f"rid={req.rid} deadline={req.gen.deadline_s}s "
                         f"waited={req.t_done - req.t_submit:.3f}s")

    def _enforce_aborts(self) -> None:
        """``on_deadline="abort"``: terminate expired mid-flight requests.
        A running one flushes its partial tokens and frees its slot; a
        sealed-out (preempted) one is discarded instead of restored — its
        ciphertext is simply dropped: no boundary crossing, no decode
        steps, just bookkeeping."""
        now = time.monotonic()
        for slot in list(self.scheduler.running):
            req = self.scheduler.running[slot]
            if not req.abort_expired(now):
                continue
            self._flush_egress(req)
            req.finish_reason = FINISH_ABORTED
            self.scheduler.finish(slot)
            self.kv.release(slot)
            self._active_mask[slot] = False
            self._paused.pop(slot, None)   # a paused victim's sealed tail
            self.td.close_stream(req.stream_id)
            self.td._log("abort_deadline",
                         f"rid={req.rid} deadline={req.gen.deadline_s}s "
                         f"tokens={len(req.output)}")
        for p in list(self._preempted):
            if not p.req.abort_expired(now):
                continue
            self._preempted.remove(p)
            self._flush_egress(p.req)   # coalesced tokens sealed with it must
            p.req.finish_reason = FINISH_ABORTED     # still reach the client
            # release the blob's shared-page references so parked
            # ciphertext does not outlive every reader; only a tampered or
            # garbled blob is tolerated here
            try:
                self.kv.discard_sealed(
                    p.key or self.td.sealing_key, p.sealed,
                    p.prefix
                    or f"kvslot/{p.req.stream_id}/{p.req.seal_epoch - 1}")
            except (IntegrityError, ValueError):
                pass
            self.scheduler.finish_detached(p.req)
            self.td.close_stream(p.req.stream_id)
            self.td._log("abort_deadline",
                         f"rid={p.req.rid} sealed KV discarded unrestored")

    def _admit_batch(self) -> int:
        """Pop waiting requests sharing the head's prefill bucket (bounded by
        free slots, the backend's KV capacity, and per-priority rate budgets)
        and prefill them in one call."""
        head = self.scheduler.peek_waiting(self._admit_filter)
        if (head is None or not self.slots.free
                or not self.kv.can_admit(self._admit_need(head))):
            return 0
        bucket = self._bucket_for(len(head.prompt))
        first = self.scheduler.next_waiting(self._admit_filter)
        self._charge_budget(first)
        slots = [self.kv.acquire(first.rid, self._admit_need(first))]
        assert slots[0] is not None, "admission raced KV accounting"
        group: List[Request] = [first]
        if self.batch_prefill:
            # group-mates must not jump the restore queue: a sealed-out
            # request with priority >= theirs gets the free slot first
            # (the head itself already outranked every sealed request, or
            # _admit_ready would have taken the restore branch).
            best_sealed = max((p.req.priority for p in self._preempted),
                              default=None)
            while self.slots.free:
                nxt = self.scheduler.peek_waiting(self._admit_filter)
                if nxt is None or self._bucket_for(len(nxt.prompt)) != bucket:
                    break
                if best_sealed is not None and nxt.priority <= best_sealed:
                    break
                if not self.kv.can_admit(self._admit_need(nxt)):
                    break
                nxt = self.scheduler.next_waiting(self._admit_filter)
                self._charge_budget(nxt)
                slot = self.kv.acquire(nxt.rid, self._admit_need(nxt))
                assert slot is not None, "admission raced KV accounting"
                group.append(nxt)
                slots.append(slot)

        # the reference pads rows to a power of two to bound its compiled
        # prefill shapes; the port's prefill runs one row a call, so it
        # takes the group's rows only (the plan pads a MoE model's group,
        # whose rows are coupled, as the reference does)
        rows = len(group)
        tokens = np.zeros((rows, bucket), np.int32)
        for i, req in enumerate(group):
            chunk = req.prompt[:bucket]
            tokens[i, bucket - len(chunk):] = chunk   # left-pad short prompts
        fresh = self.kv.fresh_prefill_cache(rows)
        logits, prefilled = self._prefill_fn(
            self.params, host_upload(tokens, self.device), fresh)
        first_np = self._first_tokens(logits, group, rows)
        group_keys = None
        if self.kv.supports_sharing:
            group_keys = [req.page_keys for req in group]
        self.kv.insert_prefill(prefilled, slots, bucket, page_keys=group_keys)
        for i, req in enumerate(group):
            self._start_decode(slots[i], req, int(first_np[i]), bucket)
        return len(group)

    def _start_decode(self, slot: int, req: Request, first_tok: int,
                      bucket: int) -> None:
        """Common post-prefill setup: the request enters the decode phase —
        it joins the scheduler's running set, its sampling row is set, and
        either its chunked prompt tail starts feeding through decode steps
        or its first sampled token is emitted."""
        self.scheduler.start(slot, req)
        req.phase = "decode"
        self._active_mask[slot] = True
        self._set_slot_sampling(slot, req)
        if len(req.prompt) > bucket:
            # chunked prefill: the tail is fed through the decode loop,
            # one token per step, before any sampling counts as output.
            req.pending_input = [int(t) for t in req.prompt[bucket:]]
            self._last_token[slot] = 0   # unused until the tail drains
        else:
            self._emit_token(slot, first_tok)

    def _first_tokens(self, logits, group: List[Request],
                      rows: int) -> np.ndarray:
        """Each group member's first token from its prefill logits, sampled
        with its own SamplingParams at token index 0 (the fold-in the decode
        loop would use)."""
        if all(req.gen.params.is_greedy for req in group):
            return sampling.greedy(logits).cpu().numpy()
        temp = np.zeros(rows, np.float32)
        top_k = np.zeros(rows, np.int32)
        top_p = np.ones(rows, np.float32)
        key = np.zeros((rows, 2), np.uint32)
        bias = None
        for i, req in enumerate(group):
            p = req.gen.params
            if not p.is_greedy:
                temp[i], top_k[i], top_p[i] = p.temperature, p.top_k, p.top_p
                key[i] = self._base_key(req)
            if p.logit_bias:
                if bias is None:
                    bias = np.zeros((rows, self._vocab), np.float32)
                for tok, val in p.logit_bias.items():
                    bias[i, int(tok)] = np.float32(val)
        kmax, dev = int(top_k.max()), self.device
        state = sampling.SamplingState(
            host_upload(temp, dev), host_upload(top_k, dev),
            host_upload(key, dev, torch.int64),
            torch.zeros(rows, dtype=torch.int64, device=dev),
            top_p=host_upload(top_p, dev) if (top_p < 1.0).any() else None,
            bias=host_upload(bias, dev) if bias is not None else None)
        return sampling.sample(
            logits, state,
            kmax=min(next_pow2(kmax), self._vocab) if kmax else 0
        ).cpu().numpy()

    # -- two-phase admission (continuous batching / disaggregated prefill) ----
    def _admit_one(self, req: Request, bucket: int) -> None:
        """Admit a single request (a rows=1 prefill, left-padded into its
        bucket like a batch of one). On a disaggregated engine the prefill
        is dispatched on the dedicated plan and parked in ``_inflight``;
        the sealed handoff consumes it next step."""
        self._charge_budget(req)
        slot = self.kv.acquire(req.rid, self._admit_need(req))
        assert slot is not None, "admission raced KV accounting"
        tokens = np.zeros((1, bucket), np.int32)
        chunk = req.prompt[:bucket]
        tokens[0, bucket - len(chunk):] = chunk   # left-pad short prompts
        if self._prefill_stream_fn is not None:
            fresh = self.model.init_cache(1, self.max_len)
            logits, cache, ready = self._prefill_stream_fn(
                self.prefill_params, host_upload(tokens, self.device), fresh)
            req.phase = "prefill"
            self._inflight[slot] = InflightPrefill(req, slot, bucket, logits,
                                                   cache, ready)
            return
        fresh = self.kv.fresh_prefill_cache(1)
        logits, prefilled = self._prefill_fn(
            self.params, host_upload(tokens, self.device), fresh)
        first_np = self._first_tokens(logits, [req], 1)
        keys = [req.page_keys] if self.kv.supports_sharing else None
        self.kv.insert_prefill(prefilled, [slot], bucket, page_keys=keys)
        self._start_decode(slot, req, int(first_np[0]), bucket)

    def _admit_continuous(self) -> int:
        """Step-level admission: pop waiting requests one at a time into
        free slots while the step-token budget (single-plan mode) and KV
        capacity allow. When the head's bucket does not fit the remaining
        budget, the best-ordered queued request that does fit backfills the
        leftover; the head keeps first claim on the next step's budget.
        Admissions after the first must outrank every sealed-out request,
        as in ``_admit_batch``, or they would jump the restore queue."""
        admitted = 0
        best_sealed = max((p.req.priority for p in self._preempted),
                          default=None)
        while self.slots.free:
            head = self.scheduler.peek_waiting(self._admit_filter)
            if head is None:
                break
            if (admitted and best_sealed is not None
                    and head.priority <= best_sealed):
                break
            bucket = self._bucket_for(len(head.prompt))
            fits_budget = (self._budget_left is None
                           or bucket <= self._budget_left)
            if fits_budget and self.kv.can_admit(self._admit_need(head)):
                req = self.scheduler.next_waiting(self._admit_filter)
                self._admit_one(req, bucket)
                if self._budget_left is not None:
                    self._budget_left -= bucket
                admitted += 1
                continue
            if self._budget_left is None:
                break   # KV-blocked without a budget: nothing to backfill on

            def fits(r, head_rid=head.rid):
                if r.rid == head_rid:
                    return False   # the head keeps next step's fresh budget
                if best_sealed is not None and r.priority <= best_sealed:
                    return False   # must not jump the restore queue
                if self._buckets and not self._admissible(r):
                    return False
                b = self._bucket_for(len(r.prompt))
                return (b <= self._budget_left
                        and self.kv.can_admit(self._admit_need(r)))

            cand = self.scheduler.next_backfill(fits)
            if cand is None:
                break
            cand.backfilled = True
            self.backfills += 1
            b = self._bucket_for(len(cand.prompt))
            self._admit_one(cand, b)
            self._budget_left -= b
            admitted += 1
        return admitted

    def _handoff_key(self, inf: InflightPrefill) -> tuple:
        """Handoff order follows the admission queue's (tightest slack
        first, priority tiebreak; pure priority otherwise), not slot
        order."""
        r = inf.req
        if self.scheduler.order == "slack":
            return (r.abs_deadline, -r.priority, r.rid)
        return (-r.priority, r.rid)

    def _handoff_ready(self) -> None:
        """Consume the prefills dispatched at the previous step: their KV
        rows cross from the prefill plan to the decode plan as seal/unseal
        pairs, up to ``handoff_batch`` rows a sealed crossing, and the
        requests enter the decode phase."""
        order = sorted(self._inflight.values(), key=self._handoff_key)
        self._inflight.clear()
        for i in range(0, len(order), self._handoff_batch):
            self._complete_handoff(order[i:i + self._handoff_batch])

    def _complete_handoff(self, group: List[InflightPrefill]) -> None:
        # Each row seals under its own kvhandoff/{stream} namespace (one
        # handoff per stream, ever: restores after preemption use kvslot/),
        # but the group crosses the plan boundary as one message: one seal
        # event and one restore event carry its total payload.
        sealed_rows = []
        total_nb = total_tensors = 0
        for inf in group:
            # the caller's stream waits for the prefill before the seal
            # reads its cache
            self.prefill_plan.join(inf.ready, inf.logits)
            prefix = f"kvhandoff/{inf.req.stream_id}"
            sealed = seal_tree(self.td.sealing_key, inf.cache, prefix=prefix)
            nb = sealed_nbytes(sealed)
            inf.req.n_handoffs += 1
            inf.req.handoff_bytes += nb
            total_nb += nb
            total_tensors += len(sealed)
            sealed_rows.append((inf, prefix, sealed))
        self.handoff_crossings += 1
        rids = ",".join(str(inf.req.rid) for inf in group)
        self.td.record_seal(total_nb, total_tensors,
                            f"handoff x{len(group)} rids={rids}")
        self.td.record_restore(total_nb, total_tensors,
                               f"handoff x{len(group)} rids={rids}")
        for inf, prefix, sealed in sealed_rows:
            req, slot, bucket = inf.req, inf.slot, inf.bucket
            restored = unseal_tree(self.td.sealing_key, sealed,
                                   self.model.abstract_cache(1, self.max_len),
                                   prefix=prefix)
            keys = [req.page_keys] if self.kv.supports_sharing else None
            self.kv.insert_prefill(restored, [slot], bucket, page_keys=keys)
            first_np = self._first_tokens(inf.logits, [req], 1)
            self._start_decode(slot, req, int(first_np[0]), bucket)

    def _preempt_for(self, incoming: Request) -> bool:
        """Free capacity for ``incoming`` by preempting the lowest-priority
        running slot it strictly outranks. On the paged backend, when only
        *pages* are short (a slot is free but the pool is not), a partial
        eviction seals just the shortfall off the victim's tail; otherwise
        the whole victim is sealed out. Returns True if capacity was
        freed."""
        if not self.scheduler.running:
            return False
        victim_slot = min(self.scheduler.running,
                          key=lambda s: (self.scheduler.running[s].priority,
                                         -self.scheduler.running[s].rid))
        victim = self.scheduler.running[victim_slot]
        if victim.priority >= incoming.priority:
            return False
        if (self.slots.free and victim_slot not in self._paused
                and self.kv.supports_partial):
            shortfall = (self.kv.pages_for(self._admit_need(incoming))
                         - self.kv.free_page_reserve)
            spare = self.kv.evictable_tail_pages(victim_slot)
            if 0 < shortfall <= spare:
                self.partial_preempt(victim_slot, shortfall)
                return True
        sealed, vreq = self.seal_slot(victim_slot)
        vreq.n_preemptions += 1
        self._preempted.append(PreemptedRequest(sealed, vreq))
        return True

    def _resume_paused(self) -> bool:
        """Restore a partially-evicted slot's sealed tail once the pool has
        room again, unless a strictly higher-priority request is still
        waiting for the pages (the reason the tail was sealed)."""
        for slot, paused in list(self._paused.items()):
            victim = self.scheduler.running[slot]
            rival = self.scheduler.peek_priority(self._admit_filter)
            if rival is not None and rival.priority > victim.priority:
                continue
            if not self.kv.can_restore_tail(paused.n_pages):
                continue
            self.kv.restore_tail_pages(self.td.sealing_key, paused.sealed,
                                       slot, paused.prefix)
            self.td.record_restore(sealed_nbytes(paused.sealed),
                                   len(paused.sealed),
                                   f"slot={slot} rid={victim.rid} partial")
            del self._paused[slot]
            return True
        return False

    def _admit_ready(self) -> None:
        """Admission policy, run at the top of every step:
        1. drop queued requests whose drop-deadline has passed and abort
           mid-flight ones whose abort-deadline has (SLO),
        2. restore sealed-out requests while no waiting request outranks
           them (and the backend has KV room),
        3. batch-admit waiting requests into free slots (bucket-grouped,
           rate-budget and KV-capacity gated),
        4. preempt a strictly lower-priority running request when the
           waiting head cannot get a slot otherwise (preempted requests
           never trigger further preemption — bounded, no thrash)."""
        while True:
            self._drop_expired()
            self._enforce_aborts()
            if self._paused and self._resume_paused():
                continue
            if self._preempted and self.slots.free:
                # only sealed requests that the strongest WAITING PRIORITY
                # does not outrank are restorable (restoring one a waiting
                # request outranks would just be preempted right back).
                # Among the eligible, tightest slack first, then priority;
                # priority-only engines pick by priority.
                rival = self.scheduler.peek_priority(self._admit_filter)
                eligible = [p for p in self._preempted
                            if rival is None
                            or p.req.priority >= rival.priority]
                if eligible:
                    if self.scheduler.order == "slack":
                        best = min(eligible,
                                   key=lambda p: (p.req.abs_deadline,
                                                  -p.req.priority,
                                                  p.req.rid))
                    else:
                        best = max(eligible,
                                   key=lambda p: (p.req.priority,
                                                  -p.req.rid))
                    if self.kv.can_restore(
                            best.req.kv_need,
                            n_pages=best.req.sealed_pages or None):
                        self._preempted.remove(best)
                        self.restore_slot(best.sealed, best.req,
                                          key=best.key, prefix=best.prefix)
                        continue
            if (self.scheduler.queue and self.slots.free
                    and (self._admit_continuous() if self._continuous
                         else self._admit_batch()) > 0):
                continue
            # preemption is a PRIORITY right, independent of queue order
            cand = self.scheduler.peek_priority(self._admit_filter)
            if (cand is not None
                    and (not self.slots.free
                         or not self.kv.can_admit(self._admit_need(cand)))
                    and self._preempt_for(cand)):
                continue
            return

    def _drain_kv_events(self) -> None:
        """Account boundary traffic the backend generated on its own:
        shared-page parking (a last live reference dropped while sealed
        references remain: the page crosses out once, content-named), the
        store's publish/hit/evict traffic, and re-materialization (parked
        pages brought back, ciphertext-resident pages decrypted in place),
        recorded as restores as the reference's catch-all branch does."""
        for kind, nb, n in self.kv.drain_events():
            if kind == "park":
                self.td.record_seal(nb, n, "shared page parked (last ref)")
            elif kind == "store_publish":
                self.td.record_seal(nb, n, "page published to sealed store")
            elif kind == "store_hit":
                self.td.record_store_hit(nb, n)
            elif kind == "store_evict":
                self.td.record_store_evict(nb, n)
            else:
                self.td.record_restore(nb, n, "shared page rematerialized")

    def _grant_step_pages(self, live: List[int]) -> List[int]:
        """On-demand allocation: make sure the pool can grant every live
        slot's append (and copy-on-write) page this step. When it runs dry,
        evict by slack: the laxest running victim (latest absolute
        deadline, weakest priority; weakest priority alone under
        ``admission_order="priority"``) loses just its private tail pages
        when that covers the shortfall, else its whole slot. Paused slots
        are candidates too. Returns the live set minus evicted or paused
        victims."""
        while True:
            live = [s for s in live if s in self.scheduler.running
                    and s not in self._paused]
            demand = sum(self.kv.step_page_need(s) for s in live)
            free = self.kv.free_physical_pages
            if demand <= free:
                return live
            candidates = list(self.scheduler.running)
            assert len(candidates) > 1, \
                "single-slot page demand exceeded the pool — capacity bug"

            def laxness(slot):
                r = self.scheduler.running[slot]
                if self.scheduler.order == "slack":
                    return (r.abs_deadline, -r.priority, r.rid)
                return (-r.priority, r.rid)
            victim = max(candidates, key=laxness)
            shortfall = demand - free
            spare = self.kv.evictable_tail_pages(victim)
            if victim not in self._paused and shortfall <= spare:
                self.partial_preempt(victim, shortfall)
            else:
                sealed, vreq = self.seal_slot(victim)
                vreq.n_preemptions += 1
                self._preempted.append(PreemptedRequest(sealed, vreq))

    # -- serving loop ----------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: prefill-stream handoffs, then
        admission/restoration/preemption, then one batched decode step.
        Returns number of *output* tokens produced (prompt-chunk feeding
        steps count zero)."""
        t0 = time.monotonic()
        if self._inflight:
            self._handoff_ready()
        if self._step_tokens is not None:
            # a fresh per-step budget: every live decode row (a slot still
            # feeding a chunked tail too) costs 1; admissions charge their
            # prefill bucket against the remainder
            live_now = sum(1 for s in self.slots.active
                           if s not in self._paused)
            self._budget_left = max(0, self._step_tokens - live_now)
        self._admit_ready()
        live = [s for s in self.slots.active
                if s not in self._paused and s not in self._inflight]
        if live and self.kv.on_demand:
            live = self._grant_step_pages(live)
        if not live:
            self._drain_kv_events()
            return 0
        feeding_prompt = {}   # slot -> tail still pending after this step?
        steps = np.zeros(self.max_slots, np.int32)
        for slot in live:
            req = self.scheduler.running.get(slot)
            if req is None:
                continue
            steps[slot] = len(req.output)   # fold-in index of the next token
            if req.pending_input:
                self._last_token[slot] = req.pending_input.pop(0)
                feeding_prompt[slot] = bool(req.pending_input)
        state, kmax = self._sampling_state(steps)
        next_np = self.kv.decode(self.params, self._last_token, state, kmax,
                                 write_slots=live)
        # a mesh plan's weight gathers: bytes from its placement, seconds as
        # each took (one device drains nothing)
        n, cb, cs = self.plan.drain_collectives()
        if n:
            self.td.record_collective(cb, cs, steps=n)
        produced = 0
        for slot in live:
            if not self._active_mask[slot] or slot in self._paused:
                continue
            if feeding_prompt.get(slot, False):
                continue   # mid-prompt chunk: this step's output is discarded
            self._emit_token(slot, int(next_np[slot]))
            produced += 1
        self._drain_kv_events()
        # feasibility floor: only steps that actually decoded count
        dt = time.monotonic() - t0
        if self._step_floor is None or dt < self._step_floor:
            self._step_floor = dt
        return produced

    @property
    def idle(self) -> bool:
        return (self.scheduler.idle and not self._preempted
                and not self._inflight)

    def run(self, max_steps: int = 10_000) -> ServeStats:
        steps = 0
        while not self.idle and steps < max_steps:
            produced = self.step()
            steps += 1
            if produced == 0 and not self.slots.active and not self.idle:
                # every waiting request is rate-budget gated: yield briefly
                # so the token buckets refill instead of busy-spinning.
                time.sleep(1e-3)
        stats = self.scheduler.stats()
        stats.shared_pages = getattr(self.kv, "shared_page_maps", 0)
        stats.cow_copies = getattr(self.kv, "cow_copies", 0)
        stats.store_hits = getattr(self.kv, "store_hits", 0)
        stats.store_restored_bytes = getattr(self.kv, "store_restored_bytes", 0)
        # evictions come from the channel (event-accounted), not the store
        # object: a store shared between engines counts fleet-wide there
        stats.store_evictions = self.td.channel.stats.store_evictions
        return stats

    # -- sealed KV preemption ----------------------------------------------------
    # The KV cache holds user conversation state; when a slot is preempted
    # its KV must not land anywhere unencrypted. It is sealed with the domain
    # key and restored later, at the backend's granularity: slot-dense moves
    # the whole [L, max_len, ...] extent, paged moves ceil(tokens/page_size)
    # pages.

    def _seal_prefix(self, req: Request) -> str:
        # unique across every seal the domain ever performs: the channel-
        # global stream id plus a per-request seal epoch (a stream cipher
        # must never encrypt two plaintexts under one nonce).
        return f"kvslot/{req.stream_id}/{req.seal_epoch}"

    def seal_slot(self, slot: int, *, key=None,
                  prefix: Optional[str] = None) -> Tuple[Dict[str, Any],
                                                         Request]:
        """Evict a running slot: returns (sealed_cache_dict, request). Any
        not-yet-prefilled prompt tail travels on ``request.pending_input``
        and not-yet-flushed egress tokens stay buffered on the request.

        A partially-evicted (paused) slot can be whole-sealed too: only its
        resident remainder is encrypted now, and the already-sealed tail
        blob rides along in the returned dict (its own epoch prefix keeps
        the nonces apart); ``restore_slot`` reassembles both.

        ``key``/``prefix`` override the worker's defaults for cross-worker
        migration: the blob seals under a fleet-shared tenant key domain in
        a caller-supplied nonce namespace that embeds the worker's name. A
        slot with a paused tail cannot be sealed so (that tail is under
        this worker's key; ``export_sealed_state`` reunites it first)."""
        paused = self._paused.pop(slot, None)
        req = self.scheduler.running.pop(slot)
        assert paused is None or key is None, \
            "cannot migration-seal a paused slot: its tail blob is local"
        # a key override means the blob leaves this worker: shared pages
        # seal by value (detach), since a by-reference entry resolves only
        # against this pool's content index and parked blobs
        detach = key is not None and self.kv.supports_sharing
        key = key if key is not None else self.td.sealing_key
        prefix = prefix if prefix is not None else self._seal_prefix(req)
        if self.kv.supports_partial:
            req.sealed_pages = (self.kv.allocated_pages(slot)
                                + (paused.n_pages if paused else 0))
        sealed = (self.kv.seal(key, slot, prefix, detach=True) if detach
                  else self.kv.seal(key, slot, prefix))
        req.seal_epoch += 1
        nb = sealed_nbytes(sealed)
        req.sealed_bytes += nb
        self.td.record_seal(nb, len(sealed),
                            f"slot={slot} rid={req.rid} stream={req.stream_id} "
                            f"epoch={req.seal_epoch - 1}")
        if paused is not None:
            sealed.update(paused.sealed)
        self.kv.release(slot)
        self._active_mask[slot] = False
        self._drain_kv_events()
        return sealed, req

    def restore_slot(self, sealed, req: Request, *, key=None,
                     prefix: Optional[str] = None) -> int:
        """Re-admit a sealed-out request into a free slot. On-demand pools
        acquire without a pledge (``can_restore(n_pages=...)`` gated the
        page takes); reservation pools re-reserve the effective worst
        case. ``key``/``prefix`` override the worker's defaults when the
        blob is a cross-worker migrant (sealed under a fleet-shared tenant
        domain in a ``kvmigrate/`` namespace)."""
        slot = self.kv.acquire(req.rid,
                               0 if self.kv.on_demand else req.kv_need)
        if slot is None:
            raise RuntimeError("no free slot/KV room to restore into")
        key = key if key is not None else self.td.sealing_key
        if prefix is None:
            prefix = f"kvslot/{req.stream_id}/{req.seal_epoch - 1}"
        try:
            self.kv.restore(key, sealed, slot, prefix, req.kv_need)
            # a sealed-while-paused eviction carries its earlier tail blob
            # under an older epoch prefix (and, under a mesh, shard
            # suffix): graft it back on top of the remainder (acquire()
            # above already reserved the full need)
            for gprefix, gsuffix in tail_blob_names(sealed):
                self.kv.restore_tail_pages(key, sealed, slot, gprefix,
                                           reserve=False, suffix=gsuffix)
        except Exception:
            self.kv.release(slot)   # a failed (e.g. tampered or
            raise                   # cross-tenant) restore must not leak
        # the whole restore succeeded: only now are the dict's shared-page
        # references spent (a rolled-back restore leaves them for
        # co-sharers)
        self.kv.discard_sealed(key, sealed, prefix)
        self.scheduler.running[slot] = req
        self._active_mask[slot] = True
        self._set_slot_sampling(slot, req)
        # next decode input: the prompt tail (if chunked prefill was cut
        # short) takes precedence in step(); otherwise the last output token.
        self._last_token[slot] = req.output[-1] if req.output else 0
        self.td.record_restore(sealed_nbytes(sealed), len(sealed),
                               f"slot={slot} rid={req.rid}")
        self._drain_kv_events()
        return slot

    def partial_preempt(self, slot: int, n_pages: int) -> None:
        """Page-granular preemption (paged backend only): seal the victim's
        ``n_pages`` tail pages and hand them (and their reservation) back to
        the pool. The victim stays admitted (slot and head pages intact)
        but sits out of the decode batch until ``_resume_paused`` restores
        the delta."""
        if not self.kv.supports_partial:
            raise RuntimeError(
                f"the {self.kv.name} backend cannot seal at page granularity;"
                f" use kv_backend='paged'")
        if slot in self._paused:
            raise RuntimeError(f"slot {slot} is already partially evicted")
        req = self.scheduler.running[slot]
        prefix = self._seal_prefix(req)
        sealed = self.kv.seal_tail_pages(self.td.sealing_key, slot, prefix,
                                         n_pages)
        req.seal_epoch += 1
        req.n_preemptions += 1
        nb = sealed_nbytes(sealed)
        req.sealed_bytes += nb
        self.td.record_seal(nb, len(sealed),
                            f"slot={slot} rid={req.rid} partial "
                            f"pages={n_pages}")
        self._paused[slot] = PausedSlot(sealed, prefix, n_pages)

    # -- fleet: drain + sealed-state migration ---------------------------------
    def drain(self) -> None:
        """Stop taking new work (later ``submit`` calls raise); everything
        already accepted keeps stepping. Pair with
        :meth:`export_sealed_state` to move the rest to another worker."""
        self._draining = True

    def export_sealed_state(
            self, *,
            key_for: Optional[Callable[[Request], Any]] = None,
            namespace: str = "kvmigrate",
    ) -> Tuple[List[PreemptedRequest], List[Request]]:
        """Seal every piece of live state out of this engine for adoption
        by another (the fleet's drain and failure path). Returns
        ``(migrants, queued)``: migrants are :class:`PreemptedRequest` blobs
        sealed under ``key_for(req)`` (the fleet passes the request's tenant
        key domain, the same on every attested worker) in the
        ``{namespace}/{stream}/{epoch}`` nonce space. The namespace must
        embed this worker's fleet-unique name: the tenant key is shared and
        stream ids are not unique across workers. Queued requests carry no
        KV and move as they are.

        The export is staged so the pool always has room: pending prefill
        handoffs complete first, plain running slots migration-seal
        directly, a paused slot goes through this worker's own seal and
        restore (reuniting its head with its local tail) before it
        migrates whole, and already-preempted blobs restore into the freed
        slots and re-seal under the export key. Every crossing is priced
        in ``ChannelStats``; per-request ``n_migrations`` and
        ``migrated_bytes`` roll up into ``ServeStats``."""
        self._draining = True
        if key_for is None:
            key_for = lambda req: self.td.sealing_key  # noqa: E731
        if self._inflight:
            self._handoff_ready()
        migrants: List[PreemptedRequest] = []

        def _migrate(slot: int) -> None:
            req = self.scheduler.running[slot]
            key = key_for(req)
            prefix = f"{namespace}/{req.stream_id}/{req.seal_epoch}"
            sealed, req = self.seal_slot(slot, key=key, prefix=prefix)
            nb = sealed_nbytes(sealed)
            req.n_migrations += 1
            req.migrated_bytes += nb
            self.td._log("migrate_out", f"rid={req.rid} {nb}B {prefix}")
            self.td.close_stream(req.stream_id)
            migrants.append(PreemptedRequest(sealed, req, key=key,
                                             prefix=prefix))

        while self.scheduler.running:
            slot = next((s for s in self.scheduler.running
                         if s not in self._paused), None)
            if slot is None:
                # every survivor is paused: its sealed tail is under this
                # worker's key and cannot cross. Whole-seal it (the tail
                # rides along), restore, and migrate the reunited slot.
                slot = next(iter(self._paused))
                sealed, req = self.seal_slot(slot)
                slot = self.restore_slot(sealed, req)
            _migrate(slot)
        # already-preempted blobs are under the local key and namespace:
        # bring each back through a now-free slot, re-seal under the export
        # key
        while self._preempted:
            p = self._preempted.pop(0)
            slot = self.restore_slot(p.sealed, p.req, key=p.key,
                                     prefix=p.prefix)
            _migrate(slot)
        queued = [req for _, _, req in sorted(self.scheduler.queue)]
        self.scheduler.queue.clear()
        for req in queued:
            self.td.close_stream(req.stream_id)
        return migrants, queued

    def import_sealed_state(self, migrants: Sequence[PreemptedRequest],
                            queued: Sequence[Request] = ()) -> None:
        """Adopt another worker's exported state. Requests keep their
        object identity (the caller's handle finishes here, with the same
        tokens: seeded sampling, output and penalty history travel on the
        request) but get fresh rids and fresh egress streams on this
        engine's channel. Migrants join the sealed-restore queue and
        re-enter through the ordinary admission gates; a later local
        re-seal falls back to this worker's key and ``kvslot/``
        namespace."""
        for p in migrants:
            p.req.rid = self.scheduler._next_rid
            self.scheduler._next_rid += 1
            p.req.stream_id = self.td.open_stream()
            self.td._log("migrate_in", f"rid={p.req.rid} {p.prefix}")
            self._preempted.append(p)
        for req in queued:
            req.rid = self.scheduler._next_rid
            self.scheduler._next_rid += 1
            req.stream_id = self.td.open_stream()
            heapq.heappush(self.scheduler.queue,
                           (self.scheduler._key(req), req.rid, req))

    # -- convenience -----------------------------------------------------------
    def generate(self, request: GenerationRequest) -> RequestOutput:
        """Serve one request to completion."""
        req = self.submit(request)
        self.run()
        return req.result()

    def stream(self, request: GenerationRequest, *,
               max_steps: int = 100_000) -> Iterator[int]:
        """Yields this request's tokens as they cross the trust boundary:
        per token with the default FramePolicy, in bursts of ``coalesce``
        with frame coalescing. Other queued requests keep advancing in the
        same decode batch. The request is submitted eagerly (before the
        first token is pulled), so it joins the batch even if the caller
        iterates later. Any on_token the request carries still fires."""
        if not isinstance(request, GenerationRequest):
            raise TypeError("stream takes a GenerationRequest "
                            "(repro_torch.runtime.api)")
        buf: List[int] = []
        inner = request.on_token

        def _tap(r, t):
            buf.append(t)
            if inner is not None:
                inner(r, t)

        request.on_token = _tap
        req = self.submit(request)

        def _drain() -> Iterator[int]:
            steps = 0
            while not req.finished:
                if steps >= max_steps:
                    raise RuntimeError(f"stream exceeded {max_steps} steps")
                produced = self.step()
                steps += 1
                if produced == 0 and not self.slots.active and not self.idle:
                    # rate-budget gated (as in run()): let buckets refill
                    time.sleep(1e-3)
                while buf:
                    yield buf.pop(0)
            while buf:
                yield buf.pop(0)

        return _drain()
