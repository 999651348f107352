"""Inference engine, single plan (port of ``repro.runtime.engine``).

Dataflow per the paper's protected stack:
  prompt --(encrypted bounce buffer)--> bucketed batched prefill(slots)
  --> batched greedy decode loop --> tokens --(encrypted frames through the
  bounce buffer, 1..N tokens each per the request's FramePolicy)--> client.

This slice ports the reference's default configuration: one compute plan,
the dense slot KV backend, bucketed left-padded batched prefill with
chunked prompt tails, priority/slack admission, per-priority rate budgets,
sealed whole-slot preemption and restore, coalesced egress, drop/abort
deadlines and admission-time deadline feasibility. Scheduler decisions are
the reference's, so the same requests produce the same admissions,
preemptions, seals and frames.

Not ported yet (each raises ``NotImplementedError``): seeded sampling
(ROADMAP.md queue A item 6), the paged backend (item 10), continuous
batching and disaggregated prefill (item 13), fleet drain and migration
(item 14), meshes (item 18).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.confidential import TrustDomain
from repro_torch.core.sealing import sealed_nbytes
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.runtime import sampling
from repro_torch.runtime.api import (FINISH_ABORTED, GenerationRequest,
                                     RequestOutput)
from repro_torch.runtime.kvcache import (KVBackend, SlotState, host_upload,
                                         make_backend, next_pow2)
from repro_torch.runtime.plan import SingleDevicePlan
from repro_torch.runtime.scheduler import Request, Scheduler, ServeStats

Params = Any


@dataclasses.dataclass
class PreemptedRequest:
    """A sealed-out request waiting for a slot: KV as ciphertext only."""
    sealed: Dict[str, Any]
    req: Request


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


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item {item})")


class Engine:
    def __init__(self, model: Model, params: Params, *, max_slots: int = 4,
                 max_len: int = 512, trust_domain: Optional[TrustDomain] = None,
                 prefill_len: int = 64,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 batch_prefill: bool = True,
                 rate_budgets: Optional[Dict[int, float]] = None,
                 kv_backend: str = "slot",
                 prefix_sharing: bool = False,
                 kv_alloc: Optional[str] = None,
                 kv_decode: str = "gather",
                 page_store: Any = None,
                 mesh: Optional[str] = None,
                 admission_order: str = "slack",
                 continuous_batching: bool = False,
                 prefill_plan: Optional[Any] = None,
                 reject_infeasible: bool = False,
                 step_time_hint_s: Optional[float] = None,
                 device=None):
        """Same arguments and defaults as the reference's engine, plus
        ``device`` (the card unless ``device="cpu"``; the model, and the
        trust domain if given, must live there too). ``prefill_buckets``
        supersedes the single static ``prefill_len``; ``batch_prefill=False``
        prefills one request per call. ``rate_budgets`` maps priority ->
        tokens/s. ``admission_order`` is ``"slack"`` (tightest deadline
        first, priority tiebreak) or ``"priority"``. ``reject_infeasible``
        refuses at ingest a request whose ``deadline_s`` is provably
        unmeetable at the fastest observed (or ``step_time_hint_s``) step
        time. The paged, sharing, store, mesh, continuous-batching and
        disaggregated options raise ``NotImplementedError``."""
        if mesh is not None:
            raise _not_ported("a mesh-spanning engine", 18)
        if continuous_batching or prefill_plan is not None:
            raise _not_ported("two-phase serving (continuous batching, "
                              "prefill_plan)", 13)
        if (prefix_sharing or kv_alloc is not None or kv_decode != "gather"
                or page_store):
            raise _not_ported("the paged KV backend and its options", 10)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.plan = SingleDevicePlan(model)
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
        self.scheduler = Scheduler(order=admission_order)
        self.kv: KVBackend = make_backend(kv_backend, model,
                                          max_slots=max_slots,
                                          max_len=max_len, plan=self.plan)
        self._active_mask = np.zeros(max_slots, bool)
        self._last_token = np.zeros(max_slots, np.int32)
        self._preempted: List[PreemptedRequest] = []
        self._buckets: Dict[int, _RateBucket] = {
            prio: _RateBucket(rate) for prio, rate in (rate_budgets or {}).items()}
        self._prefill_fn = self.plan.compile_prefill()
        self._vocab = model.cfg.vocab_size
        # -- admission-time deadline feasibility ---------------------------
        self._reject_infeasible = reject_infeasible
        self._step_time_hint_s = step_time_hint_s
        self._step_floor: Optional[float] = None  # fastest observed step

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
        gen = request
        gen.validate(self._vocab)
        if not gen.params.is_greedy:
            raise _not_ported("seeded sampling (temperature > 0)", 6)
        # worst-case KV positions: the padded prefill bucket (or the full
        # prompt when chunked past it) plus one per decode *input* — the
        # final sampled token is emitted but never fed back, so it writes no
        # KV. Past the backend's capacity, writes would clamp onto the last
        # cache row and silently corrupt the sequence — reject up front,
        # BEFORE the prompt crosses the boundary (a rejected request must
        # not skew ChannelStats).
        bucket = self._bucket_for(len(gen.prompt))
        need = max(bucket, len(gen.prompt)) + gen.max_new_tokens - 1
        fits, eff_need = self.kv.admission_check(need)
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
        req.ingress_messages = 1 if self.td.confidential else 0
        req.stream_id = self.td.open_stream()
        return req

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

    # -- egress ----------------------------------------------------------------
    def _flush_egress(self, req: Request) -> None:
        """Release the request's buffered tokens as ONE encrypted frame (the
        FramePolicy flush); the on_token callback fires per token as it
        becomes visible outside the domain."""
        if not req.egress_buf:
            return
        toks, req.egress_buf = req.egress_buf, []
        if self.td.confidential:
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
                or not self.kv.can_admit(head.kv_need)):
            return 0
        bucket = self._bucket_for(len(head.prompt))
        first = self.scheduler.next_waiting(self._admit_filter)
        self._charge_budget(first)
        slots = [self.kv.acquire(first.rid, first.kv_need)]
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
                if not self.kv.can_admit(nxt.kv_need):
                    break
                nxt = self.scheduler.next_waiting(self._admit_filter)
                self._charge_budget(nxt)
                slot = self.kv.acquire(nxt.rid, nxt.kv_need)
                assert slot is not None, "admission raced KV accounting"
                group.append(nxt)
                slots.append(slot)

        # rows padded to a power of two, as in the reference (its compiled
        # prefill shapes stay bounded; here the padding only keeps the
        # prefill shapes the reference's).
        rows = next_pow2(len(group))
        tokens = np.zeros((rows, bucket), np.int32)
        for i, req in enumerate(group):
            chunk = req.prompt[:bucket]
            tokens[i, bucket - len(chunk):] = chunk   # left-pad short prompts
        fresh = self.kv.fresh_prefill_cache(rows)
        logits, prefilled = self._prefill_fn(
            self.params, host_upload(tokens, self.device), fresh)
        first_np = sampling.greedy(logits).cpu().numpy()
        self.kv.insert_prefill(prefilled, slots, bucket)
        for i, req in enumerate(group):
            self._start_decode(slots[i], req, int(first_np[i]), bucket)
        return len(group)

    def _start_decode(self, slot: int, req: Request, first_tok: int,
                      bucket: int) -> None:
        """Common post-prefill setup: the request enters the decode phase —
        it joins the scheduler's running set, its sampling row is set, and
        either its chunked prompt tail starts feeding through decode steps
        or its first token is emitted."""
        self.scheduler.start(slot, req)
        req.phase = "decode"
        self._active_mask[slot] = True
        self.slots.clear_sampling(slot)   # greedy row
        if len(req.prompt) > bucket:
            # chunked prefill: the tail is fed through the decode loop,
            # one token per step, before any sampling counts as output.
            req.pending_input = [int(t) for t in req.prompt[bucket:]]
            self._last_token[slot] = 0   # unused until the tail drains
        else:
            self._emit_token(slot, first_tok)

    def _preempt_for(self, incoming: Request) -> bool:
        """Free a slot for ``incoming`` by sealing out the lowest-priority
        running request it strictly outranks. Returns True if it did."""
        if not self.scheduler.running:
            return False
        victim_slot = min(self.scheduler.running,
                          key=lambda s: (self.scheduler.running[s].priority,
                                         -self.scheduler.running[s].rid))
        victim = self.scheduler.running[victim_slot]
        if victim.priority >= incoming.priority:
            return False
        sealed, vreq = self.seal_slot(victim_slot)
        vreq.n_preemptions += 1
        self._preempted.append(PreemptedRequest(sealed, vreq))
        return True

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
                    if self.kv.can_restore(best.req.kv_need):
                        self._preempted.remove(best)
                        self.restore_slot(best.sealed, best.req)
                        continue
            if (self.scheduler.queue and self.slots.free
                    and self._admit_batch() > 0):
                continue
            # preemption is a PRIORITY right, independent of queue order
            cand = self.scheduler.peek_priority(self._admit_filter)
            if (cand is not None
                    and (not self.slots.free
                         or not self.kv.can_admit(cand.kv_need))
                    and self._preempt_for(cand)):
                continue
            return

    # -- serving loop ----------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admission/restoration/preemption, then one
        batched decode step. Returns number of *output* tokens produced
        (prompt-chunk feeding steps count zero)."""
        t0 = time.monotonic()
        self._admit_ready()
        live = list(self.slots.active)
        if not live:
            return 0
        feeding_prompt = {}   # slot -> tail still pending after this step?
        for slot in live:
            req = self.scheduler.running.get(slot)
            if req is not None and req.pending_input:
                self._last_token[slot] = req.pending_input.pop(0)
                feeding_prompt[slot] = bool(req.pending_input)
        next_np = self.kv.decode(self.params, self._last_token)
        produced = 0
        for slot in live:
            if not self._active_mask[slot]:
                continue
            if feeding_prompt.get(slot, False):
                continue   # mid-prompt chunk: this step's output is discarded
            self._emit_token(slot, int(next_np[slot]))
            produced += 1
        # feasibility floor: only steps that actually decoded count
        dt = time.monotonic() - t0
        if self._step_floor is None or dt < self._step_floor:
            self._step_floor = dt
        return produced

    @property
    def idle(self) -> bool:
        return self.scheduler.idle and not self._preempted

    def run(self, max_steps: int = 10_000) -> ServeStats:
        steps = 0
        while not self.idle and steps < max_steps:
            produced = self.step()
            steps += 1
            if produced == 0 and not self.slots.active and not self.idle:
                # every waiting request is rate-budget gated: yield briefly
                # so the token buckets refill instead of busy-spinning.
                time.sleep(1e-3)
        return self.scheduler.stats()

    # -- sealed KV preemption ----------------------------------------------------
    # The KV cache holds user conversation state; when a slot is preempted
    # its KV must not land anywhere unencrypted. The slot cache is sealed
    # with the domain key (the whole [L, max_len, ...] extent) and restored
    # later.

    def _seal_prefix(self, req: Request) -> str:
        # unique across every seal the domain ever performs: the channel-
        # global stream id plus a per-request seal epoch (a stream cipher
        # must never encrypt two plaintexts under one nonce).
        return f"kvslot/{req.stream_id}/{req.seal_epoch}"

    def seal_slot(self, slot: int) -> Tuple[Dict[str, Any], Request]:
        """Evict a running slot: returns (sealed_cache_dict, request). Any
        not-yet-prefilled prompt tail travels on ``request.pending_input``
        and not-yet-flushed egress tokens stay buffered on the request."""
        req = self.scheduler.running.pop(slot)
        prefix = self._seal_prefix(req)
        sealed = self.kv.seal(self.td.sealing_key, slot, prefix)
        req.seal_epoch += 1
        nb = sealed_nbytes(sealed)
        req.sealed_bytes += nb
        self.td.record_seal(nb, len(sealed),
                            f"slot={slot} rid={req.rid} stream={req.stream_id} "
                            f"epoch={req.seal_epoch - 1}")
        self.kv.release(slot)
        self._active_mask[slot] = False
        return sealed, req

    def restore_slot(self, sealed, req: Request) -> int:
        """Re-admit a sealed-out request into a free slot."""
        slot = self.kv.acquire(req.rid, req.kv_need)
        if slot is None:
            raise RuntimeError("no free slot/KV room to restore into")
        prefix = f"kvslot/{req.stream_id}/{req.seal_epoch - 1}"
        try:
            self.kv.restore(self.td.sealing_key, sealed, slot, prefix)
        except Exception:
            self.kv.release(slot)   # a failed (e.g. tampered) restore must
            raise                   # not leak the slot
        self.scheduler.running[slot] = req
        self._active_mask[slot] = True
        self.slots.clear_sampling(slot)   # greedy row
        # next decode input: the prompt tail (if chunked prefill was cut
        # short) takes precedence in step(); otherwise the last output token.
        self._last_token[slot] = req.output[-1] if req.output else 0
        self.td.record_restore(sealed_nbytes(sealed), len(sealed),
                               f"slot={slot} rid={req.rid}")
        return slot

    # -- fleet: drain + sealed-state migration ---------------------------------
    def drain(self) -> None:
        raise _not_ported("fleet drain", 14)

    def export_sealed_state(self, **kw):
        raise _not_ported("fleet sealed-state export", 14)

    def import_sealed_state(self, migrants, queued=()):
        raise _not_ported("fleet sealed-state import", 14)

    # -- convenience -----------------------------------------------------------
    def generate(self, request: GenerationRequest) -> RequestOutput:
        """Serve one request to completion."""
        req = self.submit(request)
        self.run()
        return req.result()
