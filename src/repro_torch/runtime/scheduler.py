"""Continuous-batching scheduler: priority queue, admission, completion.

The serving pattern the paper measures (vLLM on cGPU, IPEX batched decode on
CPU TEEs): requests arrive asynchronously, prefill claims a free slot,
decode advances all active slots each step, finished sequences free their
slot immediately for the next queued request. Tracks the user-perceived
metrics from §III-C: throughput (tokens/s), next-token latency, and
time-to-first-token.

v3 (request-object API): the scheduler speaks
:class:`~repro_torch.runtime.api.GenerationRequest` — per-request sampling, frame
policy and SLO fields live on the submitted object, not in a kwargs bag
duplicated here and in the engine. :class:`Request` is the live serving
record wrapped around it (output, timing, seal/stream state) and converts
to a :class:`~repro_torch.runtime.api.RequestOutput` on completion.

SLO machinery:
  * the waiting queue orders by **slack** first (``order="slack"``, the
    default): a request's slack ``deadline_s - elapsed`` shrinks as it
    waits, but ``t_submit + deadline_s`` — its absolute deadline — is
    time-invariant, so earliest-absolute-deadline IS the
    tightest-slack-first order and keeps heap keys static. Priority breaks
    ties (and deadline-less requests, whose slack is infinite, keep their
    pure priority-then-arrival order among themselves). The point:
    deadline-bound requests are served while their deadline is still
    meetable, so ``on_deadline="abort"`` fires rarely instead of cheaply.
    ``order="priority"`` restores the v4 priority-only ordering (the
    baseline the forced-contention test measures the abort reduction
    against). Preemption is untouched — only strict *priority* ever evicts
    a running slot;
  * ``drop_expired`` removes queued requests whose relative deadline has
    passed (``on_deadline="drop"`` or ``"abort"``) before they waste
    prefill compute; ``abort_expired`` additionally marks *mid-flight*
    requests for engine-side termination (seal/discard, not restore);
  * ``peek_waiting``/``next_waiting`` accept an admissibility predicate so
    the engine's per-priority token-rate budgets can hold a class back
    without starving the others — and so a continuous-batching engine can
    *backfill*: when the head's prefill bucket doesn't fit the remaining
    step-token budget, :meth:`Scheduler.next_backfill` hands out the best
    queued request that does fit, keeping the step saturated without
    reordering anything the head could still claim next step;
  * every :class:`Request` carries a coarse serving ``phase``
    (queued → prefill → decode → done): under disaggregated serving,
    prefill and decode are independently scheduled phases and a request in
    ``phase="prefill"`` is in flight on the prefill plan, its KV not yet
    handed off to the decode plan (``n_handoffs``/``handoff_bytes`` price
    that sealed crossing per request);
  * :class:`ServeStats` reports p50 alongside mean/p99 (percentiles guarded
    for <2 samples) plus dropped/deadline-miss/preemption counters, making
    the preemption-vs-drop trade-off measurable.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.api import (FINISH_ABORTED, FINISH_DROPPED, FINISH_LENGTH,
                               FINISH_REJECTED, FINISH_STOP, GenerationRequest,
                               RequestOutput, TokenCallback)

AdmitPredicate = Callable[["Request"], bool]


@dataclasses.dataclass
class Request:
    """Live serving record for one submitted :class:`GenerationRequest`."""
    rid: int
    gen: GenerationRequest
    # filled during serving
    output: List[int] = dataclasses.field(default_factory=list)
    pending_input: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    finish_reason: str = ""
    n_preemptions: int = 0
    kv_need: int = 0       # worst-case KV positions (set at submit; the unit
                           # the KV backend's admission accounting charges —
                           # *effective*, i.e. net of resident shared pages,
                           # on a prefix-sharing backend)
    page_keys: Optional[list] = None   # prompt page content keys (sharing)
    sealed_pages: int = 0  # pages held at the last whole-slot seal (what an
                           # on-demand pool gates the restore on)
    sealed_bytes: int = 0  # ciphertext bytes this request's evictions moved
    seal_epoch: int = 0    # bumps on every sealed-KV eviction (nonce freshness)
    stream_id: int = -1    # channel-global egress stream (set by the engine)
    seed: Optional[int] = None          # resolved sampling seed (reproducible)
    egress_buf: List[int] = dataclasses.field(default_factory=list)
    ingress_messages: int = 0
    egress_frames: int = 0
    egress_tokens: int = 0
    # -- two-phase serving (continuous batching / disaggregated prefill) ----
    phase: str = "queued"  # "queued" | "prefill" | "decode" | "done"
    n_handoffs: int = 0    # sealed prefill->decode plan handoffs
    handoff_bytes: int = 0  # ciphertext bytes those handoffs moved
    backfilled: bool = False  # admitted out of queue order into leftover
                              # step-token budget (continuous batching)
    # -- fleet serving -------------------------------------------------------
    n_migrations: int = 0   # sealed cross-worker moves (drain/failure)
    migrated_bytes: int = 0  # ciphertext bytes those migrations carried

    # -- mirrors of the generation request (single source of truth: gen) ----
    @property
    def prompt(self) -> np.ndarray:
        return self.gen.prompt

    @property
    def max_new_tokens(self) -> int:
        return self.gen.max_new_tokens

    @property
    def eos_id(self) -> Optional[int]:
        return self.gen.eos_id

    @property
    def priority(self) -> int:
        return self.gen.priority

    @property
    def on_token(self) -> Optional[TokenCallback]:
        return self.gen.on_token

    @property
    def coalesce(self) -> int:
        return self.gen.frame.coalesce

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.output and self.output[-1] == self.eos_id:
            return True
        return len(self.output) >= self.max_new_tokens

    @property
    def finished(self) -> bool:
        return self.t_done > 0.0

    @property
    def dropped(self) -> bool:
        return self.finish_reason == FINISH_DROPPED

    @property
    def aborted(self) -> bool:
        return self.finish_reason == FINISH_ABORTED

    @property
    def rejected(self) -> bool:
        return self.finish_reason == FINISH_REJECTED

    @property
    def abs_deadline(self) -> float:
        """Absolute deadline (monotonic clock); inf when none. Static per
        request, which is what makes slack ordering heap-safe."""
        if self.gen.deadline_s is None:
            return float("inf")
        return self.t_submit + self.gen.deadline_s

    @property
    def deadline_missed(self) -> bool:
        return (not self.dropped and self.finished
                and self.gen.deadline_s is not None
                and self.t_done - self.t_submit > self.gen.deadline_s)

    def expired(self, now: float) -> bool:
        """True when a still-queued request should be dropped (deadline SLO).
        ``abort`` subsumes ``drop`` while queued — a request that would be
        killed mid-flight is certainly not worth starting late."""
        return (self.gen.deadline_s is not None
                and self.gen.on_deadline in ("drop", "abort")
                and now - self.t_submit > self.gen.deadline_s)

    def abort_expired(self, now: float) -> bool:
        """True when a mid-flight request should be aborted (seal/discard)."""
        return (self.gen.deadline_s is not None
                and self.gen.on_deadline == "abort"
                and now - self.t_submit > self.gen.deadline_s)

    def result(self) -> RequestOutput:
        """The finished request as an API-level :class:`RequestOutput`."""
        return RequestOutput.from_request(self)


@dataclasses.dataclass
class ServeStats:
    total_tokens: int = 0
    total_requests: int = 0
    dropped_requests: int = 0      # deadline passed while queued (on_deadline=drop)
    aborted_requests: int = 0      # terminated mid-flight (on_deadline=abort)
    rejected_infeasible: int = 0   # refused at ingest: deadline unmeetable
    deadline_misses: int = 0       # served, but finished after deadline_s
    preemptions: int = 0           # sealed-KV evictions among served requests
    sealed_bytes: int = 0          # ciphertext bytes those evictions moved
    handoffs: int = 0              # sealed prefill->decode plan handoffs
    handoff_bytes: int = 0         # ciphertext bytes those handoffs moved
    backfilled_requests: int = 0   # admitted via continuous-batching backfill
    migrations: int = 0            # sealed cross-worker KV moves (fleet)
    migrated_bytes: int = 0        # ciphertext bytes those migrations carried
    shared_pages: int = 0          # page mappings served by the prefix index
    cow_copies: int = 0            # shared tail pages copied on first write
    store_hits: int = 0            # pages restored from the sealed store
    store_restored_bytes: int = 0  # ciphertext bytes those hits moved back
    store_evictions: int = 0       # store pages shed by retention policy
    wall_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def throughput_tps(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latencies_s)) if self.latencies_s else 0.0

    @property
    def p50_latency_s(self) -> float:
        return _pct(self.latencies_s, 50)

    @property
    def p99_latency_s(self) -> float:
        return _pct(self.latencies_s, 99)

    @property
    def mean_ttft_s(self) -> float:
        return float(np.mean(self.ttft_s)) if self.ttft_s else 0.0

    @property
    def p50_ttft_s(self) -> float:
        return _pct(self.ttft_s, 50)

    @property
    def p99_ttft_s(self) -> float:
        return _pct(self.ttft_s, 99)


def _pct(xs: Sequence[float], q: float) -> float:
    """Percentile guarded for tiny samples: with fewer than 2 observations a
    percentile is not an estimate, it's the sample (or nothing)."""
    if not xs:
        return 0.0
    if len(xs) < 2:
        return float(xs[0])
    return float(np.percentile(xs, q))


class Scheduler:
    def __init__(self, order: str = "slack"):
        # waiting heap entries: (key, rid, Request) — rid ties keep
        # submission order, and survive requeueing. The key is
        # (abs_deadline, -priority) in slack order (tightest deadline first,
        # priority tiebreak) or (-priority,) in priority order.
        if order not in ("slack", "priority"):
            raise ValueError(
                f"order must be 'slack' or 'priority', got {order!r}")
        self.order = order
        self.queue: List[tuple] = []
        self.running: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
        self.dropped: List[Request] = []
        self._next_rid = 0

    def _key(self, req: Request) -> tuple:
        if self.order == "slack":
            return (req.abs_deadline, -req.priority)
        return (-req.priority,)

    def submit(self, gen: GenerationRequest) -> Request:
        req = Request(self._next_rid, gen, t_submit=time.monotonic())
        self._next_rid += 1
        heapq.heappush(self.queue, (self._key(req), req.rid, req))
        return req

    def reject(self, gen: GenerationRequest) -> Request:
        """Refuse a request at ingest (admission-time deadline feasibility):
        the request never enters the queue, holds no stream/slot/page, and
        finishes immediately with ``finish_reason="rejected"``. Cheaper for
        everyone than aborting it mid-decode after it consumed prefill
        compute and sealed-KV bandwidth."""
        req = Request(self._next_rid, gen, t_submit=time.monotonic())
        self._next_rid += 1
        req.finish_reason = FINISH_REJECTED
        req.t_done = req.t_submit
        req.phase = "done"
        self.dropped.append(req)
        return req

    def drop_expired(self, now: Optional[float] = None) -> List[Request]:
        """Remove queued requests whose drop-deadline has passed. Returns the
        dropped requests (the engine still owns their stream teardown)."""
        if not any(req.expired(now or time.monotonic())
                   for _, _, req in self.queue):
            return []
        now = now or time.monotonic()
        kept, dropped = [], []
        for entry in self.queue:
            (dropped if entry[2].expired(now) else kept).append(entry)
        heapq.heapify(kept)
        self.queue = kept
        out = []
        for _, _, req in sorted(dropped, key=lambda e: e[1]):
            req.finish_reason = FINISH_DROPPED
            req.t_done = now
            self.dropped.append(req)
            out.append(req)
        return out

    def peek_waiting(self, admissible: Optional[AdmitPredicate] = None
                     ) -> Optional[Request]:
        """Best-ordered waiting request (tightest slack first in the default
        order, then priority), optionally skipping entries the predicate
        rejects (e.g. a priority class over its token-rate budget)."""
        if admissible is None:
            return self.queue[0][2] if self.queue else None
        for _, _, req in sorted(self.queue):
            if admissible(req):
                return req
        return None

    def peek_priority(self, admissible: Optional[AdmitPredicate] = None
                      ) -> Optional[Request]:
        """The highest-PRIORITY waiting request regardless of queue order —
        the gatekeeper for restore/preemption decisions. In slack order the
        queue head is the tightest *deadline* (possibly low priority), but
        priority gates must still see the strongest waiting contender, or a
        deadline-less high-priority request could neither block restores of
        weaker sealed work nor exercise its preemption right. In priority
        order this coincides with :meth:`peek_waiting`."""
        best = None
        for _, _, req in self.queue:
            if admissible is not None and not admissible(req):
                continue
            if best is None or (req.priority, -req.rid) > (best.priority,
                                                           -best.rid):
                best = req
        return best

    def next_waiting(self, admissible: Optional[AdmitPredicate] = None
                     ) -> Optional[Request]:
        if admissible is None:
            return heapq.heappop(self.queue)[2] if self.queue else None
        for entry in sorted(self.queue):
            if admissible(entry[2]):
                self.queue.remove(entry)
                heapq.heapify(self.queue)
                return entry[2]
        return None

    def next_backfill(self, fits: AdmitPredicate) -> Optional[Request]:
        """Pop the best-ordered waiting request satisfying ``fits`` — the
        continuous-batching backfill path. Identical mechanics to
        :meth:`next_waiting` with a predicate; named separately because the
        *caller's* contract differs: the predicate excludes the queue head
        (which keeps first claim on next step's fresh budget), so anything
        returned here is an out-of-order admission the caller must flag
        (``Request.backfilled``)."""
        return self.next_waiting(fits)

    def start(self, slot: int, req: Request) -> None:
        self.running[slot] = req

    def record_token(self, slot: int, token: int) -> None:
        """Record one sampled (plaintext, in-domain) token. Egress/stream
        callbacks are the engine's job — they happen at frame-flush time."""
        req = self.running[slot]
        now = time.monotonic()
        if not req.output:
            req.t_first_token = now
        req.output.append(int(token))
        req.token_times.append(now)

    def finish(self, slot: int) -> Request:
        req = self.running.pop(slot)
        req.t_done = time.monotonic()
        req.phase = "done"
        if not req.finish_reason:
            req.finish_reason = (
                FINISH_STOP if (req.eos_id is not None and req.output
                                and req.output[-1] == req.eos_id)
                else FINISH_LENGTH)
        self.finished.append(req)
        return req

    def finish_detached(self, req: Request) -> Request:
        """Finish a request that holds no slot (e.g. a sealed-out preempted
        request being aborted instead of restored). The caller sets
        ``finish_reason`` first."""
        req.t_done = time.monotonic()
        req.phase = "done"
        self.finished.append(req)
        return req

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running

    def stats(self) -> ServeStats:
        return stats_from_requests(self.finished + self.dropped)


def stats_from_requests(reqs: List[Request]) -> ServeStats:
    """ServeStats over any set of finished requests (benchmarks measure a
    warm wave this way, excluding an earlier compile-warmup wave). Dropped
    requests count toward ``dropped_requests`` but contribute no tokens or
    latency samples — they never produced any."""
    s = ServeStats()
    done = [r for r in reqs
            if r.finished and not r.dropped and not r.rejected]
    s.dropped_requests = sum(1 for r in reqs if r.dropped)
    s.rejected_infeasible = sum(1 for r in reqs if r.rejected)
    if not done:
        return s
    t0 = min(r.t_submit for r in done)
    t1 = max(r.t_done for r in done)
    s.wall_s = t1 - t0
    s.total_requests = len(done)
    for r in done:
        s.total_tokens += len(r.output)
        s.preemptions += r.n_preemptions
        s.sealed_bytes += r.sealed_bytes
        s.handoffs += r.n_handoffs
        s.handoff_bytes += r.handoff_bytes
        s.backfilled_requests += int(r.backfilled)
        s.migrations += r.n_migrations
        s.migrated_bytes += r.migrated_bytes
        s.aborted_requests += int(r.aborted)
        s.deadline_misses += int(r.deadline_missed)
        if r.output:   # an aborted request may die before its first token
            s.ttft_s.append(r.t_first_token - r.t_submit)
        # inter-token gaps only: token_times[0] IS the first-token time, so
        # prepending t_first_token would inject a spurious 0.0 latency that
        # deflates the mean/p99 this repo exists to measure.
        s.latencies_s.extend(float(b - a) for a, b in
                             zip(r.token_times[:-1], r.token_times[1:]))
    return s
