"""Request/response object model for the serving API (engine v3).

The paper serves real traffic through vLLM/IPEX-style engines where every
request carries its own generation settings and deadline, and Insight 10
shows per-crossing fixed costs dominate cGPU overhead — a knob that only
exists per request (how many tokens ride in each encrypted egress frame).
This module is the stable surface the engine, launcher, benchmarks and
examples all speak:

  * :class:`SamplingParams` — how tokens are chosen (greedy by default;
    temperature/top-k with a reproducible per-request seed),
  * :class:`FramePolicy`   — how sampled tokens cross the trust boundary
    (``coalesce=1``: one encrypted frame per token, the paper's SecureChat
    pattern; ``coalesce=N``: N tokens amortize one frame's fixed cost),
  * :class:`GenerationRequest` — prompt + params + priority + SLO fields
    (relative deadline, drop-on-deadline policy),
  * :class:`RequestOutput` — tokens, finish reason, per-request timing and
    boundary-crossing counts (the unit Insight 10's fixed cost is paid per).

Everything here is plain host-side data; the engine turns
:class:`SamplingParams` into ``[slots]``-shaped device arrays (see
``kvcache.SlotState``) so the jitted decode step samples per request.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

# fired as each token becomes visible OUTSIDE the trust domain (i.e. at
# frame-flush time, not at sample time, when frames are coalesced)
TokenCallback = Callable[["object", int], None]

FINISH_LENGTH = "length"     # hit max_new_tokens
FINISH_STOP = "stop"         # emitted eos_id
FINISH_DROPPED = "dropped"   # deadline passed while queued (on_deadline="drop")
FINISH_ABORTED = "aborted"   # deadline passed mid-flight (on_deadline="abort")
FINISH_REJECTED = "rejected"  # refused at ingest: deadline provably unmeetable


@dataclasses.dataclass
class SamplingParams:
    """Per-request token-selection settings.

    ``temperature <= 0`` is greedy (the default — byte-identical to engine
    v2). With ``temperature > 0`` the engine samples from the scaled
    distribution, optionally restricted to the ``top_k`` highest logits
    (``top_k=0`` = unrestricted; ``top_k`` must be < vocab_size — use 0
    instead of the degenerate full-vocab restriction) and/or to the nucleus
    of tokens whose cumulative probability reaches ``top_p``
    (``top_p=1.0`` = off). ``top_k`` and ``top_p`` compose: the support is
    the intersection of both restrictions.

    ``repetition_penalty`` (> 1 discourages; CTRL-style: positive logits of
    already-generated tokens divide by it, negative ones multiply) and
    ``presence_penalty`` (a flat subtraction from every already-generated
    token's logit; may be negative to *encourage* reuse) act on this
    request's generated tokens only — the prompt is not penalized, and
    neither applies to greedy requests. The neutral values (1.0 / 0.0) are
    free: like ``top_p``, the penalty math only compiles into the decode
    step when some live request actually uses it.

    ``logit_bias`` maps token ids to additive logit offsets, applied to the
    raw logits before the penalties every step (use a large negative value
    like ``-100`` to ban a token, a positive one to promote it). The map is
    static for the request's lifetime and rebuilt whenever its slot's
    sampling row is set, so a sealed preemption/restore reproduces it
    exactly. Like the penalties it only applies to sampled requests — a
    greedy request with a bias is rejected at validation rather than
    silently ignoring the map (the greedy fast path never consults sampling
    state).

    ``seed`` makes the request reproducible: the engine derives one PRNG key
    from it and ``fold_in``s the output-token index at every step, so the
    same seeded request yields byte-identical tokens even across a sealed-KV
    preemption/restore cycle (the fold-in depends only on how many tokens
    exist, not on when they were produced — and the penalty history is
    rebuilt from the request's own output list on restore). Unseeded sampled
    requests get a fresh seed at submit time (recorded in
    :class:`RequestOutput`).
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    logit_bias: Optional[Dict[int, float]] = None
    seed: Optional[int] = None

    def validate(self, vocab_size: int) -> None:
        if not np.isfinite(self.temperature):
            raise ValueError(f"temperature must be finite, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.top_k >= vocab_size:
            raise ValueError(
                f"top_k={self.top_k} must be < vocab_size={vocab_size}; "
                f"use top_k=0 for an unrestricted distribution")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}; "
                f"use top_p=1.0 for an unrestricted distribution")
        if not (np.isfinite(self.repetition_penalty)
                and self.repetition_penalty > 0):
            raise ValueError(
                f"repetition_penalty must be finite and > 0, got "
                f"{self.repetition_penalty}; 1.0 turns it off")
        if not np.isfinite(self.presence_penalty):
            raise ValueError(f"presence_penalty must be finite, got "
                             f"{self.presence_penalty}; 0.0 turns it off")
        if self.logit_bias:
            if self.is_greedy:
                raise ValueError(
                    "logit_bias requires temperature > 0: the greedy path "
                    "takes argmax over the raw logits and would silently "
                    "ignore the bias map")
            for tok, val in self.logit_bias.items():
                if not (0 <= int(tok) < vocab_size):
                    raise ValueError(
                        f"logit_bias token id {tok} out of range "
                        f"[0, {vocab_size})")
                if not np.isfinite(val):
                    raise ValueError(
                        f"logit_bias[{tok}] must be finite, got {val}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass
class FramePolicy:
    """How a request's sampled tokens leave the trust domain.

    ``coalesce=1`` streams one encrypted frame per token — maximum boundary
    crossings, the honest worst case the cgpu profile's ``fixed_boundary_s``
    prices. ``coalesce=N`` buffers N tokens per frame (flush-on-finish), so
    one fixed per-crossing cost is amortized over N tokens — the Insight-10
    amortization curve ``serve_bench.py`` sweeps. Decoded output is
    unaffected; only latency-to-client and crossing counts change.
    """
    coalesce: int = 1

    def validate(self) -> None:
        if self.coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {self.coalesce}")


@dataclasses.dataclass
class GenerationRequest:
    """One unit of serving work: prompt + per-request policies.

    SLO fields: ``deadline_s`` is relative to submit time. With
    ``on_deadline="drop"`` the scheduler removes the request if the deadline
    passes while it is still queued (counted in ``ServeStats.dropped_requests``;
    its :class:`RequestOutput` carries ``finish_reason="dropped"``). With
    ``on_deadline="abort"`` the deadline is enforced *mid-flight* too: a
    running request past its deadline is terminated at the next engine step
    (partial tokens delivered, ``finish_reason="aborted"``), and a sealed-out
    (preempted) request past its deadline is discarded instead of restored —
    bounding the tail latency its slot-mates would otherwise pay. Both count
    in ``ServeStats.deadline_misses``. With the default ``"serve"`` it is
    served anyway and a late finish is counted in
    ``ServeStats.deadline_misses``. Requests are single-use: submit a fresh
    object per call.

    ``share_prefix`` (default True) lets a prefix-sharing engine
    (``Engine(kv_backend="paged", prefix_sharing=True)``) map this
    request's prompt pages onto resident shared physical pages and register
    its own pages in the content index. Opting out (``share_prefix=False``)
    keeps every page private — for tenants whose prompts must not be
    content-addressed alongside other traffic, at worst-case memory cost.
    On a non-sharing engine the flag is inert. Decoded output is identical
    either way.
    """
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    priority: int = 0                  # higher = more important
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    frame: FramePolicy = dataclasses.field(default_factory=FramePolicy)
    deadline_s: Optional[float] = None
    on_deadline: str = "serve"         # "serve" | "drop" | "abort"
    share_prefix: bool = True
    on_token: Optional[TokenCallback] = None
    # Which tenant's key domain this request's sealed KV and egress frames
    # live in (fleet serving). None = the worker's own domain — the
    # single-engine default, byte-identical to pre-fleet behavior. The
    # gateway sets it; a tenant can't choose another tenant's domain because
    # the domain key itself never leaves the attested workers.
    tenant: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)

    def validate(self, vocab_size: int) -> None:
        if self.max_new_tokens < 1:
            # the prefill-produced first token always exists; a request that
            # asked for zero would still emit (and egress) it.
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.on_deadline not in ("serve", "drop", "abort"):
            raise ValueError(f"on_deadline must be 'serve', 'drop' or "
                             f"'abort', got {self.on_deadline!r}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        self.params.validate(vocab_size)
        self.frame.validate()


@dataclasses.dataclass
class RequestOutput:
    """The finished (or dropped) result of one :class:`GenerationRequest`.

    Timing is host-measured: ``ttft_s`` submit→first sampled token,
    ``e2e_s`` submit→done. Boundary counts are per request — the crossings
    this request paid for: one ingress message for the prompt and
    ``egress_frames`` encrypted frames carrying ``egress_tokens`` tokens
    (``egress_frames == ceil(tokens / coalesce)``; both 0 outside a
    confidential mode, where nothing crosses an encrypted boundary).
    """
    rid: int
    tokens: List[int]
    finish_reason: str
    ttft_s: float = 0.0
    e2e_s: float = 0.0
    n_preemptions: int = 0
    sealed_bytes: int = 0
    deadline_missed: bool = False
    ingress_messages: int = 0
    egress_frames: int = 0
    egress_tokens: int = 0
    seed: Optional[int] = None

    @classmethod
    def from_request(cls, req) -> "RequestOutput":
        """Build from a finished scheduler ``Request`` (duck-typed to avoid
        an api->scheduler import cycle)."""
        if not req.finished:
            raise RuntimeError(f"request {req.rid} has not finished")
        return cls(
            rid=req.rid,
            tokens=list(req.output),
            finish_reason=req.finish_reason,
            ttft_s=(req.t_first_token - req.t_submit) if req.output else 0.0,
            e2e_s=req.t_done - req.t_submit,
            n_preemptions=req.n_preemptions,
            sealed_bytes=req.sealed_bytes,
            deadline_missed=req.deadline_missed,    # one source: the Request
            ingress_messages=req.ingress_messages,
            egress_frames=req.egress_frames,
            egress_tokens=req.egress_tokens,
            seed=req.seed,
        )
