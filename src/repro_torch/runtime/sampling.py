"""Token sampling: greedy / temperature / top-k / top-p, with penalties and
logit bias (port of ``repro.runtime.sampling``).

Two entry points, as in the reference:

  * :func:`temperature` — one distribution policy for a whole batch
    (tests, offline tools).
  * :func:`sample` — the engine's batched path: every decode step samples
    all slots at once, each with its own temperature/top-k/top-p/PRNG key
    carried in a :class:`SamplingState` of ``[slots]``-shaped tensors.
    Greedy slots (``temp <= 0``) and sampled slots coexist in one call.

The order of operations is the reference's: logit bias, then the
frequency-weighted repetition penalty (``rep_pen ** count``, clipped to
[1e-30, 1e30]) and the presence penalty on the raw logits, then the divide
by ``max(temp, 1e-6)``, top-k through the static ``kmax`` bound (ties with
the k-th value are kept), top-p over what top-k left, and a Gumbel-max draw;
greedy rows take the argmax of the raw logits.

Randomness is a bit-exact copy of the reference's ``jax.random`` threefry
PRNG (jax's partitionable layout): :func:`prng_key` is ``PRNGKey(seed)``,
:func:`fold_in`, :func:`random_bits`, :func:`uniform`, :func:`gumbel` and
:func:`categorical` follow ``jax._src.prng`` and ``jax._src.random``. Torch
has no uint32 add or shift on the CPU, so every word is an int64 tensor
holding a value in [0, 2**32), masked after each add and shift. Keys are
``[..., 2]`` tensors of such words. Keys, raw bits and uniforms equal jax's
bit for bit. The Gumbel noise is ``-log(-log(u))`` evaluated in float64 and
rounded to float32: within an ulp or two of XLA's float32 evaluation (a
bound the tests state), whichever float32 ``log`` the backend would pick.

Each sampled row folds its output-token index into its request's base key,
so a seeded request draws the same tokens across a sealed-KV preemption and
on any backend. Everything runs on the logits' device, as plain torch ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_MASKED = -1e30   # large-negative logit mask (f32-safe, softmax-zero)
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


class SamplingState(NamedTuple):
    """Per-slot sampling parameters, shaped ``[slots]``. ``None`` rows switch
    their stage off (the engine passes them only when some slot uses
    them)."""
    temp: torch.Tensor    # [b] f32; <= 0 selects greedy for that slot
    top_k: torch.Tensor   # [b] int; 0 = unrestricted
    key: torch.Tensor     # [b, 2] u32 words (int64) per-request base keys
    step: torch.Tensor    # [b] int output-token index (folded into the key)
    top_p: Optional[torch.Tensor] = None     # [b] f32; None/1.0 = off
    rep_pen: Optional[torch.Tensor] = None   # [b] f32; None/1.0 = off
    presence: Optional[torch.Tensor] = None  # [b] f32; None/0.0 = off
    hist: Optional[torch.Tensor] = None      # [b, v] int generated counts
    bias: Optional[torch.Tensor] = None      # [b, v] f32 additive bias


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [b, v] -> token ids [b] (first index among equal maxima)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def pick(logits: torch.Tensor, state: Optional["SamplingState"],
         kmax: int) -> torch.Tensor:
    """A decode step's tokens: greedy on an all-greedy step (``state`` is
    None), else :func:`sample`."""
    return greedy(logits) if state is None else sample(logits, state,
                                                       kmax=kmax)


# ---------------------------------------------------------------------------
# threefry2x32 PRNG (jax's, bit for bit)
# ---------------------------------------------------------------------------

def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32 ``[2]``. ``threefry_seed``
    splits a seed into ``[hi, lo]`` words; in jax's default 32-bit mode,
    which the reference runs in, the seed is a 32-bit integer first, so the
    key is ``[0, seed mod 2**32]`` (``prng_key(100)`` is ``[0, 100]``)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds, key injection every 4), on u32
    words held in int64 tensors (broadcastable shapes). Returns
    ``(y0, y1)``."""
    k0, k1, x0, x1 = (_u32(t) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys ``[..., 2]`` and u32 data
    ``[...]`` -> keys ``[..., 2]`` (threefry of the key over the counter
    pair ``[0, data]``)."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data, dtype=torch.int64), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` in the partitionable layout:
    counter pairs ``(0, flat index)``, result ``y0 ^ y1``. ``key`` is one
    key ``[2]`` (bits of ``shape``) or a batch ``[b, 2]`` (each row draws
    ``shape`` with its own key, as under ``jax.vmap``). Returns u32 words
    in int64."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` for float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled into [minval, maxval)
    and floored at ``minval``."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    # f32 bounds as exact Python scalars (no host-to-device copy, which
    # would wait for the stream)
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * scale + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` for u uniform
    in [tiny, 1), in float64 rounded to float32. A float32 ``log`` may take
    another implementation from call to call (torch's first CPU call in a
    process that had run XLA was off by up to 841 ulp), so the noise would
    not be reproducible; float64 keeps it within 1 ulp of jax's."""
    u = uniform(key, shape, minval=_TINY).double()
    return (-torch.log(-torch.log(u))).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max): argmax of
    ``gumbel + logits``. ``key`` is one key ``[2]`` for the whole batch (as
    jax with one key and ``[b, v]`` logits) or ``[b, 2]``, one per row (as
    jax under ``vmap``)."""
    shape = logits.shape if key.dim() == 1 else logits.shape[1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _nucleus_mask(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Restrict each row of ``scaled`` logits to its nucleus: the smallest
    descending-probability prefix whose cumulative mass reaches that row's
    ``top_p``. Rows with ``top_p >= 1`` pass through unrestricted."""
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    # keep a token while the mass BEFORE it is < top_p: the first token is
    # always kept, and the token that crosses the threshold is included.
    keep = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True)
    restricted = torch.where(scaled >= thresh, scaled, _MASKED)
    return torch.where(top_p[:, None] < 1.0, restricted, scaled)


def temperature(logits: torch.Tensor, key: torch.Tensor, temp: float = 1.0,
                top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Scalar-setting sampling for a whole batch (one shared distribution
    policy and one key ``[2]``). ``temp <= 0`` is greedy."""
    if temp <= 0:
        return greedy(logits)
    vocab = logits.shape[-1]
    if top_k >= vocab:
        raise ValueError(
            f"top_k={top_k} must be < vocab_size={vocab}; "
            f"use top_k=0 for an unrestricted distribution")
    if not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    scaled = logits.to(torch.float32) / np.float32(temp)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, _MASKED)
    if top_p < 1.0:
        scaled = _nucleus_mask(scaled, torch.full(
            (scaled.shape[0],), top_p, dtype=torch.float32,
            device=logits.device))
    return categorical(key, scaled).to(torch.int32)


def shaped_logits(logits: torch.Tensor, state: SamplingState,
                  kmax: int = 0) -> torch.Tensor:
    """The f32 logits a sampled row draws from: bias, penalties, the
    temperature divide, then the top-k and top-p masks (see :func:`sample`)."""
    logits_f = logits.to(torch.float32)
    if state.bias is not None:
        logits_f = logits_f + state.bias
    if state.rep_pen is not None:
        # frequency-weighted CTRL: a count of c applies rep_pen**c (c = 0
        # gives exactly 1.0); the clip guards overflow on long sequences.
        rp_pow = torch.clamp(
            torch.pow(state.rep_pen[:, None], state.hist.to(torch.float32)),
            1e-30, 1e30)
        logits_f = torch.where(logits_f > 0, logits_f / rp_pow,
                               logits_f * rp_pow)
    if state.presence is not None:
        logits_f = logits_f - state.presence[:, None] * (
            state.hist > 0).to(torch.float32)
    # guard the divide for greedy rows (their sampled value is discarded)
    scaled = logits_f / torch.clamp_min(state.temp, 1e-6)[:, None]
    if kmax > 0:
        kmax = min(int(kmax), logits.shape[-1])
        vals = torch.topk(scaled, kmax, dim=-1).values           # [b, kmax]
        idx = torch.clamp(state.top_k.to(torch.int64) - 1, 0, kmax - 1)
        kth = torch.gather(vals, 1, idx[:, None])                # [b, 1]
        restricted = torch.where(scaled >= kth, scaled, _MASKED)
        scaled = torch.where(state.top_k[:, None] > 0, restricted, scaled)
    if state.top_p is not None:
        # after top-k: the nucleus is measured over what top-k left
        scaled = _nucleus_mask(scaled, state.top_p)
    return scaled


def sample(logits: torch.Tensor, state: SamplingState, *,
           kmax: int = 0) -> torch.Tensor:
    """Batched per-slot sampling: logits [b, v] + state [b] -> tokens [b].

    ``kmax`` bounds every slot's ``top_k`` this call (the engine rounds the
    active maximum up to a power of two); ``kmax=0`` skips top-k. Per slot:
    ``temp <= 0`` takes the argmax of the raw logits, ``top_k == 0`` and
    ``top_p`` absent or 1 leave the support unrestricted, else the support
    is the intersection of both restrictions. Each row draws with
    ``fold_in(key, step)``."""
    keys = fold_in(state.key, state.step)
    sampled = categorical(keys, shaped_logits(logits, state, kmax))
    return torch.where(state.temp > 0, sampled.to(torch.int32),
                       greedy(logits))
