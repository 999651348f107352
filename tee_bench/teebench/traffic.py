"""One general generator for every traffic mix.

A mix is a JSON file of parameters under ``traffic/``: how requests arrive
(``"poisson"``: an open loop at the cell's fixed rate; ``"closed"``: a
closed loop of the cell's clients with no think time), how long prompts
and outputs are (a lognormal with a median and a sigma, clipped), and how
many tokens ride in one egress frame (``coalesce``).

Every seed gets the same work in another order, so that runs on different
seeds differ by the order of the work and not by its amount.

* Open loop: a Poisson process over the pre-roll and the window, taken
  with its count fixed at its mean: ``rate * (preroll + window)`` arrival
  times drawn uniformly over that span and sorted, which is the law of a
  Poisson process given its count. No shorter span holds a fixed count,
  so bursts are those of Poisson arrivals. Prompt and output lengths are
  the lognormal's quantiles at ``(i + 0.5) / m``, ``m`` the count rounded
  up to whole blocks of ``lengths_block``, dealt in arrival order so that
  every block of that many consecutive requests takes one length from
  each stratum of neighbouring quantiles; the seed decides which and
  orders them. A short last block drops what it has no arrivals for, so
  seeds differ by at most ``lengths_block - 1`` of the window's last
  requests.
* Closed loop: each client's k-th request comes from round k, and every
  round holds the lognormal's quantiles over the clients, dealt to them in
  an order the seed draws.

The seed also draws every token id.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RequestSpec:
    """One request: when it falls due (seconds from the window's start;
    negative in the pre-roll, None for a closed loop's, which fall due when
    their client is free), its prompt and its output length."""
    t_due: Optional[float]
    prompt: np.ndarray
    max_new_tokens: int
    client: int = 0


def lognormal_quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of a lognormal with
    ``median`` and ``sigma``, rounded and clipped to [min, max]."""
    nd = NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    vals = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1),
                                  int(seed) >> 64, stream])


def deal(values: np.ndarray, groups: int,
         rng: np.random.Generator) -> np.ndarray:
    """Sorted ``values`` (``groups * per`` of them) dealt into ``groups``
    rows of ``per``: row g takes one value from every stratum of ``groups``
    neighbours, the seed choosing which and ordering each row."""
    per = len(values) // groups
    strata = np.sort(values).reshape(per, groups)
    rows = np.stack([rng.permutation(s) for s in strata], axis=1)
    return np.stack([rng.permutation(r) for r in rows])


def generate(traffic: dict, arrivals: dict, vocab: int, seed: int,
             window_s: float, preroll_s: float) -> List[RequestSpec]:
    """The requests of one run, in the order they fall due.

    ``arrivals`` is the cell's: ``{"rate_per_s": r, "lengths_block": k}``
    for a Poisson mix (arrivals over the pre-roll and the window), or
    ``{"clients": c, "requests_per_client": k}`` for a closed loop
    (request i belongs to client ``i % c``; each client sends its next one
    when the last finishes)."""
    kind = traffic["arrival"]
    if kind == "poisson":
        n = int(round(arrivals["rate_per_s"] * (preroll_s + window_s)))
        per = int(arrivals["lengths_block"])
        if n < 1 or per < 1:
            raise ValueError(f"no arrivals: {arrivals} over "
                             f"{preroll_s + window_s} s")
        rows = -(-n // per)
        t_due = np.sort(_rng(seed, 4).uniform(-preroll_s, window_s, n))
        prompts, outputs = (
            deal(lognormal_quantiles(traffic[key], rows * per), rows,
                 _rng(seed, stream)).reshape(-1)[:n]
            for key, stream in (("prompt", 1), ("output", 2)))
    elif kind == "closed":
        per, rows = arrivals["clients"], arrivals["requests_per_client"]
        n = per * rows
        # round r holds every client's r-th request: the quantiles over the
        # clients, in an order the seed draws
        prompts, outputs = (
            np.concatenate([rng.permutation(lognormal_quantiles(
                traffic[key], per)) for _ in range(rows)])
            for key, rng in (("prompt", _rng(seed, 1)),
                             ("output", _rng(seed, 2))))
    else:
        raise ValueError(f"unknown arrival process {kind!r}")
    tok_rng = _rng(seed, 3)
    out = []
    for i in range(n):
        prompt = tok_rng.integers(1, vocab, int(prompts[i]), dtype=np.int64)
        out.append(RequestSpec(
            t_due=float(t_due[i]) if kind == "poisson" else None,
            prompt=prompt.astype(np.int32),
            max_new_tokens=int(outputs[i]),
            client=i % per if kind == "closed" else 0))
    return out
