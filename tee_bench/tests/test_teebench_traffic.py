"""The traffic generator: the same seed gives the same requests, every
seed the same work in another order, and the lengths and gaps follow the
declared distributions."""

import math
from statistics import NormalDist

import numpy as np
import pytest

from teebench import spec, traffic
from teebench.client import bucket_for

POISSON = {"arrival": "poisson", "coalesce": 1,
           "prompt": {"median": 1000, "sigma": 0.6, "min": 128, "max": 3072},
           "output": {"median": 200, "sigma": 0.6, "min": 16, "max": 512}}
SEEDS = (7, 2 ** 40 + 11, 3_000_000_123)


RATE = {"rate_per_s": 1.6, "lengths_block": 8}


def _gen(seed, mix=POISSON, arrivals=None, window=50.0, preroll=10.0):
    return traffic.generate(mix, arrivals or RATE, 102400, seed, window,
                            preroll)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(seed):
    a, b = _gen(seed), _gen(seed)
    assert [r.t_due for r in a] == [r.t_due for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]


def test_seeds_share_the_work_in_another_order():
    runs = [_gen(s) for s in SEEDS]
    sizes = {tuple(sorted(len(r.prompt) for r in run)) for run in runs}
    outs = {tuple(sorted(r.max_new_tokens for r in run)) for run in runs}
    assert len(sizes) == len(outs) == 1
    assert {len(run) for run in runs} == {96}
    orders = {tuple(len(r.prompt) for r in run) for run in runs}
    assert len(orders) == len(runs)
    times = {tuple(r.t_due for r in run) for run in runs}
    assert len(times) == len(runs)
    assert not np.array_equal(runs[0][0].prompt[:16], runs[1][0].prompt[:16])


def test_every_block_takes_one_length_of_every_stratum():
    rows = traffic.deal(np.arange(96)[::-1], 12, np.random.default_rng(2))
    assert rows.shape == (12, 8)
    assert all(sorted(v // 12 for v in row) == list(range(8))
               for row in rows)
    assert sorted(rows.reshape(-1)) == list(range(96))


@pytest.mark.parametrize("seed", SEEDS)
def test_consecutive_arrivals_take_every_stratum(seed):
    """In arrival order, each block of ``lengths_block`` requests takes one
    output length from each eighth of the sorted lengths."""
    run = _gen(seed)
    ranks = np.argsort(np.argsort([r.max_new_tokens for r in run],
                                  kind="stable"), kind="stable")
    for b in range(0, 96, 8):
        assert sorted(ranks[b:b + 8] // 12) == list(range(8))


def test_lengths_follow_the_lognormal():
    run = _gen(5, window=300.0)
    n = len(run)
    lens = np.array([len(r.prompt) for r in run])
    assert abs(np.median(lens) - 1000) <= 2
    # the share clipped at the top is the lognormal's tail beyond 3072
    tail = 1 - NormalDist().cdf(math.log(3072 / 1000) / 0.6)
    assert abs((lens == 3072).mean() - tail) < 2.0 / n + 1e-9
    assert lens.min() >= 128 and lens.max() <= 3072
    toks = np.concatenate([r.prompt for r in run])
    assert toks.min() >= 1 and toks.max() < 102400


def test_arrivals_cover_the_preroll_and_the_window():
    run = _gen(9, window=50.0, preroll=10.0)
    t = np.array([r.t_due for r in run])
    assert np.all(np.diff(t) >= 0) and t[0] >= -10.0 and t[-1] < 50.0
    assert len(run) == 96          # the count fixed at its mean, 1.6 x 60


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_are_poisson(seed):
    """Over a long span: exponential gaps (mean 1/rate, median ln 2 of it,
    as many above the mean as e^-1 says) and counts in 5 s bins as
    dispersed as a Poisson count's (variance about the mean), so no bin
    holds a fixed number."""
    rate, span = 2.0, 2000.0
    run = _gen(seed, arrivals={"rate_per_s": rate, "lengths_block": 8},
               window=span, preroll=0.0)
    t = np.array([r.t_due for r in run])
    assert len(t) == 4000
    gaps = np.diff(t)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.02)
    assert np.median(gaps) == pytest.approx(math.log(2) / rate, rel=0.08)
    assert (gaps > 1 / rate).mean() == pytest.approx(math.exp(-1), abs=0.03)
    counts = np.bincount((t // 5.0).astype(int), minlength=400)
    assert counts.mean() == pytest.approx(10.0)
    # a fixed count per bin would read 0; a binomial count of p = 1/400
    # reads (1 - p); the 400 bins' sample variance lies within ~ +-25 %
    assert 0.75 < counts.var(ddof=1) / counts.mean() < 1.25


def test_closed_loop_rounds_share_their_lengths():
    mix = dict(POISSON, arrival="closed")
    run = _gen(3, mix, {"clients": 8, "requests_per_client": 4})
    assert len(run) == 32
    assert [r.client for r in run] == [i % 8 for i in range(32)]
    assert all(r.t_due is None for r in run)
    rounds = {tuple(sorted(len(r.prompt) for r in run[k * 8:(k + 1) * 8]))
              for k in range(4)}
    assert len(rounds) == 1
    assert len({tuple(len(r.prompt) for r in run[k * 8:(k + 1) * 8])
                for k in range(4)}) > 1


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_every_cell_request_fits_its_engine(name):
    """No operation fails: each request's bucket plus its output fits the
    paged cache's per-request room."""
    bench = spec.benchmark()
    w = spec.workload(bench, name)
    cell, mix, cfg = spec.cell(name), spec.traffic(w["traffic"]), \
        spec.config(w["config"])
    eng = cell["engine"]
    run = traffic.generate(mix, cell["arrivals"], cfg["vocab_size"], 1,
                           bench["run_seconds"], cell["preroll_s"])
    assert max(len(r.prompt) for r in run) <= max(eng["prefill_buckets"])
    need = max(bucket_for(eng["prefill_buckets"], len(r.prompt))
               + r.max_new_tokens - 1 for r in run)
    assert need <= eng["max_len"] and eng["max_len"] % eng["page_size"] == 0
    assert max(eng["prefill_buckets"]) < eng["max_len"]
