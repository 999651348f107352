"""repro_torch.runtime.sampling against repro.runtime.sampling and
jax.random, on the same numpy-made inputs.

Stated tolerances:
  * threefry keys, ``fold_in``, raw bits and uniforms: bit-equal.
  * Gumbel noise: ``|g_port - g_jax| <= GUMBEL_ULPS * ulp(max(|g|, 1))``.
    The port evaluates ``-log(-log(u))`` in float64; XLA's float32 ``log``
    errs by up to an ulp a call, which through the outer log is about
    2^-23 absolute wherever |g| <= 1, so the bound is in ulps of
    max(|g|, 1) (measured: at most 1 over 2,048,000 draws).
  * ``rep_pen ** count``: ``POW_ULPS`` ulp.
  * top-p masks: a token may be kept on one side only where the mass before
    it is within ``TOP_P_TOL`` of ``top_p`` (f32 cumsums in another order).
  * tokens: equal, except on a near tie: where the two packages pick
    different tokens, the port's perturbed logits (``shaped + gumbel``) of
    the two candidates lie within ``2 * (GUMBEL_ULPS * ulp(max(|g|, 1)) +
    shaping error)`` of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro.runtime import sampling as J
from repro_torch.runtime import sampling as T

GUMBEL_ULPS = 3
POW_ULPS = 1
TOP_P_TOL = 2e-5
TINY = float(np.finfo(np.float32).tiny)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(int(s)))
                     for s in seeds]).astype(np.uint32)


def test_prng_key_fold_in_and_bits_bit_equal_on_a_grid():
    """PRNGKey, fold_in and raw bits over 1024 seed/step pairs."""
    seeds = np.concatenate([np.arange(32), [100, 106, 2**31 - 1, -1, -7,
                                            2**32 + 5, 2**40 + 9],
                            np.random.default_rng(0).integers(0, 2**31, 25)])
    steps = np.concatenate([np.arange(16), [255, 4095, 2**31 - 1, 2**32 - 1],
                            np.random.default_rng(1).integers(0, 2**32, 12)])
    assert len(seeds) * len(steps) >= 1000
    for s in seeds:
        assert np.array_equal(T.prng_key(int(s)),
                              np.asarray(jax.random.PRNGKey(int(s)))), s
    keys = np.repeat(_keys(seeds), len(steps), axis=0)
    data = np.tile(steps.astype(np.uint32), len(seeds))
    jf = np.asarray(jax.vmap(jax.random.fold_in)(keys, data))
    tf = T.fold_in(_t(keys.astype(np.int64)), _t(data.astype(np.int64)))
    assert np.array_equal(tf.numpy(), jf.astype(np.int64))
    jb = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (37,)))(jf))
    assert np.array_equal(T.random_bits(tf, (37,)).numpy(),
                          jb.astype(np.int64))


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 2**32 - 1),
       st.sampled_from([1, 37, 300]))
def test_prng_bits_bit_equal_property(seed, step, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(step))
    tkey = T.fold_in(_t(T.prng_key(seed).astype(np.int64)),
                     torch.tensor(step))
    assert np.array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
    assert np.array_equal(T.random_bits(tkey, (n,)).numpy(),
                          np.asarray(jax.random.bits(key, (n,))).astype(
                              np.int64))
    # one key over a 2-D shape (the scalar temperature() path)
    assert np.array_equal(
        T.random_bits(tkey, (3, n)).numpy(),
        np.asarray(jax.random.bits(key, (3, n))).astype(np.int64))


@pytest.fixture(scope="module")
def draws():
    """64 folded keys x 32000 (Llama2's vocab) draws of uniforms and Gumbel
    noise from both packages."""
    keys = np.asarray(jax.vmap(jax.random.fold_in)(
        _keys(range(64)), np.arange(64, dtype=np.uint32) * 7))
    v = 32000
    ju = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (v,), minval=TINY, maxval=1.0)))(keys))
    jg = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.gumbel(
        k, (v,))))(keys))
    tk = _t(keys.astype(np.int64))
    return ju, jg, T.uniform(tk, (v,), minval=TINY).numpy(), \
        T.gumbel(tk, (v,)).numpy()


def test_uniforms_bit_equal(draws):
    ju, _, tu, _ = draws
    assert np.array_equal(tu.view(np.int32), ju.view(np.int32))
    # and the default [0, 1) range
    k = jax.random.PRNGKey(3)
    assert np.array_equal(
        T.uniform(_t(np.asarray(k).astype(np.int64)), (1000,)).numpy()
        .view(np.int32),
        np.asarray(jax.random.uniform(k, (1000,))).view(np.int32))


def _gumbel_tol(g):
    return GUMBEL_ULPS * np.spacing(np.maximum(np.abs(g), 1.0)
                                    .astype(np.float32)).astype(np.float64)


def test_gumbel_within_stated_ulp_bound(draws):
    _, jg, _, tg = draws
    err = np.abs(tg.astype(np.float64) - jg)
    assert (err <= _gumbel_tol(jg)).all(), err.max()
    assert np.isfinite(tg).all()


def _jstate(temp, top_k, keys, step, **opt):
    return J.SamplingState(jnp.asarray(temp, jnp.float32),
                           jnp.asarray(top_k, jnp.int32), jnp.asarray(keys),
                           jnp.asarray(step, jnp.int32),
                           **{k: jnp.asarray(v) for k, v in opt.items()})


def _tstate(temp, top_k, keys, step, **opt):
    return T.SamplingState(_t(temp, torch.float32), _t(top_k, torch.int32),
                           _t(keys.astype(np.int64)), _t(step, torch.int64),
                           **{k: _t(v) for k, v in opt.items()})


def _case(name, rng):
    """(logits [b, v], temp, top_k, optional rows, kmax) for one case."""
    b, v = 16, 256
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temp = np.full(b, 0.9, np.float32)
    top_k = np.zeros(b, np.int32)
    opt, kmax = {}, 0
    if name == "greedy_and_sampled":
        temp[::3] = 0.0
        top_k[1::2] = 16
        kmax = 16
    elif name == "top_k_ties":
        logits[:, :40] = np.round(logits[:, :40])   # many exact ties
        logits[:, 40:] = -50.0
        top_k[:] = rng.integers(1, 12, b)
        kmax = 16
    elif name == "top_p":
        opt["top_p"] = rng.uniform(0.2, 0.95, b).astype(np.float32)
        opt["top_p"][::4] = 1.0
    elif name == "top_p_and_top_k":
        opt["top_p"] = rng.uniform(0.2, 0.95, b).astype(np.float32)
        top_k[:] = 32
        kmax = 32
    elif name == "penalties":
        opt["hist"] = rng.integers(0, 5, (b, v)).astype(np.int32)
        opt["rep_pen"] = rng.uniform(0.5, 3.0, b).astype(np.float32)
        opt["presence"] = rng.uniform(-1.0, 2.0, b).astype(np.float32)
        opt["rep_pen"][0], opt["presence"][1] = 1.0, 0.0
    elif name == "bias":
        bias = np.zeros((b, v), np.float32)
        bias[:, rng.integers(0, v, 20)] = rng.uniform(-8, 8, 20)
        opt["bias"] = bias
    return logits, temp, top_k, opt, kmax


CASES = ["greedy_and_sampled", "top_k_ties", "top_p", "top_p_and_top_k",
         "penalties", "bias"]


@pytest.mark.parametrize("kmax_case", [("greedy_and_sampled", k)
                                       for k in (16, 32, 255)]
                         + [(c, None) for c in CASES])
def test_sample_matches_reference(kmax_case):
    """Tokens equal the reference's (or differ only on a stated near tie),
    over 8 decode steps of 16 rows each."""
    name, kmax_override = kmax_case
    rng = np.random.default_rng(CASES.index(name))
    logits, temp, top_k, opt, kmax = _case(name, rng)
    if kmax_override is not None:
        kmax = kmax_override
    b = logits.shape[0]
    keys = _keys(100 + np.arange(b))
    flips = 0
    for step in range(8):
        steps = np.full(b, step, np.int32)
        jt = np.asarray(J.sample(jnp.asarray(logits),
                                 _jstate(temp, top_k, keys, steps, **opt),
                                 kmax=kmax))
        ts = _tstate(temp, top_k, keys, steps, **opt)
        tt = T.sample(_t(logits), ts, kmax=kmax).numpy()
        if "rep_pen" in opt:
            jp = np.asarray(jnp.power(jnp.asarray(opt["rep_pen"])[:, None],
                                      jnp.asarray(opt["hist"], jnp.float32)))
            tp = torch.pow(_t(opt["rep_pen"])[:, None],
                           _t(opt["hist"]).float()).numpy()
            ulps = np.abs(jp.view(np.int32).astype(np.int64)
                          - tp.view(np.int32).astype(np.int64))
            assert ulps.max() <= POW_ULPS
        for row in np.nonzero(jt != tt)[0]:
            flips += 1
            # near tie: the port's perturbed logits of both candidates
            assert temp[row] > 0
            shaped = T.shaped_logits(_t(logits), ts, kmax)[row].double()
            key = T.fold_in(ts.key, ts.step)[row]
            g = T.gumbel(key, (logits.shape[1],))
            z = (shaped + g.double()).numpy()
            scale = np.spacing(np.float32(max(abs(z[jt[row]]), 1.0)))
            tol = 2 * (GUMBEL_ULPS + 2 * POW_ULPS) * scale
            assert abs(z[tt[row]] - z[jt[row]]) <= tol, (name, step, row)
    assert flips <= 1, f"{flips} near-tie flips in {name}"


def test_top_p_mask_matches_reference():
    rng = np.random.default_rng(5)
    scaled = (rng.standard_normal((64, 512)) * 2).astype(np.float32)
    top_p = rng.uniform(0.05, 0.99, 64).astype(np.float32)
    top_p[:4] = 1.0
    jm = np.asarray(J._nucleus_mask(jnp.asarray(scaled),
                                    jnp.asarray(top_p))) > -1e29
    tm = T._nucleus_mask(_t(scaled), _t(top_p)).numpy() > -1e29
    for row, col in zip(*np.nonzero(jm != tm)):
        srt = np.sort(scaled[row].astype(np.float64))[::-1]
        p = np.exp(srt - srt[0])
        p /= p.sum()
        before = np.cumsum(p) - p
        pos = int(np.nonzero(srt == scaled[row, col])[0][0])
        assert abs(before[pos] - top_p[row]) <= TOP_P_TOL
    assert (jm[:4] & tm[:4]).all()


def test_temperature_matches_reference_and_raises():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    tkey = _t(np.asarray(key).astype(np.int64))
    for kw in (dict(temp=0.7), dict(temp=0.7, top_k=5),
               dict(temp=1.3, top_p=0.6), dict(temp=0.0)):
        j = np.asarray(J.temperature(jnp.asarray(logits), key, **kw))
        t = T.temperature(_t(logits), tkey, **kw).numpy()
        assert np.array_equal(j, t), kw
    for bad, match in ((dict(top_k=64), "top_k"), (dict(top_k=65), "top_k"),
                       (dict(top_p=0.0), "top_p"), (dict(top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=match):
            T.temperature(_t(logits), tkey, 1.0, **bad)
        with pytest.raises(ValueError, match=match):
            J.temperature(jnp.asarray(logits), key, 1.0, **bad)


def test_sample_matches_temperature_per_row_and_top_k_support():
    """The reference's TestBatchedSamplingFn checks on the port: uniform
    state agrees with the scalar path row by row, and top-k / top-p keep
    the support."""
    logits = np.asarray(jax.random.normal(jax.random.key(3), (4, 32)))
    base = jax.random.PRNGKey(11)
    state = _tstate(np.full(4, 0.7, np.float32), np.full(4, 5, np.int32),
                    np.stack([np.asarray(base, np.uint32)] * 4),
                    np.arange(4, dtype=np.int32))
    batched = T.sample(_t(logits), state, kmax=8)
    for row in range(4):
        key = T.fold_in(_t(np.asarray(base).astype(np.int64)),
                        torch.tensor(row))
        one = T.temperature(_t(logits[row:row + 1]), key, temp=0.7, top_k=5)
        assert int(batched[row]) == int(one[0])
    keys = _keys(range(32))
    sup = np.asarray([[5.0, 4.9, 0.0, -1.0]] * 32, np.float32)
    st_ = _tstate(np.ones(32, np.float32), np.full(32, 3, np.int32), keys,
                  np.zeros(32, np.int32), top_p=np.full(32, 0.9, np.float32))
    assert set(T.sample(_t(sup), st_, kmax=4).tolist()) <= {0, 1}
