"""The plain versions of kernels B5 (qmatmul) and B2 (flash_attention), and
the ``ops.qmm`` / ``ops.mha_flash`` wrappers, against the JAX package's
Pallas kernels run in interpret mode on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.qmatmul import qmatmul as jqmatmul
from repro.quant import quantize_int8 as jquantize
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmatmul as Q
from repro_torch.quant import quantize_int8 as tquantize


def _f32(x):
    """A torch tensor or jax array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(arr, dtype):
    """numpy f32 -> (jax array, torch tensor) of the same ``dtype`` bits."""
    x = jnp.asarray(arr, dtype)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))


# ---------------------------------------------------------------------------
# B5: qmatmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 384, 128, 128, 128, 128),
    (128, 256, 256, 64, 128, 64),
    (512, 128, 384, 128, 128, 128),
])
def test_qmatmul_plain_bit_equal(m, k, n, bm, bn, bk, out):
    rng = np.random.default_rng(m + n)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    wq[:, 3] = 0                                   # an all-zero column
    scale = rng.uniform(0.01, 1.0, (1, n)).astype(np.float32)
    expect = jqmatmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                      bm=bm, bn=bn, bk=bk, out_dtype=getattr(jnp, out))
    got = Q.qmatmul(torch.from_numpy(xq), torch.from_numpy(wq),
                    torch.from_numpy(scale), out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(_f32(got), _f32(expect))


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(100, 200, 300), (7, 130, 129), (1, 64, 32)])
def test_qmm_bit_equal(m, k, n, xdt):
    rng = np.random.default_rng(m * k)
    x, tx = _both(rng.standard_normal((m, k)).astype(np.float32), xdt)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 1] = 0.0
    jw, tw = _both(w, "float32")
    expect = jops.qmm(x, jquantize(jw))
    got = tops.qmm(tx, tquantize(tw))
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(_f32(got), _f32(expect))


def test_qmatmul_rejects_what_it_does_not_take():
    xq = torch.zeros(4, 16, dtype=torch.int8)
    wq = torch.zeros(16, 8, dtype=torch.int8)
    scale = torch.ones(1, 8)
    with pytest.raises(TypeError):
        Q.qmatmul(xq.float(), wq, scale)
    with pytest.raises(TypeError):
        Q.qmatmul(xq, wq, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        Q.qmatmul(xq, wq, torch.ones(8))
    with pytest.raises(ValueError):
        Q.qmatmul(xq.to("meta"), wq.to("meta"), scale.to("meta"))


# ---------------------------------------------------------------------------
# B2: flash attention
# ---------------------------------------------------------------------------

def _qkv(shape, dtype, seed, kv_shape=None):
    rng = np.random.default_rng(seed)
    q = _both(rng.standard_normal(shape).astype(np.float32), dtype)
    k, v = (_both(rng.standard_normal(kv_shape or shape).astype(np.float32),
                  dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("bh,s,d,bq,bkv", [
    (2, 128, 64, 64, 64),
    (4, 256, 64, 128, 64),
    (1, 256, 128, 64, 128),
    (8, 128, 32, 128, 128),
])
def test_flash_plain_matches_f32(bh, s, d, bq, bkv):
    (jq, tq), (jk, tk), (jv, tv) = _qkv((bh, s, d), "float32", s + d)
    expect = jflash(jq, jk, jv, bq=bq, bkv=bkv)
    got = F.flash_attention(tq, tk, tv, bq=bq, bkv=bkv)
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=2e-5, rtol=2e-5)


def test_flash_plain_matches_bf16():
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 128, 64), "bfloat16", 9)
    expect = jflash(jq, jk, jv, bq=64, bkv=64)
    got = F.flash_attention(tq, tk, tv, bq=64, bkv=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=2e-2, rtol=2e-2)


def test_flash_plain_causality():
    """Changing future K/V must not change earlier rows."""
    (_, q), (_, k), (_, v) = _qkv((1, 128, 32), "float32", 3)
    out1 = F.flash_attention(q, k, v, bq=64, bkv=64)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = F.flash_attention(q, k2, v2, bq=64, bkv=64)
    assert torch.equal(out1[:, :100], out2[:, :100])
    assert not torch.equal(out1[:, 100:], out2[:, 100:])


@pytest.mark.parametrize("s,h,hk,dtype", [
    (128, 8, 2, "float32"),                          # GQA at a block multiple
    (1, 4, 4, "float32"), (7, 4, 4, "float32"), (129, 4, 4, "float32"),
    (200, 4, 2, "float32"), (250, 4, 4, "float32"),  # ragged s, padded
    (200, 4, 2, "bfloat16"),
])
def test_mha_flash_matches(s, h, hk, dtype):
    b, hd = 2, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv((b, s, h, hd), dtype, s + h,
                                        kv_shape=(b, s, hk, hd))
    bq = 64 if s == 128 else 128
    expect = jops.mha_flash(jq, jk, jv, bq=bq, bkv=bq)
    got = tops.mha_flash(tq, tk, tv, bq=bq, bkv=bq)
    assert tuple(got.shape) == (b, s, h, hd) and got.dtype == tq.dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)


def test_flash_rejects_what_it_does_not_take():
    q = torch.zeros(4, 128, 32)
    with pytest.raises(ValueError):            # s not a block multiple
        F.flash_attention(q[:, :100], q[:, :100], q[:, :100])
    with pytest.raises(ValueError):            # kv heads do not divide
        F.flash_attention(q, q[:3], q[:3])
    with pytest.raises(TypeError):
        F.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        F.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# ---------------------------------------------------------------------------
# B5's plan (csrc/qmatmul.cu) and ops.qmm's padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4096, 11008, 4112])
@pytest.mark.parametrize("m", [1, 17, 128, 130, 2048])
def test_qmm_plan_covers_k_once_and_sums_exactly(m, k):
    """The plan's K split covers K exactly once (whole 64-steps, at most one
    cluster of splits), M picks the regime, and the split's int partials
    summed in the plan's order give qmatmul_plain's bits (the plan of the
    real N = 4096 product, on 8 of its columns)."""
    plan = Q.qmm_plan(m, 4096, k)
    assert plan.regime == ("small" if m <= Q.SMALL_M else "large")
    assert plan.bm in Q.BM_CHOICES and (plan.bm >= m or plan.bm == 128)
    assert 1 <= plan.splits <= Q.MAX_SPLITS and plan.k_per_split % Q.BK == 0
    runs = [(i * plan.k_per_split, min(k, (i + 1) * plan.k_per_split))
            for i in range(plan.splits)]
    assert runs[0][0] == 0 and runs[-1][1] == k
    assert all(lo < hi for lo, hi in runs)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.integers(-127, 128, (min(m, 130), k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, 8), dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, 8)).astype(np.float32))
    assert torch.equal(Q._split_sum(x, w, scale, plan),
                       Q.qmatmul_plain(x, w, scale))


def test_qmm_plan_fills_the_card_at_decode():
    """At M = 1 every SM gets about two CTAs on both Llama2-7B FFN weights,
    w_down's 32 column tiles included; at M = 2048 the tiles alone do."""
    for k, n in ((4096, 11008), (11008, 4096)):
        p = Q.qmm_plan(1, n, k)
        assert -(-n // Q.BN) * p.splits >= Q.H100_SMS
        assert Q.qmm_plan(2048, n, k).splits == 1


@pytest.mark.parametrize("m", [1, 5, 130])
def test_qmm_without_m_padding_bit_equal(m):
    """ops.qmm pads K to 16 and N to 4 only (no M padding) and still gives
    the reference's bits, which pads every dimension to 128."""
    rng = np.random.default_rng(m)
    x, tx = _both(rng.standard_normal((m, 200)).astype(np.float32), "bfloat16")
    jw, tw = _both(rng.standard_normal((200, 134)).astype(np.float32),
                   "float32")
    got = tops.qmm(tx, tquantize(tw))
    assert tuple(got.shape) == (m, 134)
    np.testing.assert_array_equal(_f32(got), _f32(jops.qmm(x, jquantize(jw))))
