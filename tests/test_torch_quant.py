"""repro_torch.quant against repro.quant on the same inputs: int8 values
and scales bit for bit, quantized param trees, and quantized trees that
cross between the packages sealed and converted."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.core import sealing as js
from repro.models import build_model as jbuild
from repro.quant import quantize as jq
from repro_torch.core import TrustDomain
from repro_torch.core import sealing as ts
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.quant import quantize as tq


def _pair(shape, dtype="float32", seed=0, zero_col=None):
    """The same random weights for both packages; column ``zero_col`` (of
    the last axis) all zero."""
    arr = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col is not None:
        arr[..., zero_col] = 0.0
    x = jnp.asarray(arr, dtype)
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return x, t


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_q_equal(tqt, jqt):
    assert tqt.values.dtype == torch.int8 and tqt.scale.dtype == torch.float32
    np.testing.assert_array_equal(tqt.values.numpy(), np.asarray(jqt.values))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))


@pytest.mark.parametrize("shape,dtype,zero_col", [
    ((64, 96), "float32", 5),
    ((130, 129), "bfloat16", 0),
    ((3, 64, 40), "float32", 7),       # a layer-stacked [L, d, N] leaf
    ((2, 16, 4, 8), "bfloat16", None),  # wq-like [L, d, h, hd]: along heads
])
def test_quantize_int8_bit_equal(shape, dtype, zero_col):
    x, t = _pair(shape, dtype, seed=len(shape), zero_col=zero_col)
    jqt = jq.quantize_int8(x)
    tqt = tq.quantize_int8(t)
    _assert_q_equal(tqt, jqt)
    if zero_col is not None:          # an all-zero column: scale 1.0, values 0
        assert bool((tqt.scale[..., zero_col] == 1.0).all())
        assert not tqt.values[..., zero_col].any()


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_dequantize_and_qmatmul_ref_bit_equal(out):
    w, tw = _pair((96, 40), "float32", seed=1, zero_col=3)
    jqt, tqt = jq.quantize_int8(w), tq.quantize_int8(tw)
    np.testing.assert_array_equal(
        _np(tq.dequantize(tqt, getattr(torch, out))),
        np.asarray(jq.dequantize(jqt, getattr(jnp, out)).astype(jnp.float32)))
    for xdt in ("bfloat16", "float32"):
        x, tx = _pair((9, 96), xdt, seed=2)
        got = tq.qmatmul_ref(tx, tqt)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(
            _np(got), np.asarray(jq.qmatmul_ref(x, jqt).astype(jnp.float32)))


def _smoke_trees(dtype):
    cfg = dataclasses.replace(smoke_config("llama2-7b"), dtype=dtype)
    jp = jbuild(cfg).init_params(jax.random.key(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_same_leaves_same_bits(dtype):
    jp, tp = _smoke_trees(dtype)
    jqp, tqp = jq.quantize_params(jp), tq.quantize_params(tp)
    jflat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
             in jax.tree_util.tree_flatten_with_path(jqp)[0]}
    tflat = dict(ts.tree_leaves_with_names(tqp))
    assert list(tflat) == list(jflat)
    assert any(name.endswith(".values") for name in tflat)
    for name, leaf in tflat.items():
        ref = jflat[name]
        if ref.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy().view(np.uint16),
                ref.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=name)
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(tp) == jq.quantized_bytes(jp)


def test_quantize_params_takes_stacked_norms_and_min_size():
    """The size test is on the whole leaf: a stacked [L, d] norm of 4096
    elements quantizes across layers, a 1-D leaf never does."""
    tree = {"norm": np.ones((4, 1024), np.float32),
            "small": np.ones((4, 1000), np.float32),
            "vec": np.ones(8192, np.float32)}
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    tqp = tq.quantize_params(params_from_jax(tree, "cpu"))
    assert isinstance(tqp["norm"], tq.QTensor)
    assert isinstance(jqp["norm"], jq.QTensor)
    _assert_q_equal(tqp["norm"], jqp["norm"])
    assert not isinstance(tqp["small"], tq.QTensor)
    assert not isinstance(tqp["vec"], tq.QTensor)


def _to_torch_blob(st):
    ct = torch.from_numpy(np.asarray(st.ciphertext).view(np.int32).copy())
    return ts.SealedTensor(st.name, ct, st.mac, tuple(st.shape), st.dtype,
                           st.n_bytes)


def _to_jax_blob(st):
    return js.SealedTensor(st.name, jnp.asarray(st.ciphertext.numpy().view(
        np.uint32)), st.mac, st.shape, st.dtype, st.n_bytes)


def test_quantized_tree_seals_across_packages():
    jp, tp = _smoke_trees("bfloat16")
    jqp, tqp = jq.quantize_params(jp), tq.quantize_params(tp)
    jkey, tkey = js.SealingKey.generate(b"q"), ts.SealingKey.generate(b"q")
    jsealed = js.seal_tree(jkey, jqp)
    td = TrustDomain("tdx", sealing_key=tkey, device="cpu")
    tsealed = td.seal_params(tqp)
    # same names (['w_gate'].values / .scale) and the same MACs
    assert sorted(tsealed) == sorted(jsealed)
    assert "params['layers']['slot_0']['ffn']['w_gate'].scale" in tsealed
    for name in jsealed:
        assert tsealed[name].mac == jsealed[name].mac, name
    # sealed by the reference, loaded by the port's trust domain
    back = td.load_sealed({n: _to_torch_blob(st) for n, st in jsealed.items()},
                          tqp)
    w = back["layers"]["slot_0"]["ffn"]["w_gate"]
    assert isinstance(w, tq.QTensor)
    for (n1, a), (n2, b) in zip(ts.tree_leaves_with_names(back),
                                ts.tree_leaves_with_names(tqp)):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b), n1
    # sealed by the port, unsealed by the reference
    jback = js.unseal_tree(jkey, {n: _to_jax_blob(st)
                                  for n, st in tsealed.items()}, jqp)
    assert jax.tree.structure(jback) == jax.tree.structure(jqp)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jqp)):
        assert a.dtype == b.dtype and bool(jnp.all(a == b))
    # a flipped ciphertext bit in a scale fails the MAC
    name = "params['layers']['slot_0']['ffn']['w_gate'].scale"
    bad = dict(tsealed)
    ct = bad[name].ciphertext.clone()
    ct[0, 0] ^= 1
    bad[name] = dataclasses.replace(bad[name], ciphertext=ct)
    with pytest.raises(ts.IntegrityError):
        td.load_sealed(bad, tqp)


def test_convert_round_trips_qtensor_trees():
    jp, _ = _smoke_trees("bfloat16")
    jnp_tree = jax.tree.map(np.asarray, jq.quantize_params(jp))
    tp = params_from_jax(jnp_tree, "cpu")
    w = tp["layers"]["slot_0"]["ffn"]["w_up"]
    assert isinstance(w, tq.QTensor) and w.values.dtype == torch.int8
    back = params_to_jax(tp, bfloat16=jnp.bfloat16, qtensor=jq.QTensor)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # without the reference's class a QTensor comes back as the port's
    assert isinstance(params_to_jax(tp)["layers"]["slot_0"]["ffn"]["w_up"],
                      tq.QTensor)
