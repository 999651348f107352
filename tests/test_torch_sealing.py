"""repro_torch's confidential core against repro.core on the same inputs:
sealed blobs, MACs, names and nonces byte for byte; blobs and bounce frames
that cross between the packages; attestation and the overhead model."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attestation as jatt
from repro.core import bounce as jbounce
from repro.core import overheads as jover
from repro.core import sealing as js
from repro_torch.core import attestation as tatt
from repro_torch.core import bounce as tbounce
from repro_torch.core import overheads as tover
from repro_torch.core import sealing as ts


def _keys(seed=b"k"):
    return js.SealingKey.generate(seed), ts.SealingKey.generate(seed)


def to_torch_blob(st: js.SealedTensor) -> ts.SealedTensor:
    ct = torch.from_numpy(np.asarray(st.ciphertext).view(np.int32).copy())
    return ts.SealedTensor(st.name, ct, st.mac, tuple(st.shape), st.dtype,
                           st.n_bytes)


def to_jax_blob(st: ts.SealedTensor) -> js.SealedTensor:
    ct = jnp.asarray(st.ciphertext.numpy().view(np.uint32))
    return js.SealedTensor(st.name, ct, st.mac, st.shape, st.dtype, st.n_bytes)


def _array(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "bfloat16":
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                        jnp.bfloat16)
        t = torch.from_numpy(np.asarray(x).view(np.uint16).copy()
                             ).view(torch.bfloat16)
        return x, t
    arr = (rng.standard_normal(shape).astype(kind) if np.dtype(kind).kind == "f"
           else rng.integers(-1000, 1000, shape).astype(kind))
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


CASES = [("float32", (10, 100)), ("bfloat16", (64, 33)), ("int32", (7,)),
         ("float32", ()), ("int32", (3, 5, 7))]


@pytest.mark.parametrize("kind,shape", CASES)
def test_identical_ciphertext_and_mac(kind, shape):
    jk, tk = _keys()
    x, t = _array(kind, shape)
    jst = js.seal_tensor(jk, "params['w']", x)
    tst = ts.seal_tensor(tk, "params['w']", t)
    assert tst.header() == jst.header()
    assert tst.mac == jst.mac
    assert np.array_equal(tst.ciphertext.numpy().view(np.uint32),
                          np.asarray(jst.ciphertext))


@pytest.mark.parametrize("kind,shape", CASES)
def test_blobs_cross_both_ways(kind, shape):
    jk, tk = _keys(b"cross")
    x, t = _array(kind, shape, seed=3)
    # sealed by the reference, unsealed by the port
    back = ts.unseal_tensor(tk, to_torch_blob(js.seal_tensor(jk, "a", x)))
    assert back.dtype == t.dtype and tuple(back.shape) == tuple(shape)
    assert torch.equal(back, t)
    # sealed by the port, unsealed by the reference
    jback = js.unseal_tensor(jk, to_jax_blob(ts.seal_tensor(tk, "b", t)))
    assert jback.dtype == x.dtype and jback.shape == x.shape
    assert bool(jnp.all(jback == x))


def test_header_spells_tuple_shape_and_numpy_dtype():
    _, tk = _keys()
    st = ts.seal_tensor(tk, "t", torch.zeros((2, 3), dtype=torch.bfloat16))
    assert st.header() == b"t|(2, 3)|bfloat16|12"
    st = ts.seal_tensor(tk, "u", torch.zeros(5, dtype=torch.int32))
    assert st.header() == b"u|(5,)|int32|20"


def test_numpy_input_seals_like_a_tensor():
    _, tk = _keys()
    arr = np.arange(11, dtype=np.int32)
    a = ts.seal_tensor(tk, "n", arr)
    b = ts.seal_tensor(tk, "n", torch.from_numpy(arr))
    assert a.mac == b.mac and torch.equal(a.ciphertext, b.ciphertext)


def test_tamper_raises_integrity_error():
    _, tk = _keys()
    st = ts.seal_tensor(tk, "w", torch.arange(100, dtype=torch.float32))
    st.ciphertext[5, 17] ^= 1
    with pytest.raises(ts.IntegrityError):
        ts.unseal_tensor(tk, st)
    st = ts.seal_tensor(tk, "w", torch.arange(100, dtype=torch.float32))
    st.shape = (50,)
    with pytest.raises(ts.IntegrityError):
        ts.unseal_tensor(tk, st)
    with pytest.raises(ts.IntegrityError):
        ts.unseal_tensor(ts.SealingKey.generate(b"other"),
                         ts.seal_tensor(tk, "w", torch.ones(8)))
    # a reference blob tampered in transit fails in the port too
    jk, _ = _keys()
    blob = to_torch_blob(js.seal_tensor(jk, "w", jnp.ones(8, jnp.float32)))
    blob.ciphertext[0, 0] ^= 4
    with pytest.raises(ts.IntegrityError):
        ts.unseal_tensor(tk, blob)


def test_helpers_agree():
    jk, tk = _keys(b"helpers")
    for label in ("tenant/a", "tenant/b"):
        assert dataclasses.astuple(tk.derive(label)) == \
            dataclasses.astuple(jk.derive(label))
        assert tk.derive(label).key_id() == jk.derive(label).key_id()
    assert np.array_equal(tk.key_words, np.asarray(jk.key_words))
    for name in ("params['w']", "kvslot/3/0['pos']"):
        assert np.array_equal(ts.nonce_words_for(tk, name),
                              js.nonce_words_for(jk, name))
    assert ts.shared_page_name(b"\x01\x02", "['k']") == \
        js.shared_page_name(b"\x01\x02", "['k']")
    x, t = _array("float32", (300,))
    assert ts.ciphertext_page_bytes(ts.seal_tensor(tk, "p", t)) == \
        js.ciphertext_page_bytes(js.seal_tensor(jk, "p", x))
    ts.verify_mac(tk, ts.seal_tensor(tk, "p", t))


def test_tree_names_and_digest_agree():
    """Names are prefix + keystr(path) over sorted keys, as in jax."""
    jk, tk = _keys(b"tree")
    rng = np.random.default_rng(1)
    tree = {"layers": {"slot_0": {"k": rng.standard_normal((2, 1, 4)),
                                  "v": rng.standard_normal((2, 1, 4))}},
            "pos": np.array([3], np.int32)}
    tree["layers"]["slot_0"]["k"] = tree["layers"]["slot_0"]["k"].astype(np.float32)
    tree["layers"]["slot_0"]["v"] = tree["layers"]["slot_0"]["v"].astype(np.float32)
    jtree = {"layers": {"slot_0": {k: jnp.asarray(v) for k, v in
                                   tree["layers"]["slot_0"].items()}},
             "pos": jnp.asarray(tree["pos"])}
    ttree = ts.tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    jsealed = js.seal_tree(jk, jtree, prefix="kvslot/3/0")
    tsealed = ts.seal_tree(tk, ttree, prefix="kvslot/3/0")
    assert sorted(tsealed) == sorted(jsealed)
    assert "kvslot/3/0['layers']['slot_0']['k']" in tsealed
    assert ts.tree_digest(tsealed) == js.tree_digest(jsealed)
    assert ts.sealed_nbytes(tsealed) == js.sealed_nbytes(jsealed)
    back = ts.unseal_tree(tk, {n: to_torch_blob(b) for n, b in jsealed.items()},
                          ttree, prefix="kvslot/3/0")
    for name, leaf in ts.tree_leaves_with_names(ttree):
        assert torch.equal(dict(ts.tree_leaves_with_names(back))[name], leaf)


def _frame_to(frame, blob_fn, cls):
    return cls(frame.stream_id, frame.seq, blob_fn(frame.sealed))


def test_bounce_frames_cross_both_ways():
    jk, tk = _keys(b"io")
    jb, tb = jbounce.BounceBuffer(jk), tbounce.BounceBuffer(tk, device="cpu")
    toks = np.array([5, 6, 7], np.int32)
    # port device -> reference host, and reference device -> port host
    for _ in range(2):   # two frames per stream: seq order carries across
        tf = tb.device_send_frame(0, toks)
        out = jb.host_recv_frame(_frame_to(tf, to_jax_blob, jbounce.TokenFrame))
        assert np.array_equal(out, toks)
        jf = jb.device_send_frame(1, toks + 1)
        out = tb.host_recv_frame(_frame_to(jf, to_torch_blob,
                                           tbounce.TokenFrame))
        assert np.array_equal(out, toks + 1)
    # ingress: sealed by one side's host, opened by the other's device
    sealed = tb.host_send(toks)
    assert np.array_equal(jb.device_recv(to_jax_blob(sealed)), toks)
    assert tb.stats.messages_in == 1 and tb.stats.tokens_out == 6
    # a replayed frame is rejected by the port like by the reference
    tf = tb.device_send_frame(2, toks)
    tb.host_recv_frame(tf)
    with pytest.raises(ts.IntegrityError):
        tb.host_recv_frame(tf)


def test_attestation_agrees():
    secret = b"s" * 32
    meas = "code", "cfg", "digest"
    assert tatt.measurement(*meas) == jatt.measurement(*meas)
    jroot = jatt.HardwareRoot("tdx", secret)
    troot = tatt.HardwareRoot("tdx", secret)
    m = tatt.measurement(*meas)
    jq, tq = jroot.quote(m, "n0"), troot.quote(m, "n0")
    assert tq.to_json() == jq.to_json()
    # a quote made by the reference verifies in the port's verifier
    v = tatt.Verifier(troot, m)
    nonce = v.challenge()
    v.verify(tatt.Quote.from_json(jroot.quote(m, nonce).to_json()))
    with pytest.raises(tatt.AttestationError):
        v.verify(tatt.Quote.from_json(jroot.quote(m, nonce).to_json()))
    assert tatt.derive_tenant_material(secret, "t") == \
        jatt.derive_tenant_material(secret, "t")
    # measure_code hashes the port's own sources
    assert tatt.measure_code() != jatt.measure_code()


@pytest.mark.parametrize("profile", sorted(jover.PROFILES))
def test_overhead_model_agrees(profile):
    kw = dict(compute_s=0.003, memory_s=0.007, collective_s=0.001)
    for extra in ({}, {"numa_bound": False, "hugepages_fixed": False,
                       "steps": 4, "collective_s": 0.002}):
        j = jover.predict(jover.RooflineTerms(**kw), profile, **extra)
        t = tover.predict(tover.RooflineTerms(**kw), profile, **extra)
        assert t.as_row() == j.as_row() and t.overhead == j.overhead
    assert tover.sweep_batch(profile, 1e-4, 1e-3, [1, 8]) == \
        jover.sweep_batch(profile, 1e-4, 1e-3, [1, 8])
