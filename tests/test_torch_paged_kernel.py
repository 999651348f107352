"""repro_torch's paged attention module (kernels B3 and B4) against the
reference's ``repro.kernels.paged_attention`` on the same numpy inputs. The
JAX functions run as the reference's own tests run them on the CPU (their
default ``interpret=True`` page-walk emulation); on CPU tensors the port's
wrappers run their plain versions. The CUDA kernels themselves are checked
on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: f32 outputs within 1e-5 (the two frameworks sum the q.k and p.v
products in different orders and use different exp implementations), bf16
outputs within 1e-2 (one bf16 ulp of an O(1) value is 2**-8). The keystream
and the XOR are integer functions and must agree bit for bit."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sealing as js
from repro.kernels import paged_attention as J
from repro_torch.kernels import paged_attention as P

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def make_pool(rng, *, slots=3, pages=4, ps=8, h=4, hk=2, hd=16):
    """Random pool + a table where every slot maps a distinct shuffled set
    of pages; valids: a full table, a mid-page end (2 pages + 3) and an
    idle row (valid 0, table mapped nowhere useful)."""
    n = slots * pages
    k_pool = rng.normal(size=(n + 1, ps, hk, hd)).astype(np.float32)
    v_pool = rng.normal(size=(n + 1, ps, hk, hd)).astype(np.float32)
    table = (rng.permutation(n) + 1).reshape(slots, pages).astype(np.int32)
    valid = np.array([pages * ps, 2 * ps + 3, 0], np.int32)[:slots]
    q = rng.normal(size=(slots, h, hd)).astype(np.float32)
    return q, k_pool, v_pool, table, valid


def both(a, dtype):
    """numpy f32 -> (jax array, torch tensor) of ``dtype``, same bits."""
    if dtype == "bfloat16":
        x = jnp.asarray(a).astype(jnp.bfloat16)
        return x, torch.from_numpy(np.asarray(x).view(np.uint16).copy()
                                   ).view(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("h,hk,dtype", [(4, 4, "float32"), (4, 2, "float32"),
                                        (8, 1, "float32"),
                                        (4, 2, "bfloat16")])
def test_plain_matches_reference(h, hk, dtype):
    rng = np.random.default_rng(h * 10 + hk)
    q, kp, vp, table, valid = make_pool(rng, h=h, hk=hk)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, kp, vp))
    ref = J.paged_attention(jq, jk, jv, jnp.asarray(table), jnp.asarray(valid))
    out = P.paged_attention(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(valid))
    assert out.dtype == tq.dtype and tuple(out.shape) == q.shape
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not out[2].any()                  # the idle row attends nothing


def seal_page(key_j, name, page):
    """Seal one [L, ps, hk, hd] page as the backend does: (ciphertext bits
    in the page's plaintext layout, nonce words)."""
    st = js.seal_tensor(key_j, name, page)
    bits = np.frombuffer(js.ciphertext_page_bytes(st),
                         page.dtype).reshape(page.shape)
    return bits, js.nonce_words_for(key_j, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unseal_plain_matches_reference(dtype):
    """A pool with live and dead pages: the port's plain B4 equals the
    reference's B4 within tolerance, and equals the port's own B3 on the
    plaintext pool bit for bit (the XOR is exact, the attention the same
    code)."""
    rng = np.random.default_rng(7)
    L, layer = 3, 1
    q, kp, vp, table, valid = make_pool(rng, slots=3, pages=2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kp, vp = (np.asarray(jnp.asarray(a).astype(jdt)) for a in (kp, vp))
    page_bytes = kp[0].nbytes
    bpp = page_bytes // 64
    key = js.SealingKey.generate(b"fused")
    crypt = {n: np.zeros((kp.shape[0], 4), np.uint32) for n in "kv"}
    cipher = {"k": kp.copy(), "v": vp.copy()}
    # slot 0's first page and slot 1's second page ciphertext-resident
    for phys in (int(table[0, 0]), int(table[1, 1])):
        for n, pool in (("k", kp), ("v", vp)):
            stacked = np.stack([pool[phys]] * L)
            bits, nonce = seal_page(key, f"t['{n}']/p{phys}", stacked)
            cipher[n][phys] = bits[layer]
            crypt[n][phys, :3], crypt[n][phys, 3] = nonce, 1

    def t(a):
        if a.dtype == np.uint32:
            return torch.from_numpy(a.view(np.int32).copy())
        if dtype == "bfloat16" and a.dtype != np.int32:
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    qj = jnp.asarray(q).astype(jdt)
    qt = t(np.asarray(qj)) if dtype == "bfloat16" else t(q)
    ref = J.paged_attention_unseal(
        qj, jnp.asarray(cipher["k"]), jnp.asarray(cipher["v"]),
        jnp.asarray(table), jnp.asarray(valid), jnp.int32(layer),
        key.key_words, jnp.asarray(crypt["k"]), jnp.asarray(crypt["v"]),
        blocks_per_page=bpp)
    out = P.paged_attention_unseal(
        qt, t(cipher["k"]), t(cipher["v"]), t(table), t(valid), layer,
        np.frombuffer(key.key, np.uint32), t(crypt["k"]), t(crypt["v"]),
        blocks_per_page=bpp)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])
    plain = P.paged_attention(qt, t(kp), t(vp), t(table), t(valid))
    assert torch.equal(out, plain)


@pytest.mark.parametrize("layer", [0, 3])
def test_page_keystream_bit_equal(layer):
    rng = np.random.default_rng(layer)
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    ref = J._page_keystream(jnp.asarray(kw), tuple(jnp.uint32(x) for x in nonce),
                            jnp.int32(layer), 16)
    out = P._page_keystream(kw, [int(x) for x in nonce], layer, 16)
    assert np.array_equal(out.numpy().astype(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("live", [0, 1])
def test_unseal_tile_bit_equal(dtype, live):
    rng = np.random.default_rng(live)
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    row = np.concatenate([rng.integers(0, 2**32, 3, dtype=np.uint32),
                          np.array([live], np.uint32)])
    jt, tt = both(rng.normal(size=(8, 2, 16)).astype(np.float32), dtype)
    bpp = tt.numel() * tt.element_size() // 64
    ref = J._unseal_tile(jt, jnp.asarray(row), jnp.asarray(kw),
                         jnp.int32(2), bpp)
    out = P._unseal_tile(tt, torch.from_numpy(row.view(np.int32)), kw, 2, bpp)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    ibits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert np.array_equal(out.view(ibits).numpy().view(bits),
                          np.asarray(ref).view(bits))
    assert torch.equal(out, tt) == (not live)    # a dead flag passes through


def test_layer_counter_offset():
    """Layer l decrypts with counter_base = l * blocks_per_page: layer l's
    ciphertext, attended as layer l, equals its plaintext attended by B3."""
    rng = np.random.default_rng(11)
    q, kp, vp, table, valid = make_pool(rng, slots=1, pages=1)
    L, phys = 3, int(table[0, 0])
    bpp = kp[0].nbytes // 64
    key = js.SealingKey.generate(b"layers")
    stacked = rng.normal(size=(L,) + kp.shape[1:]).astype(np.float32)
    bits, nonce = seal_page(key, "t['k']/p0", stacked)
    crypt = np.zeros((kp.shape[0], 4), np.uint32)
    crypt[phys, :3], crypt[phys, 3] = nonce, 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ci = lambda a: t(a.view(np.int32))
    for layer in range(L):
        kc, kpl = kp.copy(), kp.copy()
        kc[phys], kpl[phys] = bits[layer], stacked[layer]
        out = P.paged_attention_unseal(
            t(q), t(kc), t(vp), t(table), t(valid), layer,
            np.frombuffer(key.key, np.uint32), ci(crypt),
            ci(np.zeros_like(crypt)), blocks_per_page=bpp)
        assert torch.equal(out, P.paged_attention(t(q), t(kpl), t(vp),
                                                  t(table), t(valid)))


def test_eligibility_predicate():
    assert P.supports_fused_unseal(torch.float32, 8192)
    assert P.supports_fused_unseal(torch.bfloat16, 4096)
    assert not P.supports_fused_unseal(torch.float32, 8192 + 32)
    assert not P.supports_fused_unseal(torch.int8, 8192)


def _args(**over):
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(5, 8, 2, 16)
    args = dict(q=q, k_pool=pool, v_pool=pool.clone(),
                table=torch.zeros(2, 3, dtype=torch.int32),
                valid=torch.ones(2, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("over,err", [
    (dict(q=torch.zeros(2, 4, 16, dtype=torch.float64)), TypeError),
    (dict(table=torch.zeros(2, 3, dtype=torch.int64)), TypeError),
    (dict(q=torch.zeros(2, 3, 16)), ValueError),            # h % hk
    (dict(valid=torch.ones(3, dtype=torch.int32)), ValueError),
    (dict(q=torch.zeros(4, 2, 16).transpose(0, 1)), ValueError),
])
def test_wrapper_rejects_bad_inputs(over, err):
    with pytest.raises(err):
        P.paged_attention(**_args(**over))


def test_unseal_wrapper_checks_page_blocks_and_sidecars():
    crypt = torch.zeros(5, 4, dtype=torch.int32)
    bpp = 8 * 2 * 16 * 4 // 64
    with pytest.raises(ValueError, match="ChaCha20 blocks"):
        P.paged_attention_unseal(**_args(), layer=0, key_words=np.zeros(8),
                                 k_crypt=crypt, v_crypt=crypt,
                                 blocks_per_page=bpp + 1)
    with pytest.raises(ValueError, match="sidecars"):
        P.paged_attention_unseal(**_args(), layer=0, key_words=np.zeros(8),
                                 k_crypt=crypt[:4], v_crypt=crypt,
                                 blocks_per_page=bpp)


def test_plain_version_never_counts_launches():
    before = dict(P.launches)
    P.paged_attention(**_args())
    crypt = torch.zeros(5, 4, dtype=torch.int32)
    P.paged_attention_unseal(**_args(), layer=1, key_words=np.zeros(8),
                             k_crypt=crypt, v_crypt=crypt,
                             blocks_per_page=8 * 2 * 16 * 4 // 64)
    assert P.launches == before


# -- the kernel's split-and-combine walk (csrc/paged_attention.cu) ----------

def test_split_geometry_reads_only_table_width_and_page_size():
    """The split depends on the page size and the table width, never on the
    batch or a slot's valid length, so a slot's bits do not depend on its
    batch."""
    assert list(inspect.signature(P.split_geometry).parameters) == [
        "max_pages", "page_size"]
    lo, hi = P.SPLIT_POSITIONS
    for ps in (1, 8, 16, 48, lo, hi, 2 * hi):
        for width in (1, 5, 16, 128, 1000):
            per, n = P.split_geometry(width, ps)
            assert per >= 1 and n == -(-width // per)
            assert (n - 1) * per < width <= n * per
            # at least lo positions (one page if a page is longer), at most
            # hi (unless lo needs more), and about SPLITS splits between
            assert per * ps >= lo or per == 1
            assert per * ps <= hi or per == max(1, -(-lo // ps))
            assert per == -(-width // P.SPLITS) or per * ps < lo + ps \
                or per * ps > hi - ps


WIDTH = 24   # table columns of the split cases (page size 8)


def split_case(rng, valid_of, *, h=4, hk=2, slots=2):
    """A pool and a table WIDTH pages wide (page size 8, several splits),
    valid lengths given in units of one split's positions S."""
    ps = 8
    per, n_splits = P.split_geometry(WIDTH, ps)
    assert n_splits >= 3
    q, kp, vp, table, _ = make_pool(rng, slots=slots, pages=WIDTH, ps=ps,
                                    h=h, hk=hk)
    valid = np.array(valid_of(per * ps), np.int32)
    return q, kp, vp, table, valid


SPLIT_CASES = {   # valid per slot, from one split's positions S
    "valid 0": lambda S: [0, S + 5],
    "valid on a split boundary": lambda S: [S, 2 * S],
    "a split wholly past valid": lambda S: [5, 2 * S + 3],
}


@pytest.mark.parametrize("case,h,hk", [(c, 4, 4) for c in SPLIT_CASES]
                         + [("gqa f32", 8, 2)])
def test_split_walk_matches_reference(case, h, hk):
    rng = np.random.default_rng(len(case))
    valid_of = SPLIT_CASES.get(case, lambda S: [2 * S + 7, S - 1])
    q, kp, vp, table, valid = split_case(rng, valid_of, h=h, hk=hk)
    ref = J.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp, table,
                                                        valid)))
    out = P._split_walk(*(torch.from_numpy(a) for a in (table, valid, q, kp,
                                                         vp)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL["float32"], atol=TOL["float32"])
    for i in np.flatnonzero(valid == 0):
        assert not out[i].any()                 # an idle slot gives 0


def test_split_walk_slot_bits_alone_and_in_batch():
    """Slot 1's row is bit-equal alone (b = 1) and inside a batch of 4 with
    other slots' valid lengths on either side of its own."""
    rng = np.random.default_rng(3)
    q, kp, vp, table, valid = split_case(
        rng, lambda S: [3 * S, 2 * S - 3, 0, S + 1], slots=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    batch = P._split_walk(t(table), t(valid), t(q), t(kp), t(vp))
    alone = P._split_walk(t(table[1:2]), t(valid[1:2]), t(q[1:2]), t(kp),
                          t(vp))
    assert torch.equal(batch[1:2], alone)


# -- B4's keystream stage (csrc/paged_attention.cu) --------------------------

@pytest.mark.parametrize("dtype,ps,hk,hd,live", [
    ("bfloat16", 16, 32, 128, 1),   # Llama2-7B: 256-byte rows, aligned
    ("float32", 8, 2, 20, 1),       # GQA f32: 80-byte rows straddle blocks
    ("float32", 8, 2, 20, 0),       # a dead page
])
def test_keystream_stage_matches_reference(dtype, ps, hk, hd, live):
    """The kernel's keystream work split and index map (every block that
    touches a kv head's rows, once, and the ring word each lane XORs) give
    every head's rows the reference's unsealed bits; a dead page computes
    no block. The ring holds exactly the blocks the head needs: 64 per
    page at Llama2-7B's aligned rows, and each straddled block once."""
    rng = np.random.default_rng(ps * hd + live)
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    row = np.concatenate([rng.integers(0, 2**32, 3, dtype=np.uint32),
                          np.array([live], np.uint32)])
    jt, tt = both(rng.normal(size=(ps, hk, hd)).astype(np.float32), dtype)
    bpp = tt.numel() * tt.element_size() // 64
    ref = np.asarray(J._unseal_tile(jt, jnp.asarray(row), jnp.asarray(kw),
                                    jnp.int32(5), bpp))
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    ibits = torch.int16 if dtype == "bfloat16" else torch.int32
    row_words = hd * tt.element_size() // 4
    for kh in range(hk):
        out = P._unseal_head_rows(tt, torch.from_numpy(row.view(np.int32)),
                                  kw, 5, bpp, kh)
        assert np.array_equal(out.view(ibits).numpy().view(bits),
                              np.ascontiguousarray(ref[:, kh]).view(bits))
        blocks, row_slot = P.keystream_slots(kh, hk, ps, row_words)
        touched = sorted({w // 16 for t in range(ps)
                          for w in range((t * hk + kh) * row_words,
                                         (t * hk + kh + 1) * row_words)})
        assert blocks == touched and len(row_slot) == ps
    want = {(32, 64): 64, (2, 20): 16}[(hk, row_words)]
    assert P.keystream_blocks(hk, ps, row_words) == want


@pytest.mark.parametrize("walk", ["plain", "split"])
def test_rows_past_valid_are_never_read(walk):
    """A page's rows past ``valid`` may hold anything: a freed
    ciphertext-resident page keeps its ciphertext bits (NaN and Inf as
    floats) when it is taken again as an append page. The kernel never
    reads such rows, and neither do the plain walks: their output equals
    the reference's on the same pool with those rows zeroed (the reference
    multiplies them by a zero probability, so NaN rows poison its output;
    ROADMAP.md queue C)."""
    rng = np.random.default_rng(9)
    q, kp, vp, table, valid = make_pool(rng)
    stale_k, stale_v = kp.copy(), vp.copy()
    for slot, n in enumerate(valid):
        for pos in range(n, table.shape[1] * kp.shape[1]):
            page = table[slot, pos // kp.shape[1]]
            stale_k[page, pos % kp.shape[1]] = np.nan
            stale_v[page, pos % kp.shape[1]] = np.inf
    ref = J.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp, table,
                                                        valid)))
    args = [torch.from_numpy(a) for a in (q, stale_k, stale_v, table, valid)]
    out = (P.paged_attention(*args) if walk == "plain"
           else P._split_walk(args[3], args[4], *args[:3]))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL["float32"], atol=TOL["float32"])
