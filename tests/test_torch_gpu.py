"""Card-only tests of repro_torch (``gpu`` marker; they skip without a CUDA
card). This file imports no JAX, so it also runs on a machine that has the
card but not the reference package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import SealingKey, TrustDomain
from repro_torch.core.sealing import nonce_words_for, seal_tensor, tree_map
from repro_torch.kernels import chacha20 as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as P
from repro_torch.kernels import qmatmul as Q
from repro_torch.models import build_model
from repro_torch.quant import quantize_int8
from repro_torch.runtime import Engine, GenerationRequest

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels build and run only on one")
    return torch.device("cuda")


def test_cuda_kernel_matches_plain_on_card(card):
    rng = np.random.default_rng(11)
    before = C.launches
    for n, cb in [(1024, 0), (5 * 1024, 7), (2 * 1024, 2**32 - 2)]:
        data = torch.from_numpy(rng.integers(0, 2**32, (16, n), dtype=np.uint32)
                                .view(np.int32)).to(card)
        kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
        nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
        out = C.chacha20_xor_blocked(kw, nw, data, counter_base=cb)
        torch.cuda.synchronize()
        assert torch.equal(out, C.chacha20_xor_plain(kw, nw, data, cb))
        # in place through ``out`` is the involution's inverse
        C.chacha20_xor_blocked(kw, nw, out, counter_base=cb, out=out)
        torch.cuda.synchronize()
        assert torch.equal(out, data)
    assert C.launches == before + 6


def _paged_case(card, dtype, *, b, h, hk, hd, ps, pages, valid, layer=3):
    """A shuffled page table over a random pool on the card, with every
    other mapped page ciphertext-resident (sealed as the backend seals an
    [L, ps, hk, hd] page; this layer's slice placed in the pool). Returns
    (q, plaintext pools, ciphertext pools, table, valid, crypts, key, bpp)."""
    g = torch.Generator(device="cpu").manual_seed(b * 100 + h)
    n = b * pages
    kp, vp = (torch.randn(n + 1, ps, hk, hd, generator=g).to(dtype).to(card)
              for _ in range(2))
    q = torch.randn(b, h, hd, generator=g).to(dtype).to(card)
    table = (torch.randperm(n, generator=g) + 1).reshape(b, pages)
    table = table.to(torch.int32).to(card)
    key = SealingKey.generate(b"gpu-paged")
    crypts, cipher = [], []
    for leaf, pool in (("k", kp), ("v", vp)):
        crypt = torch.zeros(n + 1, 4, dtype=torch.int32)
        cp = pool.clone()
        for phys in table.flatten().tolist()[::2]:
            stacked = torch.zeros((layer + 1,) + pool.shape[1:], dtype=dtype,
                                  device=card)
            stacked[layer] = pool[phys]
            name = f"t['{leaf}']/p{phys}"
            st = seal_tensor(key, name, stacked)
            bits = ops.unpack_u32(st.ciphertext, st.n_bytes).view(dtype)
            cp[phys] = bits.reshape(stacked.shape)[layer]
            crypt[phys, :3] = torch.from_numpy(
                nonce_words_for(key, name).view(np.int32).copy())
            crypt[phys, 3] = 1
        crypts.append(crypt.to(card))
        cipher.append(cp)
    bpp = ps * hk * hd * kp.element_size() // 64
    return (q, (kp, vp), tuple(cipher), table,
            torch.tensor(valid, dtype=torch.int32, device=card),
            tuple(crypts), np.frombuffer(key.key, np.uint32), bpp, layer)


CASES = [  # (dtype, geometry, tolerance)
    (torch.bfloat16, dict(b=4, h=32, hk=32, hd=128, ps=16, pages=4,
                          valid=[64, 37, 0, 17]), 1e-2),
    (torch.float32, dict(b=3, h=8, hk=2, hd=64, ps=8, pages=6,
                         valid=[48, 13, 0]), 1e-4),
    # rows that are not whole 16-byte vectors: 72 B (8-byte copies) and
    # 20 B (4-byte copies)
    (torch.float32, dict(b=3, h=4, hk=2, hd=18, ps=8, pages=5,
                         valid=[40, 13, 0]), 1e-4),
    (torch.bfloat16, dict(b=3, h=4, hk=2, hd=10, ps=16, pages=4,
                          valid=[64, 21, 0]), 1e-2),
    # serving tables: the RAG engine's 9 pages (5 splits of 2, the last
    # holding 1) and the two-phase engine's 12 pages at Llama2-7B width
    (torch.bfloat16, dict(b=3, h=32, hk=32, hd=128, ps=16, pages=9,
                          valid=[144, 129, 0]), 1e-2),
    (torch.bfloat16, dict(b=4, h=32, hk=32, hd=128, ps=16, pages=12,
                          valid=[192, 130, 0, 17]), 1e-2),
]


@pytest.mark.parametrize("dtype,geo,tol", CASES)
def test_paged_kernels_match_plain_on_card(card, dtype, geo, tol):
    """B3 and B4 against their plain versions (valid on and off page
    boundaries, an idle row, live and dead pages), and B4 on ciphertext
    equal to B3 on the plaintext pool bit for bit."""
    q, plain, cipher, table, valid, crypts, key, bpp, layer = \
        _paged_case(card, dtype, **geo)
    before = dict(P.launches)
    b3 = P.paged_attention(q, *plain, table, valid)
    b4 = P.paged_attention_unseal(q, *cipher, table, valid, layer, key,
                                  *crypts, blocks_per_page=bpp)
    torch.cuda.synchronize()
    assert P.launches["paged_attention"] == before["paged_attention"] + 1
    assert (P.launches["paged_attention_unseal"]
            == before["paged_attention_unseal"] + 1)
    torch.testing.assert_close(
        b3, P.paged_attention_plain(q, *plain, table, valid),
        rtol=tol, atol=tol)
    torch.testing.assert_close(
        b4, P.paged_attention_unseal_plain(q, *cipher, table, valid, layer,
                                           key, *crypts,
                                           blocks_per_page=bpp),
        rtol=tol, atol=tol)
    assert torch.equal(b4, b3)
    assert not b3[2].any()                       # the idle row


def _split_geometry(dtype, ps, width=24):
    """The shapes of the split tests: h, hk, hd by dtype, a table ``width``
    pages wide (several splits), and one split's positions S."""
    per, n_splits = P.split_geometry(width, ps)
    assert n_splits >= 3
    geo = (dict(h=32, hk=32, hd=128) if dtype == torch.bfloat16
           else dict(h=8, hk=2, hd=64))
    return dict(geo, ps=ps, pages=width), per * ps


@pytest.mark.parametrize("dtype,ps,tol", [(torch.bfloat16, 16, 1e-2),
                                          (torch.float32, 8, 1e-4)])
def test_paged_kernels_split_walk_on_card(card, dtype, ps, tol):
    """B3 and B4 over a table three splits wide, valid mid-split (in the
    last split, in the first) and an idle row, against the plain versions;
    B4 on ciphertext bit-equal to B3 on plaintext."""
    geo, S = _split_geometry(dtype, ps)
    q, plain, cipher, table, valid, crypts, key, bpp, layer = _paged_case(
        card, dtype, b=3, valid=[2 * S + S // 2 + 3, S // 2 + 1, 0], **geo)
    b3 = P.paged_attention(q, *plain, table, valid)
    b4 = P.paged_attention_unseal(q, *cipher, table, valid, layer, key,
                                  *crypts, blocks_per_page=bpp)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        b3, P.paged_attention_plain(q, *plain, table, valid),
        rtol=tol, atol=tol)
    torch.testing.assert_close(
        b4, P.paged_attention_unseal_plain(q, *cipher, table, valid, layer,
                                           key, *crypts,
                                           blocks_per_page=bpp),
        rtol=tol, atol=tol)
    assert torch.equal(b4, b3)
    assert not b3[2].any()


@pytest.mark.parametrize("dtype,ps", [(torch.bfloat16, 16),
                                      (torch.float32, 8)])
def test_paged_kernels_slot_bits_alone_and_in_batch(card, dtype, ps):
    """Each slot's B3 and B4 output is bit-equal alone (b = 1) and inside a
    batch of 4 whose valid lengths differ: the split never depends on the
    batch."""
    geo, S = _split_geometry(dtype, ps)
    q, plain, cipher, table, valid, crypts, key, bpp, layer = _paged_case(
        card, dtype, b=4, valid=[3 * S, 2 * S - 3, 0, S + 1], **geo)
    unseal = dict(layer=layer, key_words=key, k_crypt=crypts[0],
                  v_crypt=crypts[1], blocks_per_page=bpp)
    b3 = P.paged_attention(q, *plain, table, valid)
    b4 = P.paged_attention_unseal(q, *cipher, table, valid, **unseal)
    for i in range(4):
        one = [t[i:i + 1].contiguous() for t in (q, table, valid)]
        assert torch.equal(P.paged_attention(one[0], *plain, *one[1:]),
                           b3[i:i + 1])
        assert torch.equal(P.paged_attention_unseal(one[0], *cipher, *one[1:],
                                                    **unseal), b4[i:i + 1])


def test_paged_unseal_128_pages_straddling_rows_alone_and_in_batch(card):
    """B4 on a 128-page table whose rows straddle ChaCha20 blocks (f32, hd
    20: 80-byte rows, 20 blocks a page), every other page live: within
    tolerance of its plain version, bit-equal to B3 on the plaintext, and
    every slot's bits equal alone and in the batch of 16 (valid lengths
    staggered across the slots)."""
    valid = [128 * 8 - 61 * i for i in range(16)]
    q, plain, cipher, table, valid, crypts, key, bpp, layer = _paged_case(
        card, torch.float32, b=16, h=4, hk=2, hd=20, ps=8, pages=128,
        valid=valid)
    unseal = dict(layer=layer, key_words=key, k_crypt=crypts[0],
                  v_crypt=crypts[1], blocks_per_page=bpp)
    b3 = P.paged_attention(q, *plain, table, valid)
    b4 = P.paged_attention_unseal(q, *cipher, table, valid, **unseal)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        b4, P.paged_attention_unseal_plain(q, *cipher, table, valid,
                                           **unseal), rtol=1e-4, atol=1e-4)
    assert torch.equal(b4, b3)
    for i in range(16):
        one = [t[i:i + 1].contiguous() for t in (q, table, valid)]
        assert torch.equal(P.paged_attention_unseal(one[0], *cipher, *one[1:],
                                                    **unseal), b4[i:i + 1])


def _serve(device, params, model, **kv):
    td = TrustDomain("tdx", device=device)
    eng = Engine(model, params, trust_domain=td,
                 **(kv or dict(kv_backend="slot")),
                 max_slots=2, max_len=64, prefill_buckets=(4, 8),
                 device=device)
    prompts = [np.arange(1, 5), np.arange(1, 9), np.full(8, 7), np.arange(1, 13)]
    waves = [[(p, 6, 0) for p in prompts[:3]], [(prompts[3], 4, 5)]]
    reqs = [eng.submit(GenerationRequest(prompt=p.astype(np.int32),
                                         max_new_tokens=n, priority=pr))
            for p, n, pr in waves[0]]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(GenerationRequest(prompt=p.astype(np.int32),
                                          max_new_tokens=n, priority=pr))
             for p, n, pr in waves[1]]
    stats = eng.run(max_steps=10_000)
    assert stats.preemptions > 0
    if kv:
        assert eng.kv.fused_restore_pages > 0
    return [list(r.output) for r in reqs]


def test_engine_on_card_matches_cpu(card):
    """The f32 smoke model serves a preempting scenario on the card with
    the CPU run's tokens, every seal and frame through the CUDA kernel."""
    cfg = smoke_config("deepseek-7b")
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init_params(seed=3)
    expect = _serve("cpu", params, cpu_model)
    before = C.launches, FA.launches
    got = _serve(card, tree_map(lambda t: t.to(card), params),
                 build_model(cfg, device=card))
    assert got == expect
    assert C.launches > before[0]
    assert FA.launches > before[1]     # the prefills' attention through B2


def test_paged_kernel_engine_on_card_matches_cpu(card):
    """The f32 smoke model's paged-kernel engine serves the preempting
    scenario on the card with the CPU run's tokens, through B3 and B4."""
    cfg = smoke_config("deepseek-7b")
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init_params(seed=3)
    kv = dict(kv_backend="paged", page_size=8, kv_decode="kernel")
    expect = _serve("cpu", params, cpu_model, **kv)
    P.reset_launches()
    got = _serve(card, tree_map(lambda t: t.to(card), params),
                 build_model(cfg, device=card), **kv)
    assert got == expect
    assert P.launches["paged_attention"] > 0
    assert P.launches["paged_attention_unseal"] > 0


@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (1, 4096, 256),
                                   (100, 208, 132)])
def test_qmatmul_kernel_bit_equal_on_card(card, m, k, n):
    """B5 against its plain version (float64, exact) bit for bit, bf16 and
    f32 out, with ragged M and N edges and an all-zero weight column."""
    g = torch.Generator(device="cpu").manual_seed(m + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    w[:, 2] = 0
    scale = torch.rand((1, n), generator=g) * 1e-2 + 1e-4
    x, w, scale = x.to(card), w.to(card), scale.to(card)
    before = Q.launches
    for out_dtype in (torch.bfloat16, torch.float32):
        got = Q.qmatmul(x, w, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        assert torch.equal(got, Q.qmatmul_plain(x, w, scale,
                                                out_dtype=out_dtype))
        assert not got[:, 2].any()
    assert Q.launches == before + 2


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 4112, 4096), (17, 4112, 11008),
                                   (130, 4112, 4096), (2048, 4112, 11008),
                                   (1, 11008, 4096)])
def test_qmatmul_regimes_bit_equal_on_card(card, m, k, n, out_dtype):
    """B5 bit for bit at the plan's edges: M = 1 and 17 (small-M regime,
    K split over a cluster), 130 and 2048 (large-M regime), N = 4096 and
    11008, and K = 4112, whose last 64-step is ragged."""
    plan = Q.qmm_plan(m, n, k, torch.cuda.get_device_properties(
        card).multi_processor_count)
    assert plan.regime == ("small" if m <= Q.SMALL_M else "large")
    g = torch.Generator(device=card).manual_seed(m + n + k)
    x = torch.randint(-127, 128, (m, k), generator=g, device=card,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=card,
                      dtype=torch.int8)
    scale = torch.rand((1, n), generator=g, device=card) * 1e-3 + 1e-5
    got = Q.qmatmul(x, w, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, Q.qmatmul_plain(x, w, scale, out_dtype=out_dtype))


def test_qmm_on_card_equals_cpu(card):
    """ops.qmm through the kernel on the card gives the CPU's bits."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((7, 130), generator=g).to(torch.bfloat16)
    w = quantize_int8(torch.randn((130, 129), generator=g))
    before = Q.launches
    got = ops.qmm(x.to(card), type(w)(*(t.to(card) for t in w)))
    assert Q.launches == before + 1
    assert torch.equal(got.cpu(), ops.qmm(x, w))


FLASH_CASES = [  # (dtype, bh, bhk, s, d, (bq, bkv), tolerance)
    (torch.float32, 4, 4, 256, 64, (128, 128), 1e-5),
    (torch.bfloat16, 4, 4, 256, 128, (64, 128), 1e-2),
    (torch.float32, 8, 2, 128, 64, (128, 128), 1e-5),    # GQA
    (torch.bfloat16, 2, 1, 200, 32, (40, 40), 1e-2),     # ragged s, GQA
    (torch.bfloat16, 2, 2, 512, 128, (128, 128), 1e-2),  # 8 q blocks
    (torch.float32, 4, 2, 128, 16, (64, 64), 1e-5),     # the smoke head dim
    (torch.bfloat16, 4, 2, 256, 16, (128, 128), 1e-2),
    (torch.bfloat16, 16, 2, 256, 128, (128, 128), 1e-2),  # group 8
    (torch.bfloat16, 32, 4, 32, 128, (32, 32), 1e-2),    # s < one tile
    (torch.bfloat16, 12, 12, 4, 64, (4, 4), 1e-2),       # whisper's prompt
]


@pytest.mark.parametrize("dtype,bh,bhk,s,d,blocks,tol", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(card, dtype, bh, bhk, s, d,
                                            blocks, tol):
    """B2 against its plain version: f32 and bf16, GQA, and an s that is
    not a multiple of the kernel's 64-row tiles."""
    g = torch.Generator(device="cpu").manual_seed(s + d)
    q = torch.randn((bh, s, d), generator=g).to(dtype).to(card)
    k, v = (torch.randn((bhk, s, d), generator=g).to(dtype).to(card)
            for _ in range(2))
    bq, bkv = blocks
    before = FA.launches
    got = FA.flash_attention(q, k, v, bq=bq, bkv=bkv)
    torch.cuda.synchronize()
    assert FA.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(
        got, FA.flash_attention_plain(q, k, v, bq=bq, bkv=bkv),
        rtol=tol, atol=tol)


def test_mha_flash_on_card_matches_cpu(card):
    """ops.mha_flash with GQA and a ragged s on the card against the same
    call on the CPU (the plain version), in f32."""
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn((2, 77, 8, 64), generator=g)
    k, v = (torch.randn((2, 77, 2, 64), generator=g) for _ in range(2))
    before = FA.launches
    got = ops.mha_flash(q.to(card), k.to(card), v.to(card))
    assert FA.launches == before + 1
    torch.testing.assert_close(got.cpu(), ops.mha_flash(q, k, v),
                               rtol=1e-5, atol=1e-5)


def test_kernels_raise_on_what_they_do_not_take(card):
    """A CUDA tensor of a dtype or shape the kernel does not take raises
    and launches nothing; there is no fallback."""
    x = torch.zeros((4, 32), dtype=torch.int8, device=card)
    w = torch.zeros((32, 8), dtype=torch.int8, device=card)
    scale = torch.ones((1, 8), device=card)
    q = torch.zeros((2, 64, 64), device=card)
    before = (Q.launches, FA.launches)
    with pytest.raises(TypeError):
        Q.qmatmul(x.to(torch.int16), w, scale)
    with pytest.raises(TypeError):
        Q.qmatmul(x, w, scale.half())
    with pytest.raises(ValueError):       # K not a multiple of 16
        Q.qmatmul(x[:, :24], w[:24], scale)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):       # no kernel for head_dim 48
        FA.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                           q[..., :48].contiguous(), bq=64, bkv=64)
    assert (Q.launches, FA.launches) == before


def test_sampler_on_card_matches_cpu(card):
    """The threefry PRNG on the card: keys, raw bits and uniforms bit-equal
    to the CPU's, the Gumbel noise (float64 on both, rounded) within 3 ulp
    of max(|g|, 1), and ``sample``'s tokens
    equal away from near ties (where they differ, the two candidates'
    perturbed logits on the card lie within twice that bound)."""
    from repro_torch.runtime import sampling as S
    b, v = 16, 32000
    rng = np.random.default_rng(4)
    keys = torch.as_tensor(np.stack([S.prng_key(100 + i) for i in range(b)])
                           .astype(np.int64))
    steps = torch.as_tensor(rng.integers(0, 2**31, b))
    fk = S.fold_in(keys, steps)
    assert torch.equal(S.fold_in(keys.to(card), steps.to(card)).cpu(), fk)
    assert torch.equal(S.random_bits(fk.to(card), (v,)).cpu(),
                       S.random_bits(fk, (v,)))
    tiny = float(np.finfo(np.float32).tiny)
    assert torch.equal(S.uniform(fk.to(card), (v,), minval=tiny).cpu(),
                       S.uniform(fk, (v,), minval=tiny))
    g_cpu = S.gumbel(fk, (v,)).double()
    err = (S.gumbel(fk.to(card), (v,)).cpu().double() - g_cpu).abs()
    ulp = torch.as_tensor(np.spacing(np.maximum(g_cpu.abs().numpy(), 1.0)
                                     .astype(np.float32)))
    assert (err <= 3 * ulp).all()
    logits = torch.as_tensor(rng.standard_normal((b, v)).astype(np.float32)
                             * 3)
    state = S.SamplingState(torch.full((b,), 0.9), torch.full((b,), 16),
                            keys, steps,
                            top_p=torch.full((b,), 0.95))
    on_card = S.SamplingState(*(t.to(card) if t is not None else None
                                for t in state))
    got = S.sample(logits.to(card), on_card, kmax=16).cpu()
    want = S.sample(logits, state, kmax=16)
    for row in torch.nonzero(got != want).flatten().tolist():
        z = (S.shaped_logits(logits.to(card), on_card, 16)[row]
             + S.gumbel(S.fold_in(on_card.key, on_card.step)[row], (v,)))
        z = z.cpu().double()
        gap = abs(float(z[got[row]] - z[want[row]]))
        assert gap <= 6 * float(np.spacing(np.float32(max(
            abs(float(z[want[row]])), 1.0))))


def test_paged_sharing_engine_on_card(card):
    """The canonical scenario (sampled, prefix sharing, kernel decode) on
    the card: every request equal to its solo run, the pool invariants
    after every step, and pages shared and copied on write."""
    from conftest import canonical_requests, check_pool_invariants
    from repro_torch.runtime import SamplingParams
    cfg = smoke_config("deepseek-7b")
    model = build_model(cfg, device=card)
    params = tree_map(lambda t: t.to(card),
                      build_model(cfg, device="cpu").init_params(seed=3))
    kw = dict(kv_backend="paged", page_size=8, kv_decode="kernel",
              prefix_sharing=True, max_slots=2, max_len=64,
              prefill_buckets=(4, 8), device=card)

    def gen(spec):
        prompt, mnt, prio, seed = spec
        return GenerationRequest(
            prompt=np.asarray(prompt, np.int32), max_new_tokens=mnt,
            priority=prio,
            params=SamplingParams(temperature=0.9, top_k=16, seed=seed))
    low, high = canonical_requests()
    eng = Engine(model, params, trust_domain=TrustDomain("tdx", device=card),
                 **kw)
    P.reset_launches()
    reqs = [eng.submit(gen(s)) for s in low]
    for _ in range(3):
        eng.step()
        check_pool_invariants(eng.kv)
    reqs += [eng.submit(gen(s)) for s in high]
    while not eng.idle:
        eng.step()
        check_pool_invariants(eng.kv)
    assert eng.scheduler.stats().preemptions > 0
    assert eng.kv.shared_page_maps > 0 and eng.kv.cow_copies > 0
    assert P.launches["paged_attention"] > 0
    for spec, req in zip(low + high, reqs):
        solo = Engine(model, params,
                      trust_domain=TrustDomain("tdx", device=card), **kw)
        assert req.output == solo.generate(gen(spec)).tokens


def _serve_mesh(card, model, params, mesh, **kv):
    """_serve's waves, sampled, on the card; returns (tokens, engine, the
    sealed names of every whole-slot seal)."""
    eng = Engine(model, params, trust_domain=TrustDomain("tdx", device=card),
                 max_slots=2, max_len=64, prefill_buckets=(4, 8),
                 device=card, mesh=mesh, **kv)
    names = []
    inner_seal = eng.kv.seal

    def seal(*a, **k):
        out = inner_seal(*a, **k)
        names.extend(out)
        return out
    eng.kv.seal = seal
    prompts = [np.arange(1, 5), np.arange(1, 9), np.full(8, 7)]
    reqs = [eng.submit(_sampled((p, 6, 0, 100 + i)))
            for i, p in enumerate(prompts)]
    for _ in range(3):
        eng.step()
    reqs.append(eng.submit(_sampled((np.arange(1, 13), 4, 5, 110))))
    assert eng.run(max_steps=10_000).preemptions > 0
    return [list(r.output) for r in reqs], eng, names


@pytest.mark.parametrize("kv", [dict(kv_backend="slot"),
                                dict(kv_backend="paged", page_size=8)],
                         ids=["slot", "paged"])
def test_mesh_engine_on_card_equals_single_device(card, kv):
    """A dp=2 mesh on the card serves the single-device engine's tokens;
    every sealed name carries a shard tag, each decode step counts one
    gather of half the sharded weights, and each gather is timed."""
    model, params = _card_model(card)
    single, _, _ = _serve_mesh(card, model, params, None, **kv)
    got, eng, names = _serve_mesh(card, model, params, "dp=2", **kv)
    assert got == single
    assert names and all(n.endswith(("/s0", "/s1")) for n in names)
    ch = eng.td.channel.stats
    sharded = sum(b.numel() * b.element_size()
                  for b in eng.params.buffers.values())
    assert ch.collective_steps > 0
    assert ch.collective_bytes == ch.collective_steps * (sharded // 2)
    assert ch.collective_s > 0


def _sampled(spec):
    from repro_torch.runtime import SamplingParams
    prompt, mnt, prio, seed = spec
    return GenerationRequest(
        prompt=np.asarray(prompt, np.int32), max_new_tokens=mnt,
        priority=prio,
        params=SamplingParams(temperature=0.9, top_k=16, seed=seed))


def _card_model(card):
    cfg = smoke_config("deepseek-7b")
    return build_model(cfg, device=card), tree_map(
        lambda t: t.to(card), build_model(cfg, device="cpu").init_params(seed=3))


def test_paged_store_engine_on_card(card):
    """The canonical scenario twice on one paged-store engine with kernel
    decode on the card: the warm epoch hits the store and writes fewer
    pages, its tokens are the cold epoch's, and every request equals its
    solo run; the pool invariants hold after every step."""
    from conftest import canonical_requests, check_pool_invariants
    model, params = _card_model(card)
    kw = dict(kv_backend="paged", page_size=8, kv_decode="kernel",
              prefix_sharing=True, page_store=True, max_slots=2, max_len=64,
              prefill_buckets=(4, 8), device=card)
    low, high = canonical_requests()
    eng = Engine(model, params, trust_domain=TrustDomain("tdx", device=card),
                 **kw)
    epochs = []
    for _ in range(2):
        written, hits = eng.kv.pages_written, eng.kv.store_hits
        P.reset_launches()
        reqs = [eng.submit(_sampled(s)) for s in low]
        for _ in range(3):
            eng.step()
            check_pool_invariants(eng.kv)
        reqs += [eng.submit(_sampled(s)) for s in high]
        while not eng.idle:
            eng.step()
            check_pool_invariants(eng.kv)
        assert P.launches["paged_attention"] > 0
        epochs.append(([r.output for r in reqs],
                       eng.kv.pages_written - written,
                       eng.kv.store_hits - hits))
    (cold, cold_written, _), (warm, warm_written, warm_hits) = epochs
    assert warm == cold
    assert warm_hits > 0 and warm_written < cold_written
    solo = Engine(model, params, trust_domain=TrustDomain("tdx", device=card),
                  **dict(kw, page_store=None, prefix_sharing=False))
    for spec, out in zip(low + high, cold):
        assert out == solo.generate(_sampled(spec)).tokens


def test_two_plan_engine_on_card_rerun_identical(card):
    """Disaggregated prefill on the card (its own CUDA stream, sealed
    handoff two rows a crossing) over the long-prompt burst, twice: equal
    tokens both times (the handoff waits for the prefill's stream) and
    each request equal to its solo run on a slot engine."""
    from conftest import burst_requests
    model, params = _card_model(card)
    base = dict(max_slots=2, max_len=64, prefill_buckets=(4, 8), device=card)
    runs = []
    for _ in range(2):
        eng = Engine(model, params,
                     trust_domain=TrustDomain("tdx", device=card),
                     kv_backend="paged", page_size=8, kv_decode="kernel",
                     prefill_plan="dedicated", handoff_batch=2, **base)
        assert eng.prefill_plan.stream is not None
        assert (eng.prefill_params["embedding"]["table"].data_ptr()
                == eng.params["embedding"]["table"].data_ptr())
        reqs = [eng.submit(_sampled(s)) for s in burst_requests()]
        stats = eng.run()
        assert stats.handoffs == len(reqs) and stats.handoff_bytes > 0
        assert eng.handoff_crossings < len(reqs)
        runs.append([r.output for r in reqs])
    assert runs[0] == runs[1]
    solo = Engine(model, params, trust_domain=TrustDomain("tdx", device=card),
                  **base)
    assert runs[0] == [solo.generate(_sampled(s)).tokens
                       for s in burst_requests()]


def test_store_blobs_sealed_on_card_open_on_cpu(card):
    """A page the card publishes to the store is the same blob a CPU
    unseal opens, to the pool's bits."""
    from repro_torch.core.sealing import unseal_tensor
    model, params = _card_model(card)
    td = TrustDomain("tdx", device=card)
    eng = Engine(model, params, trust_domain=td, kv_backend="paged",
                 page_size=8, prefix_sharing=True, page_store=True,
                 max_slots=2, max_len=64, prefill_len=8, device=card)
    eng.generate(_sampled((np.arange(1, 9), 10, 0, 1)))
    entries = eng.kv.page_store._domains[td.sealing_key.key_id()]
    assert entries
    for entry in entries.values():
        for st in entry.blobs.values():
            on_card = unseal_tensor(td.sealing_key, st)
            cpu_blob = type(st)(st.name, st.ciphertext.cpu(), st.mac,
                                st.shape, st.dtype, st.n_bytes)
            assert torch.equal(unseal_tensor(td.sealing_key, cpu_blob),
                               on_card.cpu())


def test_batched_prefill_rows_equal_solo_on_card(card):
    """A bf16 model's batched prefill (the engine's plan, 4 rows of 16
    tokens) gives each row the logits and KV of the same prompt prefilled
    alone, bit for bit: cuBLAS's kernel for 64 rows rounds otherwise than
    its kernel for 16 (a Llama2-7B row differed by 0.1 in its logits), so
    the plan runs one row a call."""
    import dataclasses
    from repro_torch.runtime.plan import SingleDevicePlan
    cfg = dataclasses.replace(smoke_config("llama2-7b"), d_model=1024,
                              num_heads=8, num_kv_heads=8, head_dim=128,
                              d_ff=2816, vocab_size=32000, dtype="bfloat16")
    model = build_model(cfg, device=card)
    params = model.init_params(seed=0)
    prefill = SingleDevicePlan(model).compile_prefill()
    g = torch.Generator(device="cpu").manual_seed(31)
    tokens = torch.randint(1, 32000, (4, 16), generator=g,
                           dtype=torch.int32).to(card)
    logits, cache = prefill(params, tokens, model.init_cache(4, 64))
    for i in range(4):
        one, solo = prefill(params, tokens[i:i + 1], model.init_cache(1, 64))
        assert torch.equal(logits[i], one[0])
        for leaf in ("k", "v"):
            assert torch.equal(cache["layers"]["slot_0"][leaf][:, i],
                               solo["layers"]["slot_0"][leaf][:, 0])


# a bf16 prefill at deepseek-7b's attention width through B2 against the
# same prefill through sdpa (PERF.md section 6 states the limit)
B2_PREFILL_LOGIT_LIMIT = 0.15


@pytest.mark.parametrize("s", [1024, 4096])
def test_prefill_through_b2_on_card_matches_sdpa(card, monkeypatch, s):
    """deepseek-7b's attention (32 heads of 128) in a 2-layer bf16 model:
    the plan's one-row prefill launches B2 once a layer and counts it on
    the tracer; its logits lie within the limit of the same prefill
    through sdpa, and the first layer's KV, written before any attention,
    is bit-equal."""
    import dataclasses
    from repro_torch import tracing
    from repro_torch.models import layers
    from repro_torch.runtime.plan import SingleDevicePlan
    cfg = dataclasses.replace(smoke_config("deepseek-7b"), d_model=4096,
                              num_heads=32, num_kv_heads=32, head_dim=128,
                              d_ff=1024, vocab_size=32000, num_layers=2,
                              dtype="bfloat16")
    model = build_model(cfg, device=card)
    params = model.init_params(seed=0)
    prefill = SingleDevicePlan(model).compile_prefill()
    g = torch.Generator(device="cpu").manual_seed(s)
    tokens = torch.randint(1, cfg.vocab_size, (1, s), generator=g,
                           dtype=torch.int32).to(card)
    before = FA.launches
    with tracing.active(tracing.Tracer()) as tracer:
        got, cache = prefill(params, tokens, model.init_cache(1, s))
    torch.cuda.synchronize()
    assert FA.launches - before == cfg.num_layers
    assert tracer.counters == {"model:attn_b2": cfg.num_layers}

    def sdpa_route(c, q, k, v):
        b, n = q.shape[:2]
        positions = torch.arange(n, device=q.device)[None, :].expand(b, n)
        return layers._attend_full(c, q, k, v, positions)

    monkeypatch.setattr(layers, "_attend_prompt", sdpa_route)
    want, ref = prefill(params, tokens, model.init_cache(1, s))
    assert FA.launches - before == cfg.num_layers
    gap = (got - want).abs().max().item()
    assert gap <= B2_PREFILL_LOGIT_LIMIT, gap
    for leaf in ("k", "v"):
        assert torch.equal(cache["layers"]["slot_0"][leaf][0],
                           ref["layers"]["slot_0"][leaf][0])


@pytest.mark.parametrize("case", ["b2", "not_causal", "head_dim_96",
                                  "float16"])
def test_prompt_dispatch_on_card(card, case):
    """On the card a causal prompt in f32/bf16 at a head dim B2 has a
    kernel for launches B2 once; non-causal attention, head dim 96 and
    float16 keep the reference's arithmetic, bit for bit, and launch
    nothing."""
    from repro_torch import tracing
    from repro_torch.models import layers
    hd = 96 if case == "head_dim_96" else 64
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    cfg = layers.AttentionConfig(d_model=8 * hd, num_heads=8, num_kv_heads=2,
                                 head_dim=hd, causal=case != "not_causal")
    g = torch.Generator(device="cpu").manual_seed(11)
    q = torch.randn((1, 200, 8, hd), generator=g).to(dtype).to(card)
    k, v = (torch.randn((1, 200, 2, hd), generator=g).to(dtype).to(card)
            for _ in range(2))
    positions = torch.arange(200, device=card)[None, :]
    want = layers._attend_full(cfg, q, k, v, positions)
    before = FA.launches
    with tracing.active(tracing.Tracer()) as tracer:
        got = layers._attend_prompt(cfg, q, k, v)
    torch.cuda.synchronize()
    if case == "b2":
        assert FA.launches == before + 1
        assert tracer.counters == {"model:attn_b2": 1}
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    else:
        assert FA.launches == before
        assert tracer.counters == {"model:attn_plain": 1}
        assert torch.equal(got, want)


def test_fleet_kill_on_card_equals_solo(card):
    """Two workers on the card share the smoke model's weights (paged
    kernel decode); the busiest is killed mid-decode, its KV migrates
    sealed under the tenant key domains, the survivor restores it as
    ciphertext (B4), and every request equals its solo run on the card,
    with no page or slot leaked anywhere."""
    from repro_torch.fleet import EngineWorker, Gateway, Orchestrator
    from repro_torch.runtime import SamplingParams
    model, params = _card_model(card)
    kw = dict(max_slots=2, max_len=64, prefill_buckets=(4, 8),
              kv_backend="paged", page_size=8, kv_decode="kernel",
              device=card)
    rng = np.random.default_rng(3)
    specs = [(rng.integers(1, 100, size=int(n)).astype(np.int32), 50 + i,
              "ab"[i % 2]) for i, n in enumerate(rng.integers(4, 12, size=6))]

    def gen(spec):
        prompt, seed, tenant = spec
        return GenerationRequest(
            prompt=prompt.copy(), max_new_tokens=6, tenant=tenant,
            params=SamplingParams(temperature=0.9, top_k=16, seed=seed))
    solo = Engine(model, params, trust_domain=TrustDomain("tdx", device=card),
                  **dict(kw, max_slots=1))
    want = [solo.generate(gen(s)).tokens for s in specs]
    workers = [EngineWorker(f"w{i}", model, params, engine_kw=kw)
               for i in range(2)]
    table = [w.engine.params["embedding"]["table"] for w in workers]
    assert table[0].data_ptr() == table[1].data_ptr()   # one weight copy
    gateway = Gateway(config_repr="test")
    for t in ("a", "b"):
        gateway.register_tenant(t)
    orch = Orchestrator(gateway, workers)
    handles = [orch.submit(gen(s)) for s in specs]
    for _ in range(3):
        orch.step()
    victim = max(orch.ready_workers(), key=lambda w: w.load())
    survivor = next(w for w in workers if w is not victim)
    P.reset_launches()
    orch.kill(victim.name)
    orch.run()
    assert [h.output for h in handles] == want
    assert orch.stats.migrations > 0
    assert survivor.engine.kv.fused_restore_pages > 0
    assert P.launches["paged_attention_unseal"] > 0
    for w in workers:
        assert w.engine.slots.num_active == 0
        assert w.engine.kv.free_physical_pages == w.engine.kv.num_pages


def test_dense_encoder_ranking_on_card_equals_cpu(card):
    """The RAG encoder (bf16) on the card embeds the corpus within two bf16
    roundings of the CPU's on the same weights, and ranks it the same up
    to near ties."""
    from repro_torch.data import synthetic_text
    from repro_torch.rag import DenseRetriever
    tol = 4e-3
    docs = {f"d{i}": synthetic_text(i, 5) for i in range(15)}
    docs["needle"] = ("confidential enclave attestation protects llama "
                      "inference throughput inside trusted hardware")
    gpu = DenseRetriever(device=card).build(docs)
    cpu = DenseRetriever(device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), gpu.params)
    cpu.build(docs)
    assert gpu.embeddings.device.type == "cuda"
    assert float((gpu.embeddings.cpu() - cpu.embeddings).abs().max()) <= tol
    for q in ("confidential enclave attestation llama",
              "sealed keystream memory encryption"):
        got, ref = gpu.search(q, len(docs)), dict(cpu.search(q, len(docs)))
        assert sorted(d for d, _ in got) == sorted(ref)
        assert all(abs(s - ref[d]) <= tol for d, s in got)
        order = [d for d, _ in got]
        assert all(ref[a] >= ref[b] - 2 * tol
                   for a, b in zip(order, order[1:]))


# -- the model families (f32 smoke configs) ------------------------------------

FAMILIES = ["chameleon-34b", "dbrx-132b", "deepseek-v3-671b",
            "jamba-v0.1-52b", "rwkv6-3b", "whisper-small"]
FAMILY_KV = {"chameleon-34b": dict(kv_backend="paged", page_size=8,
                                   kv_decode="kernel"),
             "dbrx-132b": dict(kv_backend="paged", page_size=8),
             "deepseek-v3-671b": dict(kv_backend="paged", page_size=8),
             "jamba-v0.1-52b": dict(kv_backend="paged", page_size=8),
             "rwkv6-3b": dict(kv_backend="slot")}


def _family_batch(model, device, s=8):
    g = torch.Generator().manual_seed(5)
    cfg = model.cfg
    b = {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=g,
                                 dtype=torch.int32).to(device)}
    if model.is_encdec:
        b["frames"] = torch.randn(2, 12, cfg.d_model, generator=g).to(device)
    return b


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_model_on_card_matches_cpu(card, arch):
    """Each family's f32 smoke model on the card: prefill and 8 greedy
    decode steps within 1e-4 of the CPU's logits (f32 products in another
    order), the same greedy tokens, and the cache-free forward within
    1e-4."""
    cfg = smoke_config(arch)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device=card)
    params = cpu.init_params(seed=4)
    gparams = tree_map(lambda t: t.to(card), params)
    n = 12 if cpu.is_encdec else 32
    cb, gb = _family_batch(cpu, "cpu"), _family_batch(gpu, card)
    cl, cc = cpu.prefill(params, cb, cpu.init_cache(2, n))
    gl, gc = gpu.prefill(gparams, gb, gpu.init_cache(2, n))
    for _ in range(8):
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        tok = cl.argmax(-1)
        assert torch.equal(gl.argmax(-1).cpu(), tok)
        cl, cc = cpu.decode_step(params, tok[:, None].int(), cc)
        gl, gc = gpu.decode_step(gparams, tok[:, None].int().to(card), gc)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gpu.forward(gparams, gb)[0].cpu(),
                               cpu.forward(params, cb)[0], rtol=1e-4,
                               atol=1e-4)


def _family_serve(device, model, params, **kv):
    """The preempting scenario of ``_serve`` on a family's backend."""
    eng = Engine(model, params, trust_domain=TrustDomain("tdx", device=device),
                 max_slots=2, max_len=64, prefill_buckets=(4, 8),
                 device=device, **kv)
    prompts = [np.arange(1, 5), np.arange(1, 9), np.full(8, 7)]
    reqs = [eng.submit(GenerationRequest(prompt=p.astype(np.int32),
                                         max_new_tokens=6)) for p in prompts]
    for _ in range(3):
        eng.step()
    reqs.append(eng.submit(GenerationRequest(
        prompt=np.arange(1, 13, dtype=np.int32), max_new_tokens=4,
        priority=5)))
    assert eng.run(max_steps=10_000).preemptions > 0
    return [list(r.output) for r in reqs]


@pytest.mark.parametrize("arch", sorted(FAMILY_KV))
def test_family_engine_on_card_matches_cpu(card, arch):
    """Each decoder family's f32 smoke model serves the preempting scenario
    on the card with the CPU run's tokens (chameleon through B3 and B4);
    the families with attention layers prefill it through B2, MLA
    (deepseek-v3) and RWKV without."""
    cfg = smoke_config(arch)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(seed=3)
    expect = _family_serve("cpu", cpu, params, **FAMILY_KV[arch])
    P.reset_launches()
    before = FA.launches
    got = _family_serve(card, build_model(cfg, device=card),
                        tree_map(lambda t: t.to(card), params),
                        **FAMILY_KV[arch])
    assert got == expect
    assert (FA.launches > before) == (arch not in ("deepseek-v3-671b",
                                                   "rwkv6-3b"))
    if arch == "chameleon-34b":
        assert P.launches["paged_attention"] > 0
        assert P.launches["paged_attention_unseal"] > 0


def test_hybrid_pause_freezes_recurrent_state_on_card(card):
    """On the card, a paused jamba row's Mamba state rows stay bit-equal
    through a decode step it sits out while its mate's rows move, and both
    requests finish with the CPU run's tokens."""
    cfg = smoke_config("jamba-v0.1-52b")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(seed=2)
    outs = []
    for device, model, p in (("cpu", cpu, params),
                             (card, build_model(cfg, device=card),
                              tree_map(lambda t: t.to(card), params))):
        eng = Engine(model, p, trust_domain=TrustDomain("tdx", device=device),
                     max_slots=2, max_len=64, prefill_buckets=(8,),
                     kv_backend="paged", page_size=8, device=device)
        low = eng.submit(GenerationRequest(
            prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=10))
        mate = eng.submit(GenerationRequest(
            prompt=np.full(8, 3, np.int32), max_new_tokens=10))
        for _ in range(3):
            eng.step()
        dense = eng.kv._dense
        before = {k: v[:, 0].clone() for k, v in dense.items()}
        mate_before = {k: v[:, 1].clone() for k, v in dense.items()}
        eng.kv.decode(eng.params, eng._last_token, None, 0, write_slots=[1])
        assert all(torch.equal(v[:, 0], before[k]) for k, v in dense.items())
        assert any(not torch.equal(v[:, 1], mate_before[k])
                   for k, v in dense.items())
        eng.run()
        outs.append((list(low.output), list(mate.output)))
    assert outs[0] == outs[1]


def _train_state(device, moment_dtype="float32"):
    """Smoke deepseek-7b (f32) with q- and loss-chunks of 8, its initial
    train state from seed 0 on ``device``, and 2 microbatches' step."""
    import dataclasses
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import init_train_state, make_train_step
    cfg = smoke_config("deepseek-7b")
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attention_chunk=8, loss_chunk=8))
    model = build_model(cfg, device=device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                      moment_dtype=moment_dtype)
    return (init_train_state(model, opt, seed=0),
            make_train_step(model, opt, microbatches=2))


def test_train_step_on_card_matches_cpu(card):
    """Two train steps (2 microbatches, chunked attention and loss, full
    remat) on the card from the CPU's initial state: losses and grad norms
    within 1e-5, the params and moments within 1e-4 of each leaf's
    largest entry (f32 products in another order; a gradient at rounding
    noise can turn AdamW's step by up to lr)."""
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.data.pipeline import PackedLMDataset
    cstate, cstep = _train_state("cpu")
    _, gstep = _train_state(card)
    gstate = tree_map(lambda t: t.to(card), cstate)
    data = iter(PackedLMDataset(batch_size=4, seq_len=32, seed=0))
    for _ in range(2):
        batch = next(data)
        cstate, cm = cstep(cstate, batch)
        gstate, gm = gstep(gstate, batch)
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(gm[k].cpu(), cm[k], rtol=1e-5,
                                       atol=1e-5)
    for (n, g), (_, c) in zip(tree_leaves_with_names(gstate),
                              tree_leaves_with_names(cstate)):
        assert g.device.type == "cuda", n
        scale = max(float(c.abs().max()), 1e-30) if c.is_floating_point() \
            else 0.0
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=1e-4 * scale,
                                   msg=n)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sealed_checkpoint_on_card_restores_bit_equal(card, tmp_path,
                                                      moments):
    """A train state sealed on the card (B1) restores bit for bit on the
    card and on the CPU, and its files equal the same state's sealed on
    the CPU (the ciphertext does not depend on the device)."""
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    cstate, _ = _train_state("cpu", moments)
    gstate = tree_map(lambda t: t.to(card), cstate)
    key = SealingKey.generate(b"ckpt-card")
    before = C.launches
    save_checkpoint(tmp_path / "g", 3, gstate, trust_domain=TrustDomain(
        "tdx", sealing_key=key, device=card))
    assert C.launches > before
    save_checkpoint(tmp_path / "c", 3, cstate, trust_domain=TrustDomain(
        "tdx", sealing_key=key, device="cpu"))
    for f in sorted((tmp_path / "g" / "step_3").iterdir()):
        assert f.read_bytes() == (tmp_path / "c" / "step_3" / f.name
                                  ).read_bytes(), f.name
    for like, device in ((gstate, None), (cstate, "cpu")):
        back = restore_checkpoint(tmp_path / "g", 3, like,
                                  trust_domain=TrustDomain(
                                      "tdx", sealing_key=key, device=card))
        for (n, b), (_, c) in zip(tree_leaves_with_names(back),
                                  tree_leaves_with_names(cstate)):
            assert b.device.type == (device or "cuda"), n
            assert b.dtype == c.dtype and torch.equal(b.cpu(), c), n


def test_tp_engine_on_card_equals_cpu(card):
    """A smoke f32 tp=2 engine (two logical shards) on the card serves the
    CPU tp=2 engine's tokens through the sampled waves and a preemption;
    every sealed name carries the one data shard's tag."""
    model, params = _card_model(card)
    got, eng, names = _serve_mesh(card, model, params, "tp=2")
    cpu = build_model(smoke_config("deepseek-7b"), device="cpu")
    want, _, _ = _serve_mesh(torch.device("cpu"), cpu,
                             cpu.init_params(seed=3), "tp=2")
    assert got == want
    assert names and all(n.endswith("/s0") for n in names)
    assert eng.td.channel.stats.collective_s > 0


def test_tp_ranks_on_card_equal_logical_blobs(card, tmp_path):
    """Two ranks sharing the card (gloo through host memory) give a
    logical tp=2 run's tokens and blob bytes on the card, each name sealed
    by rank 0 alone."""
    import _torch_ranks_worker as W

    want = W.serve("tp=2", "cuda")
    ranks = [got["slot"] for got in W.spawn("tp=2", 2, tmp_path,
                                            device="cuda")]
    assert want["seals"]
    for got in ranks:
        assert got["tokens"] == want["tokens"]
        assert got["seals"] == want["seals"]
        assert "over gloo" in got["describe"]
    assert sorted(ranks[0]["own"]) == sorted(n for s in want["seals"]
                                             for n in s)
    assert not ranks[1]["own"]


def test_tp_moe_engine_on_card_equals_cpu(card):
    """A smoke f32 dbrx-132b engine on tp=2 logical shards on the card
    (each shard its half of the experts, routing every token) serves the
    CPU tp=2 engine's tokens through the sampled waves and a preemption,
    on the paged backend with gather decode."""
    cfg = smoke_config("dbrx-132b")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(seed=3)
    kv = dict(kv_backend="paged", page_size=8)
    got, eng, names = _serve_mesh(card, build_model(cfg, device=card),
                                  tree_map(lambda t: t.to(card), params),
                                  "tp=2", **kv)
    want, _, _ = _serve_mesh(torch.device("cpu"), cpu, params, "tp=2", **kv)
    assert got == want
    assert names and all(n.endswith("/s0") for n in names)
    assert eng.plan.tensor_parallel.mcfg.num_experts == 4


def test_paged_ranks_on_card_equal_logical(card, tmp_path):
    """Two ranks sharing the card serve the paged backend (prefix sharing,
    a preemption) at tp=2 with a logical tp=2 run's tokens, page tables
    after every step and blob bytes; rank 0 alone seals, each name once."""
    import numpy as np
    import _torch_ranks_worker as W

    want = W.serve("tp=2", "cuda", "paged")
    ranks = [got["paged"] for got in W.spawn(
        "tp=2", 2, tmp_path, device="cuda", runs=("paged",))]
    assert want["seals"] and want["shared_pages"] > 0
    for got in ranks:
        assert got["tokens"] == want["tokens"]
        assert got["seals"] == want["seals"]
        assert len(got["tables"]) == len(want["tables"])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["tables"], want["tables"]))
    names = {n for s in want["seals"] for n in s}
    assert len(set(ranks[0]["own"])) == len(ranks[0]["own"])
    assert names <= set(ranks[0]["own"]) and not ranks[1]["own"]


def test_tp_jamba_engine_on_card_equals_cpu(card):
    """A smoke f32 jamba-v0.1-52b engine on tp=2 logical shards on the
    card (each shard its half of the Mamba channels, KV heads and
    experts) serves the CPU tp=2 engine's tokens through the sampled waves
    and a preemption, on the paged backend with gather decode."""
    cfg = smoke_config("jamba-v0.1-52b")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(seed=3)
    kv = dict(kv_backend="paged", page_size=8)
    got, eng, names = _serve_mesh(card, build_model(cfg, device=card),
                                  tree_map(lambda t: t.to(card), params),
                                  "tp=2", **kv)
    want, _, _ = _serve_mesh(torch.device("cpu"), cpu, params, "tp=2", **kv)
    assert got == want
    assert names and all(n.endswith("/s0") for n in names)
    assert any("['ssm']" in n for n in names)
    # each shard: 64 of the 128 Mamba channels, w_in as its x and z blocks
    mamba = [m for *_, m, _ in eng.plan.tensor_parallel.slots].index("mamba")
    for lp in eng.params.compute:
        mb = lp["layers"][mamba]["mamba"]
        assert mb["conv_w"].shape[-1] == 64
        assert mb["w_in"].shape[-2:] == (2, 64)


def test_jamba_paged_ranks_on_card_equal_logical(card, tmp_path):
    """Two ranks sharing the card serve smoke jamba-v0.1-52b paged at tp=2
    (each rank its KV heads of every page and its Mamba channels of every
    row) with a logical tp=2 run's tokens, page tables after every step
    and blob bytes; rank 0 alone seals, each name once."""
    import _torch_ranks_worker as W

    want = W.serve("tp=2", "cuda", "jamba")
    ranks = [got["jamba"] for got in W.spawn(
        "tp=2", 2, tmp_path, device="cuda", runs=("jamba",))]
    assert want["seals"] and want["preemptions"] > 0
    for got in ranks:
        assert got["tokens"] == want["tokens"]
        assert got["seals"] == want["seals"]
        assert len(got["tables"]) == len(want["tables"])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["tables"], want["tables"]))
    names = {n for s in want["seals"] for n in s}
    assert len(set(ranks[0]["own"])) == len(ranks[0]["own"])
    assert names <= set(ranks[0]["own"]) and not ranks[1]["own"]


def test_sharded_train_step_on_card_matches_one_device(card):
    """Two sharded steps over a logical dp=2,tp=2 mesh on the card (FSDP
    over data, 2 microbatches) against the one-device step on the card:
    losses within 1e-5, every leaf within 1e-4 of its largest entry (the
    shards' f32 gradients summed in another order; a gradient at rounding
    noise can turn AdamW's step by up to lr); the state rests in its
    shards, each block on the card."""
    import dataclasses
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.data.pipeline import PackedLMDataset
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step,
                                              make_train_step)
    cfg = smoke_config("deepseek-7b")
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, fsdp=True))
    model = build_model(cfg, device=card)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = init_train_state(model, opt, seed=0)
    mesh = make_host_mesh(2, 2, device=card)
    sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt), mesh)
    data = iter(PackedLMDataset(batch_size=8, seq_len=32, seed=0))
    batch = next(data)
    sstep = make_sharded_train_step(model, opt, mesh, sspecs,
                                    sharding.batch_specs(cfg, batch, mesh),
                                    microbatches=2)
    step = make_train_step(model, opt, microbatches=2)
    placed = sharding.place(state, sharding.to_named(mesh, sspecs))
    for _ in range(2):
        placed, sm = sstep(placed, batch)
        state, m = step(state, batch)
        torch.testing.assert_close(sm["loss"], m["loss"], rtol=1e-5,
                                   atol=1e-5)
        batch = next(data)
    assert sm["collective_bytes"] > 0 and sm["collective_s"] > 0
    for (n, p), (_, w) in zip(tree_leaves_with_names(placed),
                              tree_leaves_with_names(state)):
        assert all(b.device.type == card.type for b in p.blocks.values()), n
        g = sharding.gather_leaf(p)
        scale = max(float(w.abs().max()), 1e-30) if w.is_floating_point() \
            else 0.0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale, msg=n)


@pytest.mark.parametrize("arch,shape", [("dbrx-132b", (2, 2)),
                                        ("jamba-v0.1-52b", (2, 2)),
                                        ("whisper-small", (1, 2))])
def test_tp_train_step_on_card_matches_one_device(card, arch, shape):
    """Two tensor-parallel steps on the card against the one-device step on
    the card: smoke dbrx and jamba on data=2, model=2 with the batch split
    over data at capacity factor 1.0 (tokens dropped), whisper on model=2.
    Losses within 1e-5; each leaf's update over the two steps within 1e-2
    of the norm of one device's (tests/test_torch_tp_train.py's bound: an
    element-wise bound trips on AdamW's sign-like first steps); the state
    rests on the card."""
    import dataclasses
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step,
                                              make_train_step)
    cfg = smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    model = build_model(cfg, device=card)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = init_train_state(model, opt, seed=0)
    mesh = make_host_mesh(*shape, device=card)
    sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt), mesh)
    rng = np.random.default_rng(3)
    seq = cfg.max_target_len if cfg.family == "encdec" else 16

    def batch():
        out = {k: rng.integers(lo, cfg.vocab_size, (4, seq)).astype(np.int32)
               for k, lo in (("tokens", 0), ("labels", -1))}
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal((4, 16, cfg.d_model)
                                                ).astype(np.float32)
        return out

    b = batch()
    sstep = make_sharded_train_step(model, opt, mesh, sspecs,
                                    sharding.batch_specs(cfg, b, mesh))
    step = make_train_step(model, opt)
    placed = sharding.place(state, sharding.to_named(mesh, sspecs))
    before = state
    for _ in range(2):
        placed, sm = sstep(placed, b)
        state, m = step(state, b)
        torch.testing.assert_close(sm["loss"], m["loss"], rtol=1e-5,
                                   atol=1e-5)
        b = batch()
    assert sm["collective_bytes"] > 0
    for (n, p), (_, w), (_, b0) in zip(tree_leaves_with_names(placed.params),
                                       tree_leaves_with_names(state.params),
                                       tree_leaves_with_names(before.params)):
        assert all(b.device.type == card.type for b in p.blocks.values()), n
        moved = (w - b0).norm().clamp_min(1e-30)
        assert float((sharding.gather_leaf(p) - w).norm() / moved) < 1e-2, n


def test_gpipe_gradient_on_card(card):
    """make_gpipe over a LocalGroup(4) on the card: the sequential stages'
    output within 1e-4 and their gradient within 1e-3
    (tests/test_distributed.py's tolerances)."""
    from repro_torch.distributed.collectives import LocalGroup
    from repro_torch.distributed.pipeline import make_gpipe
    g = torch.Generator(device="cpu").manual_seed(5)
    ws = (torch.randn(4, 64, 64, generator=g) * 0.15).to(card)
    mb = torch.randn(6, 8, 64, generator=g).to(card)
    ws.requires_grad_()
    stage = lambda w, x: torch.tanh(x @ w)
    out = make_gpipe(LocalGroup(4, card), stage)(ws, mb)
    ref = mb
    for i in range(4):
        ref = stage(ws[i], ref)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    (got,) = torch.autograd.grad((out ** 2).sum(), ws)
    (want,) = torch.autograd.grad((ref ** 2).sum(), ws)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_names_the_card_and_allocates_nothing(card, kind):
    """The dry run's default fake device is the card: smoke deepseek-7b's
    step on a 2 x 2 dry mesh lowers with fake CUDA tensors, allocates no
    tensor of the model on the card (a scalar ``torch.tensor`` constant
    under ``FakeTensorMode`` starts as a real tensor: a few 512 B blocks),
    and counts what the same lowering naming the CPU counts."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_mesh
    shape = {"train": ShapeConfig("t", 8, 4, "train"),
             "prefill": ShapeConfig("p", 8, 2, "prefill"),
             "decode": ShapeConfig("d", 8, 2, "decode")}[kind]
    cfg = smoke_config("deepseek-7b")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_dry_mesh({"data": 2, "model": 2})
    assert mesh.device.type == "cuda"
    got = dryrun.lower_step(cfg, shape, mesh)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= 8 * 512
    want = dryrun.lower_step(cfg, shape, make_dry_mesh(
        {"data": 2, "model": 2}, "cpu"))
    assert (got.flops, got.collectives) == (want.flops, want.collectives)
    assert got.bytes == want.bytes and got.arg_bytes == want.arg_bytes
