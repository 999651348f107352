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
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as P
from repro_torch.models import build_model
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
    before = C.launches
    got = _serve(card, tree_map(lambda t: t.to(card), params),
                 build_model(cfg, device=card))
    assert got == expect
    assert C.launches > before


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
