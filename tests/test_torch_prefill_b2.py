"""A prompt's attention (``layers._attend_prompt``): on the card B2
(``ops.mha_flash``) where it takes the shapes, the reference's ``sdpa``
everywhere else. On the CPU every prompt keeps ``sdpa``; what the card's
route computes is ``ops.mha_flash``, which here runs B2's plain version
and must equal the ``sdpa`` prefill within the tolerances B2 is held to
against the reference (``test_torch_flash_qmm.py``). The card tests hold
the dispatch's other conditions and the kernel itself."""

import dataclasses

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, layers
from repro_torch.runtime.plan import SingleDevicePlan

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _cfg(h, hk, hd=32, **kw):
    return layers.AttentionConfig(d_model=h * hd, num_heads=h,
                                  num_kv_heads=hk, head_dim=hd, **kw)


def _qkv(b, s, h, hk, hd, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g).to(dtype)
    k, v = (torch.randn((b, s, hk, hd), generator=g).to(dtype)
            for _ in range(2))
    return q, k, v


def _positions(b, s):
    return torch.arange(s)[None, :].expand(b, s)


@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2)])
@pytest.mark.parametrize("s", [256, 512, 200])
def test_b2_route_equals_sdpa(s, h, hk, dtype, chunk):
    cfg = _cfg(h, hk, chunk=chunk)
    q, k, v = _qkv(2, s, h, hk, cfg.head_dim, dtype, seed=s + hk)
    got = ops.mha_flash(q, k, v)
    want = layers._attend_full(cfg, q, k, v, _positions(2, s))
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # on the CPU the prompt's own route is the sdpa prefill, bit for bit
    assert torch.equal(layers._attend_prompt(cfg, q, k, v), want)


@pytest.mark.parametrize("case", ["b2_shapes", "not_causal", "head_dim_96",
                                  "float16", "attention_forward"])
def test_dispatch_keeps_sdpa(case):
    """A CPU tensor keeps the reference's arithmetic, bit for bit, whatever
    its shape: the shapes B2 takes on the card, non-causal attention, a
    head dim or dtype B2 has no kernel for; and the cache-free pass
    (training: B2 has no backward) never counts a prompt."""
    hd = 96 if case == "head_dim_96" else 32
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    cfg = _cfg(4, 2, hd, causal=case != "not_causal")
    if case == "attention_forward":
        p = layers.init_attention(torch.Generator().manual_seed(1), cfg,
                                  dtype=dtype)
        p = {n: t[0] for n, t in p.items()}
        x = torch.randn((2, 64, cfg.d_model)).to(dtype)
        with tracing.active(tracing.Tracer()) as tr:
            got = layers.attention_forward(p, cfg, x)
        assert tr.counters == {}
        q, k, v = layers._qkv(p, cfg, x, _positions(2, 64))
        want = layers._attend_full(cfg, q, k, v, _positions(2, 64))
        assert torch.equal(got, torch.einsum("bshk,hkd->bsd", want, p["wo"]))
        return
    q, k, v = _qkv(2, 128, 4, 2, hd, dtype)
    with tracing.active(tracing.Tracer()) as tr:
        got = layers._attend_prompt(cfg, q, k, v)
    assert tr.counters == {"model:attn_plain": 1}
    assert torch.equal(got, layers._attend_full(cfg, q, k, v,
                                                _positions(2, 128)))


@pytest.mark.parametrize("rows", [1, 2])
def test_counts_one_per_layer_per_prefill_call(rows):
    """The plan prefills a row a call: ``rows`` rows count that many calls
    of every attention layer on the span open around them; without a
    tracer nothing records and the logits are the same."""
    cfg = dataclasses.replace(smoke_config("deepseek-7b"), num_layers=3)
    model = build_model(cfg, device="cpu")
    params = model.init_params(seed=0)
    prefill = SingleDevicePlan(model).compile_prefill()
    tokens = torch.randint(1, cfg.vocab_size, (rows, 16),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    idle = tracing.Tracer()
    bare, _ = prefill(params, tokens, model.init_cache(rows, 32))
    tracer = tracing.Tracer()
    with tracing.active(tracer):
        with tracing.span("engine:prefill"):
            logits, _ = prefill(params, tokens, model.init_cache(rows, 32))
    assert tracer.counters == {"model:attn_plain": 3 * rows}
    assert tracer.spans[0].attrs == {"model:attn_plain": 3 * rows}
    assert idle.counters == {} and tracing.current() is None
    assert torch.equal(logits, bare)
