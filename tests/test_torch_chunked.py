"""repro_torch's chunked attention against repro.models: ``sdpa_chunked``
on the same numpy inputs, and the forward and prefill logits of a dense
and an MLA model with ``parallel.attention_chunk`` on the same weights.

Tolerance: f32 throughout, 1e-5 for the attention outputs and 1e-4 for
logits (rtol and atol; the frameworks sum in different orders), as
tests/test_torch_model.py holds the unchunked model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax

CHUNK = 4
SEQ = 10      # three chunks, the last one short


def _chunked(cfg, chunk):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attention_chunk=chunk))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [3, 4, 16])
def test_sdpa_chunked_matches_reference(causal, chunk):
    """[2, 10, 4 heads over 2 kv heads, 16]: q chunks of ``chunk``, causal
    chunks reading keys up to their last position."""
    rng = np.random.default_rng(chunk)
    q, k, v = (rng.standard_normal((2, SEQ, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.broadcast_to(np.arange(SEQ)[None], (2, SEQ)).astype(np.int32)
    want = jlayers.sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), chunk=chunk, causal=causal,
                                q_positions=jnp.asarray(pos))
    got = tlayers.sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), chunk=chunk,
                               causal=causal, q_positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-v3-671b"])
def test_chunked_forward_and_prefill_match_reference(arch):
    """Smoke deepseek-7b (GQA) and deepseek-v3 (MLA) with
    ``attention_chunk=4`` over 10 tokens: the teacher-forced logits and
    the prefill's last logits and cache equal the reference's, and the
    chunked port model equals the unchunked one."""
    jcfg, tcfg = _chunked(jsmoke(arch), CHUNK), _chunked(tsmoke(arch), CHUNK)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.key(0))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tm._impl.acfg.chunk == CHUNK
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    jl, _ = jm._impl.forward(jp, jnp.asarray(toks))
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    plain, _ = tbuild(tsmoke(arch), device="cpu").forward(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)

    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(2, 16))
    tlast, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                           tm.init_cache(2, 16))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    block = tm._impl.blocks[-1][0]      # "layers" or "moe_layers"
    for leaf, jleaf in jc[block]["slot_0"].items():
        np.testing.assert_allclose(tc[block]["slot_0"][leaf].numpy(),
                                   np.asarray(jleaf), rtol=1e-4, atol=1e-4)
