"""Card-only tests of repro_torch (``gpu`` marker; they skip without a CUDA
card). This file imports no JAX, so it also runs on a machine that has the
card but not the reference package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import TrustDomain
from repro_torch.core.sealing import tree_map
from repro_torch.kernels import chacha20 as C
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


def _serve(device, params, model):
    td = TrustDomain("tdx", device=device)
    eng = Engine(model, params, trust_domain=td, kv_backend="slot",
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
