"""The plain reference against the port at a smoke size on the CPU, and
the lower-precision control against the served tokens."""

import numpy as np
import pytest
import torch

from teebench import check, spec
from teebench.client import RequestRecord
from teebench.traffic import RequestSpec

import smoke


def _program(cfg, seed):
    from repro_torch.models import build_model
    from teebench.program import make_params
    model = build_model(smoke.model_cfg(cfg), device="cpu")
    return model, make_params(cfg, seed, model.abstract_params(),
                              device="cpu")


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 1])
def test_reference_matches_the_port_in_f32(seed):
    cfg = dict(smoke.CFG)
    model, params = _program(cfg, seed)
    tokens = torch.arange(1, 25).reshape(2, 12) * 7 % 255 + 1
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": tokens})
    got = spec.reference(cfg).logits(cfg, seed, [t.numpy() for t in tokens],
                                     [(0, 12)] * 2, device="cpu")
    for w, g in zip(want, got):
        assert torch.allclose(w, g, atol=2e-5, rtol=1e-5)


def _served(cfg, seed, prompt, n_new, bucket):
    """Greedy tokens of the port's own prefill and decode steps (the
    engine's left-padded layout), as a client record."""
    model, params = _program(cfg, seed)
    toks = np.zeros(bucket, np.int32)
    toks[bucket - len(prompt):] = prompt
    cache = model.init_cache(1, 64)
    out = []
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)[None]},
                                  cache)
        for _ in range(n_new):
            out.append(int(lg.argmax(-1)))
            lg, cache = model.decode_step(
                params, torch.tensor([[out[-1]]], dtype=torch.int32), cache)
    rec = RequestRecord(RequestSpec(0.0, np.asarray(prompt, np.int32), n_new),
                        bucket)
    rec.tokens = out
    return rec


def test_control_in_fp8_reads_far_above_the_bf16_program():
    """At bf16 the port's greedy tokens sit on the reference's best or a
    rounding's width below it; the fp8 control's first choices sit far
    below on the same sequences."""
    cfg = dict(smoke.CFG, torch_dtype="bfloat16")
    rng = np.random.default_rng(0)
    recs = [_served(cfg, 11, rng.integers(1, 256, n), 20, 32)
            for n in (9, 17, 30)]
    got = check.compare(spec.reference(cfg), cfg, 11, recs, device="cpu",
                        control=True)
    assert got["tokens_compared"] == 60
    assert got["control_max_logit_gap"] >= 3 * max(got["max_logit_gap"],
                                                   1e-3)


def test_sequence_lays_out_the_bucket_and_served_tokens():
    rec = RequestRecord(RequestSpec(0.0, np.array([5, 6, 7], np.int32), 3),
                        8)
    rec.tokens = [9, 10, 11]
    seq, (a, b) = check.sequence(rec)
    assert seq.tolist() == [0, 0, 0, 0, 0, 5, 6, 7, 9, 10]
    assert (a, b) == (7, 10)
