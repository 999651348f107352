"""repro_torch's dense model against repro.models on the same weights (the
reference's tree converted 1:1) and the same numpy token inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import list_configs, smoke_config
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax, params_to_jax

ARCHS = ["llama2-7b", "deepseek-7b"]


def _pair(arch, dtype="float32", seed=0):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=dtype)
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.key(seed))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, tm, tp


def _np(t):
    return t.float().numpy()


def _jnp(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_f32(arch):
    """f32: prefill logits and 8 greedy decode steps within 1e-4 (the two
    frameworks sum in different orders); greedy tokens and caches equal."""
    cfg, jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)
                                             ).astype(np.int32)
    jc = jm.init_cache(2, 32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = tm.init_cache(2, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=1e-4, atol=1e-4)
    for _ in range(8):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt[:, None]), tc)
        np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=1e-4, atol=1e-4)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            _np(tc["layers"]["slot_0"][leaf]),
            _jnp(jc["layers"]["slot_0"][leaf]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_bf16(arch):
    """bf16 weights and caches: logits within 2e-2 (bf16 rounds at other
    places in the two frameworks), fed the reference's greedy tokens."""
    cfg, jm, jp, tm, tp = _pair(arch, dtype="bfloat16")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)
                                             ).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 32))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 32))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=2e-2, atol=2e-2)
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=2e-2, atol=2e-2)


def test_decode_past_max_len_clamps_like_reference():
    """Idle slots keep advancing pos; writes clamp to the last cache row
    as dynamic_update_slice does in the reference."""
    cfg, jm, jp, tm, tp = _pair("deepseek-7b")
    toks = np.array([[3, 4, 5]], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 4))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(1, 4))
    for step in range(4):          # positions 3, 4, 5, 6 against max_len 4
        nxt = np.array([[7 + step]], np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=1e-4, atol=1e-4)
    assert int(tc["pos"][0]) == 7
    np.testing.assert_allclose(_np(tc["layers"]["slot_0"]["k"]),
                               _jnp(jc["layers"]["slot_0"]["k"]),
                               rtol=1e-4, atol=1e-4)


def test_left_padded_prefill_matches_reference():
    """Pads (token 0) are attended to, positions are 0..s-1, as in JAX."""
    cfg, jm, jp, tm, tp = _pair("llama2-7b")
    toks = np.array([[0, 0, 0, 9, 8, 7], [1, 2, 3, 4, 5, 6]], np.int32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16))
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       tm.init_cache(2, 16))
    np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=1e-4, atol=1e-4)


def test_params_convert_both_ways_bit_exact():
    cfg, jm, jp, tm, tp = _pair("llama2-7b", dtype="bfloat16")
    wq = tp["layers"]["slot_0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == (cfg.num_layers, cfg.d_model, cfg.num_heads,
                               cfg.head_dim_)
    back = params_to_jax(tp, bfloat16=jnp.bfloat16)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a).view(np.uint8), b.view(np.uint8))
    # the port's own init makes the same tree layout as the reference's
    mine = tm.init_params(seed=0)

    def layout(tree):
        return jax.tree.map(lambda a: (np.shape(a), str(a.dtype)), tree)
    assert layout(jp) == layout(params_to_jax(mine, bfloat16=jnp.bfloat16))


@pytest.mark.parametrize("name", list_configs())
def test_config_registry_matches_reference(name):
    for get in ("get_config", "smoke_config"):
        ref = getattr(jconfigs, get)(name)
        port = getattr(tconfigs, get)(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.params_count() == ref.params_count()


def test_model_defaults_to_the_card():
    cfg = tconfigs.smoke_config("llama2-7b")
    if torch.cuda.is_available():
        assert tbuild(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbuild(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild(tconfigs.smoke_config("dbrx-132b"), device="cpu")
