"""repro_torch's training stack against repro.train, repro.data and
repro.models on the same numpy-seeded inputs and the same weights (the
reference's tree converted 1:1): the model's loss and gradients, AdamW,
the train step with and without microbatches, the train loop, the packed
data and the straggler monitor. Checkpoints, restart-resume, compression,
the train state's specs and the launcher are in
tests/test_torch_train_ckpt.py.

Tolerances (f32 smoke configs): losses within 1e-5 (rtol and atol),
gradients within 1e-5 relative to each leaf's largest entry; AdamW's
moments and params within 1e-6 relative, since ``b ** step`` and ``cos``
may differ by an ulp between jnp and torch (1e-2 where a leaf is bf16: an
ulp of difference may round it the other way); a train step's params
within 1e-4 relative to each leaf's largest entry (a gradient at rounding
noise can turn AdamW's first step by up to lr). Data batches are
bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.data import pipeline as jdata
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import list_configs
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core.sealing import tree_leaves_with_names
from repro_torch.data import pipeline as tdata
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _jflat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(l, np.float32)
             if np.asarray(l).dtype.name == "bfloat16" else np.asarray(l))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tflat(tree):
    return [(n, l.detach().float().numpy() if l.dtype == torch.bfloat16
             else l.detach().numpy())
            for n, l in tree_leaves_with_names(tree)]


def _assert_trees_close(got, want, rel, what=""):
    """Same names in the same order; each leaf within ``rel`` of the
    leaf's largest magnitude (and 1e-30 absolute)."""
    g, w = _tflat(got), _jflat(want)
    assert [n for n, _ in g] == [n for n, _ in w], what
    for (name, a), (_, b) in zip(g, w):
        scale = max(float(np.max(np.abs(b), initial=0.0)), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                                   err_msg=f"{what}{name}")


def _state_from_jax(state):
    """A reference TrainState as the port's (bf16 as its bits)."""
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return tloop.TrainState(
        params_from_jax(np_tree(state.params), "cpu"),
        topt.OptState(params_from_jax(np_tree(state.opt.m), "cpu"),
                      params_from_jax(np_tree(state.opt.v), "cpu"),
                      torch.tensor(int(state.opt.step), dtype=torch.int32)))


@pytest.fixture(scope="module")
def setup():
    """Smoke deepseek-7b in both packages on the reference's weights, and
    the reference's initial train state converted."""
    jm, tm = jbuild(jsmoke("deepseek-7b")), tbuild(tsmoke("deepseek-7b"),
                                                   device="cpu")
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jstate = jloop.init_train_state(jm, jo, jax.random.key(0))
    return jm, tm, jo, to, jstate, _state_from_jax(jstate)


def _batch(seed=0, b=4, s=32):
    return next(iter(tdata.PackedLMDataset(batch_size=b, seq_len=s,
                                           seed=seed)))


def _with_chunks(cfg, loss_chunk, attention_chunk=0):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, loss_chunk=loss_chunk, attention_chunk=attention_chunk))


def _arch_batch(cfg, rng, b=2, s=16):
    if cfg.family == "encdec":
        t = cfg.max_target_len
        return {"frames": rng.standard_normal((b, s, cfg.d_model)
                                              ).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, t)
                                       ).astype(np.int32),
                "labels": rng.integers(-1, cfg.vocab_size, (b, t)
                                       ).astype(np.int32)}
    tokens = (rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
              if cfg.embedding_inputs
              else rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    return {"tokens": tokens,
            "labels": rng.integers(-1, cfg.vocab_size, (b, s)
                                   ).astype(np.int32)}


# ---------------------------------------------------------------------------
# the model's training surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [(0, 0), (5, 0), (4, 4)],
                         ids=["plain", "loss_chunk", "both_chunks"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "whisper-small"])
def test_loss_matches_reference(arch, chunks):
    """``Model.loss`` (and its metrics) on 16 tokens with masked labels,
    with and without ``loss_chunk`` (and ``attention_chunk``; whisper's
    attention has no chunk, as in the reference)."""
    jcfg, tcfg = (_with_chunks(c(arch), *chunks) for c in (jsmoke, tsmoke))
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jp = jm.init_params(jax.random.key(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _arch_batch(jcfg, np.random.default_rng(1))
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    for k in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-v3-671b"])
def test_grads_match_reference(arch):
    """``jax.grad`` of the loss and the port's autograd, leaf by leaf (the
    MLA + MoE model also carries the router's aux loss), under the
    config's remat ("full")."""
    jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch), device="cpu")
    assert tm.cfg.parallel.remat == "full"
    jp = jm.init_params(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _arch_batch(jm.cfg, np.random.default_rng(2))
    jg = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()})[0])(jp)
    _, _, tg = tloop.value_and_grad(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_trees_close(tg, jg, 1e-5)


@pytest.mark.parametrize("remat", ["none", "full", "dots_saveable"])
def test_remat_policies_give_the_same_grads(remat):
    """Recomputation changes memory, not results: each policy's gradients
    equal the no-remat ones bit for bit on the CPU."""
    cfg = tsmoke("jamba-v0.1-52b")
    tm = tbuild(cfg, device="cpu")
    tp = tm.init_params(0)
    batch = {k: torch.from_numpy(v)
             for k, v in _arch_batch(cfg, np.random.default_rng(4)).items()}
    base = tbuild(dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, remat="none")), device="cpu")
    want = tloop.value_and_grad(base, tp, batch)[2]
    got = tloop.value_and_grad(tbuild(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, remat=remat)),
        device="cpu"), tp, batch)[2]
    for (n, a), (_, b) in zip(tree_leaves_with_names(got),
                              tree_leaves_with_names(want)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", list_configs())
def test_every_arch_loss_and_grads_finite(arch):
    """tests/test_models.py's smoke check on the port: a finite loss and
    finite gradients for every registered config's smoke model."""
    cfg = tsmoke(arch)
    tm = tbuild(cfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _arch_batch(cfg, np.random.default_rng(0)).items()}
    loss, metrics, grads = tloop.value_and_grad(tm, tm.init_params(0), batch)
    assert np.isfinite(float(loss)) and np.isfinite(float(metrics["ce_loss"]))
    for name, g in tree_leaves_with_names(grads):
        assert torch.isfinite(g.float()).all(), name


def test_abstract_structures_are_meta(setup):
    """``abstract_params``/``abstract_train_state`` and the input specs
    are meta tensors of the reference's ShapeDtypeStructs' shapes."""
    from repro.configs import SHAPES as J_SHAPES
    from repro_torch.configs import SHAPES
    jm, tm, jo, to, _, _ = setup
    jabs = jloop.abstract_train_state(jm, jo)
    tabs = tloop.abstract_train_state(tm, to)
    got = [(n, tuple(l.shape), l.device.type)
           for n, l in tree_leaves_with_names(tabs)]
    want = [(jax.tree_util.keystr(p), tuple(l.shape), "meta")
            for p, l in jax.tree_util.tree_flatten_with_path(jabs)[0]]
    assert got == want
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            t, j = getattr(tm, fn)(SHAPES[name]), getattr(jm, fn)(J_SHAPES[name])
            assert {k: tuple(v.shape) for k, v in t.items()} == \
                {k: tuple(v.shape) for k, v in j.items()}
        assert tuple(tm.decode_token_specs(SHAPES[name]).shape) == \
            jm.decode_token_specs(J_SHAPES[name]).shape
    small = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=2)
    jsmall = dataclasses.replace(J_SHAPES["decode_32k"], seq_len=64,
                                 global_batch=2)
    assert [tuple(l.shape) for _, l in tree_leaves_with_names(
        tm.cache_specs(small))] == [tuple(l.shape) for l in
                                    jax.tree.leaves(jm.cache_specs(jsmall))]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=1, total_steps=6),
               dict(lr=1e-3, warmup_steps=0, total_steps=0)):
        tc, jc = topt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
        for step in range(0, 120, 3):
            np.testing.assert_allclose(
                float(topt.lr_schedule(tc, torch.tensor(step))),
                float(jopt.lr_schedule(jc, jnp.asarray(step))), rtol=1e-6,
                atol=1e-9)
    tc = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(topt.lr_schedule(tc, torch.tensor(0))) == 0.0
    assert abs(float(topt.lr_schedule(tc, torch.tensor(10))) - 1.0) < 1e-6


@pytest.mark.parametrize("moments,params_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_adamw_matches_reference(moments, params_dtype):
    """Ten AdamW updates (clipping on: the grads' norm is about 8x the
    clip) on numpy-seeded params and grads: params, moments, step,
    ``grad_norm`` and ``lr`` as the reference's."""
    rng = np.random.default_rng(5)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, moment_dtype=moments)
    tc, jc = topt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    jdt = jnp.dtype(params_dtype)
    p0 = {"a": rng.standard_normal((8, 4)).astype(np.float32),
          "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jopt.init_opt_state(jc, jp), topt.init_opt_state(tc, tp)
    assert ts.m["a"].dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[moments]
    for i in range(10):
        g = jax.tree.map(lambda x: np.asarray(
            rng.standard_normal(x.shape) * 2.0, np.float32), p0)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        tg = params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        jp, js, jmet = jopt.adamw_update(jc, jp, jg, js)
        tp, ts, tmet = topt.adamw_update(tc, tp, tg, ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
        # a bf16 leaf may round the other way after an ulp of difference
        rel = 1e-6 if params_dtype == "float32" and moments == "float32" \
            else 1e-2
        _assert_trees_close(tp, jp, rel, "params")
        _assert_trees_close(ts.m, js.m, rel, "m")
        _assert_trees_close(ts.v, js.v, rel, "v")
        assert int(ts.step) == int(js.step) == i + 1


def test_adamw_reference_cases():
    """tests/test_train.py's optimizer cases, on the port."""
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init_opt_state(cfg, params)
    for _ in range(60):
        params, state, _ = topt.adamw_update(cfg, params,
                                             {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.5
    cfg = topt.AdamWConfig(lr=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros(10)}
    _, _, metrics = topt.adamw_update(cfg, params, {"w": torch.full((10,), 1e6)},
                                      topt.init_opt_state(cfg, params))
    assert float(metrics["grad_norm"]) > 1e6  # reported before clipping
    big = {"a": torch.full((3,), 4.0), "b": {"c": torch.full((4,), -3.0)}}
    clipped, norm = topt.clip_by_global_norm(big, 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), big), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-7)
    _assert_trees_close(clipped, jclipped, 1e-7)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step and loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(setup, microbatches):
    """One step from the same state on the same batch: the loss and
    metrics, and the new params, moments and step. With 2 microbatches
    the gradients accumulate in f32, then divide."""
    jm, tm, jo, to, jstate, tstate = setup
    batch = _batch()
    js, jmet = jax.jit(jloop.make_train_step(
        jm, jo, microbatches=microbatches))(jstate, batch)
    ts, tmet = tloop.make_train_step(tm, to, microbatches=microbatches)(
        tstate, batch)
    for k in ("loss", "ce_loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_trees_close(ts.params, js.params, 1e-4, "params")
    _assert_trees_close(ts.opt.m, js.opt.m, 1e-4, "m")
    assert int(ts.opt.step) == int(js.opt.step) == 1
    # the caller's state is left as it was
    assert int(tstate.opt.step) == 0


def test_microbatching_matches_full_batch_loss(setup):
    """tests/test_train.py's case on the port: 1 vs 2 microbatches on one
    batch give the same first-step loss and close params; one microbatch
    keeps the grads' dtype, two accumulate in f32."""
    _, tm, _, to, _, tstate = setup
    batch = _batch()
    seen = []

    def record(g):
        seen.append({n: l.dtype for n, l in tree_leaves_with_names(g)})
        return g
    s1, m1 = tloop.make_train_step(tm, to, grad_transform=record)(tstate,
                                                                   batch)
    s2, m2 = tloop.make_train_step(tm, to, microbatches=2,
                                   unroll_microbatches=True,
                                   grad_transform=record)(tstate, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    d = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_leaves_with_names(s1.params), tree_leaves_with_names(s2.params)))
    assert d < 5e-2
    assert set(seen[1].values()) == {torch.float32}
    bf16 = dataclasses.replace(tsmoke("deepseek-7b"), dtype="bfloat16")
    bm = tbuild(bf16, device="cpu")
    bstate = tloop.init_train_state(bm, to, seed=0)
    tloop.make_train_step(bm, to, grad_transform=record)(bstate, batch)
    tloop.make_train_step(bm, to, microbatches=2, grad_transform=record)(
        bstate, batch)
    assert set(seen[2].values()) == {torch.bfloat16}
    assert set(seen[3].values()) == {torch.float32}


def test_loss_decreases(setup):
    _, tm, _, to, _, tstate = setup
    it = iter(tdata.PackedLMDataset(batch_size=4, seq_len=32, seed=0))
    _, hist = tloop.train_loop(tm, tstate, tloop.make_train_step(tm, to), it,
                               num_steps=8, donate=True)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(h["step_s"] > 0 for h in hist)


def test_straggler_monitor_matches_reference():
    calls = {"t": [], "j": []}
    tm = tloop.StragglerMonitor(0.1, lambda s, d: calls["t"].append((s, d)))
    jm = jloop.StragglerMonitor(0.1, lambda s, d: calls["j"].append((s, d)))
    assert tm.median_s == jm.median_s == 0.0
    for step, dt in enumerate([0.05, 0.5, 0.1, 0.3, 0.01, 0.2]):
        assert tm.observe(step, dt) == jm.observe(step, dt)
        assert tm.median_s == jm.median_s
    assert (tm.history, tm.straggles) == (jm.history, jm.straggles) == \
        ([0.05, 0.5, 0.1, 0.3, 0.01, 0.2], 3)
    assert calls["t"] == calls["j"] == [(1, 0.5), (3, 0.3), (5, 0.2)]


def test_packed_dataset_is_bit_equal():
    assert tdata.synthetic_text(3, 50) == jdata.synthetic_text(3, 50)
    for kw in (dict(batch_size=4, seq_len=32, seed=0),
               dict(batch_size=3, seq_len=100, seed=7),
               dict(text="a tiny corpus.", batch_size=2, seq_len=40)):
        t, j = tdata.PackedLMDataset(**kw), jdata.PackedLMDataset(**kw)
        assert np.array_equal(t.stream, j.stream)
        for a, b in zip(tdata.take(t, 5), jdata.take(j, 5)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert t.state() == j.state()
        t.restore(17)
        j.restore(17)
        assert np.array_equal(next(t)["tokens"], next(j)["tokens"])
