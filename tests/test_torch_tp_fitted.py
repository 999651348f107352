"""repro_torch's tensor parallelism on fitted specs, and whisper's serving
steps over model shards, against repro on the CPU (a logical ``model=2``
mesh).

Where ``tp`` does not divide a head count the reference's ``_fit`` leaves
the head dims whole and XLA computes that part whole on every device; the
port runs it whole on every model shard
(``tensor_parallel.replicated_kinds``): smoke rwkv6 cut to one head of 64
(its time mix; the channel mix still splits) and smoke whisper with three
heads and one encoder and one decoder layer (its attention; the caches
then split their positions over ``model``, as ``cache_specs`` splits
them). Where ``tp`` divides the query
heads but not the KV heads (smoke deepseek-7b's 4 query and 2 KV heads on
``model=4``), each training shard's query heads share one KV head of the
replicated projections. Each case's sharded train step is held to the reference's
one-device jitted step (a step at the full lr from the same state and
batch: the loss within 1e-4 and each leaf's update within 1e-2 of the
norm of the reference's, as tests/test_torch_sharded_train.py holds
them), and each serving case's prefill and three greedy decode steps to
the reference's one-device jitted steps, logits within 1e-4 (f32 smoke
models; the gaps measured here are below 1e-5). Whisper with three heads
is also held to the reference's prefill and decode jitted on a (1, 2) mesh
of conftest's two host devices with its ``param_specs`` and
``cache_specs``, and plain smoke whisper (heads that split) to the
one-device steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.distributed import sharding as jsharding
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.tensor_parallel import (EncDecParallel,
                                                     TensorParallel,
                                                     TensorParallelLoss,
                                                     gathered_shards)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_to_jax
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from test_torch_sharded_train import (DELTA_TOL, OPT, STEP_LOSS_TOL,
                                      _jleaves, _leaves, _update_gap)

LOGITS_TOL = 1e-4
STEPS = 3


def _one_head(c):
    return dataclasses.replace(c, ssm=dataclasses.replace(c.ssm,
                                                          head_dim=64))


def _three_heads(c):
    return dataclasses.replace(c, num_heads=3, num_kv_heads=3, head_dim=16,
                               encoder_layers=1, decoder_layers=1)


# name -> (arch, config change, what runs whole on every model shard,
# the model axis)
CASES = {"rwkv6-one-head": ("rwkv6-3b", _one_head, "rwkv", 2),
         "whisper-three-heads": ("whisper-small", _three_heads, "attn", 2),
         "deepseek-kv-heads": ("deepseek-7b", lambda c: c, None, 4),
         "whisper": ("whisper-small", lambda c: c, None, 2)}


def cfgs(name):
    arch, change, _, _ = CASES[name]
    return change(jsmoke(arch)), change(tsmoke(arch))


def _params(name):
    """The port's seed-0 params of the case and the same values as the
    reference's tree (f32 smoke models: exact; the reference's eager
    init costs seconds a model)."""
    _, tcfg = cfgs(name)
    tm = tbuild(tcfg, device="cpu")
    params = tm.init_params(0)
    return tm, params, jax.tree.map(jnp.asarray, params_to_jax(params))


def _batch(cfg, seed, b=2, s=4):
    rng = np.random.default_rng(seed)
    seq = cfg.max_target_len if cfg.family == "encdec" else s
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, seq)
                                  ).astype(np.int32),
           "labels": rng.integers(-1, cfg.vocab_size, (b, seq)
                                  ).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)
                                            ).astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["rwkv6-one-head", "whisper-three-heads",
                                  "deepseek-kv-heads"])
def test_fitted_train_step_matches_reference(name):
    jcfg, tcfg = cfgs(name)
    jm = jbuild(jcfg)
    jo = jopt.AdamWConfig(**OPT)
    tm, params, jparams = _params(name)
    jstate = jloop.TrainState(jparams, jopt.init_opt_state(jo, jparams))
    b = _batch(jcfg, 7)
    new, metrics = jax.jit(jloop.make_train_step(jm, jo))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    to = topt.AdamWConfig(**OPT)
    mesh = make_host_mesh(1, CASES[name][3], device="cpu")
    loss = TensorParallelLoss(tm, mesh.groups["model"])
    want = CASES[name][2]
    assert loss.replicated == ({want} if want else set())
    if name == "deepseek-kv-heads":
        assert [loss.kv_head(m) for m in range(4)] == [0, 0, 1, 1]
    else:
        assert loss.kv_head is None
    sspecs = tsharding.state_specs(tcfg, tloop.abstract_train_state(tm, to),
                                   mesh)
    step = tloop.make_sharded_train_step(
        tm, to, mesh, sspecs, tsharding.batch_specs(tcfg, b, mesh))
    placed = tsharding.place(tloop.TrainState(params, topt.init_opt_state(
        to, params)), tsharding.to_named(mesh, sspecs))
    placed, tmetrics = step(placed, b)
    assert abs(float(tmetrics["loss"]) - float(metrics["loss"])) <= \
        STEP_LOSS_TOL * abs(float(metrics["loss"]))
    got = [x for _, x in _leaves(tsharding.gather(placed).params)]
    assert _update_gap(got, _jleaves(jstate.params), _jleaves(new.params),
                       _jleaves(jstate.params)) <= DELTA_TOL


@functools.lru_cache(maxsize=None)
def _reference_serving(name, mesh_run=False):
    """The reference's params and its prefill's and STEPS greedy decode
    steps' logits (one device, or jitted on a (1, 2) mesh with its specs),
    and the tokens fed."""
    jcfg, _ = cfgs(name)
    jm = jbuild(jcfg)
    _, _, jp = _params(name)
    rng = np.random.default_rng(3)
    b, s = 2, 8
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (b, s)
                                                ).astype(np.int32))}
    if jm.is_encdec:
        batch["frames"] = jnp.asarray(rng.standard_normal(
            (b, 12, jcfg.d_model)).astype(np.float32))
    n = 12 if jm.is_encdec else 32
    cache = jm.init_cache(b, n)
    prefill, decode = jm.prefill, jm.decode_step
    if mesh_run:
        mesh = jhost_mesh(1, 2)
        named = lambda t: jsharding.to_named(mesh, t)
        pn = named(jsharding.param_specs(jcfg, jp, mesh))
        cn = named(jsharding.cache_specs(jcfg, cache, mesh))
        bn = named(jsharding.batch_specs(jcfg, batch, mesh))
        tn = named(jsharding.batch_specs(
            jcfg, {"t": jnp.zeros((b, 1), jnp.int32)}, mesh))["t"]
        prefill = jax.jit(prefill, in_shardings=(pn, bn, cn),
                          out_shardings=(None, cn))
        decode = jax.jit(decode, in_shardings=(pn, tn, cn),
                         out_shardings=(None, cn))
    else:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    logits, cache = prefill(jp, batch, cache)
    out, fed = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, cache = decode(jp, jnp.asarray(nxt), cache)
        out.append(np.asarray(logits))
    return jp, {k: np.array(v) for k, v in batch.items()}, fed, out


def _port_serving(name, batch, fed):
    """The port's prefill and decode steps over a logical (1, 2) mesh on
    the same params, fed the reference's tokens."""
    tm, params, _ = _params(name)
    tcfg = tm.cfg
    mesh = make_host_mesh(1, 2, device="cpu")
    placed = tsharding.place(params, tsharding.to_named(
        mesh, tsharding.param_specs(tcfg, params, mesh)))
    b = batch["tokens"].shape[0]
    tokens = torch.from_numpy(batch["tokens"])
    out = []
    with torch.inference_mode():
        shards = gathered_shards(placed, mesh)
        if tm.is_encdec:
            par = EncDecParallel(tm, mesh, local_cache=False)
            cache = tm.init_cache(b, batch["frames"].shape[1])
            logits, cache = par.prefill(shards, torch.from_numpy(
                batch["frames"]), tokens, cache)
            step = lambda t, c: par.decode_step(shards, t, c)
        else:
            par = TensorParallel(tm, mesh, local_cache=False)
            lps = par.layer_params(shards)
            cache = tm.init_cache(b, 32)
            logits, cache = par.prefill(lps, tokens, cache)
            step = lambda t, c: par.decode_step(lps, t, c)
        out.append(logits.numpy().copy())
        for nxt in fed:
            logits, cache = step(torch.from_numpy(nxt), cache)
            out.append(logits.numpy().copy())
    return par, out


@pytest.mark.parametrize("name,mesh_run", [
    ("whisper-three-heads", False), ("whisper-three-heads", True),
    ("whisper", False), ("rwkv6-one-head", False)])
def test_sharded_serving_matches_reference(name, mesh_run):
    _, batch, fed, want = _reference_serving(name, mesh_run)
    par, got = _port_serving(name, batch, fed)
    assert par.replicated == ({CASES[name][2]} if CASES[name][2] else set())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGITS_TOL, atol=LOGITS_TOL)
