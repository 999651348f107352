"""repro_torch's tensor-parallel training step against repro.train on
every family that is not dense (smoke chameleon, dbrx, deepseek-v3 with
MLA, jamba, rwkv6 and whisper), in process: the port's sharded step over
a logical ``model=2`` mesh (and whisper's over ``data=2, model=2``)
against the port's one-device step and the reference's one-device jitted
step, from the reference's initial state converted, on the same
numpy-seeded batches; and a step's collective bytes, which move no
weight over ``model``.

Tolerances are tests/test_torch_sharded_train.py's: over two steps at the
full lr from the first update, each step's loss within 1e-4 and each
leaf's update within 1e-2 of the norm of the compared update, the params
within 2e-2 (tests/test_distributed.py:103), and each step's gradient
norm within 1e-4 of the one-device step's, relative. On the CPU the gaps
measured here are at most 1e-6 in a loss and 2e-4 in a leaf's update
(jamba).

Planted faults fail this file (each tried on a copy of the package): an
identity backward in ``copy_to`` (a replicated value's gradient keeps one
shard's part), the MoE aux loss counted on every model shard, and a clip
norm that counts each replicated leaf once a model shard."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core.sealing import tree_leaves_with_names
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from test_torch_sharded_train import (DELTA_TOL, OPT, PARAM_TOL,
                                      STEP_LOSS_TOL, STEP_SEEDS, _jleaves,
                                      _leaves, _max_diff, _update_gap)
from test_torch_train import _state_from_jax

ARCHS = ["chameleon-34b", "dbrx-132b", "deepseek-v3-671b", "jamba-v0.1-52b",
         "rwkv6-3b", "whisper-small"]
# (arch, (data, model)): every family on model=2, whisper also on 2 x 2
CASES = [(a, (1, 2)) for a in ARCHS] + [("whisper-small", (2, 2))]
BATCH, SEQ = 4, 16
# each step's global gradient norm against the one-device step's,
# relative: the f32 sums run in another order (measured at most 2e-6);
# a norm that counts each replicated leaf once a model shard is 10-40 %
# off (the smoke gradients' norm stays under the clip of 1.0, so the
# updates alone would not show it)
NORM_TOL = 1e-4
# smoke jamba's one group cut from 8 slots to 2, which keeps every layer
# kind (Mamba + SwiGLU, then attention + MoE): the reference's jitted step
# on 8 slots takes about 30 s to trace and compile on the CPU
CUTS = {"jamba-v0.1-52b": dict(num_layers=2, attn_period=2)}


def cfgs(arch, capacity_factor=None):
    """(reference config, port config) of the smoke arch (cut by
    :data:`CUTS`), at ``capacity_factor`` when given."""
    out = []
    for smoke in (jsmoke, tsmoke):
        cfg = dataclasses.replace(smoke(arch), **CUTS.get(arch, {}))
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def batch(cfg, seed):
    """A numpy batch of BATCH rows (whisper's with frames and its target
    length)."""
    rng = np.random.default_rng(seed)
    seq = cfg.max_target_len if cfg.family == "encdec" else SEQ
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, seq)
                                  ).astype(np.int32),
           "labels": rng.integers(-1, cfg.vocab_size, (BATCH, seq)
                                  ).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((BATCH, SEQ, cfg.d_model)
                                            ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def reference(arch, capacity_factor=None):
    """The reference's initial state and its one-device jitted step (one
    compile), two steps: the losses and the params before and after
    each."""
    jcfg, _ = cfgs(arch, capacity_factor)
    jm = jbuild(jcfg)
    jo = jopt.AdamWConfig(**OPT)
    state = jloop.init_train_state(jm, jo, jax.random.key(0))
    step = jax.jit(jloop.make_train_step(jm, jo))
    losses, params, st = [], [_jleaves(state.params)], state
    for seed in STEP_SEEDS:
        st, metrics = step(st, {k: jnp.asarray(v) for k, v in
                                batch(jcfg, seed).items()})
        losses.append(float(metrics["loss"]))
        params.append(_jleaves(st.params))
    return state, losses, params


def port_runs(arch, shape, capacity_factor=None):
    """The port's sharded step over a logical ``shape`` mesh and its
    one-device step from the reference's converted state, two steps:
    {"sharded"|"one": (losses, params after each step)}, the last
    metrics, the sharded state, its specs and mesh."""
    jstate, _, _ = reference(arch, capacity_factor)
    state = _state_from_jax(jstate)
    _, tcfg = cfgs(arch, capacity_factor)
    tm = tbuild(tcfg, device="cpu")
    to = topt.AdamWConfig(**OPT)
    mesh = make_host_mesh(*shape, device="cpu")
    sspecs = tsharding.state_specs(tcfg, tloop.abstract_train_state(tm, to),
                                   mesh)
    batches = [batch(tcfg, s) for s in STEP_SEEDS]
    step = tloop.make_sharded_train_step(
        tm, to, mesh, sspecs, tsharding.batch_specs(tcfg, batches[0], mesh))
    placed = tsharding.place(state, tsharding.to_named(mesh, sspecs))
    runs = {"sharded": ([], [], []), "one": one_device_run(arch,
                                                         capacity_factor)}
    for b in batches:
        placed, metrics = step(placed, b)
        runs["sharded"][0].append(float(metrics["loss"]))
        runs["sharded"][1].append([x for _, x in _leaves(
            tsharding.gather(placed).params)])
        runs["sharded"][2].append(float(metrics["grad_norm"]))
    return runs, metrics, placed, sspecs, mesh


@functools.lru_cache(maxsize=None)
def one_device_run(arch, capacity_factor=None):
    """The port's one-device step from the reference's converted state on
    the same batches (shared by every mesh shape of an arch): (losses,
    params after each step, grad norms)."""
    jstate, _, _ = reference(arch, capacity_factor)
    _, tcfg = cfgs(arch, capacity_factor)
    tm = tbuild(tcfg, device="cpu")
    one_step = tloop.make_train_step(tm, topt.AdamWConfig(**OPT))
    one, out = _state_from_jax(jstate), ([], [], [])
    for seed in STEP_SEEDS:
        one, m = one_step(one, batch(tcfg, seed))
        out[0].append(float(m["loss"]))
        out[1].append([x for _, x in _leaves(one.params)])
        out[2].append(float(m["grad_norm"]))
    return out


def assert_matches(arch, shape, capacity_factor=None):
    """The sharded run's losses, params and each leaf's update against the
    reference's and the one-device run's (the module docstring's
    tolerances); the state rests in its ``state_specs`` shards. Returns
    the sharded run's last metrics."""
    _, jlosses, jparams = reference(arch, capacity_factor)
    runs, metrics, placed, sspecs, mesh = port_runs(arch, shape,
                                                    capacity_factor)
    losses, params, norms = runs["sharded"]
    one_losses, one_params, one_norms = runs["one"]
    for want in (jlosses, one_losses):
        for loss, w in zip(losses, want):
            assert abs(loss - w) < STEP_LOSS_TOL, (losses, want)
    for norm, w in zip(norms, one_norms):
        assert abs(norm - w) < NORM_TOL * w, (norms, one_norms)
    assert _max_diff(params[-1], jparams[-1]) < PARAM_TOL
    assert _max_diff(params[-1], one_params[-1]) < PARAM_TOL
    for k in range(len(STEP_SEEDS)):
        before = params[k - 1] if k else jparams[0]
        one_before = one_params[k - 1] if k else jparams[0]
        assert _update_gap(params[k], before, jparams[k + 1],
                           jparams[k]) < DELTA_TOL, k
        assert _update_gap(params[k], before, one_params[k],
                           one_before) < DELTA_TOL, k
    sizes = {"data": shape[0], "model": shape[1]}
    for (name, leaf), (_, spec) in zip(tree_leaves_with_names(placed),
                                       tree_leaves_with_names(sspecs)):
        assert leaf.named.spec == spec, name
        want = tuple(d // sizes[ax] if ax else d
                     for d, ax in zip(leaf.shape, spec))
        for coords in tsharding.local_coords(mesh):
            assert tuple(leaf.shard(coords).shape) == want, name
    return metrics


@pytest.mark.parametrize("arch,shape", CASES)
def test_tp_step_matches_reference_and_one_device(arch, shape):
    """Two tensor-parallel steps of each family against the reference's
    jitted one-device step and the port's one-device step: losses, params
    and each leaf's update; the state rests in its shards."""
    metrics = assert_matches(arch, shape)
    assert metrics["collective_bytes"] > 0


def tp_step_bytes(cfg, rows: int, seq: int, tp: int) -> int:
    """What a dense model's step on a ``model=tp`` mesh (no data axis, no
    FSDP, one microbatch, remat "full") moves into a shard, by reckoning:
    no weight; per layer the attention's and the FFN's partials reduced
    (T x d each, T = rows x seq) going forward, again in remat's
    recompute, and the normed rows' cotangents all-reduced going backward;
    the embedding's reduction; the f32 logits' gather (T x vocab / tp)
    and the f32 final rows' cotangents; the norm's partial sums, one f32
    a split leaf."""
    t, d, w = rows * seq, cfg.d_model, 4          # f32 smoke
    split = 8               # the table, each layer stack's 7 matrices
    return (tp - 1) * (t * d * w * (1 + 6 * cfg.num_layers + 1)
                       + t * cfg.vocab_size // tp * 4 + 4 * split)


def test_tp_step_moves_no_weights_over_model():
    """On ``model=2`` without FSDP a step's collectives move exactly the
    reckoned activations and partial sums (:func:`tp_step_bytes`): the
    params are never gathered over ``model``, whose weights alone would
    add their size."""
    _, tcfg = cfgs("deepseek-7b")
    tm = tbuild(tcfg, device="cpu")
    to = topt.AdamWConfig(**OPT)
    mesh = make_host_mesh(1, 2, device="cpu")
    state = tloop.init_train_state(tm, to, 0)
    sspecs = tsharding.state_specs(tcfg, state, mesh)
    b = batch(tcfg, 7)
    step = tloop.make_sharded_train_step(
        tm, to, mesh, sspecs, tsharding.batch_specs(tcfg, b, mesh))
    _, metrics = step(tsharding.place(state, tsharding.to_named(mesh,
                                                                sspecs)), b)
    assert metrics["collective_bytes"] == tp_step_bytes(tcfg, BATCH, SEQ, 2)


def test_adamw_chunks_change_no_bit(monkeypatch):
    """``adamw_leaf`` on a leaf above ``ADAMW_CHUNK`` elements (which keeps
    the f32 temporaries of a full-width expert stack in bounds) gives one
    pass's bits, on a strided block of a bf16 leaf as the sharded step
    hands it and on an f32 leaf."""
    rng = np.random.default_rng(3)
    cfg = topt.AdamWConfig(**OPT)
    scalars = topt.adamw_scalars(cfg, torch.tensor(2, dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float32):
        p, g, m, v = (torch.from_numpy(rng.standard_normal((64, 300))
                                       .astype(np.float32)).to(dtype)[:, 50:250]
                      for _ in range(4))
        v = v.abs()
        whole = topt.adamw_leaf(cfg, scalars, p, g, m, v)
        monkeypatch.setattr(topt, "ADAMW_CHUNK", 997)
        chunked = topt.adamw_leaf(cfg, scalars, p, g, m, v)
        monkeypatch.setattr(topt, "ADAMW_CHUNK", 1 << 26)
        for a, b in zip(whole, chunked):
            assert a.dtype == b.dtype and torch.equal(a, b)
