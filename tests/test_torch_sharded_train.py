"""repro_torch's sharded training against repro.distributed and repro.train
on conftest's 2 forced host devices, in process: the sharded train step
over logical meshes against the reference's jitted step on a (2, 1) mesh
and against the one-device step (the same weights, the reference's tree
converted, and the same numpy-seeded batch); GPipe against sequential
stages and the reference's ``make_gpipe``; checkpoints saved on one mesh
and restored on another, crossing packages; restart-resume on a placed
state; the launcher's ``--data-mesh``/``--model-mesh``.

Tolerances: the sharded step's params within 2e-2 (max abs) of the
reference's sharded step and of the one-device step
(tests/test_distributed.py:103), and tighter than that reference test:
over two steps at the full lr from the first update, each step's loss
within 1e-4 (the reference test's is 1e-3) and each leaf's update (new
minus old params) within 1e-2 of the norm of the reference's and the
one-device step's update of that leaf; GPipe's output within 1e-4 and its
gradient within 1e-3 (tests/test_distributed.py:157,161); checkpoints,
restores and restart-resume bit for bit."""

import dataclasses
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.train.checkpoint as jckpt
from repro.configs import smoke_config as jsmoke
from repro.core import SealingKey as JKey
from repro.core import TrustDomain as JTD
from repro.distributed import sharding as jsharding
from repro.distributed.compat import make_mesh
from repro.distributed.pipeline import make_gpipe as jmake_gpipe
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import SealingKey as TKey
from repro_torch.core import TrustDomain as TTD
from repro_torch.core.sealing import tree_leaves_with_names
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.collectives import LocalGroup
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     reshard_state,
                                                     run_with_restarts)
from repro_torch.distributed.pipeline import make_gpipe
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from test_torch_train import _state_from_jax

ROOT = Path(__file__).resolve().parents[1]
# lr_schedule gives update 1 the full lr at a warmup of 1 step, so every
# parameter moves by about lr (AdamW's first update is lr x sign(g))
OPT = dict(lr=1e-3, warmup_steps=1)
PARAM_TOL = 2e-2                          # tests/test_distributed.py:103
# the step's losses (the second taken after the first update) and each
# leaf's update relative to the norm of the compared update: on the CPU
# the measured gaps are at most 5e-7 and 8e-4 against the reference, and
# a step that drops the gradient all-reduce, trains on half the batch or
# skips AdamW's update misses them by orders of magnitude
STEP_LOSS_TOL, DELTA_TOL = 1e-4, 1e-2
GPIPE_TOL = (1e-4, 1e-3)                  # tests/test_distributed.py:157,161
ARCH = "qwen3-32b"
VARIANTS = {"base": {}, "fsdp": {"fsdp": True}, "zero1": {"zero1": True}}
# (variant, (data, model), microbatches)
CASES = [("base", (2, 1), 1), ("base", (1, 2), 1), ("base", (2, 2), 1),
         ("fsdp", (2, 2), 2), ("zero1", (2, 2), 1)]


def _cfgs(variant):
    par = VARIANTS[variant]
    out = []
    for smoke in (jsmoke, tsmoke):
        cfg = smoke(ARCH)
        out.append(dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, **par)))
    return out


def _batch(b=4, s=32, seed=7):
    rng = np.random.default_rng(seed)
    vocab = tsmoke(ARCH).vocab_size
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(-1, vocab, (b, s)).astype(np.int32)}


def _leaves(tree):
    return [(n, t.detach().float().numpy()) for n, t in
            tree_leaves_with_names(tree)]


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _max_diff(a, b):
    return max(float(np.max(np.abs(x - y), initial=0.0))
               for x, y in zip(a, b))


def _update_gap(new, old, want_new, want_old):
    """The largest, over leaves, of |update - wanted update| / |wanted
    update| (Frobenius norms; an update is new minus old params)."""
    gaps = []
    for a, b, c, d in zip(new, old, want_new, want_old):
        want = c - d
        gaps.append(float(np.linalg.norm((a - b) - want))
                    / max(float(np.linalg.norm(want)), 1e-30))
    return max(gaps)


def _equal(a, b):
    """Two port trees (placed or whole) leaf for leaf, bit for bit."""
    a, b = tsharding.gather(a), tsharding.gather(b)
    for (n, x), (_, y) in zip(tree_leaves_with_names(a),
                              tree_leaves_with_names(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), n


STEP_SEEDS = (7, 8)                       # one batch a step


@functools.lru_cache(maxsize=None)
def _reference(variant, microbatches):
    """The reference's state and its jitted step on a (2, 1) mesh of
    conftest's host devices, two steps: the losses and the params before
    and after each step."""
    jcfg, _ = _cfgs(variant)
    jm = jbuild(jcfg)
    jo = jopt.AdamWConfig(**OPT)
    state = jloop.init_train_state(jm, jo, jax.random.key(0))
    batches = [{k: jnp.asarray(v) for k, v in _batch(seed=s).items()}
               for s in STEP_SEEDS]
    step = jloop.make_train_step(jm, jo, microbatches=microbatches)
    mesh = make_mesh((2, 1), ("data", "model"))
    sspecs = jsharding.state_specs(jcfg, jloop.abstract_train_state(jm, jo),
                                   mesh)
    bspecs = jsharding.batch_specs(jcfg, jax.eval_shape(lambda: batches[0]),
                                   mesh)
    losses, params = [], [_jleaves(state.params)]
    with mesh:
        f = jax.jit(step, in_shardings=(jsharding.to_named(mesh, sspecs),
                                        jsharding.to_named(mesh, bspecs)),
                    out_shardings=(jsharding.to_named(mesh, sspecs), None))
        sharded = state
        for batch in batches:
            sharded, metrics = f(sharded, batch)
            losses.append(float(metrics["loss"]))
            params.append(_jleaves(sharded.params))
    return state, losses, params


def _port(variant, mesh_shape, microbatches, state):
    """The port's sharded step over a logical mesh and its one-device step
    from ``state`` (the reference's, converted), two steps: each one's
    losses and params after each step, the sharded run's last state."""
    _, tcfg = _cfgs(variant)
    tm = tbuild(tcfg, device="cpu")
    to = topt.AdamWConfig(**OPT)
    mesh = make_host_mesh(*mesh_shape, device="cpu")
    sspecs = tsharding.state_specs(tcfg, tloop.abstract_train_state(tm, to),
                                   mesh)
    batches = [_batch(seed=s) for s in STEP_SEEDS]
    bspecs = tsharding.batch_specs(tcfg, batches[0], mesh)
    step = tloop.make_sharded_train_step(tm, to, mesh, sspecs, bspecs,
                                         microbatches=microbatches)
    one_step = tloop.make_train_step(tm, to, microbatches=microbatches)
    out = tsharding.place(state, tsharding.to_named(mesh, sspecs))
    one = state
    runs = {"sharded": ([], []), "one": ([], [])}
    for batch in batches:
        out, metrics = step(out, batch)
        one, one_m = one_step(one, batch)
        for key, st, m in (("sharded", tsharding.gather(out), metrics),
                           ("one", one, one_m)):
            runs[key][0].append(float(m["loss"]))
            runs[key][1].append([x for _, x in _leaves(st.params)])
    return runs, out, metrics, sspecs, mesh


@pytest.mark.parametrize("variant,mesh_shape,microbatches", CASES)
def test_sharded_step_matches_reference_and_one_device(variant, mesh_shape,
                                                       microbatches):
    """The port's step over a logical mesh against the reference's jitted
    step on a (2, 1) mesh and against the one-device step, two steps: each
    loss, the params and each leaf's update; the new state rests in its
    ``state_specs`` shards, each block its shard's slice."""
    jstate, jlosses, jparams = _reference(variant, microbatches)
    runs, out, metrics, sspecs, mesh = _port(
        variant, mesh_shape, microbatches, _state_from_jax(jstate))
    losses, params = runs["sharded"]
    one_losses, one_params = runs["one"]
    for loss, want in zip(losses, jlosses):
        assert abs(loss - want) < STEP_LOSS_TOL, (losses, jlosses)
    for loss, want in zip(losses, one_losses):
        assert abs(loss - want) < STEP_LOSS_TOL, (losses, one_losses)
    assert _max_diff(params[-1], jparams[-1]) < PARAM_TOL
    assert _max_diff(params[-1], one_params[-1]) < PARAM_TOL
    for k in range(len(STEP_SEEDS)):
        before = params[k - 1] if k else jparams[0]
        want_before = jparams[k]
        one_before = one_params[k - 1] if k else jparams[0]
        assert _update_gap(params[k], before, jparams[k + 1],
                           want_before) < DELTA_TOL, k
        assert _update_gap(params[k], before, one_params[k],
                           one_before) < DELTA_TOL, k
    assert int(tsharding.gather_leaf(out.opt.step)) == len(STEP_SEEDS)
    sizes = {"data": mesh_shape[0], "model": mesh_shape[1]}
    for (name, leaf), (_, spec) in zip(tree_leaves_with_names(out),
                                       tree_leaves_with_names(sspecs)):
        assert isinstance(leaf, tsharding.Placed), name
        assert leaf.named.spec == spec, name
        want = tuple(d // int(np.prod([sizes[a] for a in (
            ax if isinstance(ax, tuple) else (ax,))])) if ax else d
            for d, ax in zip(leaf.shape, spec))
        for coords in tsharding.local_coords(mesh):
            assert tuple(leaf.shard(coords).shape) == want, name
    assert metrics["collective_bytes"] > 0


def test_sharded_step_bytes_and_shards():
    """A dp=2 FSDP step's collective bytes: each leaf sharded over
    ``data`` gathers the other half of itself, the f32 gradients' all-reduce
    moves one shard's, and 3 f32 metrics; each shard holds half of each
    sharded leaf."""
    _, tcfg = _cfgs("fsdp")
    tm = tbuild(tcfg, device="cpu")
    to = topt.AdamWConfig(**OPT)
    mesh = make_host_mesh(2, 1, device="cpu")
    state = tloop.init_train_state(tm, to, 0)
    sspecs = tsharding.state_specs(tcfg, state, mesh)
    placed = tsharding.place(state, tsharding.to_named(mesh, sspecs))
    batch = _batch()
    step = tloop.make_sharded_train_step(
        tm, to, mesh, sspecs, tsharding.batch_specs(tcfg, batch, mesh))
    _, metrics = step(placed, batch)
    nbytes = lambda t: t.numel() * t.element_size()
    sharded = sum(nbytes(p) for (_, p), (_, s) in zip(
        tree_leaves_with_names(state.params),
        tree_leaves_with_names(sspecs.params)) if "data" in s)
    n_params = sum(p.numel() for _, p in tree_leaves_with_names(state.params))
    assert sharded > 0
    assert metrics["collective_bytes"] == sharded // 2 + 4 * n_params + 12
    whole = sum(nbytes(t) for _, t in tree_leaves_with_names(state))
    halves = sum(nbytes(t) for (_, t), (_, s) in zip(
        tree_leaves_with_names(state), tree_leaves_with_names(sspecs))
        if "data" in s) // 2
    for coords in [(0, 0), (1, 0)]:
        assert tsharding.shard_nbytes(placed, coords) == whole - halves


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _gpipe_inputs(stages, d=16, seed=5):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((stages, d, d)) * 0.3).astype(np.float32)
    mb = rng.standard_normal((6, 8, d)).astype(np.float32)
    return ws, mb


def _sequential(ws, mb):
    out = mb
    for i in range(ws.shape[0]):
        out = torch.tanh(out @ ws[i])
    return out


@pytest.mark.parametrize("stages", [2, 4])
def test_gpipe_matches_sequential_stages(stages):
    """``make_gpipe`` over a LocalGroup: the sequential stages' output and
    the gradient of sum(out ** 2) by ``torch.autograd.grad``."""
    ws_np, mb_np = _gpipe_inputs(stages)
    ws = torch.from_numpy(ws_np).requires_grad_()
    mb = torch.from_numpy(mb_np)
    pipe = make_gpipe(LocalGroup(stages, "cpu"),
                      lambda w, x: torch.tanh(x @ w))
    out = pipe(ws, mb)
    ref = _sequential(ws, mb)
    assert torch.allclose(out, ref, atol=GPIPE_TOL[0], rtol=0)
    (g,) = torch.autograd.grad((out ** 2).sum(), ws)
    (gr,) = torch.autograd.grad((ref ** 2).sum(), ws)
    assert torch.allclose(g, gr, atol=GPIPE_TOL[1], rtol=0)


def test_gpipe_matches_reference_make_gpipe():
    """Over a LocalGroup(2) against the reference's ``make_gpipe`` on a
    (2, 1) ("pipe", "data") mesh: output and gradient."""
    ws_np, mb_np = _gpipe_inputs(2)
    jmesh = make_mesh((2, 1), ("pipe", "data"))
    jpipe = jmake_gpipe(jmesh, "pipe", lambda w, x: jnp.tanh(x @ w),
                        JP("pipe", None, None), JP(None, None, None),
                        JP(None, None, None))
    jout = np.asarray(jax.jit(jpipe)(ws_np, mb_np))
    jg = np.asarray(jax.jit(jax.grad(
        lambda w: jnp.sum(jpipe(w, mb_np) ** 2)))(ws_np))
    ws = torch.from_numpy(ws_np).requires_grad_()
    out = make_gpipe(LocalGroup(2, "cpu"), lambda w, x: torch.tanh(x @ w))(
        ws, torch.from_numpy(mb_np))
    (g,) = torch.autograd.grad((out ** 2).sum(), ws)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=GPIPE_TOL[0])
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=GPIPE_TOL[1])


# ---------------------------------------------------------------------------
# checkpoints across meshes and packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_setup():
    """The reference's state (one step taken, so the moments are not
    zeros) and the port's converted, with the port's specs and a cfg."""
    jcfg, tcfg = _cfgs("fsdp")
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    js = jloop.init_train_state(jm, jo, jax.random.key(0))
    js, _ = jax.jit(jloop.make_train_step(jm, jo))(
        js, {k: jnp.asarray(v) for k, v in _batch().items()})
    return jcfg, tcfg, jm, tm, jo, to, js, _state_from_jax(js)


def _named(cfg, tm, to, shape):
    mesh = make_host_mesh(*shape, device="cpu")
    return tsharding.to_named(mesh, tsharding.state_specs(
        cfg, tloop.abstract_train_state(tm, to), mesh))


def _files(path):
    path = Path(path)
    return {f.name: f.read_bytes() for f in sorted(path.iterdir())}


@pytest.mark.parametrize("sealed", [False, True], ids=["plain", "sealed"])
def test_save_on_mesh_a_restore_on_mesh_b(ckpt_setup, tmp_path, sealed):
    """Saved from a (2, 1) mesh: the files (manifest, ciphertext, MACs)
    equal a one-device save of the whole state; restored onto (1, 2) and
    (2, 2) meshes and by ``reshard_state``, every leaf bit-equal; the
    reference restores the port's files onto its 2-device mesh, and the
    port restores the reference's, saved from that mesh."""
    jcfg, tcfg, jm, tm, jo, to, js, ts = ckpt_setup
    ttd = TTD("tdx", sealing_key=TKey.generate(b"mesh"), device="cpu") \
        if sealed else None
    jtd = JTD("tdx", sealing_key=JKey.generate(b"mesh")) if sealed else None
    a = tsharding.place(ts, _named(tcfg, tm, to, (2, 1)))
    pa = tckpt.save_checkpoint(tmp_path / "a", 3, a, trust_domain=ttd)
    p1 = tckpt.save_checkpoint(tmp_path / "one", 3, ts, trust_domain=ttd)
    assert _files(pa) == _files(p1)
    for shape in [(1, 2), (2, 2)]:
        named = _named(tcfg, tm, to, shape)
        b = tckpt.restore_checkpoint(tmp_path / "a", 3, a, trust_domain=ttd,
                                     shardings=named)
        assert tsharding.placement(b) == named
        _equal(b, ts)
        _equal(reshard_state(a, named), ts)
    # the reference restores the port's files onto its (2, 1) mesh
    jmesh = make_mesh((2, 1), ("data", "model"))
    jnamed = jsharding.to_named(jmesh, jsharding.state_specs(
        jcfg, jloop.abstract_train_state(jm, jo), jmesh))
    jb = jckpt.restore_checkpoint(tmp_path / "a", 3, js, trust_domain=jtd,
                                  shardings=jnamed)
    for x, y in zip(jax.tree.leaves(jb), jax.tree.leaves(js)):
        assert x.dtype == y.dtype and bool(jnp.all(x == y))
    # the port restores the reference's, saved from its 2-device mesh
    jplaced = jax.tree.map(jax.device_put, js, jnamed)
    jckpt.save_checkpoint(tmp_path / "j", 3, jplaced, trust_domain=jtd)
    assert _files(tmp_path / "j" / "step_3") == _files(pa)
    back = tckpt.restore_checkpoint(tmp_path / "j", 3, ts, trust_domain=ttd,
                                    shardings=_named(tcfg, tm, to, (1, 2)))
    _equal(back, ts)


def test_run_with_restarts_on_a_placed_state(ckpt_setup, tmp_path):
    """A placed (2, 2) state through sealed checkpoints every 2 steps and
    failures at steps 3 and 6 gives the uninterrupted sharded run's losses
    and final state, bit for bit, and resumes onto its shards."""
    _, tcfg, _, tm, _, to, _, ts = ckpt_setup
    named = _named(tcfg, tm, to, (2, 2))
    mesh = named.opt.step.mesh
    sspecs = tsharding.state_specs(tcfg, tloop.abstract_train_state(tm, to),
                                   mesh)
    placed = tsharding.place(ts, named)
    step = tloop.make_sharded_train_step(
        tm, to, mesh, sspecs, tsharding.batch_specs(tcfg, _batch(), mesh))

    def data_factory(cursor):
        it = iter(tdata.PackedLMDataset(batch_size=4, seq_len=32, seed=0))
        for _ in range(cursor):
            next(it)
        return it

    clean, losses, r0 = run_with_restarts(
        state=placed, train_step=step, data_factory=data_factory,
        num_steps=8, manager=tckpt.CheckpointManager(tmp_path / "a"),
        checkpoint_every=2)
    td = TTD("tdx", device="cpu")
    resumed = []

    class Manager(tckpt.CheckpointManager):
        def resume(self, like, device=None, shardings=None):
            out = super().resume(like, device, shardings)
            resumed.append(tsharding.placement(out[1]))
            return out

    faulty, flosses, r = run_with_restarts(
        state=placed, train_step=step, data_factory=data_factory,
        num_steps=8, manager=Manager(tmp_path / "b", trust_domain=td),
        checkpoint_every=2, injector=FailureInjector(fail_at={3, 6}))
    assert (r0, r) == (0, 2) and flosses == losses
    assert resumed == [named, named]
    _equal(faulty, clean)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_JRESTORE = """
import hashlib, json, sys
import jax, numpy as np
from repro.configs import smoke_config
from repro.core import SealingKey, TrustDomain
from repro.distributed import sharding
from repro.distributed.compat import make_mesh
from repro.models import build_model
from repro.train.checkpoint import restore_checkpoint
from repro.train.optimizer import AdamWConfig
from repro.train.train_loop import abstract_train_state
cfg = smoke_config("deepseek-7b")
m = build_model(cfg)
like = abstract_train_state(m, AdamWConfig(moment_dtype=cfg.parallel.optimizer_dtype))
mesh = make_mesh((4, 1), ("data", "model"))
named = sharding.to_named(mesh, sharding.state_specs(cfg, like, mesh))
td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"launch"))
st = restore_checkpoint(sys.argv[1], int(sys.argv[2]), like, trust_domain=td,
                        shardings=named)
print(json.dumps([hashlib.sha256(np.asarray(x).tobytes()).hexdigest()
                  for x in jax.tree.leaves(st)]))
"""


def test_launcher_mesh_flags_and_elastic_restore(monkeypatch, tmp_path,
                                                 capsys):
    """``launch.train --data-mesh 2 --model-mesh 2`` on logical shards
    with sealed checkpoints and a failure drill prints the reference
    launcher's ``mesh:`` line and report lines; its last checkpoint
    restores onto a (4, 1) mesh through ``reshard_state`` in the port, and
    onto a (4, 1) mesh of 4 host devices in the reference, leaf for leaf
    the same bytes."""
    monkeypatch.setattr(tlaunch, "TrustDomain", functools.partial(
        TTD, sealing_key=TKey.generate(b"launch")))
    out = tmp_path / "ck"
    tlaunch.main(["--arch", "deepseek-7b", "--smoke", "--steps", "4",
                  "--seq", "32", "--tee", "tdx", "--ckpt-dir", str(out),
                  "--ckpt-every", "2", "--fail-at", "2", "--data-mesh", "2",
                  "--model-mesh", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [
        "mesh: {'data': 2, 'model': 2}",
        "arch=deepseek-7b-smoke params=0.1M (active 0.1M) tee=tdx",
        "restarts: 1"]
    first, last = map(float, lines[4].removeprefix("loss: ").split(" -> "))
    assert last < first
    step = tckpt.latest_step(out)
    assert step == 4
    cfg = tsmoke("deepseek-7b")
    tm = tbuild(cfg, device="cpu")
    to = topt.AdamWConfig(moment_dtype=cfg.parallel.optimizer_dtype)
    td = TTD("tdx", sealing_key=TKey.generate(b"launch"), device="cpu")
    whole = tckpt.restore_checkpoint(out, step, tloop.abstract_train_state(
        tm, to), trust_domain=td, device="cpu")
    named = _named(cfg, tm, to, (4, 1))
    placed = reshard_state(whole, named)
    assert tsharding.placement(placed) == named
    _equal(placed, whole)
    want = [hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                           .numpy().tobytes()).hexdigest()
            for _, t in tree_leaves_with_names(whole)]
    proc = subprocess.run(
        [sys.executable, "-c", _JRESTORE, str(out), str(step)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == want
