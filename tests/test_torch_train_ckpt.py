"""repro_torch's checkpoints, fault tolerance, gradient compression,
train-state specs and training launcher against repro.train and
repro.distributed (the training stack's other half is
tests/test_torch_train.py, whose fixtures and helpers this file shares):
checkpoints written by either package restore in the other, plain and
sealed, with equal manifests, names, MACs and file bytes; restart-resume
equals the uninterrupted run loss for loss.

Tolerances: compression's dequantized grads within 1e-6 relative and its
residuals within 1e-6 of the grad leaf's largest entry (jit may round the
scale's division differently); everything else bit for bit."""

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import repro.train.checkpoint as jckpt
from repro.configs import smoke_config as jsmoke
from repro.core import SealingKey as JKey
from repro.core import TrustDomain as JTD
from repro.core.sealing import IntegrityError as JIntegrityError
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsharding
from repro.launch import train as jlaunch
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import SealingKey as TKey
from repro_torch.core import TrustDomain as TTD
from repro_torch.core.sealing import IntegrityError, tree_leaves_with_names
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     reshard_state,
                                                     run_with_restarts)
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from test_torch_train import (OPT, _assert_trees_close, _batch, _jflat,
                              _state_from_jax, _tflat, setup)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _manifest(path):
    return json.loads((Path(path) / "manifest.json").read_text())


def _same_files(a, b):
    for f in sorted(Path(a).glob("leaf_*.npy")):
        assert f.read_bytes() == (Path(b) / f.name).read_bytes(), f.name


def _bf16_state(setup):
    """The reference's state with bf16 moments (f32 params), as the
    reference makes it; the port's converted."""
    jm, _, _, _, jstate, _ = setup
    jo = jopt.AdamWConfig(**OPT, moment_dtype="bfloat16")
    js = jloop.init_train_state(jm, jo, jax.random.key(0))
    js, _ = jax.jit(jloop.make_train_step(jm, jo))(js, _batch())
    return js, _state_from_jax(js)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_plain_checkpoints_cross_both_ways(setup, tmp_path, moments):
    """The same state saved by each package: equal manifests (names,
    dtypes, SHA-256s) and equal file bytes; each package restores the
    other's. The reference cannot restore a plain bf16 leaf at all (jnp
    refuses numpy's ``V2`` records, its own files included; ROADMAP.md
    queue C); the port restores both."""
    if moments == "float32":
        js, ts = setup[4], setup[5]
    else:
        js, ts = _bf16_state(setup)
    jp = jckpt.save_checkpoint(tmp_path / "j", 1, js)
    tp = tckpt.save_checkpoint(tmp_path / "t", 1, ts)
    assert _manifest(tp) == _manifest(jp)
    _same_files(jp, tp)
    assert _manifest(tp)["leaves"]["0"]["name"] == ".params['embedding']['table']"
    for src in ("j", "t"):
        back = tckpt.restore_checkpoint(tmp_path / src, 1, ts, device="cpu")
        for (n, a), (_, b) in zip(tree_leaves_with_names(back),
                                  tree_leaves_with_names(ts)):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        if moments == "float32":
            jback = jckpt.restore_checkpoint(tmp_path / src, 1, js)
            for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(js)):
                assert bool(jnp.all(a == b))
        else:
            with pytest.raises(TypeError, match="V2"):
                jckpt.restore_checkpoint(tmp_path / src, 1, js)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sealed_checkpoints_cross_both_ways(setup, tmp_path, moments):
    """Under one sealing key: equal manifests (names, shapes, dtypes,
    MACs) and equal ciphertext files; each package restores the other's
    bit for bit, bf16 moments included."""
    if moments == "float32":
        js, ts = setup[4], setup[5]
    else:
        js, ts = _bf16_state(setup)
    jtd = JTD("tdx", sealing_key=JKey.generate(b"ckpt"))
    ttd = TTD("tdx", sealing_key=TKey.generate(b"ckpt"), device="cpu")
    jp = jckpt.save_checkpoint(tmp_path / "j", 2, js, trust_domain=jtd)
    tp = tckpt.save_checkpoint(tmp_path / "t", 2, ts, trust_domain=ttd)
    assert _manifest(tp) == _manifest(jp) and _manifest(tp)["sealed"]
    _same_files(jp, tp)
    for src in ("j", "t"):
        back = tckpt.restore_checkpoint(tmp_path / src, 2, ts,
                                        trust_domain=ttd)
        for (n, a), (_, b) in zip(tree_leaves_with_names(back),
                                  tree_leaves_with_names(ts)):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        jback = jckpt.restore_checkpoint(tmp_path / src, 2, js,
                                         trust_domain=jtd)
        for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(js)):
            assert a.dtype == b.dtype and bool(jnp.all(a == b))


def test_checkpoint_corruption_key_binding_and_retention(setup, tmp_path):
    """tests/test_train.py's checkpoint cases on the port: a changed leaf
    fails its digest, a sealed checkpoint refuses another trust domain's
    key (as the reference refuses it) and a restore without one, and
    ``keep_n`` keeps the newest."""
    jstate, ts = setup[4], setup[5]
    path = tckpt.save_checkpoint(tmp_path / "p", 1, ts)
    victim = sorted(path.glob("leaf_*.npy"))[2]
    raw = np.load(victim)
    flat = raw.reshape(-1).copy()
    flat[0] += 1
    np.save(victim, flat.reshape(raw.shape))
    with pytest.raises(tckpt.CorruptCheckpoint):
        tckpt.restore_checkpoint(tmp_path / "p", 1, ts)
    abstract = tloop.abstract_train_state(setup[1], setup[3])
    mgr = tckpt.CheckpointManager(tmp_path / "s", trust_domain=TTD(
        "tdx", device="cpu"))
    mgr.save(5, ts)
    step, back = mgr.resume(abstract, device="cpu")
    assert step == 5 and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_names(back), tree_leaves_with_names(ts)))
    with pytest.raises(IntegrityError):
        tckpt.CheckpointManager(tmp_path / "s", trust_domain=TTD(
            "tdx", device="cpu")).resume(ts)
    with pytest.raises(JIntegrityError):
        jckpt.CheckpointManager(tmp_path / "s", trust_domain=JTD(
            "tdx")).resume(jstate)
    with pytest.raises(tckpt.CorruptCheckpoint, match="TrustDomain"):
        tckpt.restore_checkpoint(tmp_path / "s", 5, ts)
    mgr = tckpt.CheckpointManager(tmp_path / "r", keep_n=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"x": torch.ones(2)})
    assert sorted(p.name for p in (tmp_path / "r").glob("step_*")) == \
        ["step_3", "step_4"]
    assert tckpt.latest_step(tmp_path / "r") == 4
    assert tckpt.latest_step(tmp_path / "none") is None


def test_restart_resume_is_bit_identical(setup, tmp_path):
    """An interrupted and resumed run equals the uninterrupted run, loss
    for loss and leaf for leaf (sealed checkpoints every 2 steps, failures
    at steps 3 and 6)."""
    _, tm, _, to, _, tstate = setup
    step = tloop.make_train_step(tm, to)

    def data_factory(cursor):
        it = iter(tdata.PackedLMDataset(batch_size=4, seq_len=32, seed=0))
        for _ in range(cursor):
            next(it)
        return it

    clean, losses_clean, r0 = run_with_restarts(
        state=tstate, train_step=step, data_factory=data_factory,
        num_steps=8, manager=tckpt.CheckpointManager(tmp_path / "a"),
        checkpoint_every=2)
    td = TTD("tdx", device="cpu")
    faulty, losses_faulty, r = run_with_restarts(
        state=tstate, train_step=step, data_factory=data_factory,
        num_steps=8, manager=tckpt.CheckpointManager(tmp_path / "b",
                                                     trust_domain=td),
        checkpoint_every=2, injector=FailureInjector(fail_at={3, 6}))
    assert (r0, r) == (0, 2)
    assert losses_faulty == losses_clean
    for (n, a), (_, b) in zip(tree_leaves_with_names(faulty),
                              tree_leaves_with_names(clean)):
        assert torch.equal(a, b), n
    # elastic rescale: the final state placed on a (2, 1) mesh rests in
    # its state_specs shards and gathers back bit for bit
    mesh = make_host_mesh(2, 1, device="cpu")
    named = tsharding.to_named(mesh, tsharding.state_specs(
        tm.cfg, tloop.abstract_train_state(tm, to), mesh))
    placed = reshard_state(clean, named)
    assert tsharding.placement(placed) == named
    for (n, a), (_, b) in zip(
            tree_leaves_with_names(tsharding.gather(placed)),
            tree_leaves_with_names(clean)):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# compression and specs
# ---------------------------------------------------------------------------

def test_compression_matches_reference():
    """Error-feedback int8 compression leaf by leaf and over 12 steps of
    ``make_grad_compressor`` (the residual carried): the same
    dequantized grads and residuals; the wire bytes as the reference's."""
    rng = np.random.default_rng(9)
    for scale in (1e-4, 1.0, 30.0):
        g = (rng.standard_normal(257) * scale).astype(np.float32)
        e = (rng.standard_normal(257) * scale * 1e-2).astype(np.float32)
        td, te = tcomp.compress_decompress(torch.from_numpy(g),
                                           torch.from_numpy(e))
        jd, je = jcomp.compress_decompress(jnp.asarray(g), jnp.asarray(e))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                                   atol=1e-6 * scale)
    zd, ze = tcomp.compress_decompress(torch.zeros(4), torch.zeros(4))
    assert not zd.any() and not ze.any()
    ttr, tget = tcomp.make_grad_compressor()
    jtr, jget = jcomp.make_grad_compressor()
    for i in range(12):
        g = {"w": (rng.standard_normal((16, 8)) * 0.1).astype(np.float32),
             "b": {"c": rng.standard_normal(3).astype(np.float32)}}
        tout = ttr(params_from_jax(g, "cpu"))
        jout = jtr(jax.tree.map(jnp.asarray, g))
        _assert_trees_close(tout, jout, 1e-6)
        # a residual is the difference of two grad-sized numbers: its
        # rounding is an ulp of the grad's scale, not of its own
        for (n, a), (_, b), (_, gl) in zip(_tflat(tget().error),
                                           _jflat(jget().error), _jflat(g)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(gl).max(),
                                       err_msg=n)
    grads = {"a": torch.zeros((1024, 1024)), "b": torch.zeros(7)}
    assert tcomp.compressed_bytes(grads) == jcomp.compressed_bytes(
        jax.tree.map(lambda t: jnp.zeros(t.shape), grads))


def _jspecs(specs):
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]]


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-3b", "dbrx-132b"])
def test_state_specs_match_reference(arch, zero1):
    """``state_specs`` over a 2 x 2 mesh gives the reference's specs leaf
    for leaf (params, moments, step), with and without ``zero1``;
    ``to_named`` pairs each with the mesh."""
    jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch), device="cpu")
    jcfg = dataclasses.replace(jm.cfg, parallel=dataclasses.replace(
        jm.cfg.parallel, zero1=zero1))
    tcfg = dataclasses.replace(tm.cfg, parallel=dataclasses.replace(
        tm.cfg.parallel, zero1=zero1))
    jo, to = jopt.AdamWConfig(), topt.AdamWConfig()
    want = jsharding.state_specs(jcfg, jloop.abstract_train_state(jm, jo),
                                 AbstractMesh((2, 2), ("data", "model")))
    mesh = make_host_mesh(2, 2, device="cpu")
    got = tsharding.state_specs(tcfg, tloop.abstract_train_state(tm, to),
                                mesh)
    assert list(tree_leaves_with_names(got)) == _jspecs(want)
    named = tsharding.to_named(mesh, got)
    assert named.opt.step == tsharding.NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

def _run_main(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return out.getvalue().splitlines()


def test_launcher_prints_reference_report_lines(monkeypatch, tmp_path):
    """``launch.train --smoke --device cpu`` with sealed checkpoints and a
    failure drill prints the reference launcher's lines: the same
    ``arch=`` and ``restarts:`` lines, the step line, and a falling loss
    (the port's weights come from its own generator, so the losses
    differ)."""
    argv = ["--arch", "deepseek-7b", "--smoke", "--steps", "4", "--tee",
            "tdx", "--fail-at", "2", "--ckpt-every", "2", "--seq", "32"]
    want = _run_main(jlaunch.main, argv + ["--ckpt-dir", str(tmp_path / "j")],
                     monkeypatch)
    got = _run_main(tlaunch.main, argv + ["--ckpt-dir", str(tmp_path / "t"),
                                          "--device", "cpu"], monkeypatch)
    assert got[:2] == want[:2] == [
        "arch=deepseek-7b-smoke params=0.1M (active 0.1M) tee=tdx",
        "restarts: 1"]
    assert got[2].startswith("4 steps in ") and got[2].endswith(" tok/s)")
    first, last = map(float, got[3].removeprefix("loss: ").split(" -> "))
    assert last < first
    # a mesh (logical shards here) prints the reference's mesh line first
    mesh = _run_main(tlaunch.main, ["--arch", "deepseek-7b", "--smoke",
                                    "--steps", "2", "--seq", "32",
                                    "--data-mesh", "2", "--device", "cpu"],
                     monkeypatch)
    assert mesh[:2] == ["mesh: {'data': 2, 'model': 1}",
                        got[0].replace("tee=tdx", "tee=none")]


def test_train_tiny_example_runs():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_tiny.py"),
         "--device", "cpu", "--steps", "12", "--layers", "1", "--seq", "16",
         "--d-model", "32"], capture_output=True, text=True, check=True,
        env={"PYTHONPATH": str(ROOT / "src")}).stdout
    assert "survived 1 injected failure(s)" in out and "improved" in out
