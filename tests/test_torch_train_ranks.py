"""repro_torch's sharded training over ranks: gloo CPU processes
(``torch.multiprocessing``, ``file://`` init under ``tmp_path``, one
thread each), each running the same steps on the same batches
(tests/_torch_train_ranks_worker.py), against the same mesh on logical
shards in this process.

On dp=2 over 2 ranks and dp=2,tp=2 over 4, every rank's state after the
sharded steps, after a sealed save and restore onto its shards and after
one more step equals the logical run's bit for bit, with the same losses
and collective bytes; global rank 0 alone writes, and the files are the
logical run's byte for byte. On dp=2,tp=2 smoke dbrx and jamba, their
batch split over ``data`` at capacity factor 1.0, equal the logical run's
bit for bit too. GPipe over 2 ranks equals a LocalGroup(2),
forward and gradient. The launcher under ``torchrun --nproc-per-node 4``
with ``--data-mesh 2 --model-mesh 2`` prints the logical run's losses and
writes its checkpoint files, which restore onto a (4, 1) mesh through
``reshard_state``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_train_ranks_worker as W
from repro_torch.configs import smoke_config
from repro_torch.core.sealing import tree_leaves_with_names
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import LocalGroup
from repro_torch.distributed.fault_tolerance import reshard_state
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import abstract_train_state

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"dp2": (2, 1), "dp2tp2": (2, 2)}

_RUNS = {}


def _ranks(name, tmp_path_factory):
    """The spawned run of a mesh (dp2's also runs GPipe), once a module."""
    if name not in _RUNS:
        _RUNS[name] = W.spawn(MESHES[name], tmp_path_factory.mktemp(name),
                              with_gpipe=name == "dp2")
    return _RUNS[name]


def _one_thread(fn, *a):
    """``fn`` on one thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*a)
    finally:
        torch.set_num_threads(threads)


def _same(a, b):
    assert list(a) == list(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n


def _files(path):
    return {f.name: f.read_bytes() for f in sorted(Path(path).iterdir())}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_training_ranks_equal_logical(name, tmp_path,
                                              tmp_path_factory):
    """Every rank's whole state after the steps, the restore and one more
    step equals the logical run's; the same losses and bytes; rank 0
    alone writes, the logical run's files byte for byte."""
    shape = MESHES[name]
    want = _one_thread(W.train, shape, tmp_path / "logical")
    ranks = _ranks(name, tmp_path_factory)
    assert want["step"] == W.STEPS and want["writes"] and want["placed"]
    _same(want["restored"], want["trained"])
    for r, got in enumerate(ranks):
        for k in ("trained", "restored", "final"):
            _same(got[k], want[k])
        assert got["losses"] == want["losses"], r
        assert got["bytes"] == want["bytes"] > 0
        assert got["step"] == W.STEPS and got["placed"]
        assert got["writes"] == (r == 0)
    step = f"step_{W.STEPS}"
    assert _files(ranks[0]["ckpt"] / step) == _files(tmp_path / "logical" /
                                                    step)


@pytest.mark.parametrize("arch", W.MOE_ARCHS)
def test_moe_split_batch_ranks_equal_logical(arch, tmp_path_factory):
    """A MoE arch trained with its batch split over ``data`` on dp=2,tp=2:
    every rank's whole state after the steps equals the logical run's bit
    for bit (each MoE layer's rows gathered over ``data``, routed and
    reduced in rank order on both), with the same losses and bytes."""
    want = _one_thread(W.moe_train, arch, W.MOE_SHAPE)
    for r, got in enumerate(_ranks("dp2tp2", tmp_path_factory)):
        _same(got["moe"][arch]["final"], want["final"])
        assert got["moe"][arch]["losses"] == want["losses"], r
        assert got["moe"][arch]["bytes"] == want["bytes"] > 0


def test_gpipe_over_ranks_matches_local_group(tmp_path_factory):
    """GPipe over 2 gloo ranks: each rank's broadcast output and its
    stage's gradient equal a LocalGroup(2)'s, bit for bit."""
    out, g = W.gpipe(LocalGroup(2, "cpu"))
    ranks = _ranks("dp2", tmp_path_factory)
    for r, got in enumerate(ranks):
        rout, rg = got["gpipe"]
        assert torch.equal(rout, out), r
        assert torch.equal(rg[r], g[r]), r
        assert not rg[1 - r].any()          # the other stage's slice


LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "deepseek-7b",
          "--smoke", "--steps", "4", "--seq", "32", "--ckpt-every", "2",
          "--fail-at", "2", "--data-mesh", "2", "--model-mesh", "2",
          "--device", "cpu"]


def test_launcher_under_torchrun_equals_logical(tmp_path):
    """``torchrun --nproc-per-node 4`` with ``--data-mesh 2 --model-mesh
    2``: one restart, the logical run's report and loss lines, its
    checkpoint files byte for byte; the last checkpoint restores onto a
    (4, 1) mesh through ``reshard_state``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logical = subprocess.run(
        [sys.executable, *LAUNCH, "--ckpt-dir", str(tmp_path / "logical")],
        capture_output=True, text=True, timeout=300, env=env)
    assert logical.returncode == 0, logical.stderr[-2000:]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *LAUNCH, "--ckpt-dir",
         str(tmp_path / "ranks")],
        capture_output=True, text=True, timeout=300, env=env)
    assert ranks.returncode == 0, ranks.stderr[-2000:]
    want = logical.stdout.splitlines()
    got = ranks.stdout.splitlines()
    assert want[:3] == ["mesh: {'data': 2, 'model': 2}",
                        "arch=deepseek-7b-smoke params=0.1M (active 0.1M) "
                        "tee=none", "restarts: 1"]
    assert got[:3] == want[:3] and got[-1] == want[-1]
    assert got[-1].startswith("loss: ")
    for step in ("step_2", "step_4"):
        assert _files(tmp_path / "ranks" / step) == \
            _files(tmp_path / "logical" / step)
    cfg = smoke_config("deepseek-7b")
    model = build_model(cfg, device="cpu")
    opt = AdamWConfig(moment_dtype=cfg.parallel.optimizer_dtype)
    whole = ckpt.restore_checkpoint(tmp_path / "ranks", 4,
                                    abstract_train_state(model, opt),
                                    device="cpu")
    mesh = make_host_mesh(4, 1, device="cpu")
    named = sharding.to_named(mesh, sharding.state_specs(
        cfg, abstract_train_state(model, opt), mesh))
    placed = reshard_state(whole, named)
    assert sharding.placement(placed) == named
    for (n, a), (_, b) in zip(tree_leaves_with_names(sharding.gather(placed)),
                              tree_leaves_with_names(whole)):
        assert torch.equal(a, b), n
