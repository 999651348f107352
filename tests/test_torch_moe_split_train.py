"""repro_torch's sharded training of MoE models with the batch split over
``data`` against repro.train, in process: smoke dbrx and jamba (cut as
tests/test_torch_tp_train.py cuts it) at capacity factor 1.0, which drops
tokens (the smoke default of 8.0 drops none), on ``data=2`` and ``data=2,
model=2`` logical meshes against the port's one-device step and the
reference's one-device jitted step: each MoE layer routes the global
batch, so capacity, drops and the aux loss are one device's. Tolerances
are tests/test_torch_tp_train.py's. The train launcher trains a MoE arch
on a 2 x 2 mesh.

Planted faults fail this file (each tried on a copy of the package):
routing each data shard's rows alone (a capacity a data shard), and the
aux loss counted once a data shard."""

import pytest
import torch

from repro_torch.configs import smoke_config as tsmoke
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model as tbuild
from test_torch_tp_train import assert_matches, batch, cfgs, reference
from test_torch_train import _state_from_jax

ARCHS = ["dbrx-132b", "jamba-v0.1-52b"]
SHAPES = [(2, 1), (2, 2)]
CAPACITY = 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=["dp2", "dp2tp2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_split_batch_matches_reference_and_one_device(arch, shape):
    """Two steps with the batch split over ``data`` at a capacity factor
    that drops: losses, aux losses, params and each leaf's update against
    the reference's and the one-device step's."""
    metrics = assert_matches(arch, shape, CAPACITY)
    assert metrics["aux_loss"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_one_drops_tokens(arch):
    """At capacity factor 1.0 the first step's batch overflows an expert:
    the one-device loss on the tests' initial weights differs from the
    dropless one at 8.0, so routing a data shard's rows alone (half the
    capacity) would drop other pairs."""
    state = _state_from_jax(reference(arch, CAPACITY)[0])
    b = {k: torch.from_numpy(v) for k, v in batch(cfgs(arch)[1], 7).items()}
    losses = [float(tbuild(cfgs(arch, cf)[1], device="cpu").loss(
        state.params, b)[1]["ce_loss"]) for cf in (CAPACITY, 8.0)]
    assert losses[0] != losses[1]


def test_launcher_trains_moe_on_a_mesh(capsys):
    """``launch.train --arch dbrx-132b --smoke --data-mesh 2 --model-mesh
    2`` on logical shards prints the reference launcher's mesh and report
    lines and its loss falls."""
    tlaunch.main(["--arch", "dbrx-132b", "--smoke", "--steps", "4",
                  "--seq", "32", "--data-mesh", "2", "--model-mesh", "2",
                  "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["mesh: {'data': 2, 'model': 2}",
                         f"arch={tsmoke('dbrx-132b').name} params=0.1M "
                         f"(active 0.1M) tee=none"]
    first, last = map(float, lines[-1].removeprefix("loss: ").split(" -> "))
    assert last < first
