"""repro_torch's tensor-parallel engine on jamba (hybrid: Mamba + attention
+ MoE; ``Engine(mesh="tp=2")``, two logical shards on the CPU) against
repro.runtime's on the two host devices tests/conftest.py forces, on
weights converted 1:1 from the reference's (smoke jamba-v0.1-52b: 7 Mamba
layers and one attention layer, MoE on the odd slots).

The sampled canonical scenario with its preempting wave, slot and
paged-gather, equals the reference's tp=2 run in tokens, finish reasons,
stats, the audit log, page tables and every sealed name; one decode step's
logits are within a stated f32 tolerance of one device's, on tp=2 and on
dp=2,tp=2 (whose canonical tokens are the port's one-device tokens); blobs
(the recurrent rows with the pages) cross between the packages both ways.
Training jamba with its batch split over ``data`` (each MoE layer routing
the global batch) gives the one-device step's losses and updates.

Planted faults fail these tests (each tried on a copy of the package):
giving each shard a contiguous block of ``w_in``'s columns (shard 0 all of
x, shard 1 all of z) and skipping the ``bcdt`` reduction over ``model``
(keeping shard 0's partial) each fail the logits, the canonical runs and
the blob crossing."""

import numpy as np
import pytest
import torch

from test_torch_mesh import MeshSide
from test_torch_sampled_serving import Side, _canonical, assert_same_run
from test_torch_sealing import to_jax_blob, to_torch_blob
from test_torch_tp_families import _step_logits, models
from _torch_ref import reference_run

ARCH = "jamba-v0.1-52b"
BACKENDS = {"slot": dict(kv_backend="slot"),
            "paged": dict(kv_backend="paged", page_size=8)}
# one decode step's logits, tp=2 (and dp=2,tp=2) vs one device, f32: per
# layer the Mamba mixer reduces its f32 bcdt partials and its w_out
# partials, the attention and FFN halves their partials, each summed in
# another order than one device's single product; over 8 layers the
# logits move by a few ulp of the largest activations. The runs show
# 1.7e-6 (tp=2) and 2.0e-6 (dp=2,tp=2) of max |logit|: 1e-5 leaves a
# margin of 5x
LOGIT_TOL = 1e-5
SAMPLED = dict(temperature=0.9, top_k=16)


def _within_tol(got, ref):
    err = float((got - ref).abs().max())
    assert 0 < err <= LOGIT_TOL * float(ref.abs().max())
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_canonical_tp_jamba_matches_reference(backend):
    """The sampled canonical scenario on tp=2 equals the reference's tp=2
    run: tokens, finish reasons, stats, channel counters, audit, page
    tables and every sealed name (``/s0``: one data shard), recurrent
    rows included."""
    kw = dict(BACKENDS[backend], mesh="tp=2")
    ms = models(ARCH)
    t = _canonical(MeshSide(True, ms), **kw)
    j = reference_run(lambda: _canonical(MeshSide(False, ms), **kw), t)
    assert_same_run(j, t)
    teng, jeng = t[1], j[1]
    # each shard: 64 of the 128 Mamba channels, w_in as its x and z blocks
    mamba = [m for *_, m, _ in teng.plan.tensor_parallel.slots].index("mamba")
    for lp in teng.params.compute:
        mb = lp["layers"][mamba]["mamba"]
        assert mb["conv_w"].shape[-1] == 64
        assert mb["w_in"].shape[-2:] == (2, 64)
    assert teng.sealed_names == jeng.sealed_names
    names = [n for d in teng.sealed_names for n in d]
    assert names and all(n.endswith("/s0") for n in names)
    assert any("['ssm']" in n for n in names)
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    assert tch.collective_steps == jch.collective_steps > 0
    assert tch.collective_bytes > 0 and tch.collective_s > 0


@pytest.mark.parametrize("mesh,slots", [("tp=2", 2), ("dp=2,tp=2", 4)])
def test_decode_logits_within_tolerance(mesh, slots):
    """One decode step's logits on the mesh are within LOGIT_TOL x max
    |logit| of the single-device engine's on the same prompts, with the
    same argmax."""
    ms = models(ARCH)
    _within_tol(_step_logits(ms, mesh, slots), _step_logits(ms, None, slots))


def test_data_and_model_shards_give_one_device_tokens():
    """jamba on dp=2,tp=2 logical shards: each data shard steps its row,
    the MoE layers route both shards' rows together; the canonical
    scenario's tokens equal the port's single-device run's."""
    ms = models(ARCH)
    t = _canonical(MeshSide(True, ms), mesh="dp=2,tp=2", kv_backend="slot")
    assert t[1].plan.tensor_parallel.dp == 2
    single = _canonical(Side(True, ms), kv_backend="slot")
    assert [r.output for r in t[0]] == [r.output for r in single[0]]


def sealed_half(side, backend):
    """A tp=2 engine after 3 steps of two sampled requests, with slot 1's
    row (pages and recurrent state) sealed out."""
    eng = side.engine(mesh="tp=2", **BACKENDS[backend])
    reqs = [eng.submit(side.gen(np.arange(1, 9) + i,
                                dict(SAMPLED, seed=40 + i),
                                max_new_tokens=8)) for i in range(2)]
    for _ in range(3):
        eng.step()
    sealed, req = eng.seal_slot(1)
    return eng, reqs, sealed, req


def cross_packages(ms, backend):
    """Each package's tp=2 engine restores the other's sealed row (under
    the same names, shapes and key) and both finish with the tokens of an
    uninterrupted tp=2 run."""
    teng, treqs, tsealed, treq = sealed_half(Side(True, ms), backend)
    jeng, jreqs, jsealed, jreq = sealed_half(Side(False, ms), backend)
    assert sorted(tsealed) == sorted(jsealed)
    assert all(n.endswith("/s0") for n in tsealed)
    assert {n: st.shape for n, st in tsealed.items()} == \
        {n: tuple(st.shape) for n, st in jsealed.items()}
    teng.restore_slot({n: to_torch_blob(st) for n, st in jsealed.items()},
                      treq)
    jeng.restore_slot({n: to_jax_blob(st) for n, st in tsealed.items()},
                      jreq)
    teng.run()
    jeng.run()
    side = Side(True, ms)
    plain = side.engine(mesh="tp=2", **BACKENDS[backend])
    want = [plain.submit(side.gen(np.arange(1, 9) + i,
                                  dict(SAMPLED, seed=40 + i),
                                  max_new_tokens=8)) for i in range(2)]
    plain.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs] == \
        [r.output for r in want]
    return tsealed


def test_tp_jamba_blobs_cross_packages():
    """Paged: the pages, the meta and the Mamba rows (``conv``, ``ssm``)
    cross both ways."""
    sealed = cross_packages(models(ARCH), "paged")
    assert any("['conv']" in n for n in sealed)


def test_moe_split_batch_in_training_names_part_3c():
    """Training jamba (MoE: expert capacity and the aux loss couple a
    call's rows) with its batch split over ``data`` at a capacity factor
    that drops (1.0): two steps on data=2 give the one-device step's
    losses and aux losses within 1e-4 and each leaf's update within 1e-2
    of its norm (tests/test_torch_sharded_train.py's tolerances)."""
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer, train_loop
    from test_torch_sharded_train import DELTA_TOL, OPT, STEP_LOSS_TOL

    model, params = models(ARCH, capacity_factor=1.0)[2:]
    opt = optimizer.AdamWConfig(**OPT)
    state = train_loop.TrainState(params, optimizer.init_opt_state(opt,
                                                                   params))
    mesh = make_host_mesh(2, 1, device="cpu")
    sspecs = sharding.state_specs(
        model.cfg, train_loop.abstract_train_state(model, opt), mesh)
    rng = np.random.default_rng(5)
    batches = [{k: rng.integers(lo, 256, (4, 16)).astype(np.int32)
                for k, lo in (("tokens", 0), ("labels", -1))}
               for _ in range(2)]
    step = train_loop.make_sharded_train_step(
        model, opt, mesh, sspecs,
        sharding.batch_specs(model.cfg, batches[0], mesh))
    one_step = train_loop.make_train_step(model, opt)
    placed = sharding.place(state, sharding.to_named(mesh, sspecs))
    one = before = state
    for b in batches:
        placed, m = step(placed, b)
        one, m1 = one_step(one, b)
        for k in ("loss", "aux_loss"):
            assert abs(float(m[k]) - float(m1[k])) < STEP_LOSS_TOL, k
    got = sharding.gather(placed.params)
    for (n, a), (_, w), (_, p) in zip(tree_leaves_with_names(got),
                                      tree_leaves_with_names(one.params),
                                      tree_leaves_with_names(before.params)):
        moved = (w - p).norm()
        assert float((a - w).norm() / moved.clamp_min(1e-30)) < DELTA_TOL, n
