"""repro_torch's tensor-parallel engine on rwkv6 (ssm: time mix + channel
mix; ``Engine(mesh="tp=2")``, two logical shards on the CPU) against
repro.runtime's on the two host devices tests/conftest.py forces, on
weights converted 1:1 from the reference's (smoke rwkv6-3b, served on the
slot backend as the reference serves it: it has no length leaf to page).

The sampled canonical scenario with its preempting wave equals the
reference's tp=2 run in tokens, finish reasons, stats, the audit log and
every sealed name (the ``wkv`` state over heads, ``tmix_x``/``cmix_x``
whole); one decode step's logits are within a stated f32 tolerance of one
device's, on tp=2 and on dp=2,tp=2 (whose canonical tokens are the port's
one-device tokens); sealed rows cross between the packages both ways.
Greedy smoke rwkv6 repeats one token, so every run here samples.

Planted faults fail these tests (each tried on a copy of the package):
normalising each shard's heads with ``ln_out`` on their own (a per-shard
mean and variance) and multiplying ``vv`` by the shard's own receptance
block in place of the gathered one (``rr`` without its gather) each fail
the logits, the canonical run and the blob crossing."""

import pytest

from test_torch_mesh import MeshSide
from test_torch_sampled_serving import Side, _canonical, assert_same_run
from test_torch_tp_families import _step_logits, models
from test_torch_tp_jamba import cross_packages
from _torch_ref import reference_run

ARCH = "rwkv6-3b"
# one decode step's logits, tp=2 (and dp=2,tp=2) vs one device, f32: per
# layer the w_o partials and the channel mix's vv partials are summed in
# another order than one device's single product (the ln_out gather and
# the receptance gather are exact); over 2 layers the logits move by an
# ulp or two of the largest activations. The runs show 1.7e-7 (tp=2) and
# 1.8e-7 (dp=2,tp=2) of max |logit|: 1e-5 leaves a margin over 50x
LOGIT_TOL = 1e-5


def test_canonical_tp_rwkv_matches_reference():
    """The sampled canonical scenario on tp=2 equals the reference's tp=2
    run: tokens, finish reasons, stats, channel counters, audit and every
    sealed name (``/s0``: one data shard)."""
    kw = dict(kv_backend="slot", mesh="tp=2")
    ms = models(ARCH)
    t = _canonical(MeshSide(True, ms), **kw)
    j = reference_run(lambda: _canonical(MeshSide(False, ms), **kw), t)
    assert_same_run(j, t)
    teng, jeng = t[1], j[1]
    # each shard: 2 of the 4 heads of 16 channels
    assert all(lp["layers"][0]["tmix"]["w_r"].shape[-1] == 32
               for lp in teng.params.compute)
    assert teng.sealed_names == jeng.sealed_names
    names = [n for d in teng.sealed_names for n in d]
    assert names and all(n.endswith("/s0") for n in names)
    assert any("['wkv']" in n for n in names)
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    assert tch.collective_steps == jch.collective_steps > 0
    assert tch.collective_bytes > 0 and tch.collective_s > 0


@pytest.mark.parametrize("mesh,slots", [("tp=2", 2), ("dp=2,tp=2", 4)])
def test_decode_logits_within_tolerance(mesh, slots):
    """One decode step's logits on the mesh are within LOGIT_TOL x max
    |logit| of the single-device engine's on the same prompts, with the
    same argmax."""
    ms = models(ARCH)
    got, ref = _step_logits(ms, mesh, slots), _step_logits(ms, None, slots)
    err = float((got - ref).abs().max())
    assert 0 < err <= LOGIT_TOL * float(ref.abs().max())
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_data_and_model_shards_give_one_device_tokens():
    """rwkv6 on dp=2,tp=2 logical shards: the canonical scenario's tokens
    equal the port's single-device run's."""
    ms = models(ARCH)
    t = _canonical(MeshSide(True, ms), mesh="dp=2,tp=2", kv_backend="slot")
    assert t[1].plan.tensor_parallel.dp == 2
    single = _canonical(Side(True, ms), kv_backend="slot")
    assert [r.output for r in t[0]] == [r.output for r in single[0]]


def test_tp_rwkv_blobs_cross_packages():
    """Slot: the row's ``wkv``, ``tmix_x`` and ``cmix_x`` cross both
    ways."""
    sealed = cross_packages(models(ARCH), "slot")
    assert any("['cmix_x']" in n for n in sealed)
