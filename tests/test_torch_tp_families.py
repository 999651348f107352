"""repro_torch's tensor-parallel engine on the attention families
(``Engine(mesh="tp=2")``, two logical shards on the CPU) against
repro.runtime's on the two host devices tests/conftest.py forces, on weights
converted 1:1 from the reference's: smoke chameleon-34b (vlm: GQA with
qk-norm), dbrx-132b (MoE, experts split over ``model``) and
deepseek-v3-671b (MLA, a dense first layer and a MoE layer with a shared
expert).

The sampled canonical scenario with its preempting wave, slot and
paged-gather, equals the reference's tp=2 run in tokens, finish reasons,
stats, the audit log, page tables and every sealed name; one decode step's
logits are within a stated f32 tolerance of one device's; blobs cross
between the packages both ways. A MoE layer on ``dp=2,tp=2`` routes the
step's global rows: with a capacity factor that drops pairs, its logits
and tokens are one device's.

Planted faults fail these tests (each tried on a copy of the package):
dropping one shard's expert partial (the MoE sums only shard 0's experts)
fails dbrx's and deepseek-v3's logits, canonical runs and blob crossings;
reckoning the capacity per shard (over the shard's experts, or over a
data shard's rows) fails the dropping dp=2 case; skipping the reduction
over ``model`` (keeping shard 0's partial) fails every test here."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import ShardedKVBackend
from test_torch_mesh import MeshSide
from test_torch_sampled_serving import Side, _canonical, assert_same_run
from test_torch_sealing import to_jax_blob, to_torch_blob
from _torch_ref import reference_run

ARCHS = ("chameleon-34b", "dbrx-132b", "deepseek-v3-671b")
BACKENDS = {"slot": dict(kv_backend="slot"),
            "paged": dict(kv_backend="paged", page_size=8)}
TP = dict(mesh="tp=2")
# one decode step's logits, tp=2 vs one device, f32: the shards' partials
# are summed in another order than one device's single product (a
# reduction per mixer and FFN, 2 layers), so the logits move by a few ulp
# of the largest activations. The runs show 5.5e-7 (chameleon), 4.7e-7
# (dbrx) and 3.1e-7 (deepseek-v3) of max |logit|, and 4.2e-7 for dbrx on
# dp=2,tp=2 with drops: 1e-5 leaves a margin over 18x
LOGIT_TOL = 1e-5
# dbrx with a capacity factor that drops pairs (capacity int(1.0 * t * 2
# / 4) slots an expert for t tokens: 1 at a canonical step of 2 rows)
DROPPING = 1.0

_MODELS = {}


def models(arch, capacity_factor=None):
    """(reference model, params, port model, converted params), built once
    per (family, capacity factor) for the module."""
    key = (arch, capacity_factor)
    if key not in _MODELS:
        jcfg, tcfg = jsmoke(arch), tsmoke(arch)
        if capacity_factor is not None:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=capacity_factor))
            tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=capacity_factor))
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.key(0))
        _MODELS[key] = (jm, jp, tbuild(tcfg, device="cpu"),
                        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[key]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_canonical_tp_family_matches_reference(arch, backend):
    """The sampled canonical scenario on tp=2 equals the reference's tp=2
    run: tokens, finish reasons, stats, channel counters, audit, page
    tables and every sealed name (``/s0``: one data shard)."""
    kw = dict(BACKENDS[backend], **TP)
    ms = models(arch)
    t = _canonical(MeshSide(True, ms), **kw)
    j = reference_run(lambda: _canonical(MeshSide(False, ms), **kw), t)
    assert_same_run(j, t)
    teng, jeng = t[1], j[1]
    assert isinstance(teng.kv, ShardedKVBackend)
    assert teng.plan.tensor_parallel.tp == 2
    assert teng.sealed_names == jeng.sealed_names
    names = [n for d in teng.sealed_names for n in d]
    assert names and all(n.endswith("/s0") for n in names)
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    assert tch.collective_steps == jch.collective_steps > 0
    assert tch.collective_bytes > 0 and tch.collective_s > 0


def _step_logits(ms, mesh, slots=2):
    """One decode step's logits through a ``slots``-slot engine's plan,
    every row prefilled with 6 tokens (comparison only)."""
    eng = Side(True, ms).engine(max_slots=slots, max_len=64, prefill_len=8,
                                **({"mesh": mesh} if mesh else {}))
    prompts = torch.stack([torch.arange(1, 7) + 3 * i for i in range(slots)])
    cache = eng.kv.fresh_prefill_cache(slots)
    with torch.inference_mode():
        _, cache = eng.plan.compile_prefill()(eng.params, prompts.int(),
                                              cache)
        compute = eng.plan.gather(eng.params) if mesh else eng.params
        logits, _ = eng.plan.decode_step(
            compute, torch.tensor([[5 + 4 * i] for i in range(slots)],
                                  dtype=torch.int32), cache)
    return logits


def _within_tol(got, ref):
    err = float((got - ref).abs().max())
    assert 0 < err <= LOGIT_TOL * float(ref.abs().max())
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_within_tolerance(arch):
    """One decode step's logits on tp=2 are within LOGIT_TOL x max |logit|
    of the single-device engine's on the same prompts, with the same
    argmax."""
    ms = models(arch)
    _within_tol(_step_logits(ms, "tp=2"), _step_logits(ms, None))


def test_moe_on_data_shards_routes_global_rows():
    """dbrx with a capacity that drops, on dp=2,tp=2: each data shard
    steps its rows, but the MoE layer routes both shards' rows together,
    so the drops are one device's: logits within LOGIT_TOL, and the
    canonical scenario's tokens equal the single-device run's."""
    ms = models("dbrx-132b", DROPPING)
    _within_tol(_step_logits(ms, "dp=2,tp=2", slots=4),
                _step_logits(ms, None, slots=4))
    t = _canonical(MeshSide(True, ms), mesh="dp=2,tp=2", kv_backend="slot")
    assert t[1].plan.tensor_parallel.dp == 2
    single = _canonical(Side(True, ms), kv_backend="slot")
    assert [r.output for r in t[0]] == [r.output for r in single[0]]


def _sealed_half(side):
    """A tp=2 paged engine after 3 steps of two greedy requests, with slot
    1's pages sealed out."""
    eng = side.engine(mesh="tp=2", kv_backend="paged", page_size=8)
    reqs = [eng.submit(side.gen(np.arange(1, 9) + i, max_new_tokens=8))
            for i in range(2)]
    for _ in range(3):
        eng.step()
    sealed, req = eng.seal_slot(1)
    return eng, reqs, sealed, req


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_blobs_cross_packages(arch):
    """Each package's tp=2 paged engine restores the other's sealed pages
    (whole pages, under the same names and key) and both finish with the
    tokens of an uninterrupted tp=2 run."""
    ms = models(arch)
    teng, treqs, tsealed, treq = _sealed_half(Side(True, ms))
    jeng, jreqs, jsealed, jreq = _sealed_half(Side(False, ms))
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
    plain = side.engine(mesh="tp=2", kv_backend="paged", page_size=8)
    want = [plain.submit(side.gen(np.arange(1, 9) + i, max_new_tokens=8))
            for i in range(2)]
    plain.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs] == \
        [r.output for r in want]
