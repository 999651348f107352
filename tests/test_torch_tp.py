"""repro_torch's tensor-parallel mesh engine (``Engine(mesh="tp=2")``, two
logical shards on the CPU) against repro.runtime's on the two host devices
tests/conftest.py forces, on weights converted 1:1 from the reference's.

The canonical scenario (sampled, with its preempting high wave) on smoke
``deepseek-7b``, slot and paged-gather, equals the reference's tp=2 run in
tokens, finish reasons, stats, the audit log, page tables and every sealed
name (``/s0``: one data shard), and the port's single-device tokens. With
``num_kv_heads=1`` the KV heads do not divide tp=2, so the cache shards its
sequence dim over ``model`` (the SP branch, a distributed softmax) and the
same holds. One decode step's logits are within a stated f32 tolerance of
one device's; blobs cross between the packages both ways; a tp=1 mesh is
bit-equal to one device; the hybrid, ssm and encdec families and kernel
decode are refused. The collective bytes differ from the reference's HLO count by
design (ROADMAP.md queue C): 3,584 B a step against 2,592 with 2 KV heads,
5,248 against 3,424 with 1."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core.sealing import tree_leaves_with_names, unseal_tensor
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import ShardedKVBackend
from test_torch_mesh import MeshSide
from test_torch_sampled_serving import Side, _canonical, assert_same_run
from test_torch_sealing import to_jax_blob, to_torch_blob
from _torch_ref import reference_run

TP = dict(mesh="tp=2")
BACKENDS = {"slot": dict(kv_backend="slot"),
            "paged": dict(kv_backend="paged", page_size=8)}
# what one decode step's collectives move into a shard (2 rows, d_model 64,
# f32): 5 reductions of [2, 1, 64] and the logits' vocabulary gather
# (2 x 128 f32) = 5 x 512 + 1,024; with 1 KV head add per layer the query
# heads' gather (2 x 2 heads x 16 f32 = 256 B) and the (o, max, sum) gather
# (2 x 4 heads x 18 f32 = 576 B)
STEP_B = {2: 3_584, 1: 3_584 + 2 * (256 + 576)}
# one decode step's logits, tp=2 vs one device, f32: the partial products
# are summed in another order (ulp-level per reduction, 5 reductions on 2
# layers; the distributed softmax divides once more), so the logits move
# by a few ulp of the largest activations. The runs show 3.8e-7 and
# 7.2e-7 of max |logit| (2 and 1 KV heads): 1e-5 leaves a margin over 10x
LOGIT_TOL = 1e-5

_MODELS = {}


def models(kv_heads):
    """(reference model, params, port model, converted params) of smoke
    deepseek-7b with ``kv_heads`` KV heads."""
    if kv_heads not in _MODELS:
        jm = jbuild(dataclasses.replace(jsmoke("deepseek-7b"),
                                        num_kv_heads=kv_heads))
        jp = jm.init_params(jax.random.key(0))
        tm = tbuild(dataclasses.replace(tsmoke("deepseek-7b"),
                                        num_kv_heads=kv_heads), device="cpu")
        _MODELS[kv_heads] = (jm, jp, tm,
                             params_from_jax(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return _MODELS[kv_heads]


@pytest.mark.parametrize("kv_heads", [2, 1], ids=["heads", "sp"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_canonical_tp_scenario_matches_reference(backend, kv_heads):
    """The sampled canonical scenario on tp=2 equals the reference's tp=2
    run and the port's single-device run; every sealed name is the
    reference's, ``/s0``-tagged; the steps' collective count is the
    reference's and the bytes are the port's own."""
    kw = dict(BACKENDS[backend], **TP)
    ms = models(kv_heads)
    t = _canonical(MeshSide(True, ms), **kw)
    j = reference_run(lambda: _canonical(MeshSide(False, ms), **kw), t)
    assert_same_run(j, t)
    teng, jeng = t[1], j[1]
    assert isinstance(teng.kv, ShardedKVBackend)
    assert teng.plan.tensor_parallel.sp == (kv_heads == 1)
    assert teng.sealed_names == jeng.sealed_names
    names = [n for d in teng.sealed_names for n in d]
    assert names and all(n.endswith("/s0") for n in names)
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    assert tch.collective_steps == jch.collective_steps > 0
    assert teng.plan.collective_bytes_per_step == STEP_B[kv_heads]
    assert tch.collective_bytes == tch.collective_steps * STEP_B[kv_heads]
    assert tch.collective_s > 0
    single = _canonical(Side(True, ms), **BACKENDS[backend])
    assert [r.output for r in t[0]] == [r.output for r in single[0]]


def _step_logits(ms, mesh):
    """One decode step's logits through a 2-slot engine's plan, both rows
    prefilled with 6 tokens (comparison only)."""
    eng = Side(True, ms).engine(max_slots=2, max_len=64, prefill_len=8,
                                **({"mesh": mesh} if mesh else {}))
    prompts = torch.stack([torch.arange(1, 7) + 3 * i for i in range(2)])
    cache = eng.kv.fresh_prefill_cache(2)
    with torch.inference_mode():
        _, cache = eng.plan.compile_prefill()(eng.params, prompts.int(),
                                              cache)
        compute = eng.plan.gather(eng.params) if mesh else eng.params
        logits, _ = eng.plan.decode_step(
            compute, torch.tensor([[5], [9]], dtype=torch.int32), cache)
    return logits


@pytest.mark.parametrize("kv_heads", [2, 1], ids=["heads", "sp"])
def test_decode_logits_within_tolerance(kv_heads):
    """One decode step's logits on tp=2 are within LOGIT_TOL x max |logit|
    of the single-device engine's on the same prompts, with the same
    argmax."""
    ms = models(kv_heads)
    ref, got = _step_logits(ms, None), _step_logits(ms, "tp=2")
    err = float((got - ref).abs().max())
    assert 0 < err <= LOGIT_TOL * float(ref.abs().max())
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


def _sealed_half(side, mesh):
    """A tp=2 slot engine after 3 steps of two greedy requests, with slot
    1's KV sealed out."""
    eng = side.engine(mesh=mesh)
    reqs = [eng.submit(side.gen(np.arange(1, 9) + i, max_new_tokens=8))
            for i in range(2)]
    for _ in range(3):
        eng.step()
    sealed, req = eng.seal_slot(1)
    return eng, reqs, sealed, req


@pytest.mark.parametrize("kv_heads", [2, 1], ids=["heads", "sp"])
def test_tp_blobs_cross_packages(kv_heads):
    """Each package's tp=2 engine restores the other's sealed row (the
    whole row's KV, under the same names and key) and finishes with the
    tokens of an uninterrupted single-device run."""
    ms = models(kv_heads)
    teng, treqs, tsealed, treq = _sealed_half(Side(True, ms), "tp=2")
    jeng, jreqs, jsealed, jreq = _sealed_half(Side(False, ms), "tp=2")
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
    plain = Side(True, ms).engine()
    want = [plain.generate(Side(True, ms).gen(
        np.arange(1, 9) + i, max_new_tokens=8)).tokens for i in range(2)]
    assert [r.output for r in treqs] == [r.output for r in jreqs] == want


def test_tp1_mesh_is_bit_equal_to_one_device():
    """A tp=1 mesh runs the single-device step on its placed weights: the
    same logits bits, tokens and sealed KV plaintext bits (the names
    differ by the ``/s0`` tag, hence the nonces and ciphertext)."""
    ms = models(2)
    assert torch.equal(_step_logits(ms, None), _step_logits(ms, "tp=1"))
    runs = []
    for mesh in (None, "tp=1"):
        eng, reqs, sealed, req = _sealed_half(Side(True, ms), mesh)
        plain = {n.removesuffix("/s0"): unseal_tensor(eng.td.sealing_key, st)
                 for n, st in sealed.items()}
        eng.restore_slot(sealed, req)
        eng.run()
        runs.append(([r.output for r in reqs], plain))
    assert runs[0][0] == runs[1][0]
    assert sorted(runs[0][1]) == sorted(runs[1][1])
    for n, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][n]), n


@pytest.mark.parametrize("arch", ["whisper-small"])
def test_other_families_refuse_tp(arch):
    """Serving the encdec family on a tp > 1 mesh raises: neither package
    serves it (it trains on a mesh: tests/test_torch_tp_train.py; the
    decoder families are served: tests/test_torch_tp_families.py,
    tests/test_torch_tp_jamba.py, tests/test_torch_tp_rwkv.py)."""
    model = tbuild(tsmoke(arch), device="cpu")
    side = Side(True, models(2))
    with pytest.raises(NotImplementedError,
                       match="neither package serves this family"):
        side.Engine(model, None, mesh="tp=2", device="cpu")


def test_kernel_decode_on_tp_mesh_refused_as_reference():
    """Kernel decode on a tp=2 mesh raises the reference's ValueError."""
    msgs = []
    for port in (True, False):
        side = MeshSide(port, models(2))
        with pytest.raises(ValueError) as e:
            side.engine(kv_backend="paged", page_size=8, kv_decode="kernel",
                        **TP)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "single-device plan" in msgs[0]


def test_tp_views_share_the_placed_weights():
    """The tp=2 plan keeps no second copy: every shard's weight is a view
    into the placed tree's storage, and the shards' blocks tile each
    split leaf."""
    ms = models(2)
    side = Side(True, ms)
    eng = side.engine(**TP)
    full = dict(tree_leaves_with_names(eng.params.full))
    lps = eng.params.compute
    assert len(lps) == 2
    wq = full["['layers']['slot_0']['attn']['wq']"]
    for s, lp in enumerate(lps):
        got = lp["layers"][1]["attn"]["wq"]
        assert got.untyped_storage().data_ptr() == \
            wq.untyped_storage().data_ptr()
        assert torch.equal(got, wq[1, :, 2 * s:2 * s + 2])
    table = full["['embedding']['table']"]
    assert torch.equal(torch.cat([lp["embedding"] for lp in lps]), table)
