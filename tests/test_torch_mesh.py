"""repro_torch's mesh engine (``ShardedPlan``, ``ShardedKVBackend``,
``--mesh``) against repro.runtime's on a dp=2 mesh. The reference runs on
the two host devices tests/conftest.py forces; the port's mesh is two
logical shards on the CPU, on weights converted 1:1 from the reference's.

The sharding rule tables agree spec for spec on every smoke config. The
canonical scenario (``CANONICAL_CONFIGS["sharded-dp2"]``, and a paged dp=2
variant with gather decode) matches in tokens, finish reasons, stats, the
audit log, page tables, every sealed name with its ``/s{shard}`` suffix,
and ``collective_steps``. The collective BYTES differ by design: the port
counts what its gather moves into one shard, (dp - 1) / dp of every leaf
``param_specs`` shards over ``data`` (180,224 B a step on smoke
``deepseek-7b``), while the reference parses its compiled HLO, where XLA
gathers less (83,072 B a step; ROADMAP.md queue C). Tail blobs, cross-package
blobs, refusals, ``measured_link_tax`` and the launcher's lines complete
the picture."""

import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from conftest import CANONICAL_CONFIGS
from repro.configs import smoke_config as jsmoke
from repro.core.bounce import ChannelStats as JStats
from repro.core.overheads import measured_link_tax as j_link_tax
from repro.distributed import sharding as jsharding
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.roofline.analysis import ICI_BW
from repro.runtime import SingleDevicePlan as JSingle
from repro.runtime import parse_mesh as j_parse_mesh
from repro_torch.configs import list_configs
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import overheads as t_over
from repro_torch.core.bounce import ChannelStats as TStats
from repro_torch.core.sealing import tree_leaves_with_names
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.runtime import (ShardedKVBackend, ShardedPlan,
                                 SingleDevicePlan)
from repro_torch.runtime import parse_mesh as t_parse_mesh
from repro_torch.runtime.kvcache import tail_blob_names
from test_torch_engine import _report
from test_torch_families_serving import _models
from test_torch_sampled_serving import Side, _canonical, assert_same_run
from test_torch_sealing import to_jax_blob, to_torch_blob

MESH = CANONICAL_CONFIGS["sharded-dp2"]                 # slot, dp=2
PAGED_MESH = dict(kv_backend="paged", page_size=8, mesh="dp=2")
# what one decode step's gather moves into a shard on smoke deepseek-7b:
# half of the 360,448 B of leaves sharded over data (the reference's HLO
# count is 83,072 B)
DEEPSEEK_GATHER_B = 180_224


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _jflat(specs):
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["dp2", "dp2tp2"])
@pytest.mark.parametrize("arch", list_configs())
def test_specs_match_reference(arch, shape):
    """``param_specs``, ``cache_specs`` and ``batch_specs`` give the
    reference's PartitionSpec entries leaf for leaf, with FSDP forced on
    (the mesh engine's setting) and off (the config's own)."""
    jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch), device="cpu")
    jmesh = AbstractMesh(shape, ("data", "model"))
    tmesh = make_host_mesh(*shape, device="cpu")
    params, dp_over_model = tm.init_params(0), tm.cfg.parallel.dp_over_model
    for fsdp in (True, False):
        cfg = SimpleNamespace(parallel=SimpleNamespace(
            fsdp=fsdp, dp_over_model=dp_over_model, zero1=False))
        assert dict(_flat(tsharding.param_specs(cfg, params, tmesh))) == \
            _jflat(jsharding.param_specs(cfg, jm.abstract_params(), jmesh))
        assert dict(_flat(tsharding.cache_specs(
            cfg, tm.abstract_cache(2, 64), tmesh))) == _jflat(
                jsharding.cache_specs(cfg, jm.abstract_cache(2, 64), jmesh))
        batch = {"tokens": np.zeros((4, 8), np.int32),
                 "labels": np.zeros((3, 8), np.int32)}
        assert dict(_flat(tsharding.batch_specs(cfg, batch, tmesh))) == \
            _jflat(jsharding.batch_specs(cfg, batch, jmesh))


@pytest.mark.parametrize("spec", ["dp=2", "dp=2,tp=4", "tp=2", "dp", "dp=0",
                                  "pp=2", "dp=2;tp=2", "", "  "])
def test_parse_mesh_matches_reference(spec):
    try:
        want = j_parse_mesh(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_parse_mesh(spec)
        assert str(got.value) == str(e)
    else:
        assert t_parse_mesh(spec) == want


class MeshSide(Side):
    """A Side whose engines record every sealed dict's names."""

    def engine(self, td=None, **kw):
        eng = super().engine(td, **kw)
        eng.sealed_names = []
        for meth in ("seal", "seal_tail_pages"):
            def record(*a, _inner=getattr(eng.kv, meth), **k):
                out = _inner(*a, **k)
                eng.sealed_names.append(sorted(out))
                return out
            setattr(eng.kv, meth, record)
        return eng


def _assert_same_mesh_run(j, t, gather_b=None):
    """Everything ``assert_same_run`` holds, plus the mesh's own: every
    sealed name (with a shard suffix, both shards used) and the collective
    step count equal the reference's; the port's collective bytes are its
    gather's, (dp - 1) / dp of the sharded leaves."""
    assert_same_run(j, t)
    jeng, teng = j[1], t[1]
    assert isinstance(teng.kv, ShardedKVBackend)
    assert teng.sealed_names == jeng.sealed_names
    names = [n for d in teng.sealed_names for n in d]
    assert names and all(n.endswith(("/s0", "/s1")) for n in names)
    assert {n[-3:] for n in names} == {"/s0", "/s1"}
    tch, jch = teng.td.channel.stats, jeng.td.channel.stats
    assert tch.collective_steps == jch.collective_steps > 0
    plan = teng.plan
    chunk_b = sum(c.numel() * c.element_size()
                  for x in teng.params.placed.values()
                  for c in x.blocks.values())
    assert plan.collective_bytes_per_step == chunk_b // 2
    assert tch.collective_bytes == tch.collective_steps * chunk_b // 2
    if gather_b is not None:
        assert plan.collective_bytes_per_step == gather_b
    assert tch.collective_s > 0


@pytest.fixture(scope="module")
def deepseek():
    return _models("deepseek-7b")


@pytest.mark.parametrize("kw", [MESH, PAGED_MESH], ids=["slot", "paged"])
def test_canonical_mesh_scenario_matches_reference(deepseek, kw):
    """The sampled canonical scenario on dp=2 equals the reference's run
    and the port's single-device run. The port's collective bytes a step
    are its gather's, 180,224 B; the reference's HLO count is 83,072 B."""
    t = _canonical(MeshSide(True, deepseek), **kw)
    j = _canonical(MeshSide(False, deepseek), **kw)
    _assert_same_mesh_run(j, t, DEEPSEEK_GATHER_B)
    # the mesh's tokens are the single-device engine's
    single = _canonical(Side(True, deepseek),
                        **{k: v for k, v in kw.items() if k != "mesh"})
    assert [r.output for r in t[0]] == [r.output for r in single[0]]


def test_moe_mesh_scenario_matches_reference():
    """dbrx's expert capacity is reckoned over the whole batch: the port's
    one call over every row matches the reference's SPMD program."""
    models = _models("dbrx-132b")
    t = _canonical(MeshSide(True, models), **MESH)
    _assert_same_mesh_run(_canonical(MeshSide(False, models), **MESH), t)


def _tail_run(side, scenario):
    """tests/test_sharded.py's tail eviction on a dp=2 mesh: two requests,
    slot 1 (shard 1) loses its tail page, then resumes it
    (``round_trip``), or is whole-sealed while paused, restored with its
    ``/s1`` tail blob grafted back, and runs to the end."""
    eng = side.engine(max_slots=2, max_len=64, prefill_len=8,
                      kv_backend="paged", page_size=8, mesh="dp=2")
    prompt = np.arange(1, 25, dtype=np.int32)
    reqs = [eng.submit(side.gen(prompt + i, max_new_tokens=8))
            for i in range(2)]
    for _ in range(2):
        eng.step()
    eng.partial_preempt(1, 1)
    tail = sorted(eng._paused[1].sealed)
    if scenario == "paused_whole_seal":
        sealed, req = eng.seal_slot(1)
        assert tail_blob_names(sealed) == [
            (f"kvslot/{req.stream_id}/0", "/s1")]
        eng.restore_slot(sealed, req)
    eng.run()
    return [list(r.output) for r in reqs], tail, \
        [(e.kind, e.detail) for e in eng.td.audit]


@pytest.mark.parametrize("scenario", ["round_trip", "paused_whole_seal"])
def test_tail_blob_round_trips_on_mesh(deepseek, scenario):
    tout, ttail, taudit = _tail_run(Side(True, deepseek), scenario)
    jout, jtail, jaudit = _tail_run(Side(False, deepseek), scenario)
    assert (tout, ttail, taudit) == (jout, jtail, jaudit)
    assert ttail and all(n.endswith("/s1") for n in ttail)
    plain = Side(True, deepseek).engine(max_slots=2, max_len=64,
                                        prefill_len=8)
    prompt = np.arange(1, 25, dtype=np.int32)
    assert tout == [plain.generate(Side(True, deepseek).gen(
        prompt + i, max_new_tokens=8)).tokens for i in range(2)]


def _sealed_half(side):
    """A dp=2 slot engine after 3 steps of two greedy requests, with slot
    1's KV sealed out (its names end in ``/s1``)."""
    eng = side.engine(mesh="dp=2")
    reqs = [eng.submit(side.gen(np.arange(1, 9) + i, max_new_tokens=8))
            for i in range(2)]
    for _ in range(3):
        eng.step()
    sealed, req = eng.seal_slot(1)
    return eng, reqs, sealed, req


def test_mesh_blobs_cross_packages(deepseek):
    """Each package's mesh engine restores the other's ``/s1`` blob (the
    same names, MACs under the same key) and finishes with the tokens of an
    uninterrupted run."""
    teng, treqs, tsealed, treq = _sealed_half(Side(True, deepseek))
    jeng, jreqs, jsealed, jreq = _sealed_half(Side(False, deepseek))
    assert sorted(tsealed) == sorted(jsealed)
    assert all(n.endswith("/s1") for n in tsealed)
    teng.restore_slot({n: to_torch_blob(st) for n, st in jsealed.items()},
                      treq)
    jeng.restore_slot({n: to_jax_blob(st) for n, st in tsealed.items()},
                      jreq)
    teng.run()
    jeng.run()
    plain = Side(True, deepseek).engine()
    want = [plain.generate(Side(True, deepseek).gen(
        np.arange(1, 9) + i, max_new_tokens=8)).tokens for i in range(2)]
    assert [r.output for r in treqs] == [r.output for r in jreqs] == want


def test_refusals_match_reference(deepseek, monkeypatch):
    """Kernel decode on a mesh, ``mesh=`` with ``plan=`` and ``--mesh`` with
    ``--workers`` fail as the reference fails, with its messages. A
    dp=2,tp=2 mesh serves the dense smoke model (tensor parallelism over
    logical shards) with the single-device engine's tokens, and a list of
    devices is refused with a ValueError: a mesh spans ranks, one device
    each."""
    tside, jside = Side(True, deepseek), Side(False, deepseek)
    for case in ("kernel", "plan"):
        msgs = []
        for side, single in ((tside, SingleDevicePlan), (jside, JSingle)):
            kw = (dict(PAGED_MESH, kv_decode="kernel") if case == "kernel"
                  else dict(MESH, plan=single(side.model)))
            with pytest.raises(ValueError) as e:
                side.engine(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert ("single-device plan" if case == "kernel"
                else "not both") in msgs[0]
    argv = ["--arch", "deepseek-7b", "--smoke", "--mesh", "dp=2",
            "--workers", "2"]
    msgs = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            _report(main, argv + extra, monkeypatch)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "mutually exclusive" in msgs[0]
    eng = tside.engine(mesh="dp=2,tp=2")
    assert eng.plan.tensor_parallel.tp == 2
    gen = dict(prompt=np.arange(1, 9), max_new_tokens=6)
    assert eng.generate(tside.gen(**gen)).tokens == \
        tside.engine().generate(tside.gen(**gen)).tokens
    with pytest.raises(ValueError, match="spans ranks, one device each"):
        make_host_mesh(2, 1, device=["cpu", "meta"])


def test_engine_takes_a_ready_plan(deepseek):
    """``Engine(plan=...)`` as in the reference: a ready ShardedPlan serves
    as ``mesh=`` does, a ready SingleDevicePlan as the default does."""
    side = Side(True, deepseek)
    gen = side.gen(np.arange(1, 9), max_new_tokens=6)
    want = side.engine().generate(gen).tokens
    for plan in (ShardedPlan(side.model, dp=2), SingleDevicePlan(side.model)):
        eng = side.engine(plan=plan)
        assert eng.plan is plan
        assert eng.generate(side.gen(np.arange(1, 9),
                                     max_new_tokens=6)).tokens == want
        assert isinstance(eng.kv, ShardedKVBackend) == plan.is_sharded


def test_plan_times_each_decode_gather(deepseek):
    """Each decode call runs on the weights gathered back whole from their
    chunks and queues that gather's own time; a drain returns the calls,
    their bytes and the sum of those times, and leaves nothing behind."""
    _, _, model, params = deepseek
    plan = ShardedPlan(model, dp=2)
    weights = plan.place_params(params)
    seen = []
    step = plan.compile_decode(lambda p, x: seen.append(p) or x)
    assert [step(weights, i) for i in range(3)] == [0, 1, 2]
    assert all(p is weights.full for p in seen)
    got = dict(tree_leaves_with_names(weights.full))
    for name, leaf in tree_leaves_with_names(params):
        assert torch.equal(got[name], leaf), name
    n, nbytes, secs = plan.drain_collectives()
    assert (n, nbytes) == (3, 3 * DEEPSEEK_GATHER_B) and secs > 0
    assert plan.drain_collectives() == (0, 0, 0.0)


def test_measured_link_tax_matches_reference(monkeypatch):
    """With the port's link rate set to the reference's ``ICI_BW`` the
    modeled and measured breakdowns and the line are the reference's."""
    monkeypatch.setattr(t_over, "LINK_BYTES_PER_S", ICI_BW)
    out = []
    for stats, fn in ((JStats(), j_link_tax),
                      (TStats(), t_over.measured_link_tax)):
        stats.collective_steps, stats.collective_bytes = 12, 12 * 180_224
        stats.collective_s = 12 * 3.5e-5
        modeled, measured, line = fn(stats, "tdx", 2.5e-2)
        out.append((modeled.overhead, measured.overhead, modeled.t_tee_s,
                    measured.t_tee_s, line))
    assert out[0] == out[1]


def test_serve_mesh_report_lines(monkeypatch):
    """``--mesh dp=2`` (with ``--slots 3``, rounded up to 4) prints the
    reference launcher's lines: the same labels, the same counts and
    boundary traffic, and a ``link-tax`` line over the same steps whose
    bytes are the port's own gather's."""
    argv = ["--arch", "deepseek-7b", "--smoke", "--requests", "5",
            "--max-new-tokens", "4", "--slots", "3", "--mesh", "dp=2"]
    jlines = _report(jserve.main, argv, monkeypatch)
    tlines = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    label = re.compile(r"^[^0-9(]*")
    assert [label.match(l).group(0) for l in tlines] == \
        [label.match(l).group(0) for l in jlines]
    # the boundary line's collective bytes and seconds are each package's own
    own = re.compile(r"collective_bytes=\d+, collective_s=[^,]+")
    for prefix in ("boundary:", "frame coalescing:", "[mesh] rounding"):
        assert [own.sub("", l) for l in tlines if l.startswith(prefix)] == \
            [own.sub("", l) for l in jlines if l.startswith(prefix)], prefix
    (tline,) = [l for l in tlines if l.startswith("link-tax")]
    (jline,) = [l for l in jlines if l.startswith("link-tax")]
    steps = re.compile(r"over (\d+) steps")
    assert steps.search(tline).group(1) == steps.search(jline).group(1)
    assert f": {DEEPSEEK_GATHER_B} collective B/step" in tline
    (spans,) = [l for l in tlines if l.startswith("[mesh] engine spans")]
    assert spans.endswith("(2 shards on 1 physical device, cpu)")
