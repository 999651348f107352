"""repro_torch's dry run (``launch/dryrun.py``, ``launch/hillclimb.py``,
``launch/mesh.make_production_mesh``, ``roofline/analysis.analyze``)
against repro.launch's, on the CPU.

  * the production meshes, the cell tables (``ASSIGNED``, ``OPT_BUNDLE``,
    ``VARIANTS``), ``block_counts``/``with_counts`` and the skip records
    are the reference's;
  * ``param_specs``, ``state_specs``, ``batch_specs`` and ``cache_specs``
    on both production meshes are the reference's on a
    ``jax.sharding.AbstractMesh``, leaf for leaf, for all ten archs;
  * the affine extrapolation gives the reference's totals, exactly, on
    the same synthetic per-variant costs (the reference's ``lower_step``,
    ``_costs`` and ``make_production_mesh`` monkeypatched here), and on
    smoke configs the port's own full-depth count;
  * one fake rank of a 2 x 2 dry mesh counts what the same program counts
    on CPU logical shards: FLOPs x 4 and the collective bytes into one
    shard, exactly, for train, prefill and decode of smoke deepseek-7b,
    dbrx and rwkv6. Where a rank computes what logical shards compute once
    the gap is named and counted: dbrx's replicated router in training
    (every model shard routes, logical shards once a batch shard) and its
    experts in serving (every data shard computes the gathered rows'
    expert outputs, logical shards once);
  * a decode lowering reaches no kernel wrapper; a full-size production
    cell lowers; the committed sweeps have every cell.

Importing ``repro.launch.dryrun`` sets XLA_FLAGS to 512 host devices for
later processes; this file puts the variable back as it found it.
"""

import dataclasses
import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec
from torch.utils.flop_counter import FlopCounterMode

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jd  # noqa: E402
import repro.launch.hillclimb as jh  # noqa: E402
import repro.launch.mesh as jmesh_mod  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402
from repro_torch.configs import SHAPES, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.sealing import tree_leaves_with_names  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.collectives import take_all  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    TensorParallel, gathered_shards)
from repro_torch.launch import dryrun as td  # noqa: E402
from repro_torch.launch import hillclimb as th  # noqa: E402
from repro_torch.launch.mesh import (make_dry_mesh,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as tloop  # noqa: E402

RESULTS = Path(__file__).resolve().parents[1] / "results"
# the dry-vs-logical comparisons' shapes (a smoke model on 2 x 2)
SMALL = {"train": ShapeConfig("train", 8, 4, "train"),
         "prefill": ShapeConfig("prefill", 8, 2, "prefill"),
         "decode": ShapeConfig("decode", 8, 2, "decode")}


def _jflat(specs):
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _tflat(specs):
    return dict(tree_leaves_with_names(specs))


# ---------------------------------------------------------------------------
# tables, meshes, skips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_production_mesh_matches_reference(monkeypatch, multi_pod):
    """Shape, axis names, name and chip count (the reference's mesh built
    as an AbstractMesh: 512 devices are not here)."""
    monkeypatch.setattr(jmesh_mod, "make_mesh", AbstractMesh)
    want = jmesh_mod.make_production_mesh(multi_pod=multi_pod)
    got = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert got.axis_names == tuple(want.axis_names)
    assert tuple(got.shape[a] for a in got.axis_names) == \
        tuple(want.axis_sizes)
    assert got.size == want.size == (512 if multi_pod else 256)
    assert got.name == ("2x16x16" if multi_pod else "16x16")
    assert got.device == torch.device("cpu") and got.backend == "dry"
    assert make_production_mesh().device == torch.device("cuda", 0)


def test_tables_and_skips_match_reference():
    assert td.ASSIGNED == jd.ASSIGNED
    assert td.OPT_BUNDLE == jd.OPT_BUNDLE
    assert th.VARIANTS == jh.VARIANTS
    for arch in td.ASSIGNED:
        jc, tc = jget(arch), get_config(arch)
        assert td.block_counts(tc) == jd.block_counts(jc)
        counts = td.block_counts(tc)
        for pt in [dict.fromkeys(counts, 1), dict.fromkeys(counts, 2)]:
            assert dataclasses.asdict(td.with_counts(tc, pt, False)) == \
                dataclasses.asdict(jd.with_counts(jc, pt, False))
        for shape in SHAPES:
            for multi_pod in (False, True):
                if jd.shape_applicable(jc, JSHAPES[shape])[0]:
                    continue
                assert td.lower_cell(arch, shape, multi_pod=multi_pod,
                                     device="cpu") == \
                    jd.lower_cell(arch, shape, multi_pod=multi_pod)


def test_analyze_builds_the_cell_roofline():
    lowered = td.Lowered(flops=2e12, bytes=3e11,
                         collectives={"all-reduce": 4e9, "all-gather": 1e9},
                         arg_bytes=10, temp_bytes=20, out_bytes=30)
    cell = td.analyze(lowered, arch="a", shape="s", mesh_name="16x16",
                      n_chips=256, model_flops=1e14)
    assert cell.collective_bytes_per_dev == 5e9
    assert cell.collective_breakdown == {"all-reduce": 4e9, "all-gather": 1e9}
    assert cell.hbm_bytes_per_dev == 60 and cell.n_chips == 256
    assert cell.bound == "memory"


def test_dry_group_counts_what_a_rank_receives():
    """A DryGroup of 4 returns the rank program's shapes and counts the
    bytes into one shard as LocalGroup and RankGroup do, by kind; a
    mesh's tuple of axes has its own group."""
    from repro_torch.distributed.collectives import DryGroup, LocalGroup
    x = torch.ones(3, 5)
    dry, local = DryGroup(4, "cpu"), LocalGroup(4, "cpu")
    assert dry.all_gather([x], dim=1).shape == (3, 20)
    assert dry.all_reduce([x]).shape == (3, 5)
    assert dry.ppermute([x], [(1, 0), (2, 3)])[0].shape == (3, 5)
    assert dry.broadcast(None, 2, (2, 2), torch.float32).shape == (2, 2)
    local.all_gather([x] * 4, dim=1)
    local.all_reduce([x] * 4)
    nbytes, marks = dry.take()
    assert nbytes == local.take()[0] + 60 + 16 and marks == [0.0] * 4
    assert dry.kinds == {"all_gather": 180, "all_reduce": 180,
                         "ppermute": 60, "broadcast": 16}
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert mesh.group(("pod", "data")).size == 32
    assert mesh.group(("pod", "data", "model")) is mesh.flat
    assert mesh.flat.size == 512 and mesh.spans_ranks


# ---------------------------------------------------------------------------
# specs on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", td.ASSIGNED)
def test_specs_on_production_meshes_match_reference(arch):
    """param, state, batch and cache specs of each arch on 16x16 and
    2x16x16 (the decode_32k cache, the train_4k batch)."""
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch), device="meta")
    jstate = jloop.abstract_train_state(jm, jopt.AdamWConfig(
        moment_dtype=jm.cfg.parallel.optimizer_dtype))
    tstate = tloop.abstract_train_state(tm, topt.AdamWConfig(
        moment_dtype=tm.cfg.parallel.optimizer_dtype))
    jcache = jm.cache_specs(JSHAPES["decode_32k"])
    tcache = tm.cache_specs(SHAPES["decode_32k"])
    tbatch = tm.train_batch_specs(SHAPES["train_4k"])
    jbatch = jax.eval_shape(lambda: jm.train_batch_specs(JSHAPES["train_4k"]))
    for multi_pod in (False, True):
        tmesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        jmesh = AbstractMesh(tuple(tmesh.shape.values()), tmesh.axis_names)
        assert _tflat(sharding.param_specs(tm.cfg, tstate.params, tmesh)) == \
            _jflat(jsharding.param_specs(jm.cfg, jstate.params, jmesh))
        assert _tflat(sharding.state_specs(tm.cfg, tstate, tmesh)) == \
            _jflat(jsharding.state_specs(jm.cfg, jstate, jmesh))
        assert _tflat(sharding.cache_specs(tm.cfg, tcache, tmesh)) == \
            _jflat(jsharding.cache_specs(jm.cfg, jcache, jmesh))
        got = _tflat(sharding.batch_specs(tm.cfg, tbatch, tmesh))
        assert got == _jflat(jsharding.batch_specs(jm.cfg, jbatch, jmesh))
        if multi_pod:
            assert got["['labels']"] == (("pod", "data"), None)


# ---------------------------------------------------------------------------
# the affine extrapolation
# ---------------------------------------------------------------------------

KEYS = ["flops", "bytes", "coll/all-reduce", "coll/all-gather"]


def _synthetic(cfg, arch):
    """Costs affine in the block counts, with seeded coefficients."""
    counts = jd.block_counts(cfg)
    rng = np.random.default_rng(sum(map(ord, arch)))
    out = {}
    for key in KEYS:
        coef = rng.integers(1, 10**9, len(counts) + 1).astype(float)
        out[key] = coef[0] + sum(c * counts[k] for c, k in
                                 zip(coef[1:], sorted(counts)))
    return out


@pytest.mark.parametrize("arch", td.ASSIGNED)
def test_extrapolation_matches_reference(monkeypatch, arch):
    """The same synthetic costs of each unit-depth variant through both
    packages' ``lower_cell``: the same totals, exactly."""
    ma = SimpleNamespace(argument_size_in_bytes=100, alias_size_in_bytes=40,
                         temp_size_in_bytes=7, output_size_in_bytes=9)
    monkeypatch.setattr(jd, "make_production_mesh",
                        lambda multi_pod=False: SimpleNamespace(size=256))
    monkeypatch.setattr(jd, "lower_step", lambda cfg, shape, mesh:
                        SimpleNamespace(compile=lambda: SimpleNamespace(
                            cfg=cfg, memory_analysis=lambda: ma)))
    monkeypatch.setattr(jd, "_costs", lambda c: _synthetic(c.cfg, arch))

    def lower_step(cfg, shape, mesh):
        c = _synthetic(cfg, arch)
        return td.Lowered(flops=c["flops"], bytes=c["bytes"], collectives={
            k.split("/")[1]: v for k, v in c.items() if "/" in k},
            arg_bytes=60, temp_bytes=7, out_bytes=9)

    monkeypatch.setattr(td, "lower_step", lower_step)
    want = jd.lower_cell(arch, "train_4k", verbose=False)
    got = td.lower_cell(arch, "train_4k", verbose=False, device="cpu")
    for key in ("flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
                "collective_breakdown", "n_chips", "model_flops",
                "arg_bytes", "temp_bytes", "out_bytes"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("arch,kind,counts", [
    ("deepseek-v3-671b", "decode", {"dense": 2, "moe": 3}),
    ("deepseek-7b", "train", {"layers": 4}),
])
def test_extrapolation_equals_full_depth(arch, kind, counts):
    """On smoke configs the extrapolated totals are the port's own count
    at full depth (eager torch counts every layer): the costs from the
    unit-depth variants, the footprint from 2 layers a block type on,
    exactly."""
    cfg = td.with_counts(smoke_config(arch), counts, False)
    mesh = make_dry_mesh({"data": 2, "model": 2}, "cpu")
    shape = SMALL[kind]
    got = td.extrapolate_cell(cfg, lambda c: td._measures(td.lower_step(
        c, shape, mesh)))
    assert got == td._measures(td.lower_step(cfg, shape, mesh))


# ---------------------------------------------------------------------------
# one fake rank against the same program on logical shards
# ---------------------------------------------------------------------------

def _batch(meta, vocab, rng):
    return {k: (torch.as_tensor(rng.standard_normal(v.shape), dtype=v.dtype)
                if v.dtype.is_floating_point else torch.as_tensor(
                    rng.integers(0, vocab, v.shape), dtype=v.dtype))
            for k, v in meta.items()}


class _Counted:
    """FLOPs counted inside calls of a function (a nested
    FlopCounterMode: the outer counter counts them too)."""

    def __init__(self, monkeypatch, module, name):
        self.flops, inner = 0, getattr(module, name)

        def counted(*a, **k):
            with FlopCounterMode(display=False) as fc:
                out = inner(*a, **k)
            self.flops += fc.get_total_flops()
            return out

        monkeypatch.setattr(module, name, counted)


def _logical(cfg, shape, mesh, monkeypatch):
    """(FLOPs, collective bytes into one shard, the named gap) of the
    step on logical shards of ``mesh`` (CPU tensors)."""
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    groups = tuple(mesh.groups.values()) + (mesh.flat,)
    kind, (dp, tp) = shape.step_kind, (mesh.shape["data"],
                                        mesh.shape["model"])
    if kind == "train":
        # every model shard routes on a rank, each batch shard once here:
        # the router's forward, remat's recompute and its two backward
        # products, each 2 T d E, on the batch group's gathered rows
        opt = topt.AdamWConfig(moment_dtype=cfg.parallel.optimizer_dtype)
        state = tloop.init_train_state(model, opt, 0)
        sspecs = sharding.state_specs(cfg, state, mesh)
        meta = model.train_batch_specs(shape)
        step = tloop.make_sharded_train_step(
            model, opt, mesh, sspecs, sharding.batch_specs(cfg, meta, mesh),
            microbatches=cfg.parallel.microbatches)
        placed = sharding.place(state, sharding.to_named(mesh, sspecs))
        batch = _batch(meta, cfg.vocab_size, rng)
        with FlopCounterMode(display=False) as fc:
            _, metrics = step(placed, batch)
        gap = 0
        if cfg.moe is not None:
            tokens = shape.global_batch * shape.seq_len
            gap = ((tp - 1) * dp * cfg.num_layers * 4 * 2 * tokens
                   * cfg.d_model * cfg.moe.num_experts)
        return fc.get_total_flops(), metrics["collective_bytes"], gap
    params = model.init_params(0)
    pspecs = sharding.param_specs(cfg, params, mesh)
    placed = sharding.place(params, sharding.to_named(mesh, pspecs))
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    par = TensorParallel(model, mesh, local_cache=False)
    meta = (model.prefill_batch_specs(shape) if kind == "prefill"
            else {"tokens": model.decode_token_specs(shape)})
    batch = _batch(meta, cfg.vocab_size, rng)
    experts = _Counted(monkeypatch, moe, "moe_forward")
    take_all(groups)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        lps = par.layer_params(gathered_shards(placed, mesh))
        if kind == "prefill":
            par.prefill(lps, batch["tokens"], cache, split_rows=True)
        else:
            par.decode_step(lps, batch["tokens"], cache)
    nbytes, _ = take_all(groups)
    # the MoE layers' gathered rows: computed once here, by every data
    # shard on a rank
    return fc.get_total_flops(), nbytes, (dp - 1) * experts.flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "dbrx-132b", "rwkv6-3b"])
def test_dry_rank_counts_the_logical_run(monkeypatch, arch, kind):
    cfg, shape = smoke_config(arch), SMALL[kind]
    dry = td.lower_step(cfg, shape, make_dry_mesh(
        {"data": 2, "model": 2}, "cpu"))
    flops, nbytes, gap = _logical(cfg, shape, make_host_mesh(
        2, 2, device="cpu"), monkeypatch)
    assert dry.flops * 4 == flops + gap
    assert (gap > 0) == (arch == "dbrx-132b")
    assert dry.collective_bytes == nbytes > 0
    assert dry.arg_bytes > 0 and dry.out_bytes > 0 and dry.bytes > 0


def test_decode_lowering_reaches_no_kernel(monkeypatch):
    """The dry run's decode runs on the dense cache in plain torch: every
    kernel wrapper raises here, and the lowerings still run."""
    from repro_torch.kernels import chacha20, flash_attention, ops, qmatmul
    from repro_torch.kernels import paged_attention

    def trap(*a, **k):
        raise AssertionError("a kernel wrapper was reached")

    for mod in (chacha20, flash_attention, ops, qmatmul, paged_attention):
        for name in dir(mod):
            fn = getattr(mod, name)
            if callable(fn) and getattr(fn, "__module__", "") == mod.__name__ \
                    and not isinstance(fn, type) and not name.startswith("_"):
                monkeypatch.setattr(mod, name, trap)
    mesh = make_dry_mesh({"data": 2, "model": 2}, "cpu")
    for arch in ("whisper-small", "jamba-v0.1-52b"):
        low = td.lower_step(smoke_config(arch), SMALL["decode"], mesh)
        assert low.flops > 0


# ---------------------------------------------------------------------------
# a full-size production cell; the committed sweeps
# ---------------------------------------------------------------------------

def test_production_decode_cell_lowers_on_the_cpu():
    cell = td.lower_cell("deepseek-7b", "decode_32k", verbose=False,
                         device="cpu")
    assert cell.n_chips == 256 and cell.mesh == "16x16"
    assert cell.compute_s > 0 and cell.memory_s > 0 and cell.collective_s > 0
    assert cell.arg_bytes > 0 and cell.temp_bytes > 0 and cell.fits_hbm
    assert set(cell.collective_breakdown) <= {"all-gather", "all-reduce"}


def _records(name):
    return json.loads((RESULTS / name).read_text())


@pytest.mark.parametrize("fname", ["torch_dryrun_single_pod.json",
                                   "torch_dryrun_multi_pod.json"])
def test_committed_sweep_has_every_cell(fname):
    recs = _records(fname)
    assert len({r["arch"] for r in recs}) == 10
    assert sum(1 for r in recs if "error" in r) == 0
    assert len(recs) == 40
    skips = [r for r in recs if r.get("skipped")]
    assert len(skips) == 8 and all(r["shape"] == "long_500k" for r in skips)
    n = 512 if "multi" in fname else 256
    assert all(r["n_chips"] == n for r in recs if not r.get("skipped"))


def test_committed_sweep_terms_present_and_positive():
    for r in _records("torch_dryrun_single_pod.json"):
        if r.get("skipped"):
            continue
        assert r["compute_s"] > 0 and r["memory_s"] > 0
        assert r["bound"] in ("compute", "memory", "collective")


# ---------------------------------------------------------------------------
# the launchers' record files
# ---------------------------------------------------------------------------

def test_dryrun_main_resumes_and_records_failures(monkeypatch, tmp_path):
    """``--out`` is resumable: a cell recorded already is not lowered
    again; a cell that fails to lower is an error record and exit 1."""
    calls = []

    def lower_cell(arch, shape, **kw):
        calls.append((arch, shape, kw["device"]))
        if shape == "prefill_32k":
            raise RuntimeError("boom")
        return {"arch": arch, "shape": shape, "mesh": "16x16"}

    monkeypatch.setattr(td, "lower_cell", lower_cell)
    out = tmp_path / "r.json"
    argv = ["--arch", "deepseek-7b", "--shape", "train_4k", "--out",
            str(out), "--device", "cpu"]
    assert td.main(argv) == 0 and td.main(argv) == 0
    assert calls == [("deepseek-7b", "train_4k", "cpu")]
    assert td.main(["--arch", "qwen3-32b", "--shape", "prefill_32k",
                    "--out", str(out)]) == 1
    recs = json.loads(out.read_text())
    assert [r["arch"] for r in recs] == ["deepseek-7b", "qwen3-32b"]
    assert recs[1]["error"] == "boom" and "compile_s" in recs[1]
    assert td.default_out(True) == "results/torch_dryrun_multi_pod.json"


def test_hillclimb_replaces_the_same_variant(monkeypatch, tmp_path):
    seen = []

    def lower_cell(arch, shape, *, multi_pod, cfg_override, device):
        seen.append(cfg_override.parallel)
        return {"arch": arch, "shape": shape, "n": len(seen)}

    monkeypatch.setattr(th, "lower_cell", lower_cell)
    out = tmp_path / "p.json"
    for variant in ("baseline", "remat-dots", "remat-dots"):
        th.main(["--arch", "deepseek-7b", "--shape", "train_4k",
                 "--variant", variant, "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [(r["variant"], r["n"]) for r in recs] == [("baseline", 1),
                                                     ("remat-dots", 3)]
    assert seen[1].remat == "dots_saveable" and seen[0].remat == "full"
