"""repro_torch's mesh engine over ranks: gloo CPU processes
(``torch.multiprocessing``, ``file://`` init under ``tmp_path``), each
running the same engine loop on the same requests
(tests/_torch_ranks_worker.py), against the same mesh on logical shards in
this process.

On ``tp=2`` and ``dp=2`` over 2 ranks and ``dp=2,tp=2`` over 4 (the slot
backend), on ``tp=2`` and ``dp=2`` with the paged backend (smoke
deepseek-7b with prefix sharing: a shared page, a preemption that seals
pages by value and by reference), and paged at ``tp=2`` on smoke
dbrx-132b (MoE), on deepseek-v3-671b (MLA's latent whole on every rank),
on jamba-v0.1-52b (each rank's Mamba channels of every row beside its KV
heads of every page) and with one KV head (each rank keeps the whole
pool), and on the slot backend at ``tp=2`` on rwkv6-3b (each rank's
``wkv`` heads), every rank's tokens, page tables, sealed names and blob bytes
equal the logical run's bit for bit; each name is sealed by exactly one
rank (model coordinate 0 of the row's data shard, rank 0 for a
content-named page), and only rank 0 sends egress frames. The serving
launcher under ``torch.distributed.run`` prints the logical run's lines
on a paged MoE model with sharing and the store, and on paged jamba. The ring
collective matmuls (``distributed/overlap.py``) over 2 ranks and over a
``LocalGroup(2)`` match the one-shot products and the reference's own
functions under ``shard_map`` on conftest's 2 host devices, within the
reference test's tolerances (tests/test_distributed.py: 1e-4 and 1e-3)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks_worker as W
from repro.distributed import overlap as joverlap
from repro.distributed.compat import make_mesh, shard_map as jshard_map
from repro_torch.distributed.collectives import LocalGroup

# mesh name -> (mesh, world, the worker's runs on one spawn)
MESHES = {"tp2": ("tp=2", 2, ("slot", "paged", "dbrx", "sp", "mla",
                             "jamba", "rwkv")),
          "dp2": ("dp=2", 2, ("slot", "paged")),
          "dp2tp2": ("dp=2,tp=2", 4, ("slot",))}
# (mesh name, run); the slot runs keep their mesh's name as the case id
CASES = [(m, r) for m, (_, _, runs) in MESHES.items() for r in runs]
RING_TOL = (1e-4, 1e-3)     # the reference test's atol for each product
# the serving launcher on a MoE model, paged with sharing and the store,
# and on jamba paged
LAUNCH = ["-m", "repro_torch.launch.serve", "--arch", "dbrx-132b", "--smoke",
          "--mesh", "tp=2", "--kv-backend", "paged", "--page-size", "8",
          "--prefix-sharing", "--page-store", "--requests", "4",
          "--max-new-tokens", "6", "--device", "cpu"]
LAUNCH_JAMBA = ["-m", "repro_torch.launch.serve", "--arch", "jamba-v0.1-52b",
                "--smoke", "--mesh", "tp=2", "--kv-backend", "paged",
                "--page-size", "8", "--requests", "4", "--max-new-tokens",
                "6", "--device", "cpu"]

_RUNS = {}


def _logical(mesh, run):
    """The same waves on logical shards in this process (one thread, as
    the ranks run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.serve(mesh, "cpu", run)
    finally:
        torch.set_num_threads(threads)


def _ranks(name, tmp_path_factory):
    if name not in _RUNS:
        mesh, world, runs = MESHES[name]
        _RUNS[name] = W.spawn(mesh, world, tmp_path_factory.mktemp(name),
                              with_ring=name == "tp2", runs=runs)
    return _RUNS[name]


@pytest.mark.parametrize("name,run", CASES,
                         ids=[m if r == "slot" else f"{m}-{r}"
                              for m, r in CASES])
def test_ranks_equal_logical_shards(name, run, tmp_path_factory):
    """Every rank's tokens, page tables, sealed names and blob bytes equal
    the logical run's; no name is sealed by two ranks, every recorded name
    by one (and on the paged backend each content-named page too, by rank
    0); rank 0 alone egresses."""
    mesh, world, _ = MESHES[name]
    want = _logical(mesh, run)
    ranks = [got[run] for got in _ranks(name, tmp_path_factory)]
    assert want["preemptions"] > 0 and want["seals"]
    for r, got in enumerate(ranks):
        assert got["tokens"] == want["tokens"], r
        assert got["seals"] == want["seals"], r
        assert len(got["tables"]) == len(want["tables"])
        for a, b in zip(got["tables"], want["tables"]):
            assert np.array_equal(a, b), r
        assert got["preemptions"] == want["preemptions"]
        assert got["shared_pages"] == want["shared_pages"]
        assert got["steps"] == want["steps"] > 0
        assert f"{world} ranks over gloo" in got["describe"]
    if run == "paged":
        assert want["shared_pages"] > 0
    names = [n for s in want["seals"] for n in s]
    sealed_by = [n for got in ranks for n in got["own"]]
    assert len(set(sealed_by)) == len(sealed_by)       # no name twice
    assert set(names) <= set(sealed_by)
    assert all(n.startswith("kvshared/") for n in set(sealed_by) - set(names))
    tp = 2 if "tp" in mesh else 1
    for r, got in enumerate(ranks):
        assert r % tp == 0 or not got["own"], r
        assert all(r == 0 for n in got["own"] if n.startswith("kvshared/"))
    assert ranks[0]["frames"] == want["frames"] > 0
    assert all(got["frames"] == 0 for got in ranks[1:])


def test_ring_matmuls_over_ranks_and_local(tmp_path_factory):
    """all_gather_matmul and matmul_reduce_scatter over 2 gloo ranks equal
    the same rings over a LocalGroup(2) bit for bit, the one-shot products
    and the reference's rings on 2 host devices within the reference
    test's tolerances."""
    a = W.ring_inputs()
    y_local, y2_local = W.ring(LocalGroup(2, "cpu"))
    for got in _ranks("tp2", tmp_path_factory):
        y, y2 = got["ring"]
        assert torch.equal(y, y_local) and torch.equal(y2, y2_local)
    assert torch.allclose(y_local, a["x"] @ a["w"], atol=RING_TOL[0])
    assert torch.allclose(y2_local, a["xk"] @ a["wk"], atol=RING_TOL[1])
    from jax.sharding import PartitionSpec as P
    jmesh = make_mesh((2,), ("model",))
    jy = jshard_map(lambda x, w: joverlap.all_gather_matmul(x, w, "model"),
                    mesh=jmesh, in_specs=(P("model", None), P(None, None)),
                    out_specs=P(None, None), check_vma=False)(
                        a["x"].numpy(), a["w"].numpy())
    jy2 = jshard_map(
        lambda x, w: joverlap.matmul_reduce_scatter(x, w, "model"),
        mesh=jmesh, in_specs=(P(None, "model"), P("model", None)),
        out_specs=P("model", None), check_vma=False)(
            a["xk"].numpy(), a["wk"].numpy())
    np.testing.assert_allclose(y_local.numpy(), np.asarray(jy),
                               atol=RING_TOL[0], rtol=0)
    np.testing.assert_allclose(y2_local.numpy(), np.asarray(jy2),
                               atol=RING_TOL[1], rtol=0)


def _launch(cmd):
    """``cmd`` in one process on logical shards and under
    ``torch.distributed.run`` over 2 gloo ranks: (logical stdout, ranks'
    stdout)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p))
    logical = subprocess.run([sys.executable, *cmd], capture_output=True,
                             text=True, timeout=300, env=env)
    assert logical.returncode == 0, logical.stderr[-2000:]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *cmd], capture_output=True, text=True,
        timeout=300, env=env)
    assert ranks.returncode == 0, ranks.stderr[-2000:]
    return logical.stdout, ranks.stdout


def _lines(out, *starts):
    return [ln for ln in out.splitlines() if ln.startswith(starts)]


def _same_mesh_lines(logical, ranks):
    """The mesh line names the ranks, the link-tax line's bytes are the
    logical run's, and rank 0 alone prints."""
    assert _lines(ranks, "[mesh] engine spans dp=1,tp=2 (2 ranks over gloo")
    tax = [ln.split(" over ")[0] for ln in _lines(ranks, "link-tax")]
    assert tax and tax == [ln.split(" over ")[0]
                           for ln in _lines(logical, "link-tax")]
    assert len(_lines(ranks, "served ")) == 1    # rank 0 alone


def test_launcher_serves_paged_moe_over_ranks():
    """``serve.py --mesh tp=2 --kv-backend paged --prefix-sharing
    --page-store`` on smoke dbrx-132b under ``torch.distributed.run`` over
    2 gloo ranks prints the logical run's sealed-traffic, sharing and
    store lines and its collective bytes a step, the mesh line naming the
    ranks, and nothing from rank 1."""
    logical, ranks = _launch(LAUNCH)
    same = ("sealed-KV traffic:", "prefix sharing:", "store hits:",
            "kv decode:")
    assert _lines(ranks, *same) == _lines(logical, *same)
    assert len(_lines(logical, *same)) == 4
    _same_mesh_lines(logical, ranks)


def test_launcher_serves_jamba_over_ranks():
    """``serve.py --arch jamba-v0.1-52b --smoke --mesh tp=2 --kv-backend
    paged`` under ``torch.distributed.run`` over 2 gloo ranks prints the
    logical run's decode line, boundary counters (frames, bytes and
    collective steps and bytes; not the measured seconds) and collective
    bytes a step, the mesh line naming the ranks, and nothing from rank
    1."""
    logical, ranks = _launch(LAUNCH_JAMBA)

    def boundary(out):
        return [re.sub(r"collective_s=[^,]*, ", "", ln)
                for ln in _lines(out, "kv decode:", "boundary:")]
    assert len(boundary(logical)) == 2
    assert boundary(ranks) == boundary(logical)
    _same_mesh_lines(logical, ranks)
