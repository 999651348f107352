"""repro_torch's mesh engine over ranks: gloo CPU processes
(``torch.multiprocessing``, ``file://`` init under ``tmp_path``), each
running the same engine loop on the same requests
(tests/_torch_ranks_worker.py), against the same mesh on logical shards in
this process.

On ``tp=2`` and ``dp=2`` over 2 ranks and ``dp=2,tp=2`` over 4, every
rank's tokens, sealed names and blob bytes equal the logical run's bit for
bit; each name is sealed by exactly one rank (model coordinate 0 of the
row's data shard), and only rank 0 sends egress frames; the paged backend
over ranks raises naming ROADMAP.md item 21 part 3. The ring
collective matmuls (``distributed/overlap.py``) over 2 ranks and over a
``LocalGroup(2)`` match the one-shot products and the reference's own
functions under ``shard_map`` on conftest's 2 host devices, within the
reference test's tolerances (tests/test_distributed.py: 1e-4 and 1e-3)."""

import numpy as np
import pytest
import torch

import _torch_ranks_worker as W
from repro.distributed import overlap as joverlap
from repro.distributed.compat import make_mesh, shard_map as jshard_map
from repro_torch.distributed.collectives import LocalGroup

MESHES = {"tp2": ("tp=2", 2), "dp2": ("dp=2", 2), "dp2tp2": ("dp=2,tp=2", 4)}
RING_TOL = (1e-4, 1e-3)     # the reference test's atol for each product

_RUNS = {}


def _logical(mesh):
    """The same waves on logical shards in this process (one thread, as
    the ranks run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.serve(mesh)
    finally:
        torch.set_num_threads(threads)


def _ranks(name, tmp_path_factory):
    if name not in _RUNS:
        mesh, world = MESHES[name]
        _RUNS[name] = W.spawn(mesh, world, tmp_path_factory.mktemp(name),
                              with_ring=name == "tp2")
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ranks_equal_logical_shards(name, tmp_path_factory):
    """Every rank's tokens, sealed names and blob bytes equal the logical
    run's; no name is sealed by two ranks, every name by one; rank 0 alone
    egresses."""
    mesh, world = MESHES[name]
    want = _logical(mesh)
    ranks = _ranks(name, tmp_path_factory)
    assert want["preemptions"] > 0 and want["seals"]
    for r, got in enumerate(ranks):
        assert got["tokens"] == want["tokens"], r
        assert got["seals"] == want["seals"], r
        assert got["preemptions"] == want["preemptions"]
        assert got["steps"] == want["steps"] > 0
        assert f"{world} ranks over gloo" in got["describe"]
    names = [n for s in want["seals"] for n in s]
    owners = [r for r, got in enumerate(ranks) for _ in got["own"]]
    sealed_by = [n for got in ranks for n in got["own"]]
    assert sorted(sealed_by) == sorted(names)          # each name once
    tp = 2 if "tp" in mesh else 1
    assert set(owners) <= {r for r in range(world) if r % tp == 0}
    assert ranks[0]["frames"] == want["frames"] > 0
    assert all(got["frames"] == 0 for got in ranks[1:])


def test_ring_matmuls_over_ranks_and_local(tmp_path_factory):
    """all_gather_matmul and matmul_reduce_scatter over 2 gloo ranks equal
    the same rings over a LocalGroup(2) bit for bit, the one-shot products
    and the reference's rings on 2 host devices within the reference
    test's tolerances. (The same spawn checks the paged refusal.)"""
    a = W.ring_inputs()
    y_local, y2_local = W.ring(LocalGroup(2, "cpu"))
    for got in _ranks("tp2", tmp_path_factory):
        y, y2 = got["ring"]
        assert torch.equal(y, y_local) and torch.equal(y2, y2_local)
        assert "item 21 part 3" in got["paged"]    # paged over ranks raises
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
