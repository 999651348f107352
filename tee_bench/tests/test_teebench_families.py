"""The port's other decoder families through the harness at a smoke size:
deepseek-v3-671b's tree (moe: MLA, a shared expert, a dense first layer)
and jamba-v0.1-52b's (hybrid), every leaf made by the benchmark from a
test-local leaf table, one row a model layer and no two alike, sealed,
unsealed and served on the gather decode path through ``runner.serve``;
the port's config held to a configuration's file by family; declared
model FLOPs in the yardstick."""

import pytest
import torch

from teebench import program, runner, spec, weights, yardstick
from teebench.client import clock

import families
import smoke

FAMILIES = sorted(families.CONFIGS)
# the model layers each leaf's rows are made for in the smoke trees
LAYERS = {
    "moe": {"mla.w_dq": {0, 1}, "ffn.w_gate": {0}, "moe.router": {1},
            "moe.shared.w_down": {1}, "pre_norm.scale": {0, 1}},
    "hybrid": {"mamba.w_in": set(range(7)), "attn.wq": {7},
               "moe.experts.w_up": {1, 3, 5, 7}, "ffn.w_down": {0, 2, 4, 6},
               "pre_norm.scale": set(range(8))},
}


@pytest.fixture
def tables(monkeypatch):
    families.register(monkeypatch)


def _gather_cell():
    return smoke.setup(engine=dict(smoke.CELL["engine"],
                                   kv_decode="gather"))[1]


def _system(family, seed, device="cpu"):
    cfg = families.CONFIGS[family]
    return cfg, program.System(cfg, _gather_cell(), seed, device=device,
                               model_cfg=families.model_cfg(cfg))


@pytest.mark.parametrize("family", FAMILIES)
def test_every_leaf_is_made_for_its_model_layer(tables, family):
    """The unsealed tree: each row the benchmark's leaf for its model
    layer, made alone; no two model layers of a leaf alike; every model
    layer present; f32 where the table says so."""
    from repro_torch.core.sealing import tree_leaves_with_names
    cfg, system = _system(family, 2 ** 35 + 7)
    assert system.engine.kv.decode_mode == "gather"
    blocks = program.blocks_of(system.params)
    rows = {}
    for path, leaf in tree_leaves_with_names(system.params):
        name, layers = program.logical_name(path, blocks)
        assert leaf.dtype == weights.dtype_of(cfg, weights.describe(cfg,
                                                                    name))
        for layer, row in (zip(layers, leaf) if layers else [(-1, leaf)]):
            assert layer not in rows.setdefault(name, {})
            rows[name][layer] = row
            assert torch.equal(row, weights.make(cfg, 2 ** 35 + 7, name,
                                                 layer, device="cpu"))
    system.close()
    assert {layer for r in rows.values() for layer in r} - {-1} == \
        set(range(cfg["num_hidden_layers"]))
    assert set(rows) == set(spec.reference(cfg).leaves(cfg))
    for name, want in LAYERS[family].items():
        assert set(rows[name]) == want, name
    for name, by_layer in rows.items():
        alike = [(a, b) for a in by_layer for b in by_layer
                 if a < b and torch.equal(by_layer[a], by_layer[b])]
        assert not alike, (name, alike)


def _serve(family, device):
    cfg, system = _system(family, 2 ** 33 + 9, device)
    cell = system.cell
    seconds = smoke.window_s(cfg, families.model_cfg(cfg), cell)
    run = runner.serve(system, cfg, cell, smoke.MIX, 2 ** 33 + 9, seconds,
                       traced=False, t_process0=clock())
    system.close()
    done = [r for r in run.records if r.finished]
    assert not any(r.failed for r in run.records)
    assert len(done) >= cell["check"]["min_requests"]
    assert sum(len(r.tokens) for r in done) >= cell["check"]["min_tokens"]
    assert all(0 <= t < cfg["vocab_size"] for r in done for t in r.tokens)
    assert run.decode_calls


@pytest.mark.parametrize("family", FAMILIES)
def test_the_tree_serves_on_the_gather_path(tables, family):
    _serve(family, "cpu")


@pytest.mark.parametrize("family,changes,reference,fails", [
    ("moe", {}, "smoke_moe", None),
    ("hybrid", {}, "smoke_hybrid", None),
    ("moe", {"n_routed_experts": 8}, "smoke_moe", "n_routed_experts"),
    ("moe", {"hidden_size": 32}, "smoke_moe", "hidden_size"),
    ("moe", {}, "dense_decoder", "family=moe"),
    ("hybrid", {}, "dense_decoder", "family=hybrid")])
def test_check_agrees_by_family(tables, family, changes, reference, fails):
    cfg = dict(families.CONFIGS[family], **changes)
    mcfg = families.model_cfg(families.CONFIGS[family])
    ref = spec.reference({"reference": reference})
    if fails is None:
        program.check_agrees(cfg, mcfg, ref)
    else:
        with pytest.raises(ValueError, match=fails):
            program.check_agrees(cfg, mcfg, ref)


def test_deepseek_7b_agrees_with_the_port():
    cfg = spec.config("deepseek-7b")
    assert program.program_config(cfg).family == "dense"


def test_declared_model_flops_feed_the_yardstick(tables):
    cfg = families.MOE_CFG
    head = 2 * 64 * 256
    assert yardstick.prefill_flops(cfg, 5) == 1000 * 5 + 10 * 15 + head
    assert yardstick.decode_flops(cfg, [3, 4]) == (1000 + head) * 2 + 10 * 7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_the_tree_serves_on_the_card(card, tables, family):
    _serve(family, "cuda:0")
