"""The benchmark's weights: deepseek-7b's leaves bit for bit as the
harness made them before leaf tables (digests of its smoke tree, recorded
from that code), and each row of a stacked leaf made for its model layer
whatever the port's blocks and slots."""

import hashlib

import pytest
import torch

from teebench import program, weights

import smoke

SEED = 2 ** 40 + 1
# sha256 (first 16 hex digits) of each leaf of the smoke deepseek-7b tree,
# stacked over its two layers, for SEED
DIGESTS = {
    "float32": {
        "attn.wk": "da1dd82cd8d87726",
        "attn.wo": "ba71da8a248040c8",
        "attn.wq": "becf48d8b505ba1c",
        "attn.wv": "db8f2ef55788b088",
        "embedding.table": "0ce5a17e050755f9",
        "ffn.w_down": "63725a5531900f93",
        "ffn.w_gate": "5fbd2c9a877e88fa",
        "ffn.w_up": "8f4349408fdd384e",
        "final_norm.scale": "8009053de5fd4be9",
        "post_norm.scale": "72a20de72fe1d527",
        "pre_norm.scale": "0142986258e42e30",
    },
    "bfloat16": {
        "attn.wk": "d06843c590abb312",
        "attn.wo": "0342c8e09e288d14",
        "attn.wq": "4b13408a5b652172",
        "attn.wv": "761f59cf9a675099",
        "embedding.table": "65523498e2e268ab",
        "ffn.w_down": "9cdf5f0575f257b8",
        "ffn.w_gate": "3036863afa8bd73c",
        "ffn.w_up": "682e7fca165af722",
        "final_norm.scale": "fae756f899f4bd1b",
        "post_norm.scale": "a7cd8a171a8b2279",
        "pre_norm.scale": "45c92cdbb503b002",
    },
}


def _digest(t: torch.Tensor) -> str:
    raw = t.contiguous().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


@pytest.mark.parametrize("dtype", sorted(DIGESTS))
def test_deepseek_7b_leaves_keep_their_digests(dtype):
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.models import build_model
    cfg = dict(smoke.CFG, torch_dtype=dtype)
    abstract = build_model(smoke.model_cfg(cfg), device="cpu"
                           ).abstract_params()
    blocks = program.blocks_of(abstract)
    assert blocks == {"layers": (0, 2, 1)}
    got = {program.logical_name(path, blocks)[0]: _digest(t)
           for path, t in tree_leaves_with_names(
               program.make_params(cfg, SEED, abstract, device="cpu"))}
    assert got == DIGESTS[dtype]


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_rows_are_made_for_their_model_layer():
    """Blocks in the tree's order, each repeat through its slots: three
    dense layers then 58 MoE layers, and four periods of eight slots."""
    moe = {"embedding": {"table": _meta(8, 4)},
           "dense_layers": {"slot_0": {"mla": {"w_dq": _meta(3, 4, 2)}}},
           "moe_layers": {"slot_0": {"mla": {"w_dq": _meta(58, 4, 2)}}}}
    blocks = program.blocks_of(moe)
    assert blocks == {"dense_layers": (0, 3, 1), "moe_layers": (3, 58, 1)}
    assert program.logical_name("['moe_layers']['slot_0']['mla']['w_dq']",
                                blocks) == ("mla.w_dq", list(range(3, 61)))
    assert program.logical_name("['embedding']['table']", blocks) == \
        ("embedding.table", None)
    hybrid = {"groups": {f"slot_{i}": {"pre_norm": {"scale": _meta(4, 2)}}
                         for i in range(8)}}
    blocks = program.blocks_of(hybrid)
    assert blocks == {"groups": (0, 4, 8)}
    assert program.logical_name("['groups']['slot_7']['pre_norm']['scale']",
                                blocks)[1] == [7, 15, 23, 31]
    assert program.logical_name("['groups']['slot_2']['pre_norm']['scale']",
                                blocks)[1] == [2, 10, 18, 26]


def test_a_row_is_the_layer_made_alone():
    cfg = dict(smoke.CFG)
    rows = weights.stacked(cfg, 5, "attn.wq", [4, 1], device="cpu")
    assert torch.equal(rows[0], weights.make(cfg, 5, "attn.wq", 4,
                                             device="cpu"))
    assert torch.equal(rows[1], weights.make(cfg, 5, "attn.wq", 1,
                                             device="cpu"))
    assert not torch.equal(rows[0], rows[1])


def test_a_leaf_the_table_lacks_is_refused():
    with pytest.raises(KeyError, match="mla.w_dq"):
        weights.make(dict(smoke.CFG), 5, "mla.w_dq", 0, device="cpu")
