"""The port's smoke trees of two non-dense families, as configurations the
harness takes: deepseek-v3-671b's (moe: MLA, a shared expert, its first
layer dense) and jamba-v0.1-52b's (hybrid: one period of eight layers,
Mamba in seven and attention in the last, MoE on every other). Each has a
test-local leaf table in a reference's place (``FAMILY``, ``leaves``,
``RULES``, ``model_flops``); their plain references, and a published
configuration's file, are a later configuration's to bring."""

import dataclasses
import math
import sys

import torch

from teebench.weights import Leaf

# the dense keys every configuration file holds (``program._FIELDS``)
_DENSE = {"hidden_size": 64, "intermediate_size": 128, "head_dim": 16,
          "num_attention_heads": 4, "vocab_size": 256, "rope_theta": 10000.0,
          "rms_norm_eps": 1e-05, "tie_word_embeddings": True,
          "torch_dtype": "bfloat16"}

MOE_CFG = {**_DENSE, "num_key_value_heads": 4, "moe_intermediate_size": 64,
           "n_routed_experts": 4, "num_experts_per_tok": 2,
           "n_shared_experts": 1, "first_k_dense_replace": 1, "q_lora_rank": 32,
           "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
           "v_head_dim": 16, "num_hidden_layers": 2,
           "program_arch": "deepseek-v3-671b", "reference": "smoke_moe"}

HYBRID_CFG = {**_DENSE, "num_key_value_heads": 2,
              "expert_intermediate_size": 64, "num_experts": 4,
              "num_experts_per_tok": 2, "mamba_d_state": 4,
              "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 4,
              "attn_layer_period": 8, "expert_layer_period": 2,
              "num_hidden_layers": 8, "program_arch": "jamba-v0.1-52b",
              "reference": "smoke_hybrid"}


def _common(cfg):
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return {"embedding.table": Leaf((v, d), "embedding", (1,)),
            "final_norm.scale": Leaf((d,), "norm"),
            "pre_norm.scale": Leaf((d,), "norm"),
            "post_norm.scale": Leaf((d,), "norm")}


def _swiglu(prefix, d, ff):
    return {f"{prefix}.w_gate": Leaf((d, ff), "fan_in", (0,)),
            f"{prefix}.w_up": Leaf((d, ff), "fan_in", (0,)),
            f"{prefix}.w_down": Leaf((ff, d), "fan_in", (0,))}


def _experts(d, e, f):
    return {"moe.router": Leaf((d, e), "fan_in", (0,), "float32"),
            "moe.experts.w_gate": Leaf((e, d, f), "fan_in", (1,)),
            "moe.experts.w_up": Leaf((e, d, f), "fan_in", (1,)),
            "moe.experts.w_down": Leaf((e, f, d), "fan_in", (1,))}


class SmokeMoE:
    """deepseek-v3's leaves, named below the slot of ``dense_layers`` and
    ``moe_layers`` alike."""
    FAMILY = "moe"
    PORT_FIELDS = {"n_routed_experts": "moe.num_experts",
                   "num_experts_per_tok": "moe.top_k",
                   "moe_intermediate_size": "moe.d_ff_expert",
                   "n_shared_experts": "moe.num_shared_experts",
                   "first_k_dense_replace": "moe.first_k_dense",
                   "q_lora_rank": "mla.q_lora_rank",
                   "kv_lora_rank": "mla.kv_lora_rank"}

    @staticmethod
    def leaves(cfg):
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        qr, kr = cfg["q_lora_rank"], cfg["kv_lora_rank"]
        rope, nope, vd = (cfg["qk_rope_head_dim"], cfg["qk_nope_head_dim"],
                          cfg["v_head_dim"])
        f = cfg["moe_intermediate_size"]
        return {**_common(cfg),
                "mla.w_dq": Leaf((d, qr), "fan_in", (0,)),
                "mla.q_norm.scale": Leaf((qr,), "norm"),
                "mla.w_uq": Leaf((qr, h, nope + rope), "fan_in", (0,)),
                "mla.w_dkv": Leaf((d, kr + rope), "fan_in", (0,)),
                "mla.kv_norm.scale": Leaf((kr,), "norm"),
                "mla.w_uk": Leaf((kr, h, nope), "fan_in", (0,)),
                "mla.w_uv": Leaf((kr, h, vd), "fan_in", (0,)),
                "mla.wo": Leaf((h, vd, d), "fan_in", (0, 1)),
                **_swiglu("ffn", d, cfg["intermediate_size"]),
                **_experts(d, cfg["n_routed_experts"], f),
                **_swiglu("moe.shared", d, f * cfg["n_shared_experts"])}

    @staticmethod
    def model_flops(cfg):
        """Made-up counts: the yardstick must take them as declared."""
        return 1000, 10


def _a_log(out, gen, leaf):
    """S4D-real's log(1..d_state) a channel, jittered by the draw."""
    ds = leaf.shape[-1]
    base = torch.log(torch.arange(1, ds + 1, dtype=out.dtype,
                                  device=out.device))
    out.normal_(0.0, 0.01, generator=gen).add_(base)


def _dt_bias(out, gen, leaf):
    """The softplus inverse of a step log-uniform in [1e-3, 1e-1]."""
    dt = torch.empty_like(out).uniform_(generator=gen)
    dt.mul_(math.log(0.1) - math.log(1e-3)).add_(math.log(1e-3)).exp_()
    out.copy_(dt + torch.log(-torch.expm1(-dt)))


def _bias(out, gen, leaf):
    out.normal_(0.0, 0.01, generator=gen)


class SmokeHybrid:
    """jamba's leaves, each named below its slot (``mamba.w_in`` in seven
    slots of the period, ``attn.wq`` in the last)."""
    FAMILY = "hybrid"
    RULES = {"a_log": _a_log, "dt_bias": _dt_bias, "bias": _bias}

    @staticmethod
    def leaves(cfg):
        d, h, hk, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                        cfg["num_key_value_heads"], cfg["head_dim"])
        di = cfg["mamba_expand"] * d
        ds, dr, dc = (cfg["mamba_d_state"], cfg["mamba_dt_rank"],
                      cfg["mamba_d_conv"])
        return {**_common(cfg),
                "attn.wq": Leaf((d, h, hd), "fan_in", (0,)),
                "attn.wk": Leaf((d, hk, hd), "fan_in", (0,)),
                "attn.wv": Leaf((d, hk, hd), "fan_in", (0,)),
                "attn.wo": Leaf((h, hd, d), "fan_in", (0, 1)),
                "mamba.w_in": Leaf((d, 2 * di), "fan_in", (0,)),
                "mamba.conv_w": Leaf((dc, di), "fan_in", (0,)),
                "mamba.conv_b": Leaf((di,), "bias"),
                "mamba.w_bcdt": Leaf((di, 2 * ds + dr), "fan_in", (0,)),
                "mamba.w_dt": Leaf((dr, di), "fan_in", (0,)),
                "mamba.dt_bias": Leaf((di,), "dt_bias", (), "float32"),
                "mamba.a_log": Leaf((di, ds), "a_log", (), "float32"),
                "mamba.d_skip": Leaf((di,), "norm", (), "float32"),
                "mamba.w_out": Leaf((di, d), "fan_in", (0,)),
                **_swiglu("ffn", d, cfg["intermediate_size"]),
                **_experts(d, cfg["num_experts"],
                           cfg["expert_intermediate_size"])}


TABLES = {"smoke_moe": SmokeMoE, "smoke_hybrid": SmokeHybrid}
CONFIGS = {"moe": MOE_CFG, "hybrid": HYBRID_CFG}


def model_cfg(cfg):
    """The port's smoke config of ``cfg``'s family, in its type."""
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(cfg["program_arch"]),
                               dtype=cfg["torch_dtype"])


def register(monkeypatch) -> None:
    """Each test-local table where ``spec.reference`` finds a loaded
    reference."""
    for name, table in TABLES.items():
        monkeypatch.setitem(sys.modules, f"teebench_reference_{name}",
                            table)
