"""Smoke sizes for the CPU tests: a two-layer dense decoder of the
configurations' shape, a cell that fills its few slots, and a benchmark
entry for it."""

import copy
import dataclasses

CFG = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
       "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
       "tie_word_embeddings": True, "torch_dtype": "float32",
       "program_arch": "deepseek-7b", "reference": "dense_decoder"}

CELL = {"trust_domain": "cgpu",
        "engine": {"max_slots": 4, "max_len": 64, "page_size": 8,
                   "num_pages": 32, "prefill_buckets": [16, 32]},
        "arrivals": {"rate_per_s": 6.0, "lengths_block": 3},
        "preroll_s": 0.5, "trace_s": 0.5,
        "check": {"max_logit_gap": 1e-3, "min_tokens": 20,
                  "min_requests": 3, "max_requests": 6}}

MIX = {"arrival": "poisson", "coalesce": 1,
       "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                  "min": 4, "max": 30},
       "output": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                  "min": 2, "max": 12}}

BENCH = {"workloads": [{"name": "smoke", "config": "smoke",
                        "traffic": "smoke", "chips": 1}],
         "end_to_end": [
             {"name": "setup_s", "unit": "s"},
             {"name": "output_tok_s", "unit": "tokens/s"},
             {"name": "ttft_p90_ms", "unit": "ms"},
             {"name": "itl_p95_ms", "unit": "ms"}],
         "per_layer": [
             {"name": "weights_seal_s", "unit": "s"},
             {"name": "decode_step_ms.chat", "unit": "ms"},
             {"name": "admit_step_ms.chat", "unit": "ms"},
             {"name": "mfu.chat", "unit": "%"},
             {"name": "idle_pct.chat", "unit": "%"},
             {"name": "b3_roofline.chat", "unit": "%"}]}


def model_cfg(cfg=CFG):
    """The port's smoke config at the smoke file's sizes."""
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(cfg["program_arch"]),
                               dtype=cfg["torch_dtype"])


def setup(mix_changes=None, **changes):
    """(bench, cell, cfg, mix) with ``changes`` applied to the cell and
    ``mix_changes`` to the mix."""
    cell = copy.deepcopy(CELL)
    cell.update(changes)
    mix = copy.deepcopy(MIX)
    mix.update(mix_changes or {})
    return copy.deepcopy(BENCH), cell, dict(CFG), mix
