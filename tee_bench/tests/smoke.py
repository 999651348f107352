"""Smoke sizes for the CPU tests: a two-layer dense decoder of the
configurations' shape, a cell that fills its few slots, a benchmark entry
for it, and a window sized to this machine's pace."""

import copy
import dataclasses
import functools
import json

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
             {"name": "b3_roofline.chat", "unit": "%"},
             {"name": "prefill_ms.chat", "unit": "ms"},
             {"name": "decode_launch_ms.chat", "unit": "ms"}]}
# engine steps a window holds at the machine's pace: enough that the check
# finds its sample (20 tokens over 3 requests) finished whatever that pace
WINDOW_STEPS = 30
TRACED_SLOWDOWN = 1.6       # the profiler's cost on a step


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


@functools.cache
def _step_s(cfg_json: str, cell_json: str, model) -> float:
    from teebench import runner
    from teebench.client import clock
    from teebench.program import System
    cfg, cell = json.loads(cfg_json), json.loads(cell_json)
    system = System(cfg, cell, 1, device="cpu", model_cfg=model, seal=False)
    run = runner.serve(system, cfg, cell, MIX, 1, 1.0, traced=False,
                       t_process0=clock())
    system.close()
    return sum(s.t1 - s.t0 for s in run.steps) / len(run.steps)


def window_s(cfg=CFG, model=None, cell=CELL, traced=False) -> float:
    """A smoke window of ``WINDOW_STEPS`` engine steps of ``model`` (the
    port's smoke config; deepseek-7b's by default) serving ``cell`` at
    this machine's pace, measured once a process by a short serve of the
    smoke mix, and at least the 2.5 s a fast machine needs."""
    model = model if model is not None else model_cfg(cfg)
    step = _step_s(json.dumps(cfg, sort_keys=True),
                   json.dumps(cell, sort_keys=True), model)
    return max(2.5, WINDOW_STEPS * step) * (TRACED_SLOWDOWN if traced
                                           else 1.0)
